"""Decoder-only transformer LM on PyTorch.

Port of ``minidiff_tpu/models/transformer.py`` for the flagship options:
learned ``pos_emb``, ``num_kv_heads == num_heads`` with the fused head-major
QKV projection, ``norm="layer"``, ``mlp="gelu"`` (tanh form) and an untied
head.  ``TransformerLM.forward`` is the JAX ``TransformerLM.apply``, and
``lm_loss`` its training loss.  The norms go through the LayerNorm and fused
add+LayerNorm kernels, the attention core through the flash kernels and the
loss through the cross-entropy kernels (``kernels/``), each differentiable
through its ``torch.autograd.Function``; the projections are plain matrix
products.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from minidiff_tpu_torch.kernels.attention import sdpa
from minidiff_tpu_torch.kernels.layernorm import layernorm
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import Linear, resolve_device


class LayerNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * g + b over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-5, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layernorm(x, self.g, self.b, self.eps)


class MultiHeadAttention(nn.Module):
    """Causal self-attention: fused QKV projection, sdpa core, output
    projection."""

    def __init__(self, dim: int, num_heads: int, *, dtype, device, generator):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.qkv = Linear(dim, 3 * dim, bias=False, **kw)
        self.out = Linear(dim, dim, bias=False, **kw)

    def project_qkv(self, x):
        """x (b, s, d) -> q, k, v (b, h, s, hd)."""
        b, s, _ = x.shape
        # HEAD-major column layout (h, 3, hd), as the JAX package stores it
        qkv = self.qkv(x).reshape(b, s, self.num_heads, 3, self.head_dim)
        qkv = qkv.permute(3, 0, 2, 1, 4)  # (3, b, h, s, hd)
        return qkv[0], qkv[1], qkv[2]

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.project_qkv(x)
        o = sdpa(q, k, v, causal=True)
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)) with GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, *,
                 dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, **kw)
        self.attn = MultiHeadAttention(dim, num_heads, generator=generator, **kw)
        self.ln2 = LayerNorm(dim, **kw)
        hidden = mlp_ratio * dim
        self.fc1 = Linear(dim, hidden, bias=True, generator=generator, **kw)
        self.fc2 = Linear(hidden, dim, bias=True, generator=generator, **kw)

    def apply_mlp_normed(self, z):
        """The MLP branch on an already-normed input (fc1 -> GELU -> fc2)."""
        return self.fc2(F.gelu(self.fc1(z)))

    def forward(self, x):
        a = self.attn(self.ln1(x))
        # fused residual-add + ln2: t = x + a and LN(t) in one pass
        t, z = F.residual_norm(self.ln2, x, a)
        return t + self.apply_mlp_normed(z)


_LATER = "a later slice of the port"


class TransformerLM(nn.Module):
    """Decoder-only LM: token + learned positional embeddings, pre-LN
    blocks, final LayerNorm, untied linear head to vocab logits.

    Weights are drawn from a CPU ``torch.Generator`` seeded with ``seed``
    (the same weights on every device), then placed on ``device``.  Load a
    JAX checkpoint with ``model.load_state_dict(params_from_jax(tree))``.
    """

    def __init__(self, vocab_size: int = 256, dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2,
                 max_seq_len: int = 256, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0, num_kv_heads=None, rope: bool = False,
                 tie_embeddings: bool = False, norm: str = "layer",
                 mlp: str = "gelu", window=None):
        super().__init__()
        unsupported = {
            "num_kv_heads": num_kv_heads not in (None, num_heads),
            "rope": rope, "tie_embeddings": tie_embeddings,
            "norm": norm != "layer", "mlp": mlp != "gelu",
            "window": window is not None,
        }
        for name, bad in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"TransformerLM option {name!r} is not ported yet: it "
                    f"comes with {_LATER}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        scale = 1.0 / math.sqrt(dim)

        def normal(shape):
            w = torch.randn(shape, generator=gen, dtype=torch.float64) * scale
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        self.tok_emb = normal((vocab_size, dim))
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, **kw)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(dim, dtype=dtype, device=dev)
        self.head = Linear(dim, vocab_size, bias=False, **kw)
        self.pos_emb = normal((max_seq_len, dim))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def lm_head(self, x):
        """Hidden states (..., d) -> vocab logits (..., V)."""
        return self.head(x)

    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, V)."""
        _, s = tokens.shape
        x = self.tok_emb[tokens] + self.pos_emb[:s]
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.ln_f(x))


def lm_loss(logits, targets, mask=None):
    """Mean SAME-POSITION cross-entropy over (B, S, V) logits / (B, S) ids.

    For next-token training, shift at the call site:
    ``lm_loss(logits[:, :-1], tokens[:, 1:])``.  ``mask`` ((B, S), nonzero =
    scored) gives the masked mean over the scored positions.
    """
    b, s, v = logits.shape
    if mask is None:
        return F.cross_entropy(logits.reshape(b * s, v), targets.reshape(b * s))
    per_tok = F.cross_entropy(logits.reshape(b * s, v), targets.reshape(b * s),
                              reduce=False)
    m = mask.reshape(b * s).to(per_tok.dtype)
    return (per_tok * m).sum() / torch.maximum(
        m.sum(), torch.ones((), dtype=per_tok.dtype, device=m.device))
