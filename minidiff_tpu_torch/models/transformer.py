"""Decoder-only transformer LM on PyTorch.

Port of ``minidiff_tpu/models/transformer.py``.  ``TransformerLM.forward``
is the JAX ``TransformerLM.apply``, and ``lm_loss`` its training loss.  The
options of the JAX model that are ported: LayerNorm or RMSNorm
(``norm``, ``norm_eps``), learned positions or RoPE (``rope``,
``rope_base``, ``rope_dim``), multi-head or grouped-query attention
(``num_kv_heads``), the MLP kinds ``gelu`` / ``gelu_erf`` / ``swiglu`` /
``geglu`` / ``geglu_erf`` (``mlp_hidden``, ``mlp_bias``), ``attn_bias``,
``parallel_block``, ``tie_embeddings``, ``head_bias``, sliding-window
attention with attention sinks (``window``, ``sinks``) and packed
sequences (``forward(tokens, segment_ids=, positions=)``, built by
``models/pack.py``).  Module attribute
names follow the JAX parameter tree, so ``params_from_jax(model.init())``
loads into the port for any of them.  The norms go through the LayerNorm /
RMSNorm kernels and their fused add+norm forms, the attention core through
the flash kernels and the loss through the cross-entropy kernels
(``kernels/``), each differentiable through its ``torch.autograd.Function``;
the projections are plain matrix products.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from minidiff_tpu_torch.kernels.attention import sdpa
from minidiff_tpu_torch.kernels.layernorm import layernorm, rmsnorm
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import Linear, resolve_device

_LATER = "a later slice of the port"
MLP_KINDS = ("gelu", "gelu_erf", "swiglu", "geglu", "geglu_erf")
_GATE_ACT = {"swiglu": F.silu, "geglu": F.gelu, "geglu_erf": F.gelu_erf}


def _check_window(window, sinks):
    """(window, sinks) of a causal attention layer: a window of at least 1
    position (None: none) and sinks >= 0, as the JAX layer asserts."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if int(sinks) < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    return (None if window is None else int(window)), int(sinks)


def _later(option: str):
    return NotImplementedError(
        f"TransformerLM option {option!r} is not ported yet: it comes with "
        f"{_LATER}")


class LayerNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * g + b over the last axis."""

    kind = "layer"

    def __init__(self, dim: int, eps: float = 1e-5, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layernorm(x, self.g, self.b, self.eps)


class RMSNorm(nn.Module):
    """y = x / sqrt(mean(x^2) + eps) * g over the last axis (no centring,
    no bias)."""

    kind = "rms"

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(x, self.g, self.eps)


def _make_norm(kind: str, dim: int, eps=None, *, dtype, device):
    cls = {"layer": LayerNorm, "rms": RMSNorm}.get(kind)
    if cls is None:
        raise ValueError(f"unknown norm kind {kind!r} (expected 'layer'/'rms')")
    kw = {} if eps is None else {"eps": eps}
    return cls(dim, dtype=dtype, device=device, **kw)


class MultiHeadAttention(nn.Module):
    """Causal self-attention: QKV projection, sdpa core, output projection.

    With ``num_kv_heads == num_heads`` the QKV projection is one fused
    Linear whose columns are head-major (h, 3, hd); with fewer KV heads
    (grouped-query attention) q comes from ``wq`` and k, v from ``wkv``,
    whose columns are (kv, 2, hd), and each KV head serves its group of
    query heads (``expand_kv``).  ``rope`` rotates q and k at their global
    positions (or at ``positions``, per document under packing).  With a
    ``window`` each query sees the last ``window`` positions plus the first
    ``sinks`` (Mistral-style sliding windows, StreamingLLM sinks).
    """

    def __init__(self, dim: int, num_heads: int, *, dtype, device, generator,
                 num_kv_heads=None, rope: bool = False,
                 rope_base: float = 10000.0, rope_dim=None,
                 bias: bool = False, window=None, sinks: int = 0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        self.rope = rope
        self.rope_base = rope_base
        self.rope_dim = rope_dim
        self.window, self.sinks = _check_window(window, sinks)
        kw = dict(dtype=dtype, device=device, generator=generator)
        if self.num_kv_heads == num_heads:
            self.qkv = Linear(dim, 3 * dim, bias=bias, **kw)
        else:
            self.wq = Linear(dim, dim, bias=bias, **kw)
            self.wkv = Linear(dim, 2 * self.num_kv_heads * self.head_dim,
                              bias=bias, **kw)
        self.out = Linear(dim, dim, bias=bias, **kw)

    def project_qkv(self, x):
        """x (b, s, d) -> q (b, h, s, hd), k, v (b, kv, s, hd)."""
        b, s, _ = x.shape
        h, hd, kv = self.num_heads, self.head_dim, self.num_kv_heads
        if kv == h:
            # HEAD-major column layout (h, 3, hd), as the JAX package stores it
            qkv = self.qkv(x).reshape(b, s, h, 3, hd)
            qkv = qkv.permute(3, 0, 2, 1, 4)  # (3, b, h, s, hd)
            return qkv[0], qkv[1], qkv[2]
        q = self.wq(x).reshape(b, s, h, hd).transpose(1, 2)
        kvp = self.wkv(x).reshape(b, s, kv, 2, hd).permute(3, 0, 2, 1, 4)
        return q, kvp[0], kvp[1]

    def expand_kv(self, t):
        """(b, kv, s, hd) -> (b, h, s, hd): each KV head repeated over its
        query group (a copy, since the kernels take contiguous operands)."""
        if self.num_kv_heads == self.num_heads:
            return t
        b, kv, s, hd = t.shape
        g = self.num_heads // kv
        return t[:, :, None].expand(b, kv, g, s, hd).reshape(b, kv * g, s, hd)

    def forward(self, x, positions=None, segment_ids=None):
        """``segment_ids`` ((B, S) int, -1 = padding) keep attention within
        each packed document; ``positions`` ((B, S)) are where RoPE rotates
        (``arange(S)`` by default)."""
        b, s, d = x.shape
        q, k, v = self.project_qkv(x)
        if self.rope:
            pos = positions if positions is not None else torch.arange(s, device=x.device)
            q = F.apply_rope(q, pos, self.rope_base, rot_dim=self.rope_dim)
            k = F.apply_rope(k, pos, self.rope_base, rot_dim=self.rope_dim)
        o = sdpa(q, self.expand_kv(k), self.expand_kv(v), causal=True,
                 window=self.window, sinks=self.sinks, segment_ids=segment_ids)
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class TransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(norm(x)); x + MLP(norm(x)).  A parallel
    block (Phi-style) shares one norm: x + MHA(ln1(x)) + MLP(ln1(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, *,
                 dtype, device, generator, num_kv_heads=None,
                 rope: bool = False, rope_base: float = 10000.0,
                 rope_dim=None, norm: str = "layer", norm_eps=None,
                 mlp: str = "gelu", mlp_hidden=None, mlp_bias: bool = True,
                 attn_bias: bool = False, parallel_block: bool = False,
                 window=None, sinks: int = 0):
        super().__init__()
        if mlp not in MLP_KINDS:
            raise ValueError(f"unknown mlp kind {mlp!r} (expected one of {MLP_KINDS})")
        kw = dict(dtype=dtype, device=device)
        self.ln1 = _make_norm(norm, dim, norm_eps, **kw)
        self.attn = MultiHeadAttention(
            dim, num_heads, generator=generator, num_kv_heads=num_kv_heads,
            rope=rope, rope_base=rope_base, rope_dim=rope_dim, bias=attn_bias,
            window=window, sinks=sinks, **kw)
        self.parallel = bool(parallel_block)
        self.ln2 = None if self.parallel else _make_norm(norm, dim, norm_eps, **kw)
        self.mlp = mlp
        self.hidden = mlp_hidden if mlp_hidden is not None else mlp_ratio * dim
        # gated kinds: fc1's columns are PAIR-major (hidden, 2), gate and
        # value of one hidden unit side by side, as the JAX tree stores them
        gated = mlp in _GATE_ACT
        self.fc1 = Linear(dim, (2 if gated else 1) * self.hidden, bias=mlp_bias,
                          generator=generator, **kw)
        self.fc2 = Linear(self.hidden, dim, bias=mlp_bias, generator=generator,
                          **kw)

    def apply_mlp_normed(self, z):
        """The MLP branch on an already-normed input: fc1 -> activation (or
        gate * value) -> fc2."""
        h = self.fc1(z)
        act = _GATE_ACT.get(self.mlp)
        if act is not None:
            hp = h.reshape(h.shape[:-1] + (self.hidden, 2))
            h = act(hp[..., 0]) * hp[..., 1]
        elif self.mlp == "gelu_erf":
            h = F.gelu_erf(h)
        else:
            h = F.gelu(h)
        return self.fc2(h)

    def forward(self, x, positions=None, segment_ids=None):
        xa = self.ln1(x)
        a = self.attn(xa, positions, segment_ids)
        if self.parallel:
            return x + a + self.apply_mlp_normed(xa)
        # fused residual-add + ln2: t = x + a and norm(t) in one pass
        t, z = F.residual_norm(self.ln2, x, a)
        return t + self.apply_mlp_normed(z)


class TransformerLM(nn.Module):
    """Decoder-only LM: token embeddings (plus learned positions unless
    ``rope``), pre-norm blocks, a final norm, and a head to vocab logits
    (untied, or ``x @ tok_emb.T`` with ``tie_embeddings``).

    Weights are drawn one tensor at a time from a CPU ``torch.Generator``
    seeded with ``seed`` (the same weights on every device), then placed on
    ``device``.  Load a JAX checkpoint with
    ``model.load_state_dict(params_from_jax(tree))``.  Every block shares
    one ``window`` (None: full causal attention) and ``sinks``.  Dropout
    and ``remat_blocks`` raise ``NotImplementedError``.
    """

    def __init__(self, vocab_size: int = 256, dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2,
                 max_seq_len: int = 256, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0, num_kv_heads=None, rope: bool = False,
                 tie_embeddings: bool = False, norm: str = "layer",
                 mlp: str = "gelu", window=None, sinks: int = 0,
                 rope_base: float = 10000.0, attn_bias: bool = False,
                 mlp_bias: bool = True, norm_eps=None, mlp_hidden=None,
                 rope_dim=None, parallel_block: bool = False,
                 head_bias: bool = False, dropout: float = 0.0,
                 remat_blocks: bool = False):
        super().__init__()
        for option, bad in (("dropout", dropout), ("remat_blocks", remat_blocks)):
            if bad:
                raise _later(option)
        if tie_embeddings and head_bias:
            raise ValueError("head_bias requires an untied head "
                             "(tie_embeddings=False)")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.rope = rope
        self.tie_embeddings = tie_embeddings
        self.window, self.sinks = _check_window(window, sinks)
        scale = 1.0 / math.sqrt(dim)

        def normal(shape):
            w = torch.randn(shape, generator=gen, dtype=torch.float64).mul_(scale)
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        self.tok_emb = normal((vocab_size, dim))
        kw = dict(dtype=dtype, device=dev, generator=gen)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, num_kv_heads=num_kv_heads,
                             rope=rope, rope_base=rope_base, rope_dim=rope_dim,
                             norm=norm, norm_eps=norm_eps, mlp=mlp,
                             mlp_hidden=mlp_hidden, mlp_bias=mlp_bias,
                             attn_bias=attn_bias, parallel_block=parallel_block,
                             window=window, sinks=sinks, **kw)
            for _ in range(num_layers))
        self.ln_f = _make_norm(norm, dim, norm_eps, dtype=dtype, device=dev)
        if not tie_embeddings:
            self.head = Linear(dim, vocab_size, bias=head_bias, **kw)
        if not rope:
            self.pos_emb = normal((max_seq_len, dim))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def lm_head(self, x):
        """Hidden states (..., d) -> vocab logits (..., V)."""
        if self.tie_embeddings:
            return x @ self.tok_emb.T
        return self.head(x)

    def forward(self, tokens, segment_ids=None, positions=None):
        """tokens (B, S) int -> logits (B, S, V).

        ``segment_ids`` / ``positions`` ((B, S) int, ``pack_documents``):
        packed sequences, attention confined to each document and the
        positions (learned, or RoPE's) restarting per document."""
        _, s = tokens.shape
        x = self.tok_emb[tokens]
        if not self.rope:
            x = x + (self.pos_emb[positions] if positions is not None else self.pos_emb[:s])
        for blk in self.blocks:
            x = blk(x, positions, segment_ids)
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
