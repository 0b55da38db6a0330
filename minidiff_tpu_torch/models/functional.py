"""Functional pieces of the transformer and the sampler.

Port of the serving and training paths' part of
``minidiff_tpu/models/functional.py``: ``sigmoid``, ``silu``, ``gelu`` (the
tanh form), ``gelu_erf``, ``softmax``, ``logsumexp``, ``log_softmax``,
``cross_entropy``, ``apply_rope``, ``truncate_logits``, ``block_qkv``,
``residual_norm`` and ``block_finish``, plus the next-token choice the JAX
decode scan and server each inline (argmax, or Gumbel-max over truncated
logits).
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels.layernorm import add_layernorm, add_rmsnorm
from minidiff_tpu_torch.kernels.xent import softmax_xent

_NEG = -1e30


def sigmoid(x):
    # the tanh form: finite forward and backward for any |x|
    return 0.5 * (torch.tanh(x * 0.5) + 1.0)


def silu(x):
    """x * sigmoid(x), the SwiGLU gate activation."""
    return x * sigmoid(x)


def gelu(x):
    # tanh approximation (HF "gelu_new"), not torch's default exact GELU
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x**3)))


def gelu_erf(x):
    """Exact GELU 0.5 * x * (1 + erf(x / sqrt(2)))."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def softmax(z, dim: int = -1):
    m = z.max(dim=dim, keepdim=True).values
    e = torch.exp(z - m)
    return e / e.sum(dim=dim, keepdim=True)


def logsumexp(z, dim: int = -1, keepdim: bool = False):
    m = z.max(dim=dim, keepdim=True).values
    out = torch.log(torch.exp(z - m).sum(dim=dim, keepdim=True)) + m
    return out if keepdim else out.squeeze(dim)


def log_softmax(z, dim: int = -1):
    return z - logsumexp(z, dim=dim, keepdim=True)


def cross_entropy(logits, labels, reduce: bool = True):
    """Mean softmax cross-entropy (``reduce=False``: per-example losses).

    Integer class ids go through ``softmax_xent`` (the loss kernels on the
    card); one-hot or soft labels of the logits' shape take the composed
    log-softmax path.
    """
    if labels.dim() == logits.dim():
        per = -(labels * log_softmax(logits, dim=-1)).sum(dim=-1)
    else:
        per = softmax_xent(logits, labels)
    return per.mean() if reduce else per


def apply_rope(x, positions, base: float = 10000.0, rot_dim=None):
    """Rotary position embedding over the last axis of x (b, h, s, hd).

    ``positions`` gives each slot's global position: (s,), a scalar for a
    one-token step, or (b, s) when rows sit at different positions.  The
    pairs (x[2i], x[2i+1]) rotate by positions * base^(-2i/hd), with the
    frequencies and angles computed in x's dtype as the JAX package does.
    ``rot_dim`` rotates only the first ``rot_dim`` channels of each head
    (frequencies over ``rot_dim``); the rest pass through.
    """
    b, h, s, hd = x.shape
    if rot_dim is not None and rot_dim != hd:
        if not (0 < rot_dim < hd and rot_dim % 2 == 0):
            raise ValueError(f"rot_dim {rot_dim} must be even and in (0, {hd})")
        xr = apply_rope(x[..., :rot_dim], positions, base)
        return torch.cat([xr, x[..., rot_dim:]], dim=-1)
    if hd % 2:
        raise ValueError("RoPE needs an even head dim")
    half = hd // 2
    inv_freq = torch.pow(float(base), torch.arange(half, device=x.device).to(x.dtype)
                         * (-2.0 / hd))
    pos = torch.as_tensor(positions, device=x.device).to(x.dtype)
    if pos.dim() == 0:
        pos = pos.reshape(1)
    angles = pos[..., None] * inv_freq  # (s, half) or (b, s, half)
    lead = (b, 1, s, half) if angles.dim() == 3 else (1, 1, s, half)
    cos, sin = torch.cos(angles).reshape(lead), torch.sin(angles).reshape(lead)
    xr = x.reshape(b, h, s, half, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, h, s, hd)


def truncate_logits(logits, top_k=None, top_p=None, min_p=None):
    """Top-k, then nucleus top-p, then min-p truncation over (..., V) logits
    (HuggingFace's processor order); removed entries become -1e30.  The
    argmax token always survives."""
    if top_k is not None and top_k < logits.shape[-1]:
        vals, _ = torch.topk(logits, top_k, dim=-1)
        logits = torch.where(logits >= vals[..., -1:], logits,
                             torch.full_like(logits, _NEG))
    if top_p is not None and float(top_p) < 1.0:
        probs = softmax(logits.to(torch.float32))
        desc = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(desc, dim=-1)
        # keep sorted position j iff the mass strictly before it is < top_p
        keep = (cum - desc) < float(top_p)
        thresh = torch.where(keep, desc, torch.full_like(desc, 2.0)).min(
            dim=-1, keepdim=True).values
        logits = torch.where(probs >= thresh, logits, torch.full_like(logits, _NEG))
    if min_p is not None and float(min_p) > 0.0:
        probs = softmax(logits.to(torch.float32))
        mx = probs.max(dim=-1, keepdim=True).values
        logits = torch.where(probs >= float(min_p) * mx, logits,
                             torch.full_like(logits, _NEG))
    return logits


_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64: c in 16-bit halves,
    so that no product leaves the int64 range on any device."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finaliser, a bijection of [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_uniform(seed, step, row, vocab: int):
    """U(0, 1) in f32, strictly inside: (B, V) from int64 tensors ``seed``,
    ``step``, ``row`` of one shape (B,) on one device.  A counter-based hash
    of (seed, step, row, vocab index) in integer tensor ops on that device:
    the same bits on every device, no generator state, no host copy, so
    the draw can sit inside a CUDA graph whose seeds and steps are
    inputs.  Each value is (m + 0.5) / 2^24 for the hash's top 24 bits m."""
    k = _fmix32((seed & _M32) ^ 0x3C6EF372)
    k = _fmix32(k ^ (step & _M32))
    k = _fmix32(k ^ (row & _M32))
    v = _fmix32(torch.arange(vocab, dtype=torch.int64, device=seed.device) ^ 0x9E3779B9)
    bits = _fmix32(k[:, None] ^ v[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def gumbel_noise(seed, step, row, vocab: int):
    """Gumbel(0, 1) noise in f32, (B, V): ``-log(-log(u))`` of
    ``gumbel_uniform(seed, step, row, vocab)``, a pure function of its key
    and finite (u lies in [2^-25, 1 - 2^-25]).  (The JAX package draws
    threefry bits, which are not reproduced here.)"""
    return -torch.log(-torch.log(gumbel_uniform(seed, step, row, vocab)))


def select_next(logits, greedy: bool, temperature: float = 1.0, top_k=None,
                top_p=None, min_p=None, noise=None):
    """Next token from (B, V) logits: argmax, or the Gumbel-max draw
    ``argmax(truncate(logits / temperature) + noise)``."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    scaled = truncate_logits(scaled, top_k=top_k, top_p=top_p, min_p=min_p)
    return torch.argmax(scaled + noise.to(scaled.dtype), dim=-1)


def block_qkv(blk, x, positions=None):
    """ln1 -> QKV projection (+RoPE at ``positions``: None for
    ``arange(s)``, or whatever ``apply_rope`` takes): q (b, h, s, hd), k, v
    (b, kv, s, hd)."""
    attn = blk.attn
    q, k, v = attn.project_qkv(blk.ln1(x))
    if attn.rope:
        pos = (positions if positions is not None
               else torch.arange(x.shape[1], device=x.device))
        q = apply_rope(q, pos, attn.rope_base, rot_dim=attn.rope_dim)
        k = apply_rope(k, pos, attn.rope_base, rot_dim=attn.rope_dim)
    return q, k, v


def residual_norm(norm, x, a):
    """``(t, z) = (x + a, norm(x + a))`` through the fused add+norm kernel
    of ``norm``'s kind (a LayerNorm or an RMSNorm module)."""
    if norm.kind == "rms":
        pair = add_rmsnorm(x, a, norm.g, norm.eps)
    else:
        pair = add_layernorm(x, a, norm.g, norm.b, norm.eps)
    return pair[0], pair[1]


def block_finish(blk, x, o):
    """Close a block around attention output ``o`` (b, h, s, hd): merge
    heads, out-projection residual with ln2, then the MLP residual.  A
    parallel block adds both branches to x, its MLP on ln1(x) again."""
    b, h, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    a = blk.attn.out(o)
    if blk.parallel:
        return x + a + blk.apply_mlp_normed(blk.ln1(x))
    t, z = residual_norm(blk.ln2, x, a)
    return t + blk.apply_mlp_normed(z)
