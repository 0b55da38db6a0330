"""Functional pieces of the transformer and the sampler.

Port of the serving and training paths' part of
``minidiff_tpu/models/functional.py``: ``gelu`` (the tanh form),
``softmax``, ``logsumexp``, ``log_softmax``, ``cross_entropy``,
``truncate_logits``, ``block_qkv``, ``residual_norm`` and ``block_finish``,
plus the next-token choice the JAX decode scan and server each inline
(argmax, or Gumbel-max over truncated logits).
"""

from __future__ import annotations

import numpy as np
import torch

from minidiff_tpu_torch.kernels.layernorm import add_layernorm
from minidiff_tpu_torch.kernels.xent import softmax_xent

_NEG = -1e30


def gelu(x):
    # tanh approximation (HF "gelu_new"), not torch's default exact GELU
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x**3)))


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


def gumbel_noise(shape, key, device):
    """Gumbel(0, 1) noise in f32, a pure function of ``key`` (a tuple of
    ints such as (seed, step)).  Drawn on the CPU from a torch.Generator
    seeded from the key, so it is the same on every device.  (The JAX
    package draws threefry bits, which cannot be reproduced here.)"""
    words = np.random.SeedSequence([int(k) & 0xFFFFFFFF for k in key]
                                   ).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32) + 1e-9
    return (-torch.log(-torch.log(u))).to(device)


def select_next(logits, greedy: bool, temperature: float = 1.0, top_k=None,
                top_p=None, min_p=None, noise=None):
    """Next token from (B, V) logits: argmax, or the Gumbel-max draw
    ``argmax(truncate(logits / temperature) + noise)``."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    scaled = truncate_logits(scaled, top_k=top_k, top_p=top_p, min_p=min_p)
    return torch.argmax(scaled + noise.to(scaled.dtype), dim=-1)


def block_qkv(blk, x):
    """ln1 -> fused QKV projection: q, k, v (b, h, s, hd)."""
    return blk.attn.project_qkv(blk.ln1(x))


def residual_norm(norm, x, a):
    """``(t, z) = (x + a, norm(x + a))`` through the fused add+LN kernel."""
    pair = add_layernorm(x, a, norm.g, norm.b, norm.eps)
    return pair[0], pair[1]


def block_finish(blk, x, o):
    """Close a block around attention output ``o`` (b, h, s, hd): merge
    heads, out-projection residual with ln2, then the MLP residual."""
    b, h, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    a = blk.attn.out(o)
    t, z = residual_norm(blk.ln2, x, a)
    return t + blk.apply_mlp_normed(z)
