"""Cached forwards shared by compiled decode and the decode server.

Port of ``_chunk_step`` and ``_prefill`` from
``minidiff_tpu/models/speculative.py``; the speculative decoder itself comes
with a later slice.  Caches are per-layer ``{"k", "v"}`` tensors of shape
(B, H, L, hd) in the parameter dtype, updated IN PLACE.
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels.attention import sdpa
from minidiff_tpu_torch.models import functional as F

_NEG = -1e30


def _chunk_step(model, caches, chunk, pos, L: int):
    """Process c tokens per row at per-row global positions pos..pos+c-1.

    chunk (B, c) int, pos (B,) int; returns logits (B, c, V).  Attention
    covers the full cache window under the per-row mask ``l <= pos + i``
    (earlier positions plus in-chunk causality in one predicate).
    """
    b, c = chunk.shape
    dev = chunk.device
    pos2d = pos.reshape(b, 1) + torch.arange(c, device=dev).reshape(1, c)
    x = model.tok_emb[chunk] + model.pos_emb[pos2d]
    lid = torch.arange(L, device=dev).reshape(1, 1, 1, L)
    mask = lid <= pos2d.reshape(b, 1, c, 1)  # (B, 1, c, L)
    rows = torch.arange(b, device=dev).reshape(b, 1)
    for blk, cache in zip(model.blocks, caches):
        q, kk, vv = F.block_qkv(blk, x)
        # rows written by index, in place: the same cache the JAX package
        # builds with its one-hot contraction (_write_rows)
        cache["k"][rows, :, pos2d] = kk.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][rows, :, pos2d] = vv.transpose(1, 2).to(cache["v"].dtype)
        keys = cache["k"].to(q.dtype)
        vals = cache["v"].to(q.dtype)
        scores = (q @ keys.transpose(-1, -2)) * (1.0 / (blk.attn.head_dim ** 0.5))
        # scores and softmax in f32 whatever the model dtype, as the JAX step
        scores = scores.to(torch.float32)
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
        o = F.softmax(scores, dim=-1).to(q.dtype) @ vals
        x = F.block_finish(blk, x, o)
    x = model.ln_f(x)
    return model.lm_head(x)


def _prefill(model, toks, L: int, last=None):
    """Whole-prompt parallel forward of toks (B, s) -> (caches of window L
    holding positions < s, logits (B, V) at position ``last``, default s-1).
    """
    b, s = toks.shape
    last = s - 1 if last is None else int(last)
    x = model.tok_emb[toks] + model.pos_emb[:s]
    caches = []
    for blk in model.blocks:
        attn = blk.attn
        q, kk, vv = F.block_qkv(blk, x)
        ck = torch.zeros((b, attn.num_heads, L, attn.head_dim),
                         dtype=model.dtype, device=toks.device)
        cv = torch.zeros_like(ck)
        ck[:, :, :s] = kk
        cv[:, :, :s] = vv
        caches.append({"k": ck, "v": cv})
        o = sdpa(q, kk, vv, causal=True)
        x = F.block_finish(blk, x, o)
    x = model.ln_f(x)
    return caches, model.lm_head(x[:, last:last + 1])[:, 0]
