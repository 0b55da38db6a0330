"""Cached forwards shared by compiled decode and the decode server.

Port of ``_chunk_step`` and ``_prefill`` from
``minidiff_tpu/models/speculative.py``; the speculative decoder itself comes
with a later slice.  Caches are per-layer ``{"k", "v"}`` tensors of shape
(B, kv, L, hd) (kv = the model's KV heads) in the parameter dtype, updated
IN PLACE, and expanded over each head's query group before attention; an
int8 cache (``kv_quant``, ``minidiff_tpu/models/decode.py:75-97, 189-205``)
is ``{"k8", "ks", "v8", "vs"}``: int8 lines (B, kv, L, hd), quantized per
(batch, head, position) over hd, with their f32 scales (B, kv, L), read
through the ``sdpa_int8`` kernel, which takes the query groups itself.
RoPE models rotate q and k at the global positions and add no learned
positions.  A sliding-window model (``model.window``) keeps the last
``window`` positions of each query plus the first ``model.sinks``, in the
prefill's flash kernels and in the cached step's mask alike.
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels.attention import sdpa
from minidiff_tpu_torch.kernels.quant import quantize_int8_rows, sdpa_int8_cache
from minidiff_tpu_torch.models import functional as F

_NEG = -1e30


def _chunk_step(model, caches, chunk, pos, L: int):
    """Process c tokens per row at per-row global positions pos..pos+c-1.

    chunk (B, c) int, pos (B,) int; returns logits (B, c, V).  Attention
    covers the full cache window under the per-row mask ``l <= pos + i``
    (earlier positions plus in-chunk causality in one predicate); a
    sliding-window model tightens it to the band ``l > pos + i - window``
    plus the ``sinks`` head rows (``minidiff_tpu/models/speculative.py:145-149``).
    """
    b, c = chunk.shape
    dev = chunk.device
    pos2d = pos.reshape(b, 1) + torch.arange(c, device=dev).reshape(1, c)
    x = model.tok_emb[chunk]
    if not model.rope:
        x = x + model.pos_emb[pos2d]
    lid = torch.arange(L, device=dev).reshape(1, 1, 1, L)
    qpos = pos2d.reshape(b, 1, c, 1)
    mask = lid <= qpos  # (B, 1, c, L)
    if getattr(model, "window", None) is not None:
        band = lid > qpos - model.window
        if model.sinks:
            band = band | (lid < model.sinks)
        mask = mask & band
    rows = torch.arange(b, device=dev).reshape(b, 1)
    for blk, cache in zip(model.blocks, caches):
        q, kk, vv = F.block_qkv(blk, x, pos2d)
        if "k8" in cache:
            # (B, c, h) rows by index, in place
            _write_int8_rows(cache, (rows, slice(None), pos2d),
                             kk.transpose(1, 2), vv.transpose(1, 2))
            o = sdpa_int8_cache(q, cache["k8"], cache["ks"], cache["v8"],
                                cache["vs"], pos)
        else:
            # rows written by index, in place: the same cache the JAX
            # package builds with its one-hot contraction (_write_rows)
            cache["k"][rows, :, pos2d] = kk.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][rows, :, pos2d] = vv.transpose(1, 2).to(cache["v"].dtype)
            keys = blk.attn.expand_kv(cache["k"].to(q.dtype))
            vals = blk.attn.expand_kv(cache["v"].to(q.dtype))
            scores = (q @ keys.transpose(-1, -2)) * (1.0 / (blk.attn.head_dim ** 0.5))
            # scores and softmax in f32 whatever the model dtype, as the JAX step
            scores = scores.to(torch.float32)
            scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
            o = F.softmax(scores, dim=-1).to(q.dtype) @ vals
        x = F.block_finish(blk, x, o)
    x = model.ln_f(x)
    return model.lm_head(x)


def _write_int8_rows(cache, index, kk, vv):
    """Quantize fresh k/v rows per row over hd and store them at ``index``
    of the int8 cache; kk/vv come in the shape that ``index`` selects."""
    for name, rows in (("k", kk), ("v", vv)):
        q8, sc = quantize_int8_rows(rows)
        cache[name + "8"][index] = q8
        cache[name + "s"][index] = sc


def _alloc_caches(model, b: int, L: int, kv_quant: bool, device):
    """Per-layer caches of window L for b rows, as a prefill leaves them
    before it writes: zeros, and for an int8 cache scale rows of 1 (as in
    the JAX cache)."""
    caches = []
    for blk in model.blocks:
        shape = (b, blk.attn.num_kv_heads, L, blk.attn.head_dim)
        if kv_quant:
            caches.append({"k8": torch.zeros(shape, dtype=torch.int8, device=device),
                           "ks": torch.ones(shape[:3], dtype=torch.float32, device=device),
                           "v8": torch.zeros(shape, dtype=torch.int8, device=device),
                           "vs": torch.ones(shape[:3], dtype=torch.float32, device=device)})
        else:
            caches.append({"k": torch.zeros(shape, dtype=model.dtype, device=device),
                           "v": torch.zeros(shape, dtype=model.dtype, device=device)})
    return caches


def _prefill(model, toks, L: int, last=None, kv_quant: bool = False, caches=None):
    """Whole-prompt parallel forward of toks (B, s) -> (caches of window L
    holding positions < s, logits (B, V) at position ``last``, default s-1).
    ``kv_quant`` stores int8 caches; attention still runs on the full
    precision k/v, as in the JAX prefill (``decode.py:189-205``).  Given
    ``caches`` (``_alloc_caches``' layout), the prefill resets and fills
    them in place instead of allocating.
    """
    b, s = toks.shape
    last = s - 1 if last is None else int(last)
    x = model.tok_emb[toks]
    if not model.rope:
        x = x + model.pos_emb[:s]
    if caches is None:
        caches = _alloc_caches(model, b, L, kv_quant, toks.device)
    else:
        for cache in caches:
            for name, t in cache.items():
                t.fill_(1 if name in ("ks", "vs") else 0)
    for blk, cache in zip(model.blocks, caches):
        attn = blk.attn
        q, kk, vv = F.block_qkv(blk, x)
        if kv_quant:
            _write_int8_rows(cache, (slice(None), slice(None), slice(0, s)), kk, vv)
        else:
            cache["k"][:, :, :s] = kk
            cache["v"][:, :, :s] = vv
        o = sdpa(q, attn.expand_kv(kk), attn.expand_kv(vv), causal=True,
                 window=model.window, sinks=model.sinks)
        x = F.block_finish(blk, x, o)
    x = model.ln_f(x)
    return caches, model.lm_head(x[:, last:last + 1])[:, 0]
