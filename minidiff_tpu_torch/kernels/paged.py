"""Paged decode attention: one query token over a shared pool of KV pages.

Port of ``minidiff_tpu/kernels/paged.py`` (``paged_attention``,
``paged_attention_reference``, ``append_kv``).  Layouts as there: q
(B, kv, g, hd) with query head h in kv head h // g; pools (P, kv, PAGE, hd);
table (B, maxp) int32 page ids; pos (B,) int32, the position of the incoming
token (cache rows l <= pos are live).  The mask is the dense server's,
``l <= pos``, with the optional sliding-window band ``l > pos - window`` and
``sinks`` always-visible head rows.

A CUDA tensor goes to the hand-written ``paged_attn`` kernel of
``csrc/paged.cu``, which walks the slot's pages through its table up to
page ``max(pos, 0) // PAGE`` with an online softmax, rounding the
unnormalised probabilities to the pool dtype before the PV product as the
TPU kernel does; pages past that one are never read.  The walk is split
over the CTAs of one thread-block cluster per (slot, kv head), each taking
an even share of the live pages, and their partials combine in f32 in rank
order (``paged_plan`` decides the split from shapes before launch).  A dead
slot (pos < 0) reads page 0 only, all of it masked, and gets the mean of
its V rows.  A CPU tensor goes to the plain version,
``paged_attention_reference`` over the gathered logical view, which rounds
the normalised probabilities instead.  A CUDA tensor the kernel does not
take raises: nothing falls back.

``append_kv`` is a scatter (``index_put_``) in place, as the JAX package's is
an XLA scatter and no Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minidiff_tpu_torch.kernels import _build

PAGE = 128
# launches of the kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"paged_attn": 0}
# the head dims the kernel is built for; others take the plain version on
# either device (``paged_attention``)
HEAD_DIMS = (64, 128, 256)
# the most CTAs sharing one (slot, kv head): a thread-block cluster (16, the
# H100's non-portable cluster size), whose CTAs combine their partials
# through distributed shared memory
MAX_SPLITS = 16
# csrc/paged.cu's ring: keys per stage (a quarter page), its byte budget
# and stage counts
STAGE_KEYS, RING_BYTES, MIN_STAGES, MAX_STAGES = 32, 32 * 1024, 2, 8
# a launch splits each (slot, kv head) while the doubled splits' query rows
# (B x kv x 2S x g) stay within SPLIT_ROWS (``paged_plan``).  From
# chip_smoke.py's decode_split_ab (PERF.md §6): at 8 slots of 8 pages the
# fastest count was 8 at one query row per KV head (512 CTAs) and 4 at four
# (256), and 8 at 2 KV heads (one page per split)
SPLIT_ROWS = 8 * _build.SMS
_NEG_INF = -1e30


class PagedPlan(NamedTuple):
    """How ``paged_attn`` launches: query rows per block of the kernel (1,
    2, 4 or 8; a group of more walks the pages again per block), the CTAs
    per (slot, kv head) (one cluster; split s takes pages [s n / S,
    (s + 1) n / S) of the slot's n live ones), the ring's stages, the
    shared memory of each CTA in bytes, and the CTAs."""

    rows: int
    splits: int
    stages: int
    smem: int
    ctas: int


def block_rows(g: int) -> int:
    """The kernel's query rows per block for a group of ``g`` heads."""
    return 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8


def paged_plan(b: int, kv: int, g: int, hd: int, maxp: int, dtype,
               splits=None) -> PagedPlan:
    """The launch plan of ``paged_attn`` for B = ``b`` slots of ``kv`` KV
    heads of ``g`` query heads each, head dim ``hd`` and ``maxp`` pages per
    slot, from shapes only (a read of ``pos`` would synchronise every
    step, so a slot that holds fewer than ``maxp`` pages gets the splits of
    a full one): the splits double while each split may still get a page
    (S <= maxp) and the doubled splits' query rows, B x kv x 2S x g, stay
    within ``SPLIT_ROWS``, up to ``MAX_SPLITS`` (``splits`` names another
    count, for chip_smoke.py's split A/B).  The shared memory is
    csrc/paged.cu's ``smem_bytes``: the ring, the receive buffer, the
    scores and the row statistics."""
    size = torch.finfo(dtype).bits // 8
    stage = STAGE_KEYS * hd * size
    stages = min(MAX_STAGES, max(MIN_STAGES, RING_BYTES // stage))
    rows = block_rows(g)
    if splits is None:
        splits = 1
        while (2 * splits <= min(MAX_SPLITS, maxp)
               and 2 * b * kv * splits * g <= SPLIT_ROWS):
            splits *= 2
    smem = (stages * stage + -(-4 * (rows * (hd + PAGE + 3) + 2 * splits * rows) // 8) * 8
            + 8 * stages)
    return PagedPlan(rows, splits, stages, smem, b * kv * splits)


def _mask(l_global, pos_b, window, sinks: int):
    visible = l_global <= pos_b
    if window is not None:
        band = l_global > pos_b - int(window)
        if sinks:
            band = band | (l_global < int(sinks))
        visible = visible & band
    return visible


def paged_attention_reference(q, pool_k, pool_v, table, pos, scale: float,
                              window=None, sinks: int = 0):
    """The same attention over the gathered logical view (the plain
    version): q (B, kv, g, hd); pools (P, kv, PAGE, hd); table (B, maxp);
    pos (B,)."""
    b, kv, g, hd = q.shape
    maxp = table.shape[1]
    tab = table.to(torch.int64)
    view_k = pool_k[tab].transpose(1, 2).reshape(b, kv, maxp * PAGE, hd)
    view_v = pool_v[tab].transpose(1, 2).reshape(b, kv, maxp * PAGE, hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bkgd,bkld->bkgl", q.to(acc), view_k.to(acc)) * scale
    l_global = torch.arange(maxp * PAGE, device=q.device).reshape(1, 1, 1, -1)
    pos_b = pos.to(torch.int64).reshape(b, 1, 1, 1)
    s = torch.where(_mask(l_global, pos_b, window, sinks), s,
                    torch.full_like(s, _NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(view_v.dtype)
    return torch.einsum("bkgl,bkld->bkgd", p.to(acc),
                        view_v.to(acc)).to(q.dtype)


def _check_cuda(q, pool_k, pool_v, table, pos):
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_attn: kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (pool_k, pool_v, table, pos):
        if t.device != q.device:
            raise TypeError(f"paged_attn: every operand must be on {q.device}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("paged_attn: q must be cast to the pools' dtype")
    b, kv, g, hd = q.shape
    if (pool_k.dim() != 4 or pool_k.shape[1:] != (kv, PAGE, hd)
            or pool_v.shape != pool_k.shape or table.dim() != 2
            or table.shape[0] != b or pos.shape != (b,)):
        raise ValueError(f"paged_attn: q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}, table {tuple(table.shape)}, "
                         f"pos {tuple(pos.shape)}")


def paged_attention(q, pool_k, pool_v, table, pos, scale=None, window=None,
                    sinks: int = 0):
    """One decode token per slot over its pages -> (B, kv, g, hd) in
    q.dtype.  A head dim the kernel is not built for (``HEAD_DIMS``) takes
    the plain version on either device."""
    hd = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    if q.device.type == "cpu" or hd not in HEAD_DIMS:
        return paged_attention_reference(q, pool_k, pool_v, table, pos, scale,
                                         window, int(sinks))
    _check_cuda(q, pool_k, pool_v, table, pos)
    b, kv, g, _ = q.shape
    return _launch(q, pool_k, pool_v, table, pos, scale, window, sinks,
                   paged_plan(b, kv, g, hd, table.shape[1], q.dtype))


def _launch(q, pool_k, pool_v, table, pos, scale: float, window, sinks: int,
            plan: PagedPlan):
    """``paged_attn`` launched by ``plan``, into a new output."""
    b, kv, g, hd = q.shape
    out = torch.empty((b, kv, g, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    args = [_build.operand(t) for t in (q, pool_k, pool_v, table.to(torch.int32),
                                        pos.to(torch.int32))] + [out]
    with torch.cuda.device(q.device):
        err = _build.function("paged_attn")(
            *_build.ptrs(*args), b, kv, g, hd, table.shape[1], scale,
            0 if window is None else int(window), int(sinks), plan.rows,
            plan.splits, plan.smem, _build.DTYPE_CODES[q.dtype], _build.stream())
    _build.check(err, "paged_attn")
    LAUNCHES["paged_attn"] += 1
    return out


def append_kv(pool, rows, page_ids, offsets):
    """Write one decode step's KV lines into their pages, in place: row b
    (B, kv, hd) lands at pool[page_ids[b], :, offsets[b]].  Live slots hold
    distinct pages; dead slots all write the garbage page 0, where any order
    is fine."""
    pool[page_ids.to(torch.int64), :, offsets.to(torch.int64)] = rows.to(pool.dtype)
    return pool
