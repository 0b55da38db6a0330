"""Scaled dot-product attention: the flash-attention forward and backward.

Port of ``minidiff_tpu/kernels/attention.py`` (``sdpa``, ``_flash_fwd``,
``_flash_bwd``, ``flash_grads``).  ``sdpa`` takes (B, H, S, D) operands and
is differentiable through ``SdpaFn``, which saves the forward's ``o`` and
per-row logsumexp ``lse`` for the backward, as the JAX custom VJP does.  A
CUDA tensor goes to the hand-written kernels: ``csrc/flash_fwd.cu`` for the
forward, ``csrc/flash_bwd.cu`` (``flash_bwd_dkv``, then ``flash_bwd_dq``)
for the backward.  In bf16 both run on ``wgmma``: the forward with 64 or 128
query rows per CTA, as ``flash_plan`` decides from shapes before launch, the
backward's two kernels with one or two consumer warpgroups per CTA, as
``flash_bwd_plan`` decides; f32 keeps the CUDA-core tiles.  A CPU tensor
goes to the plain versions, ``_plain_flash_fwd`` and ``_plain_flash_bwd``.
A CUDA tensor the kernels do not take raises: nothing falls back.

``sdpa`` sends operands to ``SdpaFn`` only where ``flash_eligible`` holds,
the rule of the JAX ``_flash_eligible`` (``attention.py:785-806``): 4-D, one
dtype of f32 or bf16, head dim 128 or 256 (``d % 128 == 0 and d <= 256``),
matching K/V shapes.  Anything else (head dim 32 or 64, f64) takes, on
either device, the composed forward under torch autograd, as the JAX
package's composed path.  The rule is decided from shapes and dtypes before
launch.

Every mask of the JAX kernels rides into the port's: causal, a sliding
``window`` with ``sinks`` always-visible first keys (StreamingLLM), a
key-padding row per batch (``kvm``: (B, Sk) int32, nonzero = attend) and
packed segment ids (``seg``: (B, S) int32, equal ids attend, -1 marks
padding), the last two shared by the ``h`` heads folded into the leading
B*H axis (row ``bh`` reads batch ``bh // h``).  ``sdpa`` takes the JAX
package's rules for them (``attention.py:828-900``): a ``mask`` that is not
key-padding-shaped, or ids that are not (S,) / (B|1, S) over S_q == S_k,
take the composed path.  A query row with no visible key (possible under a
key row, never under ids, which always see their own diagonal) averages v
over the keys of the tiles it visits and returns lse -1e30, and its backward
takes P = 1 there, as the JAX kernels do.

Masked scores are -1e30, not -inf, in both versions, as on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build

_NEG_INF = -1e30
# the head dims the kernels are built for (the JAX kernels' d % 128 == 0
# and d <= 256)
HEAD_DIMS = (128, 256)
# the query rows per CTA of the bf16 forward's tiles (``flash_plan``): one
# or two warpgroups of 64 rows; 128 at head dim 128 where such CTAs cover
# the card's SMs
FLASH_ROWS = (64, 128)
SMS = _build.SMS

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def _normalize_window(window, sinks, sq: int, sk: int, causal: bool):
    """(window, sinks) as the kernels take them: a window needs causal
    masking; one that covers every causal position is the same computation
    as no window, and sinks mean nothing without one."""
    if window is None:
        return None, 0
    window, sinks = int(window), int(sinks)
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if window >= sq and window >= sk:
        return None, 0
    return window, sinks


def _keep_mask(sq: int, sk: int, window, device, sinks: int = 0):
    """(Sq, Sk) causal visibility: col <= row, and with a window row - col
    < window unless col < ``sinks``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    keep = rows >= cols
    if window is not None:
        live = rows - cols < window
        if sinks:
            live = live | (cols < sinks)
        keep = keep & live
    return keep


def _masked_scores(q, k, scale: float, causal: bool, window, sinks: int = 0,
                   kvm=None, seg=None, h: int = 1):
    # scores in at least f32, cast BEFORE the contraction (a bf16 score
    # matrix has already lost the bits); f64 inputs stay f64
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("...qd,...kd->...qk", q.to(acc), k.to(acc)) * scale
    neg = torch.full_like(s, _NEG_INF)
    if causal:
        keep = _keep_mask(s.shape[-2], s.shape[-1], window, s.device, sinks)
        s = torch.where(keep, s, neg)
    if kvm is not None:
        s = torch.where(kvm.repeat_interleave(h, dim=0)[:, None, :] != 0, s, neg)
    if seg is not None:
        sg = seg.repeat_interleave(h, dim=0)
        s = torch.where(sg[:, :, None] == sg[:, None, :], s, neg)
    return s


def _plain_flash_fwd(q, k, v, scale: float, causal: bool, window=None, sinks: int = 0,
                     kvm=None, seg=None, h: int = 1):
    """(o, lse) of the flash forward, composed: the kernel's plain version.
    lse is f32 (f64 for f64 inputs)."""
    s = _masked_scores(q, k, scale, causal, window, sinks, kvm, seg, h)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v), lse


def _plain_flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool,
                     window=None, sinks: int = 0, kvm=None, seg=None, h: int = 1):
    """(dq, dk, dv) of the flash backward, composed: P from the saved lse,
    dP, dS, then the three products in f32 (f64 for f64 inputs), with P and
    dS rounded to the operand dtype where the kernels round them.  Masked
    scores are -1e30: P is 0 there, and 1 on a row with no visible key
    (lse -1e30), as in the JAX kernels."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = _masked_scores(q, k, scale, causal, window, sinks, kvm, seg, h)
    p = torch.exp(s - lse.to(acc)[..., None])
    doa = do.to(acc)
    dp = torch.einsum("...qd,...kd->...qk", doa, v.to(acc))
    delta = (doa * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    p = p.to(q.dtype).to(acc)
    ds = ds.to(q.dtype).to(acc)
    dv = torch.einsum("...qk,...qd->...kd", p, doa)
    dk = torch.einsum("...qk,...qd->...kd", ds, q.to(acc))
    dq = torch.einsum("...qk,...kd->...qd", ds, k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(name: str, q, k, v, *others):
    """Validate what the kernels take; raise on anything else.  Returns
    (bh, sq, sk, d)."""
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v, *others):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name}: operands must share q's device and dtype")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: kernels are built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} must match q's "
                             f"{tuple(q.shape)}")
    if sk == 0 and bh * sq > 0:
        raise ValueError(f"{name}: no keys")
    return bh, sq, sk, d


def _check_masks(name: str, q, kvm, seg, h: int, bh: int, sq: int, sk: int):
    """The key rows and ids as the kernels read them: int32, contiguous and
    aligned on q's device, (bh / h, Sk) and (bh / h, S) with S_q == S_k."""
    if h < 1 or bh % h:
        raise ValueError(f"{name}: {bh} rows are not a multiple of h {h}")
    out = []
    for what, t, n in (("kvm", kvm, sk), ("seg", seg, sq)):
        if t is None:
            out.append(None)
            continue
        if t.device != q.device or t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32 on q's device")
        if tuple(t.shape) != (bh // h, n):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} must be "
                             f"({bh // h}, {n})")
        out.append(_build.operand(t))
    if seg is not None and sq != sk:
        raise ValueError(f"{name}: segment ids need S_q == S_k")
    return out


def flash_plan(bh: int, sq: int, d: int, dtype) -> int:
    """The query rows per CTA of the flash forward on the card, decided from
    shapes and dtypes before launch.  bf16 runs ``csrc/flash_fwd.cu``'s
    ``wgmma`` tile: 128 rows (two warpgroups sharing each K/V tile) at head
    dim 128 where 128-row CTAs cover the card's SMs, else 64 (one
    warpgroup: a short prefill's few tiles spread over twice the CTAs; at
    head dim 256 the two-warpgroup tile was slower at every shape timed, so
    it is not built).  f32 runs the CUDA-core tile of 64 rows.  A dtype or head dim the kernels are not built for
    raises, as ``flash_fwd`` does on the card (``sdpa`` composes those)."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_fwd: kernel takes float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: kernels are built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if dtype != torch.bfloat16 or d != 128:
        return 64
    return 128 if bh * -(-sq // 128) >= SMS else 64


class BwdPlan(NamedTuple):
    """The tiles of the flash backward's two kernels on the card
    (``flash_bwd_plan``).  ``dkv_wgs`` / ``dq_wgs``: consumer warpgroups per
    CTA of the bf16 ``wgmma`` kernels (0 for f32's CUDA-core tile);
    ``dkv_keys`` keys per dK/dV CTA, which streams query tiles of
    ``dkv_bq`` rows; ``dq_rows`` query rows per dQ CTA, which streams key
    tiles of ``dq_bk`` rows."""
    dkv_wgs: int
    dkv_keys: int
    dkv_bq: int
    dq_wgs: int
    dq_rows: int
    dq_bk: int


def flash_bwd_plan(bh: int, sq: int, sk: int, d: int, dtype) -> BwdPlan:
    """The tiles of the flash backward on the card, decided from shapes and
    dtypes before launch.  bf16 runs ``csrc/flash_bwd.cu``'s ``wgmma``
    kernels, each streaming tiles of 64 rows: at head dim 128 a dK/dV CTA
    of two warpgroups (128 keys) and a dQ CTA of two (128 query rows) where
    such CTAs make two waves on the card's SMs, else one (64: at about one
    wave, as (16, 1088, 128), the causal CTAs' unequal lengths cost the
    two-warpgroup dK/dV tile more than its shared tiles save); at head dim
    256 a dK/dV CTA of two warpgroups on the same 64 keys (128 columns of
    dK and dV each, which is what fits their registers) and a dQ CTA of one
    (64 rows: two would not fit shared memory).  f32 runs the CUDA-core
    tile (64 rows, 32 at head dim 256).  A dtype or head dim the kernels
    are not built for raises, as ``flash_bwd`` does on the card (``sdpa``
    composes those)."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_bwd: kernel takes float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_bwd: kernels are built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if dtype != torch.bfloat16:
        t = 64 if d == 128 else 32
        return BwdPlan(0, t, t, 0, t, t)
    if d == 256:
        return BwdPlan(2, 64, 64, 1, 64, 64)
    dkv = 2 if bh * -(-sk // 128) >= 2 * SMS else 1
    dq = 2 if bh * -(-sq // 128) >= 2 * SMS else 1
    return BwdPlan(dkv, 64 * dkv, 64, dq, 64 * dq, 64)


def flash_fwd(q, k, v, scale: float, causal: bool, window=None, sinks: int = 0,
              kvm=None, seg=None, h: int = 1):
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (o (BH, Sq, D), lse (BH, Sq) f32),
    under causal, the window and its sinks, the key-padding rows ``kvm`` and
    the segment ids ``seg`` of the h heads of each batch row."""
    window, sinks = _normalize_window(window, sinks, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return _plain_flash_fwd(q, k, v, scale, causal, window, sinks, kvm, seg, h)
    bh, sq, _, d = _check_cuda("flash_fwd", q, k, v)
    return _fwd_launch(q, k, v, scale, causal, window, flash_plan(bh, sq, d, q.dtype),
                       sinks, kvm, seg, h)


def _fwd_launch(q, k, v, scale: float, causal: bool, window, rows: int, sinks: int = 0,
                kvm=None, seg=None, h: int = 1):
    """The CUDA forward at ``rows`` query rows per CTA: ``flash_plan``'s, or
    the other tile of ``FLASH_ROWS`` (chip_smoke.py's A/B); ``window`` and
    ``sinks`` as ``_normalize_window`` leaves them."""
    bh, sq, sk, d = _check_cuda("flash_fwd", q, k, v)
    kvm, seg = _check_masks("flash_fwd", q, kvm, seg, h, bh, sq, sk)
    ops = (q.contiguous(), k.contiguous(), v.contiguous())
    o = torch.empty_like(ops[0])
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    _launch("flash_fwd", ops, (o, lse), (kvm, seg), (bh, sq, sk, d), scale,
            (int(bool(causal)), 0 if window is None else window, int(sinks), int(h),
             rows, _build.DTYPE_CODES[q.dtype]))
    return o, lse


def _bwd_operands(q, k, v, o, lse, do, window, causal, sinks: int = 0, kvm=None,
                  seg=None, h: int = 1):
    """Check and prepare the CUDA backward's operands: contiguous (q, k, v,
    do, lse), delta = rowsum(do * o) in f32 (computed in plain torch, as
    ``_flash_bwd`` computes it outside its kernels), then the key rows and
    ids (None where absent); (bh, sq, sk, d); and the flags (causal,
    window, sinks, h, dtype code)."""
    bh, sq, sk, d = _check_cuda("flash_bwd", q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.shape != (bh, sq):
        raise ValueError(f"flash_bwd: lse must be ({bh}, {sq}) float32")
    kvm, seg = _check_masks("flash_bwd", q, kvm, seg, h, bh, sq, sk)
    doc = do.contiguous()
    delta = (doc.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    ops = (q.contiguous(), k.contiguous(), v.contiguous(), doc,
           lse.contiguous(), delta, kvm, seg)
    dims = (bh, sq, sk, d)
    flags = (int(bool(causal)), 0 if window is None else window, int(sinks), int(h),
             _build.DTYPE_CODES[q.dtype])
    return ops, dims, flags


def _launch(name: str, ops, outs, masks, dims, scale: float, flags) -> None:
    """Launch ``name`` on (ops, then the key rows and ids, None as a null
    pointer, then outs)."""
    mptrs = [None if t is None else t.data_ptr() for t in masks]
    with torch.cuda.device(ops[0].device):
        err = _build.function(name)(
            *_build.ptrs(*ops), *mptrs, *_build.ptrs(*outs), *dims, float(scale),
            *flags, _build.stream())
    _build.check(err, name)
    LAUNCHES[name] += 1


def flash_bwd_dkv(ops, dims, scale: float, flags, wgs=None):
    """(dk, dv) by the ``flash_bwd_dkv`` kernel from ``_bwd_operands``, with
    ``flash_bwd_plan``'s warpgroups per CTA, or ``wgs`` (chip_smoke.py's
    A/B of the tiles)."""
    k, v = ops[1], ops[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if wgs is None:
        wgs = flash_bwd_plan(*dims, k.dtype).dkv_wgs
    causal, window, sinks, h, dtype = flags
    _launch("flash_bwd_dkv", ops[:6], (dk, dv), ops[6:], dims, scale,
            (causal, window, sinks, h, wgs, dtype))
    return dk, dv


def flash_bwd_dq(ops, dims, scale: float, flags, wgs=None):
    """dq by the ``flash_bwd_dq`` kernel from ``_bwd_operands``; ``wgs`` as
    for ``flash_bwd_dkv``."""
    dq = torch.empty_like(ops[0])
    if wgs is None:
        wgs = flash_bwd_plan(*dims, dq.dtype).dq_wgs
    causal, window, sinks, h, dtype = flags
    _launch("flash_bwd_dq", ops[:6], (dq,), ops[6:], dims, scale,
            (causal, window, sinks, h, wgs, dtype))
    return dq


def flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool, window=None,
              sinks: int = 0, kvm=None, seg=None, h: int = 1):
    """(dq, dk, dv) over (BH, S, D) operands from the forward's o and lse and
    the cotangent do, under the forward's masks.  On CUDA: delta in plain
    torch, then the ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels."""
    window, sinks = _normalize_window(window, sinks, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return _plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window, sinks,
                                kvm, seg, h)
    ops, dims, flags = _bwd_operands(q, k, v, o, lse, do, window, causal, sinks, kvm,
                                     seg, h)
    if q.numel() == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = flash_bwd_dkv(ops, dims, scale, flags)
    return flash_bwd_dq(ops, dims, scale, flags), dk, dv


class SdpaFn(torch.autograd.Function):
    """Attention over (BH, S, D) operands; saves (q, k, v, o, lse) and the
    key rows and ids for the flash backward, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, sinks=0, kvm=None, seg=None, h=1):
        o, lse = flash_fwd(q, k, v, scale, causal, window, sinks, kvm, seg, h)
        ctx.args = (scale, causal, window, sinks)
        ctx.h = h
        ctx.save_for_backward(q, k, v, o, lse, kvm, seg)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, kvm, seg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, *ctx.args, kvm, seg, ctx.h)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_eligible(q, k, v) -> bool:
    """Whether ``sdpa`` takes the flash kernels (``SdpaFn``) for these
    operands: the JAX ``_flash_eligible`` without its Pallas switch."""
    if q.dim() != 4 or not q.dtype == k.dtype == v.dtype:
        return False
    if q.dtype not in _build.DTYPE_CODES:
        return False
    b, h, _, d = q.shape
    sk = k.shape[2] if k.dim() == 4 else -1
    return (d % 128 == 0 and d <= 256 and tuple(k.shape) == (b, h, sk, d)
            and tuple(v.shape) == (b, h, sk, d))


def _kv_mask_shape_ok(shape, b: int, sk: int) -> bool:
    """Whether a mask of ``shape`` is key padding (the JAX
    ``_kv_mask_shape_ok``): after broadcasting against (B, H, Sq, Sk) its
    value depends only on (batch, key): (Sk,), (1, Sk), (B|1, 1, Sk) or
    (B|1, 1, 1, Sk)."""
    nd = len(shape)
    if nd == 0 or nd > 4 or shape[-1] != sk:
        return False
    if nd <= 2:
        return nd == 1 or shape[0] == 1
    return all(d == 1 for d in shape[1:-1]) and shape[0] in (1, b)


def _as_kv_mask(mask, b: int, sk: int, device):
    """A key-padding-shaped ``mask`` as a (B, Sk) int32 table (the JAX
    ``_as_kv_mask``)."""
    m = torch.as_tensor(mask, device=device)
    lead = m.shape[0] if m.dim() >= 3 else 1
    return (m.reshape(lead, sk) != 0).to(torch.int32).expand(b, sk).contiguous()


def _seg_shape_ok(shape, b: int, s: int, sk: int) -> bool:
    """Segment ids the kernels take: (S,) or (B|1, S), with S_q == S_k."""
    if s != sk:
        return False
    nd = len(shape)
    if nd == 1:
        return shape[0] == s
    return nd == 2 and shape[1] == s and shape[0] in (1, b)


def _as_seg(seg, b: int, s: int, device):
    """Segment ids as a (B, S) int32 table."""
    sg = torch.as_tensor(seg, device=device).to(torch.int32)
    if sg.dim() == 1:
        sg = sg[None, :]
    return sg.expand(b, s).contiguous()


def _flash_tables(mask, segment_ids, b: int, s: int, sk: int, device):
    """The key rows and ids of the kernels (None where absent), for a mask
    and ids that ``flash_grads_decision`` passed."""
    kvm = None if mask is None else _as_kv_mask(mask, b, sk, device)
    seg = None if segment_ids is None else _as_seg(segment_ids, b, s, device)
    return kvm, seg


def _composed_sdpa(q, k, v, scale: float, causal: bool, mask=None, window=None,
                   sinks: int = 0):
    """Softmax attention over the dense scores (the JAX ``_composed_sdpa``):
    scores and softmax in at least f32, ``mask`` boolean and broadcastable
    over them (True = attend)."""
    s = _masked_scores(q, k, scale, causal, window, sinks)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v)


def _dense_mask(mask, segment_ids, device):
    """The composed path's boolean mask: ``mask`` (a 3-D (B, Sq, Sk) one
    with the head axis inserted) and the same-document mask of
    ``segment_ids``, as the JAX ``sdpa`` builds them."""
    if mask is not None:
        mask = torch.as_tensor(mask, device=device) != 0
        if mask.dim() == 3:
            mask = mask[:, None]
    if segment_ids is not None:
        sg = torch.as_tensor(segment_ids, device=device)
        if sg.dim() == 1:
            sg = sg[None, :]
        sm = sg[:, None, :, None] == sg[:, None, None, :]
        mask = sm if mask is None else mask & sm
    return mask


def sdpa(q, k, v, causal: bool = False, scale=None, mask=None, window=None,
         sinks: int = 0, segment_ids=None):
    """Scaled dot-product attention over (B, H, S, D) operands (3-D ones as
    H = 1): the flash kernels where ``flash_eligible`` holds and the masks
    ride into them, the composed path elsewhere.  ``mask`` (True / nonzero =
    attend) broadcasts over the scores; ``window`` (causal only) keeps each
    query's last ``window`` keys, plus the first ``sinks``;
    ``segment_ids`` ((S,) or (B, S) int, ids >= 0, -1 = padding) keeps
    attention within each packed document (S_q == S_k)."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[:, None], k[:, None], v[:, None]
    if q.dim() != 4:
        raise ValueError(f"sdpa takes (B, H, S, D) operands, got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scale, causal = float(scale), bool(causal)
    b, h, s, d = q.shape
    sk = k.shape[-2]
    if segment_ids is not None and s != sk:
        raise ValueError("segment_ids requires S_q == S_k (self-attention "
                         f"packing); got {s} vs {sk}")
    window, sinks = _normalize_window(window, sinks, s, sk, causal)
    if flash_grads_decision(q, k, v, causal, mask, window, sinks, segment_ids):
        kvm, seg = _flash_tables(mask, segment_ids, b, s, sk, q.device)
        o = SdpaFn.apply(q.reshape(b * h, s, d), k.reshape(b * h, sk, d),
                         v.reshape(b * h, sk, d), causal, scale, window, sinks, kvm,
                         seg, h).reshape(b, h, s, d)
    else:
        o = _composed_sdpa(q, k, v, scale, causal, _dense_mask(mask, segment_ids, q.device),
                           window, sinks)
    return o[:, 0] if squeeze else o


def flash_grads_decision(q, k, v, causal: bool, mask=None, window=None, sinks: int = 0,
                         segment_ids=None) -> bool:
    """Whether the flash kernels serve ``sdpa`` and the tape's first-order
    ``sdpa`` VJPs for these (B, H, S, D) operands (the JAX
    ``flash_grads_decision`` without its autotuner): flash-eligible, and the
    mask and ids of shapes the kernels take."""
    if not flash_eligible(q, k, v) or (window is not None and not causal):
        return False
    b, _, s, _ = q.shape
    sk = k.shape[2]
    if mask is not None and not _kv_mask_shape_ok(tuple(torch.as_tensor(mask).shape), b, sk):
        return False
    return segment_ids is None or _seg_shape_ok(
        tuple(torch.as_tensor(segment_ids).shape), b, s, sk)


def flash_grads(q, k, v, do, scale: float, causal: bool, mask=None, window=None,
                sinks: int = 0, segment_ids=None):
    """(dq, dk, dv) of ``sdpa`` for (B, H, S, D) operands through the flash
    kernels (the JAX ``flash_grads``): the forward once more for its o and
    lse, then the dK/dV and dQ kernels, instead of the composed VJPs' three
    (S, S) matrices.  Where ``flash_grads_decision`` holds."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    window, sinks = _normalize_window(window, sinks, s, sk, causal)
    kvm, seg = _flash_tables(mask, segment_ids, b, s, sk, q.device)
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    o, lse = flash_fwd(qf, kf, vf, scale, causal, window, sinks, kvm, seg, h)
    dq, dk, dv = flash_bwd(qf, kf, vf, o, lse, do.reshape(b * h, s, d).to(q.dtype),
                           scale, causal, window, sinks, kvm, seg, h)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)
