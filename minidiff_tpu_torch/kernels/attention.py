"""Scaled dot-product attention: the flash-attention forward and backward.

Port of ``minidiff_tpu/kernels/attention.py`` (``sdpa``, ``_flash_fwd``,
``_flash_bwd``).  ``sdpa`` takes (B, H, S, D) operands and is differentiable
through ``SdpaFn``, which saves the forward's ``o`` and per-row logsumexp
``lse`` for the backward, as the JAX custom VJP does.  A CUDA tensor goes to
the hand-written kernels: ``csrc/flash_fwd.cu`` for the forward,
``csrc/flash_bwd.cu`` (``flash_bwd_dkv``, then ``flash_bwd_dq``) for the
backward.  In bf16 both run on ``wgmma``: the forward with 64 or 128 query
rows per CTA, as ``flash_plan`` decides from shapes before launch, the
backward's two kernels with one or two consumer warpgroups per CTA, as
``flash_bwd_plan`` decides; f32 keeps the CUDA-core tiles.  A CPU tensor
goes to the plain versions,
``_plain_flash_fwd`` and ``_plain_flash_bwd``.  A CUDA tensor the kernels
do not take raises: nothing falls back.

``sdpa`` sends operands to ``SdpaFn`` only where ``flash_eligible`` holds,
the rule of the JAX ``_flash_eligible`` (``attention.py:785-806``): 4-D, one
dtype of f32 or bf16, head dim 128 or 256 (``d % 128 == 0 and d <= 256``),
matching K/V shapes.  Anything else (head dim 32 or 64, f64) takes, on
either device, the composed forward under torch autograd, as the JAX
package's composed path.  The rule is decided from shapes and dtypes before
launch.

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


def _normalize_window(window, sq: int, sk: int, causal: bool):
    """A window needs causal masking; one that covers every causal position
    is the same computation as no window."""
    if window is None:
        return None
    window = int(window)
    if not causal:
        raise ValueError("sliding-window attention requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window >= sq and window >= sk:
        return None
    return window


def _keep_mask(sq: int, sk: int, window, device):
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    keep = rows >= cols
    if window is not None:
        keep = keep & (rows - cols < window)
    return keep


def _masked_scores(q, k, scale: float, causal: bool, window):
    # scores in at least f32, cast BEFORE the contraction (a bf16 score
    # matrix has already lost the bits); f64 inputs stay f64
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("...qd,...kd->...qk", q.to(acc), k.to(acc)) * scale
    if causal:
        keep = _keep_mask(s.shape[-2], s.shape[-1], window, s.device)
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def _plain_flash_fwd(q, k, v, scale: float, causal: bool, window=None):
    """(o, lse) of the flash forward, composed: the kernel's plain version.
    lse is f32 (f64 for f64 inputs)."""
    s = _masked_scores(q, k, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v), lse


def _plain_flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool,
                     window=None):
    """(dq, dk, dv) of the flash backward, composed: P from the saved lse,
    dP, dS, then the three products in f32 (f64 for f64 inputs), with P and
    dS rounded to the operand dtype where the kernels round them."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = _masked_scores(q, k, scale, causal, window)
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


def flash_fwd(q, k, v, scale: float, causal: bool, window=None):
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (o (BH, Sq, D), lse (BH, Sq) f32)."""
    window = _normalize_window(window, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return _plain_flash_fwd(q, k, v, scale, causal, window)
    bh, sq, _, d = _check_cuda("flash_fwd", q, k, v)
    return _fwd_launch(q, k, v, scale, causal, window, flash_plan(bh, sq, d, q.dtype))


def _fwd_launch(q, k, v, scale: float, causal: bool, window, rows: int):
    """The CUDA forward at ``rows`` query rows per CTA: ``flash_plan``'s, or
    the other tile of ``FLASH_ROWS`` (chip_smoke.py's A/B); ``window`` as
    ``_normalize_window`` leaves it."""
    bh, sq, sk, d = _check_cuda("flash_fwd", q, k, v)
    ops = (q.contiguous(), k.contiguous(), v.contiguous())
    o = torch.empty_like(ops[0])
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    _launch("flash_fwd", ops, (o, lse), (bh, sq, sk, d), scale,
            (int(bool(causal)), 0 if window is None else window, rows,
             _build.DTYPE_CODES[q.dtype]))
    return o, lse


def _bwd_operands(q, k, v, o, lse, do, window, causal):
    """Check and prepare the CUDA backward's operands: contiguous (q, k, v,
    do, lse), delta = rowsum(do * o) in f32 (computed in plain torch, as
    ``_flash_bwd`` computes it outside its kernels), (bh, sq, sk, d), and
    the flags (causal, window, dtype code)."""
    bh, sq, sk, d = _check_cuda("flash_bwd", q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.shape != (bh, sq):
        raise ValueError(f"flash_bwd: lse must be ({bh}, {sq}) float32")
    doc = do.contiguous()
    delta = (doc.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    ops = (q.contiguous(), k.contiguous(), v.contiguous(), doc,
           lse.contiguous(), delta)
    dims = (bh, sq, sk, d)
    flags = (int(bool(causal)), 0 if window is None else window,
             _build.DTYPE_CODES[q.dtype])
    return ops, dims, flags


def _launch(name: str, ops, outs, dims, scale: float, flags) -> None:
    with torch.cuda.device(ops[0].device):
        err = _build.function(name)(
            *_build.ptrs(*ops, *outs), *dims, float(scale), *flags,
            _build.stream())
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
    causal, window, dtype = flags
    _launch("flash_bwd_dkv", ops, (dk, dv), dims, scale, (causal, window, wgs, dtype))
    return dk, dv


def flash_bwd_dq(ops, dims, scale: float, flags, wgs=None):
    """dq by the ``flash_bwd_dq`` kernel from ``_bwd_operands``; ``wgs`` as
    for ``flash_bwd_dkv``."""
    dq = torch.empty_like(ops[0])
    if wgs is None:
        wgs = flash_bwd_plan(*dims, dq.dtype).dq_wgs
    causal, window, dtype = flags
    _launch("flash_bwd_dq", ops, (dq,), dims, scale, (causal, window, wgs, dtype))
    return dq


def flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool, window=None):
    """(dq, dk, dv) over (BH, S, D) operands from the forward's o and lse and
    the cotangent do.  On CUDA: delta in plain torch, then the
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels."""
    window = _normalize_window(window, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return _plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
    ops, dims, flags = _bwd_operands(q, k, v, o, lse, do, window, causal)
    if q.numel() == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = flash_bwd_dkv(ops, dims, scale, flags)
    return flash_bwd_dq(ops, dims, scale, flags), dk, dv


class SdpaFn(torch.autograd.Function):
    """Attention over (BH, S, D) operands; saves (q, k, v, o, lse) for the
    flash backward, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_fwd(q, k, v, scale, causal, window)
        ctx.args = (scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


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


def sdpa(q, k, v, causal: bool = False, scale=None, window=None):
    """Scaled dot-product attention over (B, H, S, D) operands: the flash
    kernels where ``flash_eligible`` holds, the composed path elsewhere."""
    if q.dim() != 4:
        raise ValueError(f"sdpa takes (B, H, S, D) operands, got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not flash_eligible(q, k, v):
        # the composed path (the plain forward) under torch autograd
        window = _normalize_window(window, q.shape[-2], k.shape[-2], causal)
        return _plain_flash_fwd(q, k, v, float(scale), bool(causal), window)[0]
    b, h, s, d = q.shape
    sk = k.shape[2]
    o = SdpaFn.apply(q.reshape(b * h, s, d), k.reshape(b * h, sk, d),
                     v.reshape(b * h, sk, d), bool(causal), float(scale), window)
    return o.reshape(b, h, s, d)
