"""Scaled dot-product attention: the flash-attention forward kernel.

Port of ``minidiff_tpu/kernels/attention.py`` (``sdpa`` and ``_flash_fwd``).
``sdpa`` takes (B, H, S, D) operands.  A CUDA tensor goes to the
hand-written kernel of ``csrc/flash_fwd.cu``, which returns ``o`` and the
per-row logsumexp ``lse`` as ``_flash_fwd`` does (the backward of the next
slice reads ``lse``).  A CPU tensor goes to ``_plain_sdpa``, the port of
``_composed_sdpa``.  A CUDA tensor the kernel does not take raises: nothing
falls back.

Masked scores are -1e30, not -inf, in both versions, as on the TPU.
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 128

# launches of the kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"flash_fwd": 0}


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


def _plain_sdpa(q, k, v, scale: float, causal: bool, window=None):
    """Composed softmax attention: the port of ``_composed_sdpa``."""
    s = _masked_scores(q, k, scale, causal, window)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v)


def _plain_flash_fwd(q, k, v, scale: float, causal: bool, window=None):
    """(o, lse) of the flash forward, composed: the kernel's plain version."""
    s = _masked_scores(q, k, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1).to(torch.float32)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v), lse


def flash_fwd(q, k, v, scale: float, causal: bool, window=None):
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (o (BH, Sq, D), lse (BH, Sq) f32)."""
    window = _normalize_window(window, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return _plain_flash_fwd(q, k, v, scale, causal, window)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd: kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError("flash_fwd: q, k and v must share device and dtype")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d != _HEAD_DIM:
        raise ValueError(f"flash_fwd: kernel is specialised on head dim "
                         f"{_HEAD_DIM}, got {d}")
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"flash_fwd: shapes {q.shape} {k.shape} {v.shape}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(qc)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh == 0 or sq == 0:
        return o, lse
    if sk == 0:
        raise ValueError("flash_fwd: no keys")
    ptrs = []
    for t in (qc, kc, vc, o, lse):
        if t.data_ptr() % 16:
            raise ValueError("flash_fwd: operands must be 16-byte aligned")
        ptrs.append(t.data_ptr())
    with torch.cuda.device(q.device):
        err = _build.function("flash_fwd")(
            *ptrs, bh, sq, sk, d, float(scale), int(bool(causal)),
            0 if window is None else window, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def sdpa(q, k, v, causal: bool = False, scale=None, window=None):
    """Scaled dot-product attention over (B, H, S, D) operands."""
    if q.dim() != 4:
        raise ValueError(f"sdpa takes (B, H, S, D) operands, got {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scale = float(scale)
    if q.device.type == "cpu":
        window = _normalize_window(window, q.shape[-2], k.shape[-2], causal)
        return _plain_sdpa(q, k, v, scale, bool(causal), window)
    b, h, s, d = q.shape
    sk = k.shape[2]
    o, _ = flash_fwd(q.reshape(b * h, s, d), k.reshape(b * h, sk, d),
                     v.reshape(b * h, sk, d), scale, bool(causal), window)
    return o.reshape(b, h, s, d)
