"""The first-order linear recurrence ``y_t = a_t * y_{t-1} + b_t``.

Port of ``minidiff_tpu/kernels/scan.py`` (``linear_scan``, ``_canonical``).
The scan runs along ``axis`` with ``y_{-1} = 0``, elementwise over every
other axis, which ``linear_scan`` canonicalises to a contiguous (lead, T,
trail) view.  A CUDA tensor of f32 or bf16 goes to the hand-written kernel of
``csrc/scan.cu``, which carries in f32 and rounds each output once to the
stored dtype, as ``_scan_kernel`` does; a CPU tensor goes to the plain
version ``_plain_scan``, the sequential loop of the JAX package's numpy
backend (``numpy_backend.py:110-121``) with the same numerics.  Other dtypes
take the plain version on either device, as ``_scan_decision`` sends them to
``associative_scan``.  The kernel takes any T and C: there is no padding and
no autotune race.

``linear_scan`` is differentiable through ``ScanFn``, which saves ``a`` and
the output ``y`` and computes the cotangent once, as the reversed scan of
``ops/definitions.py:515-547``: r = flip(scan(shift(flip(a)), flip(g))),
then the gradients (r * shift(y), r).  Its backward scan is the same kernel.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build

# launches of the kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"scan": 0}


def _plain_scan(a, b):
    """(lead, T, C) -> y (lead, T, C) in b's dtype: the sequential loop,
    carried in f32 (f64 for f64) and rounded once per output."""
    acc_dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    out = torch.empty_like(b)
    acc = torch.zeros((b.shape[0], b.shape[2]), dtype=acc_dt, device=b.device)
    for t in range(b.shape[1]):
        acc = a[:, t].to(acc_dt) * acc + b[:, t].to(acc_dt)
        out[:, t] = acc
    return out


def _check_cuda(a, b):
    if a.device != b.device or a.dtype != b.dtype:
        raise TypeError(f"scan: operands on {a.device} / {b.device} of "
                        f"{a.dtype} / {b.dtype}; both must match")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"scan: takes two (lead, T, C) operands of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def scan(a, b):
    """y over (lead, T, C) operands of one shape and dtype, along axis 1:
    the kernel for CUDA f32 / bf16, the plain version otherwise."""
    if a.device.type == "cpu" or a.dtype not in _build.DTYPE_CODES:
        return _plain_scan(a, b)
    _check_cuda(a, b)
    y = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    ops = [_build.operand(t) for t in (a, b)]
    with torch.cuda.device(a.device):
        err = _build.function("linear_scan")(
            *_build.ptrs(*ops, y), *a.shape, _build.DTYPE_CODES[a.dtype],
            _build.stream())
    _build.check(err, "scan")
    LAUNCHES["scan"] += 1
    return y


def _shift(t):
    """t_{i-1} along axis 1 with zeros at i = 0 (``_scan_shift``)."""
    return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)


def _cotangent(a, g):
    """r_t = g_t + a_{t+1} r_{t+1}, the cotangent both VJPs share: the scan
    run in reverse, its decay shifted one step (``_linear_scan_cotangent``)."""
    ar = torch.flip(a, [1])
    return torch.flip(scan(_shift(ar), torch.flip(g, [1])), [1])


class ScanFn(torch.autograd.Function):
    """The scan over (lead, T, C) operands; saves a and y, and its backward
    runs the reversed scan once for both gradients."""

    @staticmethod
    def forward(ctx, a, b):
        y = scan(a, b)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        r = _cotangent(a, g.contiguous())
        return r * _shift(y), r


def linear_scan(a, b, axis: int = -1):
    """y_t = a_t * y_{t-1} + b_t along ``axis`` (y_{-1} = 0), a and b of one
    shape, computed in their promoted dtype; differentiable."""
    if a.shape != b.shape:
        raise ValueError(f"linear_scan requires matching shapes, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    dtype = torch.promote_types(a.dtype, b.dtype)
    # (lead, T, trail), as ``_canonical``: a view of contiguous operands
    ax = axis % a.dim()
    shape = (math.prod(a.shape[:ax]), a.shape[ax], math.prod(a.shape[ax + 1:]))
    return ScanFn.apply(a.to(dtype).reshape(shape),
                        b.to(dtype).reshape(shape)).reshape(a.shape)
