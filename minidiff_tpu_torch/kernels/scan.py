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
``associative_scan``.  The kernels take any T and C: there is no padding and
no autotune race.  ``scan`` launches by ``scan_plan``, decided from shapes
before launch: rows of whole 16-byte runs and at least ``RING_MIN_T`` steps
take the ring kernel (a channel tile a CTA, T walked through a ring of
shared-memory stages that TMA tensor copies fill ahead of the chain), the
others the thread kernel (a channel pair a thread).

``scan(a, b, reverse=True)`` runs the recurrence backwards: r_t = a_{t+1}
r_{t+1} + b_t from t = T - 1 down to 0, with r_T = 0 and a_T = 0.  That is
the reversed scan of ``ops/definitions.py:515-547``, flip(scan(shift(flip(
a)), flip(g))), with the same two rounded operations in the same order, so
the same bits, read in place.  ``linear_scan`` is differentiable through
``ScanFn``, which saves ``a`` and the output ``y``; its backward runs the
reverse scan once for the cotangent r and returns the gradients (r *
shift(y), r).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build

# launches of the kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"scan": 0}


# the ring kernel's launch shapes, restated from csrc/scan.cu (kRingMaxTile,
# kRingMaxStages, the steps a stage it is built for, two channels a
# consumer thread, one producer warp), and the plan's choices, which
# chip_smoke.py's scan_route_ab read (every lead 1-8 at T 1,024, the
# server's one-row prefills, against the thread kernel of a -DSCAN_V1 build
# and the ring at the other tiles and depths, in the same call): a tile of
# RING_TILE channels (128 CTAs at lead 1 and C 32,768, one an SM), RING_STEPS
# steps a stage, as many stages (2 to RING_MAX_STAGES) as fit RING_BYTES of
# shared memory, and the ring only from RING_MIN_T steps (below, its set-up
# costs more than the thread kernel's whole run)
RING_MAX_TILE = 256
RING_MAX_STAGES = 8
RING_STEP_CHOICES = (8, 16, 32)
RING_VEC = 2
RING_TILE = 256
RING_STEPS = 16
RING_BYTES = 64 * 1024
RING_MIN_T = 128
THREADS = 256


class ScanPlan(NamedTuple):
    """How ``scan`` launches: the route ("ring": ``scan_ring_kernel``, a
    lead row's tile of ``tile`` channels a CTA, ``vec`` a consumer thread,
    ``stages`` slots of ``steps`` steps; "thread": ``scan_kernel``, ``vec``
    channels a thread, ``THREADS`` threads a CTA, tile, steps and stages 0),
    the CTAs and the threads of a CTA."""

    route: str
    tile: int
    vec: int
    steps: int
    stages: int
    ctas: int
    threads: int


def scan_plan(lead: int, t: int, c: int, dtype, route=None, tile=None, steps=None,
              stages=None) -> ScanPlan:
    """The launch plan of ``scan`` over (lead, t, c) operands of ``dtype``,
    from shapes only.  Rows of whole 16-byte runs (c x itemsize a multiple
    of 16) of at least ``RING_MIN_T`` steps take the ring kernel: tiles of
    ``RING_TILE`` channels, ``RING_STEPS`` steps a stage, and the most
    stages, 2 to ``RING_MAX_STAGES``, whose slots of a and b fit
    ``RING_BYTES``.  Other rows take the thread kernel.  ``route``,
    ``tile``, ``steps`` and ``stages`` force the choice, for chip_smoke.py's
    A/B; a forced ring raises where the ring kernel cannot take the rows."""
    size = dtype.itemsize
    whole = c * size % 16 == 0
    if route is None:
        route = "ring" if whole and t >= RING_MIN_T else "thread"
    if route == "ring":
        if not whole:
            raise ValueError(f"scan_plan: rows of {c} x {size} bytes are no whole "
                             "16-byte runs")
        tile = tile or RING_TILE
        steps = steps or RING_STEPS
        if stages is None:
            stages = max(2, min(RING_MAX_STAGES, RING_BYTES // (2 * steps * tile * size)))
        if (tile % 64 or not 64 <= tile <= RING_MAX_TILE or steps not in RING_STEP_CHOICES
                or not 2 <= stages <= RING_MAX_STAGES
                or 2 * stages * steps * tile * size + 128 > _build.SMEM_LIMIT):
            raise ValueError(f"scan_plan: the ring does not take tile {tile}, "
                             f"{steps} steps x {stages} stages")
        return ScanPlan("ring", tile, RING_VEC, steps, stages, lead * -(-c // tile),
                        tile // RING_VEC + 32)
    vec = 2 if c % 2 == 0 else 1
    return ScanPlan("thread", 0, vec, 0, 0, -(-(lead * (c // vec)) // THREADS), THREADS)


def _plain_scan(a, b, reverse: bool = False):
    """(lead, T, C) -> y (lead, T, C) in b's dtype: the sequential loop,
    carried in f32 (f64 for f64) and rounded once per output; ``reverse``
    walks t from T - 1 down, y_t = a_{t+1} y_{t+1} + b_t with a_T = 0."""
    acc_dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    out = torch.empty_like(b)
    acc = torch.zeros((b.shape[0], b.shape[2]), dtype=acc_dt, device=b.device)
    t_len = b.shape[1]
    if not reverse:
        for t in range(t_len):
            acc = a[:, t].to(acc_dt) * acc + b[:, t].to(acc_dt)
            out[:, t] = acc
        return out
    for t in reversed(range(t_len)):
        decay = a[:, t + 1].to(acc_dt) if t + 1 < t_len else torch.zeros_like(acc)
        acc = decay * acc + b[:, t].to(acc_dt)
        out[:, t] = acc
    return out


def _check_cuda(a, b):
    if a.device != b.device or a.dtype != b.dtype:
        raise TypeError(f"scan: operands on {a.device} / {b.device} of "
                        f"{a.dtype} / {b.dtype}; both must match")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"scan: takes two (lead, T, C) operands of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def scan(a, b, reverse: bool = False):
    """y over (lead, T, C) operands of one shape and dtype, along axis 1
    (backwards with ``reverse``): the kernel for CUDA f32 / bf16, the plain
    version otherwise."""
    if a.device.type == "cpu" or a.dtype not in _build.DTYPE_CODES:
        return _plain_scan(a, b, reverse)
    return _launch(a, b, reverse)


def _launch(a, b, reverse: bool = False, plan=None):
    """Launch ``linear_scan`` on (lead, T, C) CUDA operands by ``plan``, or
    by ``scan_plan``'s rule when None."""
    _check_cuda(a, b)
    y = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    plan = plan or scan_plan(*a.shape, a.dtype)
    ops = [_build.operand(t) for t in (a, b)]
    with torch.cuda.device(a.device):
        err = _build.function("linear_scan")(
            *_build.ptrs(*ops, y), *a.shape, _build.DTYPE_CODES[a.dtype], int(reverse),
            plan.tile, plan.steps, plan.stages, _build.stream())
    _build.check(err, "scan")
    LAUNCHES["scan"] += 1
    return y


def _shift(t):
    """t_{i-1} along axis 1 with zeros at i = 0 (``_scan_shift``)."""
    return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)


class ScanFn(torch.autograd.Function):
    """The scan over (lead, T, C) operands; saves a and y, and its backward
    runs the reverse scan once for both gradients."""

    @staticmethod
    def forward(ctx, a, b):
        y = scan(a, b)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        # r_t = g_t + a_{t+1} r_{t+1}: the cotangent both gradients share
        r = scan(a, g.contiguous(), reverse=True)
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
