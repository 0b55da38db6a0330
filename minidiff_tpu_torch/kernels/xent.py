"""Softmax cross-entropy over integer labels, forward and backward.

Port of ``minidiff_tpu/kernels/xent.py`` (``softmax_xent``, ``xent_grad``).
Semantics, shared by the CUDA kernels and the plain versions here (acc = f32
for sub-f32 logits, else the logits' dtype):

    loss = logsumexp(z) - z[label]                    (per row, in acc)
    dz   = (softmax(z) - onehot(label)) * g           (cast to z.dtype)

The kernels write the loss in f32, which is acc for the two dtypes they take.
``softmax_xent`` is differentiable through ``SoftmaxXentFn``.  A CUDA tensor
goes to the hand-written kernels of ``csrc/xent.cu`` (``xent_fwd``,
``xent_bwd``); a CPU tensor goes to the plain versions.  A CUDA tensor the
kernels do not take raises: nothing falls back.  The kernels take any row
width V.  ``xent_fwd`` launches by ``xent_fwd_plan`` and ``xent_bwd`` by
``xent_bwd_plan``, decided from shapes before launch: rows of whole 16-byte
vectors from ``FWD_ROW_MIN_V[dtype]`` (``ROW_MIN_V``) to ``ROW_MAX_V`` values take
the row kernel (one CTA per row, the row held on chip: one read of the
logits, and the backward's one write of dz), the others the warp kernel (a
warp per row) or, for rows that are no whole number of vectors, one element
a lane.  The tape's ``softmax_xent`` enters through ``loss`` and
``loss_grad``, which send f32 and bf16 logits to the kernels (their plain
versions on the CPU) and other dtypes to the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels.layernorm import _acc_dtype

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"xent_fwd": 0, "xent_bwd": 0}


# the row kernel's launch shapes, restated from csrc/xent.cu (kRowMaxThreads,
# kRowMaxValues, kFwdMaxVecs, kWarpsPerBlock) for xent_bwd_plan and
# xent_fwd_plan: the backward holds at most ROW_MAX_VALUES f32 a thread, the
# forward at most FWD_MAX_VECS packed 16-byte vectors
ROW_MAX_THREADS = 1024
ROW_MAX_VALUES = 32
FWD_MAX_VECS = 8
WARP_ROWS = 4
# the row kernel takes rows of ROW_MIN_V (backward) or FWD_ROW_MIN_V[dtype]
# (forward: 8 KB rows) to ROW_MAX_V values.  ROW_MAX_V is what the backward
# holds: ROW_MAX_VALUES f32 a thread on ROW_MAX_THREADS threads.  The minima
# are the crossovers that chip_smoke.py's xent_bwd_route_ab and
# xent_fwd_route_ab read (8,192 rows, bf16 and f32, against the warp kernels
# of the -DXENT_BWD_V1 and -DXENT_FWD_V1 builds in the same call)
ROW_MAX_V = ROW_MAX_THREADS * ROW_MAX_VALUES
ROW_MIN_V = 512
FWD_ROW_MIN_V = {torch.bfloat16: 4096, torch.float32: 2048}
# the forward's vectors a thread: FWD_VECS, or FWD_MAX_VECS where FWD_VECS
# would take more than FWD_THREADS threads (two CTAs of FWD_THREADS fit an
# SM's registers, one of 1,024 alone), as xent_fwd_route_ab read them
FWD_VECS = 4
FWD_THREADS = 512


class XentPlan(NamedTuple):
    """How ``xent_fwd`` or ``xent_bwd`` launches: the route ("row":
    ``xent_row_kernel``, one CTA per row; "warp": ``xent_fwd_kernel`` or
    ``xent_bwd_kernel``, ``WARP_ROWS`` rows a CTA, a warp each, on 16-byte
    vectors; "scalar": the same, one element a lane), the CTAs, the threads
    of a CTA, and the 16-byte vectors of the row each thread holds (row
    route; 0 on the others, whose lanes loop)."""

    route: str
    ctas: int
    threads: int
    vecs: int


def _vec(dtype) -> int:
    """Values in one 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


def _plan(name: str, min_v: int, max_vecs: int, want_vecs: int, rows: int, v: int,
          dtype, route, vecs) -> XentPlan:
    """The plan of ``name`` whose row route starts at ``min_v`` values,
    holds at most ``max_vecs`` vectors a thread and takes ``want_vecs``
    unless a whole warp would then hold more than the row."""
    w = _vec(dtype)
    nvec = v // w
    whole = v % w == 0
    if route is None:
        route = "row" if whole and min_v <= v <= ROW_MAX_V else "warp"
    if route == "row":
        if not whole or v > ROW_MAX_V:
            raise ValueError(f"{name}_plan: the row kernel does not hold V {v} "
                             f"of {dtype}")
        if vecs is None:
            vecs = want_vecs
            while vecs > 1 and 32 * vecs > nvec:
                vecs //= 2
        if vecs > max_vecs or vecs & (vecs - 1):
            raise ValueError(f"{name}_plan: {vecs} vectors a thread")
        threads = (-(-nvec // vecs) + 31) // 32 * 32
        if threads > ROW_MAX_THREADS:
            raise ValueError(f"{name}_plan: V {v} needs {threads} threads at "
                             f"{vecs} vectors a thread")
        return XentPlan("row", rows, threads, vecs)
    return XentPlan("warp" if whole else "scalar", -(-rows // WARP_ROWS),
                    32 * WARP_ROWS, 0)


def xent_bwd_plan(rows: int, v: int, dtype, route=None, vecs=None) -> XentPlan:
    """The launch plan of ``xent_bwd`` for ``rows`` rows of ``v`` logits
    of ``dtype``, from shapes only.  Rows of whole 16-byte vectors of
    ``ROW_MIN_V`` to ``ROW_MAX_V`` values take the row kernel, each thread
    holding ``ROW_MAX_VALUES`` values (``vecs`` vectors, a power of two) or,
    for a row of fewer than one warp's worth, the most with which a whole
    warp holds it, on the fewest whole warps that cover the row; other rows
    of whole vectors the warp kernel, the rest the one-element route.
    ``route`` ("row" or "warp") and ``vecs`` force the choice, for
    chip_smoke.py's A/B; a forced row route raises where the row kernel
    cannot hold the row."""
    most = ROW_MAX_VALUES // _vec(dtype)
    return _plan("xent_bwd", ROW_MIN_V, most, most, rows, v, dtype, route, vecs)


def xent_fwd_plan(rows: int, v: int, dtype, route=None, vecs=None) -> XentPlan:
    """The launch plan of ``xent_fwd``, as ``xent_bwd_plan``'s from
    ``FWD_ROW_MIN_V[dtype]`` values, each thread holding ``FWD_VECS``
    vectors, or ``FWD_MAX_VECS`` where ``FWD_VECS`` would take more than
    ``FWD_THREADS`` threads (fewer where one warp would hold more than the
    row)."""
    nvec = v // _vec(dtype)
    want = FWD_VECS if -(-nvec // FWD_VECS) <= FWD_THREADS else FWD_MAX_VECS
    return _plan("xent_fwd", FWD_ROW_MIN_V.get(dtype, ROW_MAX_V + 1), FWD_MAX_VECS, want,
                 rows, v, dtype, route, vecs)


def _plain_xent(z, lab):
    """Per-row loss in acc: the port of ``_jnp_xent``.  A label outside [0,
    V) matches no column, as in the kernels and the TPU kernel's iota
    compare: its z[label] counts as 0."""
    za = z.to(_acc_dtype(z.dtype))
    m = za.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(za - m).sum(dim=-1, keepdim=True)) + m
    lab = lab.to(torch.int64)
    valid = (lab >= 0) & (lab < z.shape[-1])
    zlab = torch.gather(za, -1, torch.where(valid, lab, 0).unsqueeze(-1))[..., 0]
    return lse[..., 0] - torch.where(valid, zlab, 0)


def _plain_xent_grad(z, lab, g):
    """dz: the port of ``_jnp_xent_grad``."""
    acc = _acc_dtype(z.dtype)
    za = z.to(acc)
    m = za.max(dim=-1, keepdim=True).values
    e = torch.exp(za - m)
    p = e / e.sum(dim=-1, keepdim=True)
    onehot = (torch.arange(z.shape[-1], device=z.device)
              == lab.to(torch.int64).unsqueeze(-1)).to(acc)
    return ((p - onehot) * g.to(acc).unsqueeze(-1)).to(z.dtype)


def _check_cuda(name: str, z, lab, *others):
    if z.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {z.dtype}")
    if z.dim() != 2 or lab.shape != z.shape[:1]:
        raise ValueError(f"{name}: takes (rows, V) logits and (rows,) labels, "
                         f"got {tuple(z.shape)} and {tuple(lab.shape)}")
    if lab.dtype.is_floating_point or lab.dtype.is_complex:
        raise TypeError(f"{name}: labels must be integers, got {lab.dtype}")
    for t in (lab, *others):
        if t.device != z.device:
            raise TypeError(f"{name}: every operand must be on {z.device}")


def xent_fwd(z, lab):
    """z (rows, V), lab (rows,) int -> per-row loss (rows,)."""
    if z.device.type == "cpu":
        return _plain_xent(z, lab)
    return _fwd_kernel(z, lab)


def _fwd_kernel(z, lab, plan=None):
    """Launch ``xent_fwd`` on z (rows, V) and lab (rows,) by ``plan``, or by
    ``xent_fwd_plan``'s rule when None."""
    _check_cuda("xent_fwd", z, lab)
    rows, v = z.shape
    zc = z.contiguous()
    labc = lab.to(torch.int32).contiguous()
    loss = torch.empty((rows,), dtype=torch.float32, device=z.device)
    if rows == 0:
        return loss
    plan = plan or xent_fwd_plan(rows, v, z.dtype)
    route = (plan.threads, plan.vecs) if plan.route == "row" else (0, 0)
    with torch.cuda.device(z.device):
        err = _build.function("xent_fwd")(
            *_build.ptrs(zc, labc, loss), rows, v, _build.DTYPE_CODES[z.dtype],
            *route, _build.stream())
    _build.check(err, "xent_fwd")
    LAUNCHES["xent_fwd"] += 1
    return loss


def xent_grad(z, lab, g):
    """dz of the per-row loss for the per-row cotangent g: (rows, V)."""
    if z.device.type == "cpu":
        return _plain_xent_grad(z, lab, g)
    return _bwd_kernel(z, lab, g)


def _bwd_kernel(z, lab, g, plan=None):
    """Launch ``xent_bwd`` on z (rows, V), lab and g (rows,) by ``plan``,
    or by ``xent_bwd_plan``'s rule when None."""
    _check_cuda("xent_bwd", z, lab, g)
    if g.shape != lab.shape:
        raise ValueError(f"xent_bwd: g {tuple(g.shape)} must match the labels "
                         f"{tuple(lab.shape)}")
    rows, v = z.shape
    zc = z.contiguous()
    labc = lab.to(torch.int32).contiguous()
    gc = g.to(torch.float32).contiguous()
    dz = torch.empty_like(zc)
    if rows == 0:
        return dz
    plan = plan or xent_bwd_plan(rows, v, z.dtype)
    route = (plan.threads, plan.vecs) if plan.route == "row" else (0, 0)
    with torch.cuda.device(z.device):
        err = _build.function("xent_bwd")(
            *_build.ptrs(zc, labc, gc, dz), rows, v, _build.DTYPE_CODES[z.dtype],
            *route, _build.stream())
    _build.check(err, "xent_bwd")
    LAUNCHES["xent_bwd"] += 1
    return dz


class SoftmaxXentFn(torch.autograd.Function):
    """Per-row loss of (rows, V) logits; the backward is ``xent_grad``."""

    @staticmethod
    def forward(ctx, z, lab):
        ctx.save_for_backward(z, lab)
        return xent_fwd(z, lab)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, lab = ctx.saved_tensors
        return xent_grad(z, lab, g), None


def softmax_xent(z, lab):
    """Per-row loss (labels' shape) of ``z`` (..., V) logits and ``lab`` (...)
    int class ids: f32 for bf16/f32 logits, f64 for f64."""
    v = z.shape[-1]
    loss = SoftmaxXentFn.apply(z.reshape(-1, v), lab.reshape(-1))
    return loss.reshape(lab.shape)


_loss_rows = _build.tape_entry("loss", xent_fwd, _plain_xent)
_loss_grad_rows = _build.tape_entry("loss_grad", xent_grad, _plain_xent_grad)


def loss(z, lab):
    """Per-row loss (labels' shape) of ``z`` (..., V) logits and ``lab``
    (...) class ids, with no autograd, chosen by z's dtype as
    ``_build.tape_entry`` chooses."""
    v = z.shape[-1]
    return _loss_rows(z.reshape(-1, v), lab.reshape(-1)).reshape(lab.shape)


def loss_grad(z, lab, g):
    """dz (z's shape) of ``loss`` for the cotangent ``g`` (labels' shape),
    chosen as ``loss`` chooses."""
    v = z.shape[-1]
    return _loss_grad_rows(z.reshape(-1, v), lab.reshape(-1),
                           g.reshape(-1)).reshape(z.shape)
