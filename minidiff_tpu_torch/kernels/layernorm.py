"""LayerNorm and RMSNorm, each plain and fused with a residual add, forward
and backward.

Port of ``minidiff_tpu/kernels/layernorm.py`` (``layernorm``, ``ln_grads``,
``add_layernorm``, ``addln_grads``, ``rmsnorm``, ``rms_grads``,
``add_rmsnorm``, ``addrms_grads``).  LayerNorm's semantics, shared by the
CUDA kernels and the plain versions here:

    acc = f32 if x is sub-f32 (bf16/f16) else x.dtype
    mu  = mean(x, -1);  var = mean((x-mu)^2, -1)      # biased, in acc
    y   = (x-mu) * rsqrt(var+eps) * g + b             # cast back to x.dtype

    xhat = (x-mu) * rsig;  w = dy * g
    dx = (w - mean(w) - xhat * mean(w * xhat)) * rsig  # cast to x.dtype
    dg = sum_rows(dy * xhat);  db = sum_rows(dy)       # cast to g.dtype

``add_layernorm`` returns the stacked pair ``(x + a, LN(x + a))`` with
``x + a`` rounded to the model dtype before the statistics; its backward
adds the cotangent of ``x + a`` to the rounded ``dx`` in the model dtype and
routes that one ``dx`` to both ``x`` and ``a``.

RMSNorm drops the centring and the bias:

    rsig = rsqrt(mean(x*x, -1) + eps);  y = x * rsig * g
    xhat = x * rsig;  w = dy * g
    dx = (w - xhat * mean(w * xhat)) * rsig;  dg = sum_rows(dy * xhat)

``add_rmsnorm`` / ``addrms_grads`` pair up as the LayerNorm ones do.

``layernorm``, ``add_layernorm``, ``rmsnorm`` and ``add_rmsnorm`` are
differentiable through ``LayerNormFn``, ``AddLayerNormFn``, ``RMSNormFn`` and
``AddRMSNormFn``.  A CUDA tensor goes to the hand-written kernels of
``csrc/layernorm.cu`` (``ln_fwd``, ``addln_fwd``, ``ln_bwd``, ``addln_bwd``)
and ``csrc/rmsnorm.cu`` (``rms_fwd``, ``addrms_fwd``, ``rms_bwd``,
``addrms_bwd``); a CPU tensor goes to the plain versions.  The kernels take
f32 and bf16 rows of up to ``MAX_WIDTH`` values whose width their 16-byte
vectors divide; other rows take the plain (composed) versions on either
device, as the JAX package composes them (``layernorm.py:67-69``), by the
rule ``uses_kernel`` decided before launch.  A CUDA tensor that the rule
sends to the kernels and that they do not take (operands of mixed dtypes)
raises: nothing falls back.

The four forwards (``ln_fwd``, ``addln_fwd``, ``rms_fwd``, ``addrms_fwd``)
launch by ``norm_fwd_plan``, decided from shapes before launch: at
decode-sized row counts (up to ``WAVE_MAX_ROWS``) the one-wave kernel of
``csrc/rowblock.cuh`` (``norm_wave_kernel``: one CTA per row, x, the
residual a, g and b fetched together, t = x + a stored before the row's one
exchange, LayerNorm's statistics merged by Chan's formula in a fixed
order), else their earlier routes (``ln_rows_kernel``, a warp per row, for
LayerNorm rows a warp's registers hold; ``norm_fwd_kernel``, a block per
row, for the rest).

The four backwards launch by ``norm_bwd_plan``: ``rms_bwd``, ``ln_bwd``
and ``addln_bwd`` on the ring kernel of ``csrc/rowblock.cuh``
(``norm_ring_bwd_kernel``: persistent CTAs, the x and dy rows (and
addln's g0 row) of the next rows in flight by TMA bulk copies into a ring
of shared-memory stages, g read once, one exchange a row for all the row
sums, LayerNorm's four merged as parts by Chan's formula); ``addrms_bwd``
on its earlier kernel (``norm_bwd_kernel``, a block per row), two CTAs per
SM.  Each backward's CTAs write f32 partial rows of dg (and db), summed in
a fixed order: on the ring by the entry's second kernel
(``ring_sum_kernel``, which writes dg and db in g's dtype), elsewhere
here.  A build of ``rmsnorm.cu`` or ``layernorm.cu`` without the ring
(``-DNORM_BWD_V1``) says so (``rms_bwd_ring``, ``ln_bwd_ring``), and its
backwards then launch as they did before it (``ln_bwd_kernel``, a warp per
row, for LayerNorm rows of up to ``BWD_WARP_WIDTH`` values;
``norm_bwd_kernel`` for the rest).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"ln_fwd": 0, "addln_fwd": 0, "ln_bwd": 0, "addln_bwd": 0,
            "rms_fwd": 0, "addrms_fwd": 0, "rms_bwd": 0, "addrms_bwd": 0}

# the widest row the kernels take (the JAX kernels' limit)
MAX_WIDTH = 8192
# the forward kernels' launch shapes, restated from csrc/rowblock.cuh
# (kWaveMaxThreads, kMaxThreads) and csrc/layernorm.cu (kWarpsPerBlock,
# kMaxVecsPerLane) for norm_fwd_plan
WAVE_MAX_THREADS = 512
BLOCK_MAX_THREADS = 256
WARP_ROWS = 4
WARP_MAX_VECS = 8
# the forwards take the one-wave kernel at up to this many rows:
# chip_smoke.py's norm_rows_ab found it faster than the old routes at 1-128
# bf16 rows of 1,024 and 4,096 for all four, and slower for ln_fwd and
# addln_fwd at 512 rows of 4,096 (the fused forwards cross where the plain
# ones do)
WAVE_MAX_ROWS = 128
# the backward kernels' launch shapes, restated from csrc/layernorm.cu
# (kBwdWarpRowWidth, kBwdWarps) and csrc/rowblock.cuh (kRingMaxStages) for
# norm_bwd_plan
BWD_WARP_WIDTH = 1024
BWD_WARPS = 8
RING_MAX_STAGES = 8
# the ring of rms_bwd, ln_bwd and addln_bwd: the CTAs an SM runs by the
# bytes of one stage (x and dy, and addln's g0; up to each count, 1 past the
# last), and the stage bytes an SM keeps in flight, which set the stages (at
# least 2).  chip_smoke.py's norm_bwd_route_ab timed 1-8 CTAs an SM at 2-8
# stages, rms_bwd at (8192, 1024), (8192, 4096) and (1024, 4096), ln_bwd
# and addln_bwd at (8192, 1024), (4096, 512) and (8192, 4096), in bf16 and
# f32: stages of 2-3 KB (1 KB rows) were fastest at 8 CTAs an SM and 2
# stages, of 4-6 KB at 4 and 2, of 8-16 KB at 2 and 2, of 24 KB and more
# within 3% of their best at 1 and 2 (keyed by the row's bytes, addln_bwd's
# three 8 KB rows took 2 CTAs an SM, 4.5% slower than 1)
RING_CTAS_BY_STAGE_BYTES = ((3072, 8), (6144, 4), (16384, 2))
RING_BYTES = 32 * 1024
# a ring CTA's shared memory beside its stages: the system's 1 KB, the
# stages' mbarriers and the exchange scratch (LayerNorm's 1.5 KB)
RING_SMEM_EXTRA = 3072


class NormPlan(NamedTuple):
    """How a forward norm launches: the route ("wave":
    ``norm_wave_kernel``, one CTA per row; "warp": ``ln_rows_kernel``,
    ``WARP_ROWS`` rows per CTA, a warp each; "block": ``norm_fwd_kernel``,
    one CTA per row), the CTAs, the threads of a CTA, and the 16-byte
    vectors of a row that one thread holds (a lane, on the warp route)."""

    route: str
    ctas: int
    threads: int
    vecs: int


def norm_fwd_plan(rows: int, d: int, dtype, rms: bool, wave=None) -> NormPlan:
    """The launch plan of ``rms_fwd`` and ``addrms_fwd`` (``rms``) or
    ``ln_fwd`` and ``addln_fwd`` for ``rows`` rows of ``d`` values, from
    shapes only (the residual add changes no route): the one-wave kernel at up to
    ``WAVE_MAX_ROWS`` rows (``wave`` forces the choice, for chip_smoke.py's
    A/B), with the fewest vectors a thread (a power of two) with which
    ``WAVE_MAX_THREADS`` threads hold the row, on the fewest whole warps
    that cover it; else the warp-per-row kernel for LayerNorm rows of at
    most ``32 * WARP_MAX_VECS`` vectors, and the block-per-row kernel (the
    fewest vectors a thread, a power of two, at ``BLOCK_MAX_THREADS``
    threads at most) for the others."""
    nvec = d // (16 // (torch.finfo(dtype).bits // 8))
    if wave is None:
        wave = rows <= WAVE_MAX_ROWS
    if not wave and not rms and nvec <= 32 * WARP_MAX_VECS:
        return NormPlan("warp", -(-rows // WARP_ROWS), 32 * WARP_ROWS, -(-nvec // 32))
    most = WAVE_MAX_THREADS if wave else BLOCK_MAX_THREADS
    vecs = 1
    while vecs * most < nvec:
        vecs *= 2
    return NormPlan("wave" if wave else "block", rows,
                    (-(-nvec // vecs) + 31) // 32 * 32, vecs)


def _row_shape(nvec: int):
    """rowblock.cuh's row_shape: the fewest vectors a thread (a power of
    two) with which ``BLOCK_MAX_THREADS`` threads hold ``nvec`` vectors, and
    the fewest whole warps that cover them."""
    vecs = 1
    while vecs * BLOCK_MAX_THREADS < nvec:
        vecs *= 2
    return vecs, (-(-nvec // vecs) + 31) // 32 * 32


class NormBwdPlan(NamedTuple):
    """How a backward norm launches: the route ("ring":
    ``norm_ring_bwd_kernel``, persistent CTAs over a ring of ``stages``
    shared-memory stages; "warp": ``ln_bwd_kernel``, ``BWD_WARPS`` warps a
    CTA, a warp a row; "block": ``norm_bwd_kernel``, a CTA walks its rows
    one at a time), the CTAs (each writes one partial row), the threads of a
    CTA, the 16-byte vectors of a row one thread (a lane, on the warp route)
    holds, and the ring's stages (0 off the ring)."""

    route: str
    ctas: int
    threads: int
    vecs: int
    stages: int


def norm_bwd_plan(rows: int, d: int, dtype, rms: bool, add: bool, stages=None,
                  per_sm=None, ring=None) -> NormBwdPlan:
    """The launch plan of ``rms_bwd`` (``rms`` and not ``add``),
    ``addrms_bwd``, ``ln_bwd`` or ``addln_bwd`` (``add``: the fused
    residual's) for ``rows`` rows of ``d`` values, from shapes only.
    ``rms_bwd``, ``ln_bwd`` and ``addln_bwd`` take the ring: ``row_shape``'s
    threads and vectors, ``per_sm`` CTAs an SM (by the bytes of a stage,
    which holds x and dy, and ``addln_bwd``'s g0: ``RING_CTAS_BY_STAGE_BYTES``),
    the fewest stages (at least 2, at most ``RING_MAX_STAGES``) that keep
    ``RING_BYTES`` of stages in flight per SM, both cut
    to what shared memory holds, and at most one CTA a row.  ``stages`` and
    ``per_sm`` force the choice, for chip_smoke.py's A/B, and ``ring=False``
    the launch each had before the ring, which ``addrms_bwd`` keeps: two
    CTAs an SM or one per 8 rows, whichever is fewer, on the warp kernel for
    LayerNorm rows of up to ``BWD_WARP_WIDTH`` values (its lane vectors the
    next power of two over the row's share), else on the block-per-row
    kernel."""
    size = torch.finfo(dtype).bits // 8
    nvec = d // (16 // size)
    if ring is None:
        ring = not (rms and add)
    if ring:
        if rms and add:
            raise ValueError("addrms_bwd has no ring")
        vecs, threads = _row_shape(nvec)
        stage = (3 if add else 2) * d * size
        if per_sm is None:
            per_sm = next((n for most, n in RING_CTAS_BY_STAGE_BYTES if stage <= most), 1)
        if stages is None:
            stages = max(2, min(RING_MAX_STAGES, -(-RING_BYTES // (per_sm * stage))))
        stages = min(stages, RING_MAX_STAGES, _build.SMEM_LIMIT // stage)
        while per_sm > 1 and per_sm * (stages * stage + RING_SMEM_EXTRA) > _build.SMEM_PER_SM:
            per_sm -= 1
        return NormBwdPlan("ring", min(per_sm * _build.SMS, rows), threads, vecs, stages)
    ctas = max(1, min(-(-rows // 8), 2 * _build.SMS))
    if not rms and d <= BWD_WARP_WIDTH:
        vecs = 1
        while 32 * vecs < nvec:
            vecs *= 2
        return NormBwdPlan("warp", ctas, 32 * BWD_WARPS, vecs, 0)
    vecs, threads = _row_shape(nvec)
    return NormBwdPlan("block", ctas, threads, vecs, 0)


def uses_kernel(x) -> bool:
    """Whether the norm kernels take the rows of ``x``: f32 or bf16, a width
    their 16-byte vectors divide (8 bf16 or 4 f32 values) and at most
    ``MAX_WIDTH``.  Other rows take the plain version on either device."""
    if x.dtype not in _build.DTYPE_CODES:
        return False
    d = x.shape[-1]
    return d % (16 // x.element_size()) == 0 and d <= MAX_WIDTH


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt in (torch.float64, torch.float32) else torch.float32


def _plain_layernorm(x, g, b, eps: float = 1e-5):
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    mu = xa.mean(dim=-1, keepdim=True)
    xc = xa - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * g.to(acc) + b.to(acc)).to(x.dtype)


def _plain_add_layernorm(x, a, g, b, eps: float = 1e-5):
    t = x + a
    return torch.stack([t, _plain_layernorm(t, g, b, eps)])


def _plain_ln_grads(x, g, dy, eps: float = 1e-5):
    """(dx, dg, db): the port of ``_jnp_ln_grads``."""
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    mu = xa.mean(dim=-1, keepdim=True)
    xc = xa - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    xhat = xc * rsig
    dya = dy.to(acc)
    w = dya * g.to(acc)
    m1 = w.mean(dim=-1, keepdim=True)
    m2 = (w * xhat).mean(dim=-1, keepdim=True)
    dx = ((w - m1 - xhat * m2) * rsig).to(x.dtype)
    red = tuple(range(x.dim() - 1))
    dg = (dya * xhat).sum(dim=red).to(g.dtype)
    db = dya.sum(dim=red).to(g.dtype)
    return dx, dg, db


def _plain_addln_grads(t, g, dy, g0, eps: float = 1e-5):
    """``_plain_ln_grads`` with the cotangent ``g0`` of ``t`` added to the
    rounded dx in the model dtype (``addln_grads``' plain path)."""
    dx, dg, db = _plain_ln_grads(t, g, dy, eps)
    return dx + g0, dg, db


def _plain_rmsnorm(x, g, eps: float = 1e-6):
    """The port of ``_jnp_rmsnorm``."""
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    rsig = torch.rsqrt((xa * xa).mean(dim=-1, keepdim=True) + eps)
    return (xa * rsig * g.to(acc)).to(x.dtype)


def _plain_add_rmsnorm(x, a, g, eps: float = 1e-6):
    t = x + a
    return torch.stack([t, _plain_rmsnorm(t, g, eps)])


def _plain_rms_grads(x, g, dy, eps: float = 1e-6):
    """(dx, dg): the port of ``_jnp_rms_grads``."""
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    rsig = torch.rsqrt((xa * xa).mean(dim=-1, keepdim=True) + eps)
    xhat = xa * rsig
    dya = dy.to(acc)
    w = dya * g.to(acc)
    m = (w * xhat).mean(dim=-1, keepdim=True)
    dx = ((w - xhat * m) * rsig).to(x.dtype)
    dg = (dya * xhat).sum(dim=tuple(range(x.dim() - 1))).to(g.dtype)
    return dx, dg


def _plain_addrms_grads(t, g, dy, g0, eps: float = 1e-6):
    """``_plain_rms_grads`` with the cotangent ``g0`` of ``t`` added to the
    rounded dx in the model dtype (``addrms_grads``' plain path)."""
    dx, dg = _plain_rms_grads(t, g, dy, eps)
    return dx + g0, dg


def _check_cuda(name: str, x, *others):
    """Validate what the kernels take; raise on anything else."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    for t in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: every operand must be {x.dtype} on "
                            f"{x.device}, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if d % vec or d > MAX_WIDTH:
        raise ValueError(f"{name}: last dim {d} must be a multiple of {vec} "
                         f"and at most {MAX_WIDTH} for {x.dtype}")


def _same_shape(name: str, x, *others):
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shapes differ, {tuple(x.shape)} vs "
                             f"{tuple(t.shape)}")


# the forwards that launch by norm_fwd_plan, and whether each is RMSNorm
_PLANNED = {"ln_fwd": False, "addln_fwd": False, "rms_fwd": True, "addrms_fwd": True}


def _fwd_kernel(name: str, x, operands, eps: float, out_shape, plan=None):
    """Launch the forward ``name`` on x and its other operands (same dtype
    and device; the residual, if any, of x's shape) into a new tensor of
    ``out_shape``, by ``plan``, or by ``norm_fwd_plan``'s rule when it is
    None."""
    _check_cuda(name, x, *operands)
    if name.startswith("add"):
        _same_shape(name, x, operands[0])
    d = x.shape[-1]
    ins = [t.contiguous() for t in (x, *operands)]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    plan = plan or norm_fwd_plan(rows, d, x.dtype, _PLANNED[name])
    route = (plan.threads, plan.vecs) if plan.route == "wave" else (0, 0)
    with torch.cuda.device(x.device):
        err = _build.function(name)(
            *_build.ptrs(*ins, out), rows, d, float(eps),
            _build.DTYPE_CODES[x.dtype], *route, _build.stream())
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def _layernorm_fwd(x, g, b, eps: float):
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_layernorm(x, g, b, eps)
    return _fwd_kernel("ln_fwd", x, (g, b), eps, x.shape)


def _add_layernorm_fwd(x, a, g, b, eps: float):
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_add_layernorm(x, a, g, b, eps)
    return _fwd_kernel("addln_fwd", x, (a, g, b), eps, (2,) + tuple(x.shape))


def _rmsnorm_fwd(x, g, eps: float):
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_rmsnorm(x, g, eps)
    return _fwd_kernel("rms_fwd", x, (g,), eps, x.shape)


def _add_rmsnorm_fwd(x, a, g, eps: float):
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_add_rmsnorm(x, a, g, eps)
    return _fwd_kernel("addrms_fwd", x, (a, g), eps, (2,) + tuple(x.shape))


# each ring's entry that says whether its library has the ring
_RING_ENTRY = {"rms_bwd": "rms_bwd_ring", "ln_bwd": "ln_bwd_ring", "addln_bwd": "ln_bwd_ring"}


def _bwd_kernel(name: str, x, g, dy, g0, eps: float, plan=None):
    """Launch a backward (g0 None for ``ln_bwd`` / ``rms_bwd``) by
    ``plan`` (``norm_bwd_plan``'s rule when None).  On the ring the entry
    sums its CTAs' f32 partial rows (dg, and db for LayerNorm) into outputs
    in g's dtype itself; off it they are summed here, then cast.  Returns
    (dx, dg[, db])."""
    operands = (x, g, dy) if g0 is None else (x, g, dy, g0)
    _check_cuda(name, *operands)
    _same_shape(name, *((x, dy) if g0 is None else (x, dy, g0)))
    d = x.shape[-1]
    rows = x.numel() // d
    rms, add = "rms" in name, g0 is not None
    sums = 1 if rms else 2
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return (dx,) + (torch.zeros_like(g),) * sums
    plan = plan or norm_bwd_plan(rows, d, x.dtype, rms, add)
    with torch.cuda.device(x.device):
        if plan.route == "ring" and not _build.function(_RING_ENTRY[name])():
            # a build without the ring (-DNORM_BWD_V1) launches as before it
            plan = norm_bwd_plan(rows, d, x.dtype, rms, add, ring=False)
        parts = torch.empty((sums, plan.ctas, d), dtype=torch.float32, device=x.device)
        # every entry but addrms_bwd's takes dg (and db) and the ring's
        # (threads, vecs, stages): on the ring it sums the partial rows into
        # them itself
        outs, route = (), ()
        if name != "addrms_bwd":
            outs = tuple(torch.empty(g.shape, dtype=g.dtype, device=g.device)
                         for _ in range(sums))
            route = ((plan.threads, plan.vecs, plan.stages) if plan.route == "ring"
                     else (0, 0, 0))
        ins = [t.contiguous() for t in operands]
        err = _build.function(name)(
            *_build.ptrs(*ins, dx, *parts, *outs), rows, d, plan.ctas, float(eps),
            _build.DTYPE_CODES[x.dtype], *route, _build.stream())
    _build.check(err, name)
    LAUNCHES[name] += 1
    if plan.route == "ring":
        return (dx, *outs)
    return (dx, *parts.sum(dim=1).to(g.dtype))


def ln_grads(x, g, dy, eps: float = 1e-5):
    """(dx, dg, db) of ``layernorm(x, g, b, eps)`` for the cotangent dy."""
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_ln_grads(x, g, dy, eps)
    return _bwd_kernel("ln_bwd", x, g, dy, None, eps)


def addln_grads(t, g, dy, g0, eps: float = 1e-5):
    """(dx, dg, db) of ``add_layernorm`` for the cotangents g0 of ``t =
    x + a`` and dy of ``LN(t)``; dx is the gradient of both x and a."""
    if t.device.type == "cpu" or not uses_kernel(t):
        return _plain_addln_grads(t, g, dy, g0, eps)
    return _bwd_kernel("addln_bwd", t, g, dy, g0, eps)


class LayerNormFn(torch.autograd.Function):
    """LayerNorm with its kernel backward; the statistics are recomputed
    from the saved x, as the TPU backward kernel does."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g)
        return _layernorm_fwd(x, g, b, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg, db = ln_grads(x, g, dy, ctx.eps)
        return dx, dg, db, None


class AddLayerNormFn(torch.autograd.Function):
    """The stacked ``(x + a, LN(x + a))``; the backward reads the cotangent
    of each half and returns one dx for both x and a."""

    @staticmethod
    def forward(ctx, x, a, g, b, eps):
        ctx.eps = eps
        pair = _add_layernorm_fwd(x, a, g, b, eps)
        ctx.save_for_backward(pair, g)
        return pair

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        pair, g = ctx.saved_tensors
        dx, dg, db = addln_grads(pair[0], g, grad[1], grad[0], ctx.eps)
        return dx, dx, dg, db, None


def rms_grads(x, g, dy, eps: float = 1e-6):
    """(dx, dg) of ``rmsnorm(x, g, eps)`` for the cotangent dy."""
    if x.device.type == "cpu" or not uses_kernel(x):
        return _plain_rms_grads(x, g, dy, eps)
    return _bwd_kernel("rms_bwd", x, g, dy, None, eps)


def addrms_grads(t, g, dy, g0, eps: float = 1e-6):
    """(dx, dg) of ``add_rmsnorm`` for the cotangents g0 of ``t = x + a``
    and dy of ``RMSNorm(t)``; dx is the gradient of both x and a."""
    if t.device.type == "cpu" or not uses_kernel(t):
        return _plain_addrms_grads(t, g, dy, g0, eps)
    return _bwd_kernel("addrms_bwd", t, g, dy, g0, eps)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with its kernel backward; rsig is recomputed from the saved
    x, as the TPU backward kernel does."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g)
        return _rmsnorm_fwd(x, g, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg = rms_grads(x, g, dy, ctx.eps)
        return dx, dg, None


class AddRMSNormFn(torch.autograd.Function):
    """The stacked ``(x + a, RMSNorm(x + a))``; the backward returns one dx
    for both x and a."""

    @staticmethod
    def forward(ctx, x, a, g, eps):
        ctx.eps = eps
        pair = _add_rmsnorm_fwd(x, a, g, eps)
        ctx.save_for_backward(pair, g)
        return pair

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        pair, g = ctx.saved_tensors
        dx, dg = addrms_grads(pair[0], g, grad[1], grad[0], ctx.eps)
        return dx, dx, dg, None


def layernorm(x, g, b, eps: float = 1e-5):
    """Last-axis LayerNorm of ``x`` with gain ``g`` and bias ``b``."""
    return LayerNormFn.apply(x, g, b, float(eps))


def add_layernorm(x, a, g, b, eps: float = 1e-5):
    """Stacked ``(2, *x.shape)``: ``[0] = x + a``, ``[1] = LN(x + a)``."""
    return AddLayerNormFn.apply(x, a, g, b, float(eps))


def rmsnorm(x, g, eps: float = 1e-6):
    """Last-axis RMSNorm of ``x`` with gain ``g``."""
    return RMSNormFn.apply(x, g, float(eps))


def add_rmsnorm(x, a, g, eps: float = 1e-6):
    """Stacked ``(2, *x.shape)``: ``[0] = x + a``, ``[1] = RMSNorm(x + a)``."""
    return AddRMSNormFn.apply(x, a, g, float(eps))


_TAPE = {"rmsnorm": (_rmsnorm_fwd, _plain_rmsnorm),
         "add_rmsnorm": (_add_rmsnorm_fwd, _plain_add_rmsnorm),
         "rms_grads": (rms_grads, _plain_rms_grads),
         "addrms_grads": (addrms_grads, _plain_addrms_grads)}


def for_tape(name: str):
    """The tape's entry ``name`` (``rmsnorm``, ``add_rmsnorm``,
    ``rms_grads``, ``addrms_grads``), chosen by x's dtype as
    ``_build.tape_entry`` chooses."""
    return _build.tape_entry(name, *_TAPE[name])
