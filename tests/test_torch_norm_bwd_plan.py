"""The launch plan of the port's four backward norms, and the RMSNorm ring
kernel's order, on the CPU.

``kernels.layernorm.norm_bwd_plan`` decides, from shapes only and before
launch, how ``csrc/rmsnorm.cu``'s ``rms_bwd`` and ``addrms_bwd`` and
``csrc/layernorm.cu``'s ``ln_bwd`` and ``addln_bwd`` launch.  ``rms_bwd``,
``ln_bwd`` and ``addln_bwd`` run ``csrc/rowblock.cuh``'s
``norm_ring_bwd_kernel`` (persistent CTAs, thread 0 keeping the x and dy
(and addln's g0) of the next rows in flight by TMA bulk copies into a ring
of shared-memory stages, one exchange a row for the row sums);
``addrms_bwd`` keeps the launch it had.  The kernels cannot run here, so
these tests hold (``tests/test_torch_ln_bwd_plan.py`` holds LayerNorm's
ring in its own detail):

- the plan for all four at every width ``uses_kernel`` takes and rows 1 to
  8,192, in bf16 and f32: ``addrms_bwd`` gets the kernel, grid and block
  it had before the plan (restated here from ``rowblock.cuh``'s
  ``row_shape`` and the wrapper's "two CTAs per SM, or one per 8 rows");
  the others get ``row_shape``'s threads and vectors, the CTAs an SM its
  table gives for the stage's bytes, a ring that shared memory holds at
  those CTAs (two rows a stage, three for ``addln_bwd``), and at most one
  CTA a row; and ``_bwd_kernel`` hands each C entry its plan, in the
  argument count of its ctypes signature, and plans ``rms_bwd`` as before
  the ring for a library built without it (``-DNORM_BWD_V1``);
- the ring's schedule, restated from the kernel: every row's stage and
  mbarrier parity, each stage refilled only after the barrier of the row
  that held it, at 0-40 rows and 1-8 stages;
- the ring kernel's arithmetic in its order (``_ring_rms_bwd``): each
  thread's sums of x^2 and (dy g) x over its columns, both through one
  warp butterfly, the warps' partials combined by the same shuffles, rsig,
  m2 = rsig sum(w x) / d, dx = (w - xhat m2) rsig, the dg partial rows of
  each CTA's interleaved rows, summed in ``ring_sum_kernel``'s order
  and rounded once to g's dtype.  It is held against
  the plain version and the JAX package's Pallas kernel in interpret mode
  at d 1024 and 4096, a ragged f32 width (1000) and rows whose mean is
  large beside their spread;
- ``chip_smoke.py``'s ``norm_bwd_route_ab``, rehearsed at small shapes with
  the stubs the README names, and the ring's constants pinned to its
  readings on the card.

Tolerances: float32 1e-6 relative plus 1e-6 of the largest magnitude (the
same f32 algebra summed in another order; dg sums 16 rows); bfloat16 at
most one bf16 ulp (both sides compute in f32 and round once).
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from minidiff_tpu.kernels import layernorm as JLN
from minidiff_tpu_torch.kernels import layernorm as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
EPS = 1e-6
SMS = 132
# the four backwards: whether each is RMSNorm, whether it adds the residual
BACKWARDS = {"ln_bwd": (False, False), "addln_bwd": (False, True),
             "rms_bwd": (True, False), "addrms_bwd": (True, True)}


def _size(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _row_shape(nvec: int):
    """rowblock.cuh's row_shape: (vectors a thread, threads)."""
    n = 1
    while n * 256 < nvec:
        n *= 2
    return n, ((nvec + n - 1) // n + 31) // 32 * 32


def _launch_before_the_plan(rows: int, d: int, dtype, rms: bool):
    """The backwards' launch as the wrapper and the C entries made it before
    norm_bwd_plan (and before the ring): two CTAs per SM, or one per 8 rows;
    layernorm.cu's dispatch_bwd sends LayerNorm rows of up to 1,024 values
    to ln_bwd_kernel (8 warps, per_lane vectors a lane rounded up to 1, 2, 4
    or the widest), every other row to rowblock.cuh's norm_bwd_kernel at
    row_shape."""
    ctas = max(1, min(-(-rows // 8), 2 * SMS))
    nvec = d // (16 // _size(dtype))
    if not rms and d <= 1024:
        per_lane = (nvec + 31) // 32
        widest = 1024 // (32 * (16 // _size(dtype)))
        nv = 1 if per_lane <= 1 else 2 if per_lane <= 2 else (
            4 if widest == 4 or per_lane <= 4 else widest)
        return L.NormBwdPlan("warp", ctas, 256, nv, 0)
    nv, threads = _row_shape(nvec)
    return L.NormBwdPlan("block", ctas, threads, nv, 0)


ROWS = (1, 8, 37, 131, 1024, 8192)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_plan_for_all_four_backwards(dt):
    dtype = _TORCH[dt]
    vec = 16 // _size(dtype)
    for d in range(vec, L.MAX_WIDTH + 1, vec):
        nvec = d // vec
        for rows in ROWS:
            for name, (rms, add) in BACKWARDS.items():
                p = L.norm_bwd_plan(rows, d, dtype, rms, add)
                assert L.norm_bwd_plan(rows, d, dtype, rms, add, ring=False) == \
                    _launch_before_the_plan(rows, d, dtype, rms), (name, d, rows)
                if name == "addrms_bwd":
                    assert p == _launch_before_the_plan(rows, d, dtype, rms), (name, d, rows)
                    continue
                assert p.route == "ring"
                assert (p.vecs, p.threads) == _row_shape(nvec)
                stage = (3 if add else 2) * d * _size(dtype)
                assert 1 <= p.stages <= L.RING_MAX_STAGES
                assert p.stages * stage <= L._build.SMEM_LIMIT
                # at least two stages wherever two fit
                assert p.stages >= 2 or 2 * stage > L._build.SMEM_LIMIT
                # the CTAs an SM by the stage's bytes, fewer only where
                # shared memory does not hold them, and at most one CTA a row
                want = next((n for most, n in L.RING_CTAS_BY_STAGE_BYTES
                             if stage <= most), 1)
                per_sm = -(-p.ctas // SMS)
                assert 1 <= p.ctas <= rows
                assert p.ctas == min(per_sm * SMS, rows)
                assert per_sm * (p.stages * stage + L.RING_SMEM_EXTRA) <= L._build.SMEM_PER_SM
                if rows >= want * SMS:
                    assert per_sm <= want
                    assert per_sm == want or (
                        (per_sm + 1) * (p.stages * stage + L.RING_SMEM_EXTRA)
                        > L._build.SMEM_PER_SM)
                # RING_BYTES of stages in flight per SM, where the cap and
                # shared memory allow
                if rows >= want * SMS and per_sm == want:
                    assert (p.stages * per_sm * stage >= L.RING_BYTES
                            or p.stages == L.RING_MAX_STAGES
                            or (p.stages + 1) * stage > L._build.SMEM_LIMIT)


def test_plan_can_be_forced():
    # chip_smoke.py's A/B times each ring it names
    p = L.norm_bwd_plan(8192, 4096, torch.bfloat16, True, False, stages=4, per_sm=1)
    assert (p.ctas, p.stages) == (SMS, 4)
    p = L.norm_bwd_plan(8192, 1024, torch.bfloat16, True, False, stages=8, per_sm=4)
    assert (p.ctas, p.stages) == (4 * SMS, 8)
    # cut to what shared memory holds: a CTA's 227 KB, an SM's 228 KB
    p = L.norm_bwd_plan(8192, 8192, torch.float32, True, False, stages=8, per_sm=4)
    assert p.stages == 3 and p.ctas == SMS


def _recorder(monkeypatch, ring: bool):
    """Replace the C entries with a recorder of what _bwd_kernel hands them;
    ``rms_bwd_ring`` and ``ln_bwd_ring`` answer whether the library has the
    ring."""
    calls = []

    def entry(n):
        if n in ("rms_bwd_ring", "ln_bwd_ring"):
            return lambda: int(ring)

        def run(*args):
            calls.append((n, args))
            return 0
        return run

    monkeypatch.setattr(L._build, "function", entry)
    monkeypatch.setattr(L._build, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(L, "LAUNCHES", dict.fromkeys(L.LAUNCHES, 0))
    return calls


@pytest.mark.parametrize("name", sorted(BACKWARDS))
@pytest.mark.parametrize("dt,d", [("bfloat16", 1024), ("bfloat16", 4096), ("float32", 1000)])
def test_bwd_kernel_passes_the_plan(name, dt, d, monkeypatch):
    calls = _recorder(monkeypatch, ring=True)
    rms, add = BACKWARDS[name]
    dtype = _TORCH[dt]
    sums = 1 if rms else 2
    for rows in (1, 8, 300):
        x = torch.zeros(rows, d, dtype=dtype)
        g = torch.ones(d, dtype=dtype)
        g0 = x if add else None
        out = L._bwd_kernel(name, x, g, x, g0, 1e-5)
        assert len(out) == 1 + sums and out[0].shape == x.shape
        assert all(t.shape == g.shape and t.dtype == dtype for t in out[1:])
        got, args = calls.pop()
        assert got == name and not calls
        assert len(args) == len(L._build.SIGNATURES[name][1])
        plan = L.norm_bwd_plan(rows, d, dtype, rms, add)
        # the operands, dx, the partial rows, and the ring's dg (and db)
        n_ptrs = 3 + add + 1 + sums + (sums if name != "addrms_bwd" else 0)
        assert args[n_ptrs:n_ptrs + 5] == (rows, d, plan.ctas, 1e-5,
                                           L._build.DTYPE_CODES[dtype])
        if name in ("ln_bwd", "addln_bwd"):
            assert plan.route == "ring"
            assert args[n_ptrs + 5:-1] == (plan.threads, plan.vecs, plan.stages)
        elif name == "rms_bwd":
            assert plan.route == "ring"
            assert args[n_ptrs + 5:-1] == (plan.threads, plan.vecs, plan.stages)
            # a forced plan reaches the entry as it is; off the ring, zeros
            forced = L.norm_bwd_plan(rows, d, dtype, True, False, stages=3, per_sm=1)
            L._bwd_kernel(name, x, g, x, None, 1e-5, forced)
            args = calls.pop()[1]
            assert args[n_ptrs + 2] == forced.ctas
            assert args[n_ptrs + 5:-1] == (forced.threads, forced.vecs, 3)
            old = L.norm_bwd_plan(rows, d, dtype, True, False, ring=False)
            assert old == _launch_before_the_plan(rows, d, dtype, True)
            L._bwd_kernel(name, x, g, x, None, 1e-5, old)
            assert calls.pop()[1][n_ptrs + 5:-1] == (0, 0, 0)
        else:
            assert len(args) == n_ptrs + 6
    assert L.LAUNCHES[name] == (9 if name == "rms_bwd" else 3)
    if name == "addrms_bwd":
        with pytest.raises(ValueError, match="no ring"):
            L.norm_bwd_plan(8, d, dtype, True, True, ring=True)


@pytest.mark.parametrize("dt,d", [("bfloat16", 1024), ("bfloat16", 4096), ("float32", 1000)])
def test_a_build_without_the_ring_launches_as_before(dt, d, monkeypatch):
    # rmsnorm.cu built with -DNORM_BWD_V1 answers rms_bwd_ring() = 0: the
    # wrapper then plans rms_bwd as it did before the ring (its grid, and
    # the partial rows summed here), whatever plan it was given
    calls = _recorder(monkeypatch, ring=False)
    dtype = _TORCH[dt]
    for rows in (1, 8, 300, 8192):
        x = torch.zeros(rows, d, dtype=dtype)
        g = torch.ones(d, dtype=dtype)
        old = _launch_before_the_plan(rows, d, dtype, True)
        for plan in (None, L.norm_bwd_plan(rows, d, dtype, True, False, stages=8, per_sm=1)):
            dx, dg = L._bwd_kernel("rms_bwd", x, g, x, None, 1e-5, plan)
            assert dg.shape == g.shape and dg.dtype == dtype
            args = calls.pop()[1]
            assert args[8] == old.ctas and args[-4:-1] == (0, 0, 0)


# --------------------------------------------------------------------------
# the ring's schedule, restated
# --------------------------------------------------------------------------


def _ring_schedule(n: int, stages: int):
    """norm_ring_bwd_kernel's loads and waits over a CTA's n rows: thread 0
    issues rows 0 .. min(stages, n) - 1 before the loop; row k waits on
    stage k % stages at parity (k / stages) & 1, and after row k's barrier
    thread 0 issues row k + stages into the same stage.  Yields each wait
    as (row, stage, parity, the row the stage then holds, the loads into
    that stage so far)."""
    holds = [None] * stages
    loads = [0] * stages
    consumed = set()

    def issue(k):
        st = k % stages
        # a stage is refilled only after the row it held passed its barrier
        assert holds[st] is None or holds[st] in consumed
        holds[st] = k
        loads[st] += 1

    for k in range(min(stages, n)):
        issue(k)
    for k in range(n):
        st = k % stages
        yield k, st, (k // stages) & 1, holds[st], loads[st]
        consumed.add(k)  # every thread read its vectors before the barrier
        if k + stages < n:
            issue(k + stages)


def test_ring_schedule():
    for stages in range(1, L.RING_MAX_STAGES + 1):
        for n in range(41):
            waits = list(_ring_schedule(n, stages))
            assert [w[0] for w in waits] == list(range(n))
            for k, st, parity, held, loads in waits:
                assert held == k
                # the wait is for the stage's (k // stages)-th load, its
                # phase of that parity; that load is the latest issued, so
                # no later phase can have completed
                assert loads == k // stages + 1 and parity == (loads - 1) & 1


# --------------------------------------------------------------------------
# the ring kernel's arithmetic, restated
# --------------------------------------------------------------------------


def _butterfly(t, span: int = 32):
    """warp_sum (span 32) or group_sum over the last axis."""
    lanes = torch.arange(t.shape[-1])
    for o in (16, 8, 4, 2, 1):
        if o < span:
            t = t + t[..., lanes ^ o]
    return t


def _ring_rms_bwd(x, g, dy, eps: float, plan):
    """``norm_ring_bwd_kernel<T, NV, true, false>`` in its order: CTA b
    takes rows b, b + ctas, ...; thread t holds vectors t, t + threads, ...
    (``plan.vecs``) in every row, sums x^2 and (dy g) x over them in that
    order, both sums go through the warp butterfly and then, lane l of
    every warp taking warp l's partials, the same shuffles over the fewest
    lanes that hold one each; rsig = rsqrt(s0 / d + eps), m2 = rsig (s1 /
    d) (1 / d from the host), xhat = x rsig, dx = (dy g - xhat m2) rsig
    rounded to x's dtype, and dg += dy xhat per thread over the CTA's rows,
    the partial rows summed as ring_sum_kernel sums them."""
    rows, d = x.shape
    v = 16 // _size(x.dtype)
    threads, nv, nvec = plan.threads, plan.vecs, d // v
    warps = threads // 32
    span = 1
    while span < warps:
        span *= 2

    def spread(t):  # (rows, d) -> (rows, threads, nv, v), missing vectors 0
        out = torch.zeros(t.shape[0], threads * nv, v)
        out[:, :nvec] = t.float().reshape(t.shape[0], nvec, v)
        return out.reshape(t.shape[0], nv, threads, v).transpose(1, 2)

    xs, ds, gs = spread(x), spread(dy), spread(g[None])
    s0 = torch.zeros(rows, threads)
    s1 = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(v):
            xe, de, ge = xs[:, :, i, j], ds[:, :, i, j], gs[:, :, i, j]
            s0 = s0 + xe * xe
            s1 = s1 + de * ge * xe
    inv_d = torch.tensor(1.0, dtype=torch.float32) / d
    tot = []
    for s in (s0, s1):
        w = _butterfly(s.reshape(rows, warps, 32))[..., 0]
        padded = torch.zeros(rows, span)
        padded[:, :warps] = w
        tot.append(_butterfly(padded, span)[:, 0])
    rsig = torch.rsqrt(tot[0] * inv_d + eps)[:, None, None, None]
    m2 = rsig * (tot[1] * inv_d)[:, None, None, None]
    xh = xs * rsig
    dx = ((ds * gs - xh * m2) * rsig).transpose(1, 2).reshape(rows, -1)[:, :d]
    parts = torch.zeros(plan.ctas, threads, nv, v)
    for b in range(plan.ctas):
        for r in range(b, rows, plan.ctas):
            parts[b] = parts[b] + ds[r] * xh[r]
    parts = parts.transpose(1, 2).reshape(plan.ctas, -1)[:, :d]
    # ring_sum_kernel: warp w sums partial rows w, w + 16, ... in order,
    # then the warps' sums are added in warp order
    warp_sums = torch.zeros(16, d)
    for w in range(16):
        for r in range(w, plan.ctas, 16):
            warp_sums[w] = warp_sums[w] + parts[r]
    dg = torch.zeros(d)
    for w in range(16):
        dg = dg + warp_sums[w]
    return dx.to(x.dtype), dg.to(g.dtype)


def _inputs(rows: int, d: int, mean: float, seed: int):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((rows, d)) * 3 + mean).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    return x, g, dy


def _hold(got, ref, dt: str):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float32).astype(np.float64)
    assert np.isfinite(got).all()
    if dt == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    else:
        big = np.maximum(np.abs(got), np.abs(ref))
        ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


# (dtype, d, mean of the rows): the train steps' widths at chip_smoke.py's
# x*3 + 1, a ragged f32 width whose last warp holds fewer vectors, and rows
# whose mean is 8 and 300 spreads
CASES = [(dt, d, 1.0) for dt in ("float32", "bfloat16") for d in (1024, 4096)]
CASES += [("float32", 1000, 1.0), ("float32", 1024, 24.0), ("bfloat16", 4096, 900.0)]


@pytest.mark.parametrize("dt,d,mean", CASES)
def test_ring_order_matches_plain_and_jax_kernel(dt, d, mean):
    rows = 16
    x, g, dy = _inputs(rows, d, mean, seed=d + int(mean))
    tx, tg, tdy = (torch.from_numpy(a).to(_TORCH[dt]) for a in (x, g, dy))
    plan = L.norm_bwd_plan(rows, d, tx.dtype, True, False)
    assert plan.route == "ring" and plan.ctas == rows
    # three CTAs over the 16 rows (6, 5 and 5, interleaved)
    plan = plan._replace(ctas=3)
    dx, dg = _ring_rms_bwd(tx, tg, tdy, EPS, plan)
    assert dx.dtype == tx.dtype and dg.dtype == tg.dtype
    pdx, pdg = L._plain_rms_grads(tx, tg, tdy, EPS)
    _hold(dx, pdx.float().numpy(), dt)
    _hold(dg, pdg.float().numpy(), dt)
    jx, jg, jdy = (jnp.asarray(a).astype(_JNP[dt]) for a in (x, g, dy))
    kdx, kdg = JLN._pallas_rms_bwd(jx, jg, jdy, EPS, 8, interpret=True)
    _hold(dx, np.asarray(kdx.astype(jnp.float32)), dt)
    _hold(dg, np.asarray(kdg.astype(_JNP[dt]).astype(jnp.float32)), dt)


# --------------------------------------------------------------------------
# chip_smoke.py's A/B, rehearsed, and the readings behind the constants
# --------------------------------------------------------------------------


def _plain_bwd(name, x, g, dy, g0, eps, plan=None):
    """_bwd_kernel's stand-in on the CPU: the plain backward of ``name``."""
    if name == "rms_bwd":
        return L._plain_rms_grads(x, g, dy, eps)
    if name == "ln_bwd":
        return L._plain_ln_grads(x, g, dy, eps)
    return L._plain_addln_grads(x, g, dy, g0, eps)


def test_route_ab_rehearsed(monkeypatch):
    # the forced rings launch through _bwd_kernel, which only the card runs
    monkeypatch.setattr(L, "_bwd_kernel", _plain_bwd)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=50: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "lib_at", lambda source, path: None)
    monkeypatch.setattr(chip_smoke, "built_as", lambda source, lib: contextlib.nullcontext())
    monkeypatch.setattr(chip_smoke, "NORM_BWD_AB", ((64, 256), (16, 1024)))
    monkeypatch.setattr(chip_smoke, "LN_BWD_AB", ((48, 512), (9, 128)))
    monkeypatch.setattr(chip_smoke, "OPT_TRAIN_BATCH", 1)
    monkeypatch.setattr(chip_smoke, "OPT_TRAIN_SEQ", 16)
    monkeypatch.setattr(chip_smoke, "OPT_MODEL", dict(chip_smoke.OPT_MODEL, dim=1024))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype)

    out = chip_smoke.norm_bwd_route_ab(torch, randn, {"rmsnorm": None, "layernorm": None})
    assert [(r["name"], r["dtype"], r["shape"]) for r in out] == [
        ("rms_bwd", dt, s) for dt in ("bfloat16", "float32") for s in ([64, 256], [16, 1024])
    ] + [(n, dt, s) for dt in ("bfloat16", "float32") for s in ([48, 512], [9, 128])
         for n in ("ln_bwd", "addln_bwd")]
    for rec in out:
        assert {"old", "plan"} <= set(rec["us"]) and all(len(t) == 2 for t in rec["us"].values())
        # every ring it timed is a distinct launch
        rings = [tuple(r) for r in rec["rings"].values()]
        assert len(rings) == len(set(rings)) > 1
        assert ("addrms_us" in rec) == (rec["shape"] == [16, 1024])


# the rings chip_smoke.py's norm_bwd_route_ab timed within 3% of the
# fastest it tried (bf16, NVIDIA H100 80GB HBM3, 700.00 W; the wrapper's
# time, the partial rows' sum included), as (rows, d): {(CTAs an SM, stages)}
NEAR_FASTEST_RING = {(8192, 4096): {(2, 2), (1, 4), (2, 4), (1, 2)},
                     (8192, 1024): {(4, 2), (4, 4)},
                     (1024, 4096): {(2, 2)}}


def test_ring_constants_are_the_route_ab_reading():
    for (rows, d), near in NEAR_FASTEST_RING.items():
        p = L.norm_bwd_plan(rows, d, torch.bfloat16, True, False)
        assert (-(-p.ctas // SMS), p.stages) in near


@pytest.mark.parametrize("key,want", [
    ("void rowblock::norm_ring_bwd_kernel<__nv_bfloat16, 2, true, false>(__nv_bfloat16 const*)",
     "rms_bwd"),
    ("void rowblock::ring_sum_kernel<__nv_bfloat16, true, false>(float const*, float const*, "
     "__nv_bfloat16*, __nv_bfloat16*, int, int)", "rms_bwd"),
    ("void rowblock::norm_ring_bwd_kernel<float, 1, false, false>(float const*)", "ln_bwd"),
    ("_ZN8rowblock20norm_ring_bwd_kernelI13__nv_bfloat16Li1ELb0ELb1EEEvPKT_S4_", "addln_bwd"),
    ("void rowblock::ring_sum_kernel<float, false, true>(float const*)", "addln_bwd"),
    ("_ZN8rowblock15ring_sum_kernelIfLb0ELb0EEEvPKfS2_PT_S4_ii", "ln_bwd"),
    ("void rowblock::norm_bwd_kernel<__nv_bfloat16, 2, true, false>(float*)", "rms_bwd"),
    ("_ZN8rowblock15norm_bwd_kernelI13__nv_bfloat16Li2ELb1ELb0EEEvPKT_S4_", "rms_bwd"),
    ("void rowblock::norm_bwd_kernel<__nv_bfloat16, 2, true, true>(float*)", None),
    ("_ZN8rowblock15norm_bwd_kernelIfLi4ELb0ELb0EEEvPKT_S3_", "ln_bwd"),
    ("void rowblock::norm_bwd_kernel<float, 4, false, true>(float*)", "addln_bwd"),
    ("void (anonymous namespace)::xent_row_bwd_kernel<float, 8>(float const*)", "xent_bwd"),
    ("void (anonymous namespace)::xent_bwd_kernel<__nv_bfloat16, true>(int)", "xent_bwd"),
    ("void (anonymous namespace)::xent_fwd_kernel<__nv_bfloat16, true>(int)", None),
    ("void (anonymous namespace)::ln_bwd_kernel<float, 1, false>(float*)", "ln_bwd"),
    ("_ZN12_GLOBAL__N_113ln_bwd_kernelI13__nv_bfloat16Li4ELb1EEEvPKT_S4_", "addln_bwd"),
    ("void rowblock::norm_wave_kernel<float, 1, false, false>(float const*)", None)])
def test_profile_names_the_redesigned_backwards(key, want):
    # the train profiles' device time per step of xent_bwd, rms_bwd, ln_bwd
    # and addln_bwd, on the new kernels and on the old builds' (addrms_bwd's
    # norm_bwd_kernel not counted)
    assert chip_smoke.bwd_instance(key) == want
