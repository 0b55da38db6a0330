"""The launch plan of the port's cross-entropy backward, and the row
kernel's arithmetic, on the CPU.

``kernels.xent.xent_bwd_plan`` decides, from shapes only and before launch,
whether ``csrc/xent.cu``'s ``xent_bwd`` runs ``xent_row_bwd_kernel`` (one
CTA per row, the row held in f32 registers, one exchange of (max, sum)
pairs), the warp kernel (a warp per row) or its one-element route, and
with how many threads and vectors.  The kernels cannot run here, so these
tests hold:

- the plan at every width V from 1 to 65,536 (the JAX kernel's ``_MAX_V``),
  in bf16 and f32: its route by the width rule, and on the row route the
  configuration ``xent.cu``'s ``row_kernel`` takes (whole warps of at most
  1,024 threads that cover the row with the fewest, at most 32 values a
  thread); and that ``_bwd_kernel`` hands the C entry its plan's (threads,
  vectors), in the argument count of its ctypes signature;
- the row kernel's arithmetic, restated in torch in its order
  (``_row_bwd``): each thread's max over its values and its exps, the
  warps' (max, sum) merges by butterfly shuffles, the warps' pairs merged
  the same way after the exchange, and dz = (e c - onehot) g.  It is held
  against the plain version and the JAX package's Pallas kernel in
  interpret mode at 128 rows of V 1,024 and 4,096, labels outside [0, V)
  included;
- ``chip_smoke.py``'s ``xent_bwd_route_ab`` and ``xent_width_sweep``,
  rehearsed at small shapes with the stubs the README names;
- the crossover ``ROW_MIN_V`` that ``xent_bwd_route_ab`` read on the card.

Tolerances: float32 1e-5 relative plus 2^-21 of the largest cotangent
(``chip_smoke.py``'s ``TOL["xent_dz"]``: the same f32 algebra in another
order, where p near 1 keeps p's few-ulp absolute error in p - 1); bfloat16
at most one bf16 ulp from the JAX kernel (both compute in f32 and round
once).
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from minidiff_tpu.kernels import xent as JX
from minidiff_tpu_torch.kernels import xent as X


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
FLT_MAX = 3.402823466e38


def _vec(dtype) -> int:
    """Values in one 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


def _row_kernel_takes(v: int, w: int, threads: int, vecs: int) -> bool:
    """xent.cu's row_kernel, restated: the configurations it launches."""
    nvec = v // w
    return (v % w == 0 and vecs in (1, 2, 4, 8) and vecs * w <= X.ROW_MAX_VALUES
            and threads % 32 == 0 and threads <= X.ROW_MAX_THREADS
            and threads * vecs >= nvec > (threads - 32) * vecs)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_plan_routes_threads_and_vectors(dt):
    dtype = _TORCH[dt]
    w = _vec(dtype)
    assert X.ROW_MAX_V == 32768 == X.ROW_MAX_THREADS * X.ROW_MAX_VALUES
    for v in range(1, JX._MAX_V + 1):
        for rows in (1, 37, 8192):
            p = X.xent_bwd_plan(rows, v, dtype)
            if v % w:
                assert p == X.XentPlan("scalar", -(-rows // 4), 128, 0)
            elif X.ROW_MIN_V <= v <= X.ROW_MAX_V:
                assert p.route == "row" and p.ctas == rows
                assert _row_kernel_takes(v, w, p.threads, p.vecs)
                # as many values a thread as it holds, fewer only where one
                # warp would otherwise hold more than the row
                nvec = v // w
                assert p.vecs * w == X.ROW_MAX_VALUES or 32 * 2 * p.vecs > nvec
            else:
                assert p == X.XentPlan("warp", -(-rows // 4), 128, 0)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_forced_row_route(dt):
    dtype = _TORCH[dt]
    w = _vec(dtype)
    for v in range(w, X.ROW_MAX_V + 1, w):
        p = X.xent_bwd_plan(8, v, dtype, route="row")
        assert _row_kernel_takes(v, w, p.threads, p.vecs)
        if p.vecs > 1 and 2 * p.threads <= X.ROW_MAX_THREADS:
            # chip_smoke.py's A/B also times half the vectors on more threads
            q = X.xent_bwd_plan(8, v, dtype, route="row", vecs=p.vecs // 2)
            assert _row_kernel_takes(v, w, q.threads, q.vecs)
    for v in (X.ROW_MAX_V + w, JX._MAX_V, w + 1):
        with pytest.raises(ValueError):
            X.xent_bwd_plan(8, v, dtype, route="row")
    # more threads than a CTA holds
    with pytest.raises(ValueError):
        X.xent_bwd_plan(8, X.ROW_MAX_V, dtype, route="row", vecs=X.ROW_MAX_VALUES // w // 2)
    assert X.xent_bwd_plan(8, 4096, dtype, route="warp").route == "warp"


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("v", [10, 512, 4096, 32768, 65536])
def test_bwd_kernel_passes_the_plan(dt, v, monkeypatch):
    # the C entry is replaced by a recorder: what _bwd_kernel hands it
    calls = []

    def entry(n):
        def run(*args):
            calls.append((n, args))
            return 0
        return run

    monkeypatch.setattr(X._build, "function", entry)
    monkeypatch.setattr(X._build, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(X, "LAUNCHES", dict.fromkeys(X.LAUNCHES, 0))
    dtype = _TORCH[dt]
    rows = 16
    z = torch.zeros(rows, v, dtype=dtype)
    lab = torch.zeros(rows, dtype=torch.int64)
    g = torch.ones(rows)
    plan = X.xent_bwd_plan(rows, v, dtype)
    out = X._bwd_kernel(z, lab, g)
    assert out.shape == z.shape and out.dtype == dtype
    name, args = calls.pop()
    assert name == "xent_bwd" and not calls
    # the pointers, rows, v, dtype, threads, vecs, the stream
    assert len(args) == len(X._build.SIGNATURES["xent_bwd"][1]) == 10
    assert args[4:7] == (rows, v, X._build.DTYPE_CODES[dtype])
    want = (plan.threads, plan.vecs) if plan.route == "row" else (0, 0)
    assert args[7:9] == want
    # a forced plan reaches the entry as it is
    if v % _vec(dtype) == 0 and v <= X.ROW_MAX_V:
        forced = X.xent_bwd_plan(rows, v, dtype, route="warp" if plan.route == "row" else "row")
        X._bwd_kernel(z, lab, g, forced)
        args = calls.pop()[1]
        assert args[7:9] == ((forced.threads, forced.vecs) if forced.route == "row" else (0, 0))
    assert X.LAUNCHES["xent_bwd"] >= 1


# --------------------------------------------------------------------------
# the row kernel's arithmetic, restated
# --------------------------------------------------------------------------


def _butterfly(t, op, span: int = 32):
    """warp_sum / warp_max (span 32) or group_sum / group_max over the last
    axis: at each step a lane combines its value with its partner's (lane ^
    o, o < span); the pairs combine the same two values, so every lane ends
    with the same bits."""
    lanes = torch.arange(t.shape[-1])
    for o in (16, 8, 4, 2, 1):
        if o < span:
            t = op(t, t[..., lanes ^ o])
    return t


def _row_bwd(z, lab, g, plan):
    """``xent_row_bwd_kernel`` on z (rows, V) in its order: thread t holds
    vectors t, t + threads, ... of the row (``plan.vecs``); its max m_t over
    its values, e_i = exp(z_i - m_t) in f32 and s_t their sum in that order
    (-FLT_MAX and 0 for a thread that holds nothing); the warp's m_w by
    max-shuffles and s_w as the shuffled sum of s_t exp(m_t - m_w); after
    the exchange, lane l of every warp takes warp l's pair (lanes past the
    last warp an empty one) and the same two steps over the fewest lanes (a
    power of two) that hold one pair each give m and s; then c_t =
    exp(m_t - m) / s and dz = (e c_t - onehot) g, rounded once to z's
    dtype."""
    rows, v = z.shape
    w = _vec(z.dtype)
    threads, nv, nvec = plan.threads, plan.vecs, v // w
    warps = threads // 32
    span = 1
    while span < warps:
        span *= 2
    held = torch.zeros(rows, threads * nv, w)
    held[:, :nvec] = z.float().reshape(rows, nvec, w)
    held = held.reshape(rows, nv, threads, w).transpose(1, 2)  # (rows, threads, nv, w)
    have = (torch.arange(threads * nv) < nvec).reshape(nv, threads).T  # (threads, nv)
    mt = torch.full((rows, threads), -FLT_MAX)
    for i in range(nv):
        for j in range(w):
            mt = torch.where(have[:, i], torch.maximum(mt, held[:, :, i, j]), mt)
    e = torch.exp(held - mt[..., None, None])
    st = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(w):
            st = st + torch.where(have[:, i], e[:, :, i, j], 0.0)
    lanes = (rows, warps, 32)
    mw = _butterfly(mt.reshape(lanes), torch.maximum)
    sw = _butterfly(st.reshape(lanes) * torch.exp(mt.reshape(lanes) - mw), torch.add)
    assert (mw == mw[..., :1]).all() and (sw == sw[..., :1]).all()
    pm = torch.full((rows, 32), -FLT_MAX)
    ps = torch.zeros(rows, 32)
    pm[:, :warps], ps[:, :warps] = mw[..., 0], sw[..., 0]
    pm, ps = pm[:, :span], ps[:, :span]  # lane l of every warp: warp l & (span - 1)
    m = _butterfly(pm, torch.maximum, span)
    s = _butterfly(ps * torch.exp(pm - m), torch.add, span)
    assert (m == m[:, :1]).all() and (s == s[:, :1]).all()
    m, s = m[:, 0], s[:, 0]
    ct = torch.exp(mt - m[:, None]) * (1.0 / s)[:, None]
    col = (torch.arange(threads * nv).reshape(nv, threads).T[..., None] * w
           + torch.arange(w))  # (threads, nv, w): each value's column
    onehot = (col == lab.long()[:, None, None, None]).float()
    dz = (e * ct[..., None, None] - onehot) * g.float()[:, None, None, None]
    dz = dz.transpose(1, 2).reshape(rows, threads * nv * w)[:, :v]
    return dz.to(z.dtype)


def _inputs(rows: int, v: int, seed: int):
    """Logits at chip_smoke.py's scale (3 x normal), labels with rows whose
    label lies outside [0, V) (-1, V, V + 7), cotangents of both signs."""
    rng = np.random.RandomState(seed)
    z = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    lab = rng.randint(0, v, rows).astype(np.int32)
    lab[:3] = (-1, v, v + 7)
    g = rng.standard_normal(rows).astype(np.float32)
    return z, lab, g


def _hold(got, ref, dt: str, gmax: float):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float32).astype(np.float64)
    assert np.isfinite(got).all()
    if dt == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2 ** -21 * gmax)
    else:
        # one bf16 ulp of the larger of the two magnitudes
        big = np.maximum(np.abs(got), np.abs(ref))
        ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [1024, 4096])
def test_row_order_matches_plain_and_jax_kernel(dt, v):
    z, lab, g = _inputs(128, v, seed=v)
    tz = torch.from_numpy(z).to(_TORCH[dt])
    tl, tg = torch.from_numpy(lab), torch.from_numpy(g)
    plan = X.xent_bwd_plan(128, v, tz.dtype, route="row")
    got = _row_bwd(tz, tl, tg, plan)
    assert got.dtype == tz.dtype
    gmax = float(np.abs(g).max())
    _hold(got, X._plain_xent_grad(tz, tl, tg).float().numpy(), dt, gmax)
    jz = jnp.asarray(z).astype(_JNP[dt])
    kernel = JX._pallas_xent_bwd(jz, jnp.asarray(lab), jnp.asarray(g), 128, interpret=True)
    _hold(got, np.asarray(kernel.astype(jnp.float32)), dt, gmax)
    # the rows whose label lies outside [0, V) have no -g column
    assert (got[:3].float() * tg[:3, None].sign() >= 0).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_row_order_on_other_thread_shapes(dt):
    # half the vectors on twice the threads (the A/B's other shape), and a
    # row whose last warp holds fewer vectors than the others
    dtype = _TORCH[dt]
    w = _vec(dtype)
    for v, vecs in ((4096, None), (4096 + 2 * w, None), (1024, 1)):
        z, lab, g = _inputs(16, v, seed=v + 1)
        tz = torch.from_numpy(z).to(dtype)
        tl, tg = torch.from_numpy(lab), torch.from_numpy(g)
        plan = X.xent_bwd_plan(16, v, dtype, route="row", vecs=vecs)
        _hold(_row_bwd(tz, tl, tg, plan), X._plain_xent_grad(tz, tl, tg).float().numpy(),
              dt, float(np.abs(g).max()))


def test_row_exps_per_element():
    # one exp per element and three per thread: 1.09 per element at V
    # 32,768 on 1,024 threads (the warp kernel issued two)
    plan = X.xent_bwd_plan(1, 32768, torch.bfloat16)
    assert plan.threads == 1024
    assert round((32768 + 3 * plan.threads) / 32768, 2) == 1.09


# --------------------------------------------------------------------------
# chip_smoke.py's A/B and sweep, rehearsed
# --------------------------------------------------------------------------


def _rehearse(monkeypatch):
    # the forced plans launch through _bwd_kernel, which only the card runs
    monkeypatch.setattr(X, "_bwd_kernel", lambda z, lab, g, plan=None: X._plain_xent_grad(
        z, lab, g))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=50: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "lib_at", lambda source, path: None)
    monkeypatch.setattr(chip_smoke, "built_as", lambda source, lib: contextlib.nullcontext())
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype)

    return gen, randn


def test_route_ab_rehearsed(monkeypatch):
    gen, randn = _rehearse(monkeypatch)
    monkeypatch.setattr(chip_smoke, "XENT_AB_ROWS", 16)
    monkeypatch.setattr(chip_smoke, "XENT_AB_V", (16, 512, 2048, 40000, 10))
    out = chip_smoke.xent_bwd_route_ab(torch, gen, randn, None)
    assert len(out) == 10
    for rec in out:
        v = rec["shape"][1]
        assert rec["route"] == X.xent_bwd_plan(16, v, _TORCH[rec["dtype"]]).route
        # old, the plan, and the row shapes the plan did not pick, two turns each
        assert {"old", "plan"} <= set(rec["us"]) and all(len(t) == 2 for t in rec["us"].values())
        rows = [k for k in rec["us"] if k.startswith("row ")]
        if v in (512, 2048):
            assert len(rows) == 1
        elif v == 16:
            assert len(rows) == 1  # the row kernel beside the warp route
        else:
            assert rows == []
        assert set(rec["fwd_us"]) == {"old", "new"}


def test_width_sweep_rehearsed(monkeypatch):
    gen, randn = _rehearse(monkeypatch)
    monkeypatch.setattr(chip_smoke, "XENT_SWEEP_V", (8, 10, 512, 1000, 4104, 40000))
    worst = chip_smoke.xent_width_sweep(torch, gen, randn)
    assert set(worst) == {"row", "warp", "scalar"}


# the V at which chip_smoke.py's xent_bwd_route_ab (8,192 rows, bf16 and
# f32) found the row kernel no slower than the warp kernel of the
# -DXENT_BWD_V1 build, and the V at which it found it slower
ROW_FASTER_V = (512, 2048, 8192, 32768)
WARP_FASTER_V = ()


def test_crossover_is_the_route_ab_reading():
    assert max(WARP_FASTER_V, default=0) < X.ROW_MIN_V <= min(ROW_FASTER_V)
    assert max(ROW_FASTER_V) <= X.ROW_MAX_V
