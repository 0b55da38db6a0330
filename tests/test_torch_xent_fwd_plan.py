"""The launch plan of the port's cross-entropy forward, and the row kernel's
forward arithmetic, on the CPU.

``kernels.xent.xent_fwd_plan`` decides, from shapes only and before launch,
whether ``csrc/xent.cu``'s ``xent_fwd`` runs ``xent_row_kernel`` with BWD
false (one CTA per row, the row held in f32 registers, one exchange of
(max, sum) pairs, the label's value taken by the thread that holds it) or
the warp kernel (a warp per row, two passes over the row and a load of
z[label]), and with how many threads and vectors.  The kernels cannot run
here, so these tests hold:

- the plan at every width V from 1 to 65,536, in bf16 and f32: its route by
  the width rule from ``FWD_ROW_MIN_V`` (8 KB rows), on the row route the
  vectors a thread of its rule and the configuration
  ``xent.cu``'s ``row_kernel`` takes, and that ``_fwd_kernel`` hands the C
  entry its plan's (threads, vectors) in the argument count of its ctypes
  signature;
- the forward row kernel's arithmetic, restated in torch in its order
  (``_row_fwd``): each thread's max and sum of exps, the warps' (max, sum)
  merges by butterfly shuffles, the warps' pairs merged the same way after
  the exchange, and loss = (log s + m) - z[label] with z[label] from its
  holder (0 where the label lies outside [0, V)).  It is held against the
  plain version and the JAX package's Pallas kernel in interpret mode at
  128 rows of V 1,024 and 4,096, labels outside [0, V) included;
- the plain version taking a label outside [0, V) as the kernels do (its
  z[label] counts as 0), against the interpret-mode Pallas kernel;
- ``chip_smoke.py``'s ``xent_fwd_route_ab``, rehearsed at small shapes with
  the stubs the README names, and the crossover it read on the card.

Tolerance: ``chip_smoke.py``'s ``TOL["xent_loss"]``, 1e-5 relative plus
1e-4 (f32 statistics summed in another order; the loss is of order 1-10).
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
RTOL, ATOL = chip_smoke.TOL[("xent_loss", "float32")]


def _vec(dtype) -> int:
    """Values in one 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


def _row_kernel_takes(v: int, w: int, threads: int, vecs: int) -> bool:
    """xent.cu's row_kernel with BWD false, restated: the configurations it
    launches."""
    nvec = v // w
    return (v % w == 0 and vecs in (1, 2, 4, 8) and vecs <= X.FWD_MAX_VECS
            and threads % 32 == 0 and threads <= X.ROW_MAX_THREADS
            and threads * vecs >= nvec > (threads - 32) * vecs)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_fwd_plan_routes_threads_and_vectors(dt):
    dtype = _TORCH[dt]
    w = _vec(dtype)
    for v in range(1, JX._MAX_V + 1):
        for rows in (1, 8192):
            p = X.xent_fwd_plan(rows, v, dtype)
            if v % w:
                assert p == X.XentPlan("scalar", -(-rows // 4), 128, 0)
            elif X.FWD_ROW_MIN_V[dtype] <= v <= X.ROW_MAX_V:
                assert p.route == "row" and p.ctas == rows
                assert _row_kernel_takes(v, w, p.threads, p.vecs)
                # FWD_VECS vectors a thread on at most FWD_THREADS threads,
                # else FWD_MAX_VECS; fewer only where one warp would
                # otherwise hold more than the row
                nvec = v // w
                want = (X.FWD_VECS if -(-nvec // X.FWD_VECS) <= X.FWD_THREADS
                        else X.FWD_MAX_VECS)
                assert p.vecs == want or (p.vecs < want and 32 * 2 * p.vecs > nvec)
            else:
                assert p == X.XentPlan("warp", -(-rows // 4), 128, 0)
    # forced routes, as chip_smoke.py's A/B forces them
    assert X.xent_fwd_plan(8, 4096, dtype, route="warp").route == "warp"
    p = X.xent_fwd_plan(8, 64 * w, dtype, route="row")
    assert _row_kernel_takes(64 * w, w, p.threads, p.vecs)
    with pytest.raises(ValueError):
        X.xent_fwd_plan(8, X.ROW_MAX_V + w, dtype, route="row")


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("v", [10, 512, 4096, 32768, 65536])
def test_fwd_kernel_passes_the_plan(dt, v, monkeypatch):
    # the C entry is replaced by a recorder: what _fwd_kernel hands it
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
    plan = X.xent_fwd_plan(rows, v, dtype)
    out = X._fwd_kernel(z, lab)
    assert out.shape == (rows,) and out.dtype == torch.float32
    name, args = calls.pop()
    assert name == "xent_fwd" and not calls
    # the pointers, rows, v, dtype, threads, vecs, the stream
    assert len(args) == len(X._build.SIGNATURES["xent_fwd"][1]) == 9
    assert args[3:6] == (rows, v, X._build.DTYPE_CODES[dtype])
    assert args[6:8] == ((plan.threads, plan.vecs) if plan.route == "row" else (0, 0))
    if v % _vec(dtype) == 0 and v <= X.ROW_MAX_V:
        forced = X.xent_fwd_plan(rows, v, dtype, route="warp" if plan.route == "row" else "row")
        X._fwd_kernel(z, lab, forced)
        args = calls.pop()[1]
        assert args[6:8] == ((forced.threads, forced.vecs) if forced.route == "row" else (0, 0))
    assert X.LAUNCHES["xent_fwd"] >= 1


# --------------------------------------------------------------------------
# the forward row kernel's arithmetic, restated
# --------------------------------------------------------------------------


def _butterfly(t, op, span: int = 32):
    """warp_max / warp_sum (span 32) or group_max / group_sum over the last
    axis: at each step a lane combines its value with lane ^ o's (o < span),
    so every lane ends with the same bits."""
    lanes = torch.arange(t.shape[-1])
    for o in (16, 8, 4, 2, 1):
        if o < span:
            t = op(t, t[..., lanes ^ o])
    return t


def _row_fwd(z, lab, plan):
    """``xent_row_kernel`` with BWD false on z (rows, V) in its order:
    thread t holds vectors t, t + threads, ... of the row; its max m_t over
    its values, then s_t the sum in that order of exp(z_i - m_t) in f32
    (-FLT_MAX and 0 for a thread that holds nothing), and z[label] if it
    holds column label; the warp's m_w by max-shuffles and s_w as the
    shuffled sum of s_t exp(m_t - m_w); after the exchange, lane l of every
    warp takes warp l's pair (lanes past the last warp an empty one) and
    the same two steps over the fewest lanes that hold one pair each give m
    and s; the loss is (log s + m) - z[label], z[label] 0 where no thread
    holds the label."""
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
    col = (torch.arange(threads * nv).reshape(nv, threads).T[..., None] * w
           + torch.arange(w))  # (threads, nv, w): each value's column
    mine = (col == lab.long()[:, None, None, None]) & have[None, :, :, None]
    zl = torch.where(mine, held, 0.0).sum(dim=(1, 2, 3))  # one holder at most
    mt = torch.full((rows, threads), -FLT_MAX)
    for i in range(nv):
        for j in range(w):
            mt = torch.where(have[:, i], torch.maximum(mt, held[:, :, i, j]), mt)
    st = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(w):
            st = st + torch.where(have[:, i], torch.exp(held[:, :, i, j] - mt), 0.0)
    lanes = (rows, warps, 32)
    mw = _butterfly(mt.reshape(lanes), torch.maximum)
    sw = _butterfly(st.reshape(lanes) * torch.exp(mt.reshape(lanes) - mw), torch.add)
    assert (mw == mw[..., :1]).all() and (sw == sw[..., :1]).all()
    pm = torch.full((rows, 32), -FLT_MAX)
    ps = torch.zeros(rows, 32)
    pm[:, :warps], ps[:, :warps] = mw[..., 0], sw[..., 0]
    pm, ps = pm[:, :span], ps[:, :span]
    m = _butterfly(pm, torch.maximum, span)
    s = _butterfly(ps * torch.exp(pm - m), torch.add, span)
    assert (m == m[:, :1]).all() and (s == s[:, :1]).all()
    return (torch.log(s[:, 0]) + m[:, 0]) - zl


def _inputs(rows: int, v: int, seed: int):
    """Logits at chip_smoke.py's scale (3 x normal) and labels with rows
    whose label lies outside [0, V) (-1, V, V + 7)."""
    rng = np.random.RandomState(seed)
    z = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    lab = rng.randint(0, v, rows).astype(np.int32)
    lab[:3] = (-1, v, v + 7)
    return z, lab


def _hold(got, ref):
    got = np.asarray(got, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [1024, 4096])
def test_row_fwd_order_matches_plain_and_jax_kernel(dt, v):
    z, lab = _inputs(128, v, seed=v + 3)
    tz = torch.from_numpy(z).to(_TORCH[dt])
    tl = torch.from_numpy(lab)
    plan = X.xent_fwd_plan(128, v, tz.dtype, route="row")
    got = _row_fwd(tz, tl, plan)
    _hold(got.numpy(), X._plain_xent(tz, tl).numpy())
    jz = jnp.asarray(z).astype(_JNP[dt])
    kernel = JX._pallas_xent_fwd(jz, jnp.asarray(lab), 128, interpret=True)
    _hold(got.numpy(), np.asarray(kernel))
    # the rows whose label lies outside [0, V) lose no z[label]: their loss
    # is the row's logsumexp, above its max
    assert (got[:3] > tz[:3].float().max(dim=1).values).all()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_row_fwd_order_on_other_thread_shapes(dt):
    # half the vectors on twice the threads, one vector a thread, and a row
    # whose last warp holds fewer vectors than the others
    dtype = _TORCH[dt]
    w = _vec(dtype)
    for v, vecs in ((4096, None), (4096, 1), (4096 + 2 * w, None), (512, None)):
        z, lab = _inputs(16, v, seed=v + 5)
        tz, tl = torch.from_numpy(z).to(dtype), torch.from_numpy(lab)
        plan = X.xent_fwd_plan(16, v, dtype, route="row", vecs=vecs)
        _hold(_row_fwd(tz, tl, plan).numpy(), X._plain_xent(tz, tl).numpy())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_takes_labels_outside_the_row_as_the_kernels(dt):
    # a label outside [0, V) matches no column: z[label] counts as 0, as in
    # the interpret-mode Pallas kernel's iota compare (gather would fail)
    z, lab = _inputs(128, 512, seed=11)
    tz = torch.from_numpy(z).to(_TORCH[dt])
    got = X._plain_xent(tz, torch.from_numpy(lab))
    kernel = JX._pallas_xent_fwd(jnp.asarray(z).astype(_JNP[dt]), jnp.asarray(lab), 128,
                                 interpret=True)
    _hold(got.numpy(), np.asarray(kernel))
    # those rows' loss is their logsumexp
    _hold(got[:3].numpy(), torch.logsumexp(tz[:3].float(), dim=1).numpy())
    # in range the plain version keeps its bits: lse - z[label]
    inside = X._plain_xent(tz[3:], torch.from_numpy(lab[3:]))
    assert torch.equal(got[3:], inside)


# --------------------------------------------------------------------------
# chip_smoke.py's A/B, rehearsed, and its readings
# --------------------------------------------------------------------------


def test_fwd_route_ab_rehearsed(monkeypatch):
    monkeypatch.setattr(X, "_fwd_kernel", lambda z, lab, plan=None: X._plain_xent(z, lab))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=50: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "lib_at", lambda source, path: None)
    monkeypatch.setattr(chip_smoke, "built_as", lambda source, lib: contextlib.nullcontext())
    monkeypatch.setattr(chip_smoke, "XENT_FWD_AB", ((16, 16), (16, 512), (16, 40000),
                                                    (16, 10)))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype)

    out = chip_smoke.xent_fwd_route_ab(torch, gen, randn, None)
    assert len(out) == 8
    for rec in out:
        v = rec["shape"][1]
        plan = X.xent_fwd_plan(16, v, _TORCH[rec["dtype"]])
        assert rec["route"] == plan.route
        assert {"old", "plan"} <= set(rec["us"]) and all(len(t) == 2 for t in rec["us"].values())
        # the route the plan did not pick, where the row kernel holds the row,
        # and the row kernel at its other counts of vectors a thread
        other = set(rec["us"]) - {"old", "plan"}
        if v == 16:
            assert other == {"warp" if plan.route == "row" else "row"}
        elif v == 512:
            # the row kernel beside the warp route, at each count of vectors
            # a thread with which a warp holds no more than the row
            nvec = 512 // (16 // _TORCH[rec["dtype"]].itemsize)
            row = X.xent_fwd_plan(16, v, _TORCH[rec["dtype"]], route="row")
            assert plan.route == "warp" and "row" in other
            assert other - {"row"} == {f"row {(-(-nvec // n) + 31) // 32 * 32}x{n}"
                                       for n in (1, 2, 4, 8) if n != row.vecs and 32 * n <= nvec}
        else:
            assert other == set()


# the V at which chip_smoke.py's xent_fwd_route_ab (8,192 rows) found the
# row kernel faster than the warp kernel of the -DXENT_FWD_V1 build, and
# the V at which it found it slower, by dtype: the crossover lies at 8 KB
# rows in both
ROW_FASTER_V = {"bfloat16": (4096, 8192, 32768), "float32": (2048, 4096, 8192, 32768)}
WARP_FASTER_V = {"bfloat16": (128, 256, 512, 1024, 2048), "float32": (128, 256, 512, 1024)}


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_fwd_crossover_is_the_route_ab_reading(dt):
    min_v = X.FWD_ROW_MIN_V[_TORCH[dt]]
    assert max(WARP_FASTER_V[dt]) < min_v <= min(ROW_FASTER_V[dt])
    assert max(ROW_FASTER_V[dt]) <= X.ROW_MAX_V
    # at V 32,768 in bf16, 512 threads of 8 vectors beat 1,024 of 4; at V
    # 4,096 and 8,192, 4 vectors beat 8
    assert X.xent_fwd_plan(8192, 32768, torch.bfloat16)[2:] == (512, 8)
    assert X.xent_fwd_plan(8192, 4096, torch.bfloat16)[2:] == (128, 4)
