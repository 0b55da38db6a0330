"""LayerNorm's ring backward (``ln_bwd``, ``addln_bwd``), on the CPU.

``csrc/rowblock.cuh``'s ``norm_ring_bwd_kernel`` runs LayerNorm's backward
at every row count: persistent CTAs walk the rows interleaved, thread 0
keeps the x and dy rows (and ``addln_bwd``'s g0 row: three a stage) of the
next rows in flight by TMA bulk copies into a ring of shared-memory stages,
and each row has one exchange carrying its four sums (the mean, the centred
sum of squares, sum(w) and sum(w (x - mean))) as parts merged by Chan's
k-part formula; ``ring_sum_kernel`` then sums the CTAs' dg and db partial
rows in a fixed order.  The kernels cannot run here, so these tests hold:

- ``norm_bwd_plan`` for both at rows 1 to 8,192 and d 128 to 8,192 in bf16
  and f32 (route, CTAs, threads, vectors, stages), the stages cut to
  ``SMEM_LIMIT`` with three rows a stage, and the plan of a
  ``-DNORM_BWD_V1`` build (``ln_bwd_ring`` answers 0: the kernels before
  the ring, their partial rows summed by the wrapper);
- the ring's schedule with three rows a stage, restated from the kernel;
- the kernel's arithmetic in its order (``_ring_ln_bwd``): each thread's
  part (its mean, then the centred sums about it), the warp butterflies
  and the k-part merge onto the warp's mean, the exchange, the same merge
  onto the row's mean over the warps' partials, dx (rounded twice with
  the residual), and the partial rows and their fixed-order sum; held
  against ``_plain_ln_grads`` / ``_plain_addln_grads`` and the JAX
  package's ``_pallas_ln_bwd`` / ``_pallas_addln_bwd`` in interpret mode,
  with rows of mean 300, a ragged f32 width and 1 KB rows;
- the ring constants against ``chip_smoke.py``'s ``norm_bwd_route_ab``
  readings on the card.

Tolerances as ``tests/test_torch_norm_bwd_plan.py``'s: float32 1e-6
relative plus 1e-6 of the largest magnitude, bfloat16 at most one ulp.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
EPS = 1e-5
SMS = 132
ROWS = (1, 8, 37, 132, 1024, 4096, 8192)


def _size(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _row_shape(nvec: int):
    """rowblock.cuh's row_shape: (vectors a thread, threads)."""
    n = 1
    while n * 256 < nvec:
        n *= 2
    return n, ((nvec + n - 1) // n + 31) // 32 * 32


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_plan(dt, add):
    dtype = _TORCH[dt]
    for d in range(128, L.MAX_WIDTH + 1, 128):
        stage = (3 if add else 2) * d * _size(dtype)
        want = next((n for most, n in L.RING_CTAS_BY_STAGE_BYTES if stage <= most), 1)
        for rows in ROWS:
            p = L.norm_bwd_plan(rows, d, dtype, False, add)
            assert p.route == "ring"
            assert (p.vecs, p.threads) == _row_shape(d // (16 // _size(dtype)))
            assert 2 <= p.stages <= L.RING_MAX_STAGES
            assert p.stages * stage <= L._build.SMEM_LIMIT
            per_sm = -(-p.ctas // SMS)
            assert p.ctas == min(per_sm * SMS, rows)
            assert per_sm * (p.stages * stage + L.RING_SMEM_EXTRA) <= L._build.SMEM_PER_SM
            # the table's CTAs an SM, fewer only where shared memory does not
            # hold them; the fewest stages that keep RING_BYTES in flight
            if rows >= want * SMS:
                assert per_sm == want or (
                    (per_sm + 1) * (p.stages * stage + L.RING_SMEM_EXTRA) > L._build.SMEM_PER_SM)
                if per_sm == want:
                    assert p.stages == max(2, min(L.RING_MAX_STAGES,
                                                  -(-L.RING_BYTES // (per_sm * stage))))


def test_stages_are_cut_to_shared_memory_at_three_rows_a_stage():
    # addln_bwd's stage holds x, dy and g0: 96 KB at f32 d 8192, two fit
    # in a CTA's 227 KB; ln_bwd's two rows (64 KB) three
    p = L.norm_bwd_plan(8192, 8192, torch.float32, False, True, stages=8)
    assert p.stages == 2 and p.ctas == SMS
    p = L.norm_bwd_plan(8192, 8192, torch.float32, False, False, stages=8)
    assert p.stages == 3
    p = L.norm_bwd_plan(8192, 8192, torch.bfloat16, False, True, stages=8, per_sm=4)
    assert p.stages == 4 and p.ctas == SMS  # 4 x 48 KB: one CTA an SM
    p = L.norm_bwd_plan(8192, 4096, torch.bfloat16, False, True, stages=8, per_sm=4)
    assert p.stages == 8 and p.ctas == SMS  # 8 x 24 KB fill a CTA's memory
    p = L.norm_bwd_plan(4096, 512, torch.bfloat16, False, True, stages=8, per_sm=8)
    assert p.stages == 8 and p.ctas == 8 * SMS  # 8 x 3 KB, 8 CTAs an SM


def _recorder(monkeypatch, ring: bool):
    """Replace the C entries with a recorder of what _bwd_kernel hands them;
    ``ln_bwd_ring`` answers whether the library has the ring."""
    calls = []

    def entry(n):
        if n == "ln_bwd_ring":
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


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("name", ["ln_bwd", "addln_bwd"])
def test_the_entry_gets_its_plan(name, ring, monkeypatch):
    # a -DNORM_BWD_V1 build answers ln_bwd_ring() = 0: the wrapper then
    # plans the launch before the ring (warp per row to 1,024 values, else
    # block per row), whatever plan it was given, and sums the partial rows
    calls = _recorder(monkeypatch, ring)
    add = name == "addln_bwd"
    for dt, d in (("bfloat16", 1024), ("bfloat16", 512), ("float32", 1000),
                  ("bfloat16", 4096)):
        dtype = _TORCH[dt]
        for rows in (1, 8, 300, 4096):
            x = torch.zeros(rows, d, dtype=dtype)
            g = torch.ones(d, dtype=dtype)
            for given in (None, L.norm_bwd_plan(rows, d, dtype, False, add, stages=3,
                                                per_sm=1)):
                out = L._bwd_kernel(name, x, g, x, x if add else None, 1e-5, given)
                assert len(out) == 3 and out[0].shape == x.shape
                assert all(t.shape == g.shape and t.dtype == dtype for t in out[1:])
                got, args = calls.pop()
                assert got == name and not calls
                assert len(args) == len(L._build.SIGNATURES[name][1])
                plan = given or L.norm_bwd_plan(rows, d, dtype, False, add)
                if not ring:
                    plan = L.norm_bwd_plan(rows, d, dtype, False, add, ring=False)
                    assert plan.route == ("warp" if d <= L.BWD_WARP_WIDTH else "block")
                # x, g, dy (, g0), dx, the two partial-row sets, dg, db
                n_ptrs = 3 + add + 1 + 2 + 2
                assert args[n_ptrs:n_ptrs + 5] == (rows, d, plan.ctas, 1e-5,
                                                   L._build.DTYPE_CODES[dtype])
                assert args[n_ptrs + 5:-1] == ((plan.threads, plan.vecs, plan.stages)
                                               if ring else (0, 0, 0))
    assert L.LAUNCHES[name] == 32


# --------------------------------------------------------------------------
# the ring's schedule with three rows a stage, restated
# --------------------------------------------------------------------------


def _stage_copies(k: int, stages: int, rows_a_stage: int, row_bytes: int):
    """norm_ring_bwd_kernel's issue(k): the stage k % stages, the bytes its
    mbarrier expects, and the shared-memory ranges of the row's copies (x,
    dy, then g0), as (start, end) byte offsets into the ring."""
    st = k % stages
    base = st * rows_a_stage * row_bytes
    copies = [(base + i * row_bytes, base + (i + 1) * row_bytes)
              for i in range(rows_a_stage)]
    return st, rows_a_stage * row_bytes, copies


def test_ring_schedule_with_three_rows_a_stage():
    for rows_a_stage in (2, 3):
        for stages in range(1, L.RING_MAX_STAGES + 1):
            for row_bytes in (256, 1024, 16384):
                smem = stages * rows_a_stage * row_bytes  # the launch's dynamic bytes
                for n in range(0, 41):
                    holds = [None] * stages
                    loads = [0] * stages
                    consumed = set()

                    def issue(k):
                        st, expect, copies = _stage_copies(k, stages, rows_a_stage, row_bytes)
                        # the copies tile the stage and expect its bytes
                        assert sum(e - s for s, e in copies) == expect
                        assert all(e <= smem and s % 16 == 0 for s, e in copies)
                        assert copies[0][0] == st * expect
                        # refilled only after the row it held passed its barrier
                        assert holds[st] is None or holds[st] in consumed
                        holds[st] = k
                        loads[st] += 1

                    for k in range(min(stages, n)):
                        issue(k)
                    for k in range(n):
                        st = k % stages
                        # the wait: the stage's (k // stages)-th load, at its parity
                        assert holds[st] == k and loads[st] == k // stages + 1
                        assert (k // stages) & 1 == (loads[st] - 1) & 1
                        # every thread copies its x, dy and g0 vectors to
                        # registers before the row's barrier
                        consumed.add(k)
                        if k + stages < n:
                            issue(k + stages)
                    assert sum(loads) == n


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


def _rcp(n):
    """kRcp's reciprocals: 1 / n rounded to f32, 0 for 0."""
    n = torch.as_tensor(n, dtype=torch.float32)
    return torch.where(n > 0, torch.tensor(1.0) / n.clamp_min(1), torch.zeros(()))


def _chan_q(q, c, m, mean):
    e = m - mean
    return q + c * e * e


def _chan_a(a, b, m, mean):
    return a + (m - mean) * b


def _ring_ln_bwd(x, g, dy, g0, eps: float, plan, stats=False):
    """``norm_ring_bwd_kernel<T, NV, false, ADD>`` in its order.  CTA b takes
    rows b, b + ctas, ...; thread t holds vectors t, t + threads, ... of
    every row.  A thread's part: s = its x summed in order, m = s times
    1/(its values) (part_rcp), then q = sum (x - m)^2, B = sum w, A = sum w
    (x - m) with w = dy g; the warp's part: sw = warp_sum(s), mw = sw times
    1/(the warp's values) (warp_rcp), qw = warp_sum(q + c (m - mw)^2), bw =
    warp_sum(B), aw = warp_sum(A + (m - mw) B); after the exchange, lane l
    of every warp takes warp l's partials and the same shuffles over the
    fewest lanes that hold one each give mean = sum(sw) / d, q = sum(qw +
    cw (mw - mean)^2), m1 = sum(bw) / d, A = sum(aw + (mw - mean) bw) (1 / d
    from the host); rsig = rsqrt(q / d + eps), m2 = rsig (A / d), xhat = (x
    - mean) rsig, dx = (w - m1 - xhat m2) rsig rounded to x's dtype, and
    with g0 rounded again after adding it.  dg += dy xhat and db += dy per
    thread over the CTA's rows, the partial rows summed as ring_sum_kernel
    sums them, rounded once to g's dtype.  With ``stats``, the rows' mean,
    centred sum of squares and sum(w (x - mean)) instead."""
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
    tid = torch.arange(threads)
    held = sum(((tid + i * threads) < nvec).int() for i in range(nv))
    part_rcp = torch.where(held == nv, torch.tensor(1.0 / (nv * v)), _rcp(held * v))
    c_t = (held * v).float()
    warp = tid // 32
    wv = sum((nvec - i * threads - 32 * warp).clamp(0, 32) for i in range(nv))
    warp_rcp = torch.where(wv == 32 * nv, torch.tensor(1.0 / (32 * nv * v)), _rcp(wv * v))
    c_w = (wv * v).float()

    s = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(v):
            s = s + xs[:, :, i, j]
    m = s * part_rcp
    q, bs, as_ = (torch.zeros(rows, threads) for _ in range(3))
    for i in range(nv):
        live = i < held
        for j in range(v):
            e = xs[:, :, i, j] - m
            w = ds[:, :, i, j] * gs[:, :, i, j]
            q = torch.where(live, q + e * e, q)
            bs = torch.where(live, bs + w, bs)
            as_ = torch.where(live, as_ + w * e, as_)

    def warp_sum(t):
        return _butterfly(t.reshape(rows, warps, 32))[..., 0]

    sw = warp_sum(s)
    mw = sw * warp_rcp.reshape(warps, 32)[:, 0]
    mw_t = mw.repeat_interleave(32, dim=1)
    qw = warp_sum(_chan_q(q, c_t, m, mw_t))
    bw = warp_sum(bs)
    aw = warp_sum(_chan_a(as_, bs, m, mw_t))
    cw = c_w.reshape(warps, 32)[:, 0].expand(rows, warps)

    def lanes(t):  # the warps' partials on the first `span` lanes
        out = torch.zeros(rows, span)
        out[:, :warps] = t
        return out

    def group_sum(t):
        return _butterfly(t, span)[:, 0]

    inv_d = torch.tensor(1.0, dtype=torch.float32) / d
    sw_, mw_, qw_, cw_, bw_, aw_ = (lanes(t) for t in (sw, mw, qw, cw, bw, aw))
    mean = group_sum(sw_) * inv_d
    qr = group_sum(_chan_q(qw_, cw_, mw_, mean[:, None]))
    m1 = group_sum(bw_) * inv_d
    ar = group_sum(_chan_a(aw_, bw_, mw_, mean[:, None]))
    if stats:
        return mean, qr, ar
    rsig = torch.rsqrt(qr * inv_d + eps)
    m2 = rsig * (ar * inv_d)
    col = (slice(None), None, None, None)
    xh = (xs - mean[col]) * rsig[col]
    dx = ((ds * gs - m1[col] - xh * m2[col]) * rsig[col]).transpose(1, 2).reshape(rows, -1)
    dx = dx[:, :d].to(x.dtype)
    if g0 is not None:
        dx = (dx.float() + g0.float()).to(x.dtype)

    sums = []
    for term in (ds * xh, ds):
        parts = torch.zeros(plan.ctas, threads, nv, v)
        for b in range(plan.ctas):
            for r in range(b, rows, plan.ctas):
                parts[b] = parts[b] + term[r]
        parts = parts.transpose(1, 2).reshape(plan.ctas, -1)[:, :d]
        # ring_sum_kernel: warp w sums partial rows w, w + 16, ... in order,
        # then the warps' sums are added in warp order
        warp_sums = torch.zeros(16, d)
        for w in range(16):
            for r in range(w, plan.ctas, 16):
                warp_sums[w] = warp_sums[w] + parts[r]
        total = torch.zeros(d)
        for w in range(16):
            total = total + warp_sums[w]
        sums.append(total.to(g.dtype))
    return dx, sums[0], sums[1]


def _inputs(rows: int, d: int, mean: float, seed: int):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((rows, d)) * 3 + mean).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    g0 = rng.standard_normal((rows, d)).astype(np.float32)
    return x, g, dy, g0


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


# (dtype, d, mean of the rows): the flagship's width at chip_smoke.py's x*3 +
# 1, 1 KB rows (the MoE train step's bf16 512 and f32 256), the options
# model's 4096 (the bf16 one on two vectors a thread: 2 KB a warp), a ragged
# f32 width whose last warp holds fewer vectors, a narrow one whose last
# warp's lanes hold none, and rows of mean 300 spreading 3 in bf16 (in f32
# their own spacing, 3e-5 at 300, is 1e-5 of the spread: no two orders of
# the mean agree to 1e-6 there; test_statistics_at_a_large_mean holds them)
CASES = [(dt, d, 1.0) for dt in ("float32", "bfloat16") for d in (1024, 4096)]
CASES += [("bfloat16", 512, 1.0), ("float32", 256, 1.0), ("float32", 1000, 1.0),
          ("bfloat16", 8192, 1.0), ("bfloat16", 128, 1.0), ("float32", 1024, 24.0),
          ("bfloat16", 1024, 300.0), ("bfloat16", 4096, 300.0)]


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dt,d,mean", CASES)
def test_ring_order_matches_plain_and_jax_kernel(dt, d, mean, add):
    rows = 16
    x, g, dy, g0 = _inputs(rows, d, mean, seed=d + int(mean) + add)
    tx, tg, tdy, tg0 = (torch.from_numpy(a).to(_TORCH[dt]) for a in (x, g, dy, g0))
    plan = L.norm_bwd_plan(rows, d, tx.dtype, False, add)
    assert plan.route == "ring" and plan.ctas == rows
    # three CTAs over the 16 rows (6, 5 and 5, interleaved)
    plan = plan._replace(ctas=3)
    dx, dg, db = _ring_ln_bwd(tx, tg, tdy, tg0 if add else None, EPS, plan)
    assert dx.dtype == tx.dtype and dg.dtype == db.dtype == tg.dtype
    if add:
        pdx, pdg, pdb = L._plain_addln_grads(tx, tg, tdy, tg0, EPS)
    else:
        pdx, pdg, pdb = L._plain_ln_grads(tx, tg, tdy, EPS)
    for got, ref in ((dx, pdx), (dg, pdg), (db, pdb)):
        _hold(got, ref.float().numpy(), dt)
    jx, jg, jdy, jg0 = (jnp.asarray(a).astype(_JNP[dt]) for a in (x, g, dy, g0))
    if add:
        kdx, kdg, kdb = JLN._pallas_addln_bwd(jx, jg, jdy, jg0, EPS, 8, interpret=True)
    else:
        kdx, kdg, kdb = JLN._pallas_ln_bwd(jx, jg, jdy, EPS, 8, interpret=True)
    _hold(dx, np.asarray(kdx.astype(jnp.float32)), dt)
    for got, k in ((dg, kdg), (db, kdb)):
        _hold(got, np.asarray(k.astype(_JNP[dt]).astype(jnp.float32)), dt)


def test_statistics_at_a_large_mean():
    # rows of mean 300 spreading 3 in f32: the restated merge keeps the
    # centred sums to within 2e-5 of the f64 truth (sum(w (x - mean)) keeps
    # the f32 mean's own error, about an ulp of 300, times sum(w)); the
    # one-pass sum of squares loses ten times more to cancellation (sum(x^2)
    # ~ 9e4 d against d var ~ 9 d)
    x, g, dy, _ = _inputs(16, 4096, 300.0, seed=3)
    tx, tg, tdy = (torch.from_numpy(a) for a in (x, g, dy))
    plan = L.norm_bwd_plan(16, 4096, torch.float32, False, False)._replace(ctas=3)
    mean, q, a = (t.double() for t in _ring_ln_bwd(tx, tg, tdy, None, 0.0, plan, stats=True))
    x64, w64 = tx.double(), (tdy * tg).double()
    xc = x64 - x64.mean(1, keepdim=True)
    q_true, a_true = (xc * xc).sum(1), (w64 * xc).sum(1)

    def rel(got, want):  # of the rows' largest magnitude
        return ((got - want).abs().max() / want.abs().max()).item()

    assert (mean - x64.mean(1)).abs().max() < 1e-4  # 3 ulps of 300
    assert rel(q, q_true) < 1e-5 and rel(a, a_true) < 2e-5
    q_one = (tx * tx).sum(1) - tx.sum(1) ** 2 / 4096
    assert rel(q_one.double(), q_true) > 10 * rel(q, q_true)
    # and dx and dg stay within x's own f32 spacing at 300 (3e-5, 1e-5 of
    # the spread) of the f64 truth
    dx, dg, _ = _ring_ln_bwd(tx, tg, tdy, None, 0.0, plan)
    rsig = 1 / xc.pow(2).mean(1, keepdim=True).sqrt()
    xh = xc * rsig
    truth = (w64 - w64.mean(1, keepdim=True) - xh * (w64 * xh).mean(1, keepdim=True)) * rsig
    assert (dx.double() - truth).abs().max() / truth.abs().max() < 1e-4
    dg_true = (dy.astype(np.float64) * xh.numpy()).sum(0)
    assert np.abs(dg.double().numpy() - dg_true).max() / np.abs(dg_true).max() < 1e-4


# --------------------------------------------------------------------------
# the readings behind the constants
# --------------------------------------------------------------------------


# the rings chip_smoke.py's norm_bwd_route_ab timed within 3% of the fastest
# it tried for ln_bwd and addln_bwd in both turns (bf16, NVIDIA H100 80GB
# HBM3, 700.00 W; the wrapper's time, the partial rows' sum included), as
# (name, rows, d): {(CTAs an SM, stages)}
NEAR_FASTEST_RING = {("ln_bwd", 8192, 1024): {(4, 2)},
                     ("addln_bwd", 8192, 1024): {(4, 2), (4, 4)},
                     ("ln_bwd", 4096, 512): {(4, 2), (4, 4), (8, 2), (8, 4), (8, 8)},
                     ("addln_bwd", 4096, 512): {(4, 2), (8, 2), (8, 4), (8, 8)},
                     ("ln_bwd", 8192, 4096): {(2, 2), (2, 4)},
                     ("addln_bwd", 8192, 4096): {(1, 2), (1, 4)}}


def test_ring_constants_are_the_route_ab_reading():
    for (name, rows, d), near in NEAR_FASTEST_RING.items():
        p = L.norm_bwd_plan(rows, d, torch.bfloat16, False, name == "addln_bwd")
        assert (-(-p.ctas // SMS), p.stages) in near, (name, rows, d)
