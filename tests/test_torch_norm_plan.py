"""The launch plan of the port's forward norms, and the one-wave kernel's
reduction order, on the CPU.

``kernels.layernorm.norm_fwd_plan`` decides, from shapes only and before
launch, whether ``csrc/rmsnorm.cu``'s ``rms_fwd`` and ``addrms_fwd`` and
``csrc/layernorm.cu``'s ``ln_fwd`` and ``addln_fwd`` take
``csrc/rowblock.cuh``'s ``norm_wave_kernel`` (one CTA per row, x, the
residual a, g and b fetched in one wave, t = x + a stored before the row's
one exchange) or their earlier routes, and with how many threads and
vectors.  The kernels cannot run here, so these tests hold:

- the plan, for every width ``uses_kernel`` takes, at rows 1, 8, 37 and
  8192, in bf16 and f32: its route by the rows rule, whole warps of at most
  1,024 threads (128 on the warp route) that cover the row, and the
  vectors each thread holds, as the C entries and kernels compute them;
  and that ``_fwd_kernel`` hands every forward's C entry its plan's
  (threads, vectors), in the argument count of its ctypes signature;
- the wave kernel's arithmetic, restated in torch in its order
  (``_wave_norm``): each thread's partial over its vectors, warp shuffles in
  the butterfly's pairs, the warps' partials in warp order, and for
  LayerNorm each part's (count, mean, centred sum of squares) combined by
  Chan's formula in its k-part form.  It is held against the plain versions
  and the JAX package's Pallas kernels in interpret mode at the decode
  shapes (8, 1024) and (8, 4096), a ragged width (1000) and rows whose mean
  is large beside their spread, where a one-pass sum of squares cancels;
  and with the residual (``ADD``): t = x + a rounded to the model dtype
  first, then the same order on t, against the plain fused versions (t
  exact), the unfused JAX pipeline and ``_pallas_addln_fwd`` /
  ``_pallas_addrms_fwd`` in interpret mode (t exact; in bf16 XLA's CPU
  backend keeps their x + a in f32, so their y is held to the same order
  on the unrounded sum), at the decode shapes and a ragged f32 width
  (5000);
- the crossover in rows that ``chip_smoke.py``'s ``norm_rows_ab`` read.

Tolerances: float32 1e-6 relative plus 1e-6 of the largest magnitude (the
same f32 algebra summed in another order); bfloat16 at most one bf16 ulp
from the plain version (both compute in f32 and round once, so only a
rounding can move).
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
EPS = {"rms": 1e-6, "ln": 1e-5}


def _vec(dtype) -> int:
    """Values in one 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_plan_routes_threads_and_vectors(kind, dt):
    dtype = _TORCH[dt]
    v = _vec(dtype)
    for d in range(v, L.MAX_WIDTH + 1, v):
        assert L.uses_kernel(torch.empty(0, d, dtype=dtype))
        nvec = d // v
        for rows in (1, 8, 37, 8192):
            p = L.norm_fwd_plan(rows, d, dtype, kind == "rms")
            assert p.threads % 32 == 0 and p.threads >= 32
            if rows <= L.WAVE_MAX_ROWS:
                # one CTA per row of at most 512 threads, the fewest vectors
                # a thread (a power of two): one up to 4,096 bf16 values
                assert p.route == "wave" and p.ctas == rows
                assert p.threads <= L.WAVE_MAX_THREADS == 512
                assert p.vecs & (p.vecs - 1) == 0
                assert p.vecs == 1 or (p.vecs // 2) * L.WAVE_MAX_THREADS < nvec
                assert p.vecs == 1 or d > 4096 // (2 if dt == "float32" else 1)
                covered = p.threads
            elif kind == "ln" and nvec <= 32 * L.WARP_MAX_VECS:
                # ln_rows_kernel: four rows a CTA, a warp each
                assert p.route == "warp" and p.threads == 128
                assert p.ctas == -(-rows // L.WARP_ROWS)
                assert p.vecs <= L.WARP_MAX_VECS
                covered = 32
            else:
                # norm_fwd_kernel: rowblock.cuh's row_shape
                assert p.route == "block" and p.ctas == rows
                assert p.threads <= L.BLOCK_MAX_THREADS
                assert p.vecs & (p.vecs - 1) == 0
                assert p.vecs == 1 or (p.vecs // 2) * L.BLOCK_MAX_THREADS < nvec
                covered = p.threads
            # the threads of a row cover it, with the fewest whole warps
            assert covered * p.vecs >= nvec > (covered - 32) * p.vecs
            assert p.threads <= 1024


def test_plan_can_be_forced_either_way():
    # chip_smoke.py's A/Bs time both routes at every row count
    assert L.norm_fwd_plan(8192, 1024, torch.bfloat16, True, wave=True).route == "wave"
    assert L.norm_fwd_plan(8, 1024, torch.bfloat16, True, wave=False).route == "block"
    assert L.norm_fwd_plan(8, 1024, torch.bfloat16, False, wave=False).route == "warp"
    assert L.norm_fwd_plan(8, 4096, torch.bfloat16, False, wave=False).route == "block"


# rows at which chip_smoke.py's norm_rows_ab (bf16, d 1024 and 4096) found
# the wave route faster than the old one for all four forwards (the fused
# ones cross where the plain ones do, so one constant serves them), and
# rows at which it did not for at least one of them
WAVE_FASTER_ROWS = (1, 8, 32, 128)
OLD_FASTER_ROWS = (512, 8192)


# the four forwards as _fwd_kernel launches them: whether each is RMSNorm,
# whether it adds the residual
FORWARDS = {"ln_fwd": (False, False), "addln_fwd": (False, True),
            "rms_fwd": (True, False), "addrms_fwd": (True, True)}


def test_every_forward_launches_by_the_plan():
    assert L._PLANNED == {name: rms for name, (rms, _) in FORWARDS.items()}


@pytest.mark.parametrize("name", sorted(FORWARDS))
@pytest.mark.parametrize("dt,d", [("bfloat16", 1024), ("bfloat16", 4096),
                                  ("float32", 5000)])
def test_fwd_kernel_passes_the_plan(name, dt, d, monkeypatch):
    # the C entry is replaced by a recorder: what _fwd_kernel hands it
    calls = []

    def entry(n):
        def run(*args):
            calls.append((n, args))
            return 0
        return run

    monkeypatch.setattr(L._build, "function", entry)
    monkeypatch.setattr(L._build, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(L, "LAUNCHES", dict.fromkeys(L.LAUNCHES, 0))
    rms, add = FORWARDS[name]
    dtype = _TORCH[dt]
    for rows in (1, 8, L.WAVE_MAX_ROWS, L.WAVE_MAX_ROWS + 1, 300):
        x = torch.zeros(rows, d, dtype=dtype)
        g = torch.ones(d, dtype=dtype)
        operands = ((x,) if add else ()) + ((g,) if rms else (g, g))
        out_shape = (2, rows, d) if add else (rows, d)
        out = L._fwd_kernel(name, x, operands, 1e-5, out_shape)
        assert tuple(out.shape) == out_shape
        got, args = calls.pop()
        assert got == name and not calls
        # the C signature's argument count: the pointers, rows, d, eps,
        # dtype, threads, vecs, the stream
        assert len(args) == len(L._build.SIGNATURES[name][1])
        assert len(args) == 1 + len(operands) + 1 + 7
        assert args[-7:-3] == (rows, d, 1e-5, L._build.DTYPE_CODES[dtype])
        plan = L.norm_fwd_plan(rows, d, dtype, rms)
        if rows <= L.WAVE_MAX_ROWS:
            assert plan.route == "wave" and args[-3:-1] == (plan.threads, plan.vecs)
        else:
            assert plan.route != "wave" and args[-3:-1] == (0, 0)
        # a forced plan reaches the entry as it is
        forced = L.norm_fwd_plan(rows, d, dtype, rms, wave=rows > L.WAVE_MAX_ROWS)
        L._fwd_kernel(name, x, operands, 1e-5, out_shape, forced)
        args = calls.pop()[1]
        want = (forced.threads, forced.vecs) if forced.route == "wave" else (0, 0)
        assert args[-3:-1] == want
    assert L.LAUNCHES[name] == 10


def test_crossover_is_the_rows_ab_reading():
    assert max(WAVE_FASTER_ROWS) <= L.WAVE_MAX_ROWS < min(OLD_FASTER_ROWS)


# --------------------------------------------------------------------------
# the wave kernel's reduction, restated
# --------------------------------------------------------------------------


def _butterfly(t):
    """warp_sum over the last axis (32 lanes): at each step a lane adds its
    partner's value (lane ^ o); the pairs add the same two values, so every
    lane ends with the same bits."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ o]
    return t


def _rcp(c):
    """The kernel's ``kRcp``: the correctly rounded f32 reciprocal of each
    count (0 for 0), by which a part's sum becomes its mean (the kernel
    divides nowhere; for a power of two it is the division)."""
    return torch.where(c > 0, (1.0 / c.double().clamp(min=1)).float(), 0.0)


def _wave_norm(x, g, b, eps: float, rms: bool, a=None):
    """``norm_wave_kernel`` on rows x (rows, d) in f32, step by step in its
    order (with the residual ``a``, ``ADD``: first t = x + a, added in f32
    and rounded once to the model dtype, and then the rows are t): thread t
    holds vectors t, t + threads, ... of the row (the plan's vecs) and sums
    its values (or squares) in that order, the warp sums by shuffles, and
    after the exchange every warp sums the warps' partials by shuffles,
    lane w holding warp w's.  LayerNorm: each thread's (count, mean,
    centred sum of squares), each mean a sum times the reciprocal of its
    count (``_rcp``), the warp's mean from its sum and count and its
    centred sum as sum_t [q_t + c_t (m_t - m_w)^2], then the row's mean
    from the warps' sums and its centred sum as sum_w [q_w + c_w (m_w -
    mean)^2].  Returns y in x's dtype, or with ``a`` the stacked (t, y)."""
    if a is not None:
        t = (x.float() + a.float()).to(x.dtype)
        return torch.stack([t, _wave_norm(t, g, b, eps, rms)])
    rows, d = x.shape
    v = _vec(x.dtype)
    plan = L.norm_fwd_plan(rows, d, x.dtype, rms, wave=True)
    threads, nv, nvec = plan.threads, plan.vecs, d // v
    warps = threads // 32
    xf = x.float()
    # (rows, threads, nv, V) with the missing vectors zero, and which exist
    held = torch.zeros(rows, threads * nv, v)
    held[:, :nvec] = xf.reshape(rows, nvec, v)
    held = held.reshape(rows, nv, threads, v).transpose(1, 2)
    have = (torch.arange(threads * nv) < nvec).reshape(nv, threads).T  # (threads, nv)
    s = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(v):
            e = held[:, :, i, j]
            s = s + torch.where(have[:, i], e * e if rms else e, 0.0)

    def lanes(t):  # (rows, threads) -> (rows, warps, 32)
        return t.reshape(rows, warps, 32)

    def across_warps(part):  # (rows, warps) -> the sum every warp computes
        padded = torch.zeros(rows, 32)
        padded[:, :warps] = part
        return _butterfly(padded)[:, 0]

    inv_d = torch.tensor(1.0, dtype=torch.float32) / d
    if rms:
        tot = across_warps(_butterfly(lanes(s))[..., 0])
        rsig = torch.rsqrt(tot * inv_d + eps)[:, None]
        return (xf * rsig * g.float()).to(x.dtype)
    c = (have.sum(1).float() * v).expand(rows, threads)
    m = s * _rcp(c)
    q = torch.zeros(rows, threads)
    for i in range(nv):
        for j in range(v):
            e = held[:, :, i, j] - m
            q = q + torch.where(have[:, i], e * e, 0.0)
    sw, cw = _butterfly(lanes(s)), _butterfly(lanes(c))
    mw = sw * _rcp(cw)
    e = lanes(m) - mw
    qw = _butterfly(lanes(q) + lanes(c) * e * e)
    sw, mw, qw, cw = (t[..., 0] for t in (sw, mw, qw, cw))
    mean = across_warps(sw) * inv_d
    ew = mw - mean[:, None]
    rsig = torch.rsqrt(across_warps(qw + cw * ew * ew) * inv_d + eps)
    y = (xf - mean[:, None]) * rsig[:, None] * g.float() + b.float()
    return y.to(x.dtype)


def _inputs(rows: int, d: int, dt: str, mean: float, seed: int):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((rows, d)) * 3 + mean).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


def _hold(got, ref, dt: str):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float32).astype(np.float64)
    assert np.isfinite(got).all()
    if dt == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    else:
        # one bf16 ulp of the larger of the two magnitudes (8 bits of
        # significand: 2^(e - 7) for a value in [2^e, 2^(e + 1)))
        big = np.maximum(np.abs(got), np.abs(ref))
        ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


# (dtype, rows, d, mean of the rows): the decode shapes at chip_smoke.py's
# x*3 + 1, a ragged width, rows whose mean is 8 spreads (3 each) and, in
# bf16, 1,000 spreads (in f32 the inputs' own spacing at 3,000, 2.4e-4, is
# 8e-5 of the spread: no side holds 1e-6 there); and rows of two and four
# vectors a thread whose last threads hold fewer (bf16 8184, f32 5000)
CASES = [(dt, 8, d, mean) for dt in ("float32", "bfloat16")
         for d, mean in ((1024, 1.0), (4096, 1.0), (1000, 1.0), (1024, 24.0))]
CASES += [("bfloat16", 8, 4096, 3000.0), ("bfloat16", 8, 8184, 1.0),
          ("float32", 8, 5000, 1.0)]


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dt,rows,d,mean", CASES)
def test_wave_order_matches_plain_and_jax_kernels(dt, rows, d, mean, kind):
    x, g, b = _inputs(rows, d, dt, mean, seed=d + int(mean))
    tx, tg, tb = (torch.from_numpy(a).to(_TORCH[dt]) for a in (x, g, b))
    rms = kind == "rms"
    got = _wave_norm(tx, tg, tb, EPS[kind], rms)
    plain = L._plain_rmsnorm(tx, tg, EPS[kind]) if rms else L._plain_layernorm(
        tx, tg, tb, EPS[kind])
    _hold(got, plain.float().numpy(), dt)
    jx, jg, jb = (jnp.asarray(a).astype(_JNP[dt]) for a in (x, g, b))
    if rms:
        kernel = JLN._pallas_rms_fwd(jx, jg, EPS[kind], 8, interpret=True)
    else:
        kernel = JLN._pallas_ln_fwd(jx, jg, jb, EPS[kind], 8, interpret=True)
    _hold(got, np.asarray(kernel.astype(jnp.float32)), dt)


def test_wave_statistics_are_centred_at_a_large_mean():
    # rows of mean 1,000 and spread 3 in f32: the restated k-part merge
    # keeps the variance to 1e-5 of the f64 truth, where a one-pass sum of
    # squares loses it to cancellation (E[x^2] ~ 1e6, var ~ 9)
    x, _, _ = _inputs(8, 4096, "float32", 1000.0, seed=5)
    tx = torch.from_numpy(x)
    ones, zeros = torch.ones(4096), torch.zeros(4096)
    y = _wave_norm(tx, ones, zeros, 0.0, rms=False).double()
    x64 = torch.from_numpy(x).double()
    truth = (x64 - x64.mean(1, keepdim=True)) / x64.std(1, unbiased=False, keepdim=True)
    # y = (x - mean) * rsig: its spread is var / (var + 0) = 1 when the
    # statistics are right
    assert torch.allclose(y.std(1, unbiased=False), torch.ones(8, dtype=torch.float64),
                          rtol=1e-5)
    assert (y - truth).abs().max() < 1e-3  # x's own f32 spacing, 6e-5 / 3 a unit
    xm = x64.float()
    one_pass = (xm * xm).mean(1) - xm.mean(1) ** 2
    assert ((one_pass.double() - x64.var(1, unbiased=False)).abs()
            / x64.var(1, unbiased=False)).max() > 1e-3


# (dtype, rows, d) of the fused residual-add forwards: the decode shapes
# (the flagship's addln at d 1024, the options' addrms at 4096 and the MoE
# model's at 1024) and a ragged f32 width whose last threads hold fewer
# vectors
ADD_CASES = [(dt, 8, d) for dt in ("float32", "bfloat16") for d in (1024, 4096)]
ADD_CASES += [("float32", 8, 5000)]


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dt,rows,d", ADD_CASES)
def test_wave_add_order_matches_plain_and_jax_kernels(dt, rows, d, kind):
    x, g, b = _inputs(rows, d, dt, 1.0, seed=d + 11)
    res = np.random.RandomState(d).standard_normal((rows, d)).astype(np.float32)
    tx, ta, tg, tb = (torch.from_numpy(v).to(_TORCH[dt]) for v in (x, res, g, b))
    rms = kind == "rms"
    eps = EPS[kind]
    got = _wave_norm(tx, tg, tb, eps, rms, a=ta)
    assert got.shape == (2, rows, d) and got.dtype == _TORCH[dt]
    # y is the plain wave norm of the rounded t, bit for bit (chip_smoke.py
    # holds the kernels to the same)
    assert torch.equal(got[1], _wave_norm(got[0], tg, tb, eps, rms))
    plain = (L._plain_add_rmsnorm(tx, ta, tg, eps) if rms
             else L._plain_add_layernorm(tx, ta, tg, tb, eps))
    assert torch.equal(got[0], plain[0])
    _hold(got[1], plain[1].float().numpy(), dt)

    jx, ja, jg, jb = (jnp.asarray(v).astype(_JNP[dt]) for v in (x, res, g, b))
    if rms:
        fused = JLN._pallas_addrms_fwd(jx, ja, jg, eps, 8, interpret=True)
        unfused = JLN._pallas_rms_fwd(fused[0], jg, eps, 8, interpret=True)
    else:
        fused = JLN._pallas_addln_fwd(jx, ja, jg, jb, eps, 8, interpret=True)
        unfused = JLN._pallas_ln_fwd(fused[0], jg, jb, eps, 8, interpret=True)
    fused, unfused = (np.asarray(v.astype(jnp.float32)) for v in (fused, unfused))
    assert np.array_equal(got[0].float().numpy(), fused[0])
    # the JAX kernel's contract: its outputs equal the unfused add, then the
    # norm (layernorm.py:126-130)
    _hold(got[1], unfused, dt)
    if dt == "float32":
        _hold(got[1], fused[1], dt)
    else:
        # in bf16 XLA's CPU backend keeps the interpret-mode kernel's x + a
        # in f32 (excess precision), so its y is the norm of the unrounded
        # sum: the wave order on that sum, rounded once, gives it
        tf = tx.float() + ta.float()
        _hold(_wave_norm(tf, tg.float(), tb.float(), eps, rms).to(tx.dtype),
              fused[1], dt)
