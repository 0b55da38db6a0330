"""The launch plan of the port's linear scan, its ring's schedule, and the
reverse mode, on the CPU.

``kernels.scan.scan_plan`` decides, from shapes only and before launch,
whether ``csrc/scan.cu``'s ``linear_scan`` runs ``scan_ring_kernel`` (a
lead row's tile of channels a CTA, T walked through a ring of
shared-memory stages that TMA bulk copies fill ahead of the chain) or the
thread kernel, and with which tile, steps a stage and stages.  The kernels
cannot run here, so these tests hold:

- the plan at leads 1-8, T 1 to 1,024 (the stage's remainders included)
  and C even, odd and ragged, in bf16 and f32: the tiles cover every
  channel once, the ring fits the card's shared memory, the CTAs cover the
  SMs at lead 1 where the channels allow, and the rows that are no whole
  16-byte runs take the thread kernel; and that ``_launch`` hands the C
  entry its plan and the reverse flag in its ctypes signature's count;
- the ring's schedule restated in torch (``_ring_scan``): the producer's
  TMA boxes into the stage slots (zeros past T and C, the reverse mode's
  decays one row ahead), every step used once in its order, and the
  consumers' chain of a rounded multiply and a rounded add, bit for bit
  the plain version forward and reverse; and a step-by-step run of the full and empty
  mbarriers' parities that fails on a wait passing early or a deadlock;
- the reverse mode: ``_plain_scan(reverse=True)`` bit for bit the old
  composition flip(scan(shift(flip(a)), flip(g))) in f32 and bf16;
  ``ScanFn``'s backward one reverse scan and no flip, its gradients against
  the JAX package's ``linear_scan`` VJPs at f64 (1e-10, as
  ``tests/test_torch_ssm.py``);
- ``chip_smoke.py``'s ``scan_route_ab`` and ``scan_cases`` rehearsed at
  small shapes with the stubs the README names, its profile groups and its
  flip route (``fwd_v1``).
"""

from __future__ import annotations

import contextlib
import itertools
import random

import numpy as np
import pytest
import torch

import chip_smoke
import minidiff_tpu as jmd
from minidiff_tpu.ops import definitions as jdefs
from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels import scan as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL64 = dict(rtol=1e-10, atol=1e-10)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_plan_tiles_cover_every_channel(dt):
    dtype = DTYPES[dt]
    size = dtype.itemsize
    cs = (1, 2, 3, 8, 10, 64, 100, 136, 520, 1000, 4096, 4100, 8448, 32768, 32776)
    ts = (1, 7, 15, 16, 17, 127, 128, 129, 384, 1000, 1024)
    for lead, t, c in itertools.product(range(1, 9), ts, cs):
        p = S.scan_plan(lead, t, c, dtype)
        if c * size % 16 or t < S.RING_MIN_T:
            assert p.route == "thread" and p.tile == p.steps == p.stages == 0
            assert p.vec == (2 if c % 2 == 0 else 1)
            assert p.ctas * p.threads >= lead * c // p.vec > (p.ctas - 1) * p.threads
            continue
        assert p.route == "ring" and p.vec == 2 and p.tile == S.RING_TILE
        assert p.tile % 64 == 0 and p.tile <= S.RING_MAX_TILE
        assert p.threads == p.tile // 2 + 32
        tiles = -(-c // p.tile)
        assert p.ctas == lead * tiles
        # each channel in exactly one tile, each tile's rows 16-byte runs
        owner = np.repeat(np.arange(tiles), p.tile)[:c]
        assert np.bincount(owner, minlength=tiles).sum() == c
        assert all((min(p.tile, c - x * p.tile) * size) % 16 == 0 for x in range(tiles))
        assert 2 <= p.stages <= S.RING_MAX_STAGES and p.steps == S.RING_STEPS
        # the ring fits RING_BYTES (and 128 bytes to align it) of shared memory
        ring = 2 * p.stages * p.steps * p.tile * size
        assert ring <= S.RING_BYTES and ring + 128 <= _build.SMEM_LIMIT
        assert p.stages == S.RING_MAX_STAGES or 2 * (p.stages + 1) * p.steps * p.tile * size \
            > S.RING_BYTES


def test_plan_at_the_main_paths_shapes():
    # a server slot's one-row prefill: one CTA on each of 128 SMs (one wave)
    for t in (128, 256, 384):
        one = S.scan_plan(1, t, 32768, torch.bfloat16)
        assert one.route == "ring" and one.ctas == 128 <= _build.SMS
    train = S.scan_plan(8, 1024, 32768, torch.bfloat16)
    assert train.route == "ring" and train.ctas == 8 * 32768 // train.tile
    assert S.scan_plan(8, 1024, 32768, torch.float32).stages == 2
    # generate_compiled_ssm's prefill of 16 steps, and rows of no whole runs
    assert S.scan_plan(8, 16, 32768, torch.bfloat16).route == "thread"
    assert S.scan_plan(1, 200, 33, torch.float32).route == "thread"


# the T at which chip_smoke.py's scan_route_ab found the plan's ring faster
# than the thread kernel of the -DSCAN_V1 build, and the T at which it found
# it slower (bf16, C 32,768)
RING_FASTER_T = (128, 256, 384, 1024)
THREAD_FASTER_T = (16,)


def test_ring_crossover_is_the_route_ab_reading():
    assert max(THREAD_FASTER_T) < S.RING_MIN_T <= min(RING_FASTER_T)


def test_forced_plans():
    p = S.scan_plan(1, 100, 4096, torch.float32, route="ring", tile=256, steps=8, stages=3)
    assert (p.tile, p.steps, p.stages, p.threads) == (256, 8, 3, 160)
    assert S.scan_plan(1, 100, 4096, torch.bfloat16, route="thread").route == "thread"
    for bad in (dict(tile=96), dict(tile=1024), dict(stages=1), dict(stages=9),
                dict(tile=512), dict(steps=4), dict(steps=64),
                dict(tile=256, steps=32, stages=8)):
        with pytest.raises(ValueError):
            S.scan_plan(1, 100, 4096, torch.float32, route="ring", **bad)
    with pytest.raises(ValueError):
        S.scan_plan(1, 100, 4097, torch.float32, route="ring")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(1, 384, 32768), (3, 5, 33)])
def test_launch_passes_the_plan(shape, reverse, monkeypatch):
    # the C entry is replaced by a recorder: what _launch hands it
    calls = []

    def entry(n):
        def run(*args):
            calls.append((n, args))
            return 0
        return run

    monkeypatch.setattr(S._build, "function", entry)
    monkeypatch.setattr(S._build, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(S, "LAUNCHES", dict.fromkeys(S.LAUNCHES, 0))
    a = torch.zeros(shape, dtype=torch.bfloat16)
    y = S._launch(a, a, reverse)
    assert y.shape == a.shape and y.dtype == a.dtype
    name, args = calls.pop()
    assert name == "linear_scan" and not calls
    # the pointers, lead, t, c, dtype, reverse, tile, steps, stages, the stream
    assert len(args) == len(S._build.SIGNATURES["linear_scan"][1]) == 12
    plan = S.scan_plan(*shape, torch.bfloat16)
    assert args[3:11] == (*shape, 1, int(reverse), plan.tile, plan.steps, plan.stages)
    assert S.LAUNCHES["scan"] == 1


# --------------------------------------------------------------------------
# the ring's schedule, restated
# --------------------------------------------------------------------------


def _span(k, t_len, steps, reverse):
    """scan.cu's span: stage k's steps [lo, lo + n)."""
    if reverse:
        hi = t_len - k * steps
        lo = max(0, hi - steps)
        return lo, hi - lo
    lo = k * steps
    return lo, min(steps, t_len - lo)


def _box(x, row, t0, c0, steps, tile):
    """One TMA box of a (lead, T, C) operand: rows t0 .. t0 + steps of lead
    row ``row``, channels c0 .. c0 + tile, zeros past T and C."""
    out = torch.zeros((steps, tile), dtype=x.dtype)
    rows = x[row, max(t0, 0):t0 + steps, c0:c0 + tile]
    out[:rows.shape[0], :rows.shape[1]] = rows
    return out


def _ring_scan(a, b, plan, reverse):
    """``scan_ring_kernel`` on (lead, T, C) in its order: for each CTA (a
    lead row, a tile of channels) the producer loads stage k's boxes into
    slot k % stages (steps x tile of b from the stage's first step, and of
    a from the same step or, REV, the step after: the decays a_{t+1}; zeros
    past T and C), and the consumers walk the stage's steps, a rounded
    multiply then a rounded add in f32 (REV: the last step's decay 0), each
    output rounded once to the stored dtype."""
    lead, t_len, c = a.shape
    out = torch.full_like(b, float("nan"))
    for row, x in itertools.product(range(lead), range(-(-c // plan.tile))):
        c0 = x * plan.tile
        width = min(plan.tile, c - c0)
        slots = torch.full((plan.stages, 2, plan.steps, plan.tile), float("nan"),
                           dtype=a.dtype)
        carry = torch.zeros(width, dtype=torch.float32)
        used = []
        for k in range(-(-t_len // plan.steps)):
            s = k % plan.stages
            lo, n = _span(k, t_len, plan.steps, reverse)
            assert 0 < n <= plan.steps
            slots[s, 0] = _box(a, row, lo + 1 if reverse else lo, c0, plan.steps, plan.tile)
            slots[s, 1] = _box(b, row, lo, c0, plan.steps, plan.tile)
            order = range(n - 1, -1, -1) if reverse else range(n)
            for j in order:
                if reverse and lo + j + 1 >= t_len:
                    fa = torch.zeros(width, dtype=torch.float32)
                else:
                    fa = slots[s, 0, j, :width].float()
                carry = fa * carry  # two f32 ops, each rounded: never one FMA
                carry = carry + slots[s, 1, j, :width].float()
                out[row, lo + j, c0:c0 + width] = carry.to(b.dtype)
                used.append(lo + j)
        # every step used once, in order
        assert used == (list(range(t_len - 1, -1, -1)) if reverse else list(range(t_len)))
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_ring_order_is_the_plain_version_bit_for_bit(dt, reverse):
    dtype = DTYPES[dt]
    rng = np.random.default_rng(5)
    for lead, t, c, tile, steps, stages in ((2, 37, 200, 64, 8, 2), (1, 16, 64, 64, 16, 2),
                                            (1, 1, 136, 128, 8, 3), (3, 33, 72, 64, 8, 4),
                                            (1, 50, 64, 64, 16, 8), (1, 70, 64, 64, 32, 2)):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (lead, t, c))).to(dtype)
        b = torch.from_numpy(rng.standard_normal((lead, t, c))).to(dtype)
        b[0, -1, :3] = -0.0
        plan = S.scan_plan(lead, t, c, dtype, route="ring", tile=tile, steps=steps,
                           stages=stages)
        got = _ring_scan(a, b, plan, reverse)
        assert torch.equal(_bits(got), _bits(S._plain_scan(a, b, reverse)))


def _wait_passes(completed: int, parity: int) -> bool:
    """mbarrier.try_wait.parity: the phase of that parity has completed,
    i.e. the current phase (the count of completed ones) has the other."""
    return completed % 2 != parity


@pytest.mark.parametrize("seed", range(6))
def test_ring_barriers_never_pass_early_or_deadlock(seed):
    # producer and consumer warps as scan.cu runs them, in a random
    # interleaving: the producer waits on empty[s] before its (k / stages)-th
    # refill of slot s, each consumer warp on full[s] for stage k and then
    # arrives on empty[s]; a wait that passes must find its phase complete
    rnd = random.Random(seed)
    for stages, nst, warps in ((2, 7, 1), (3, 10, 4), (8, 3, 2), (4, 33, 3)):
        full = [0] * stages   # completed phases
        empty = [0] * stages
        arrivals = [0] * stages
        pk, ck = 0, [0] * warps
        while pk < nst or min(ck) < nst:
            agents = ([("p", None)] if pk < nst else []) + [
                ("c", w) for w in range(warps) if ck[w] < nst]
            kind, w = rnd.choice(agents)
            if kind == "p":
                s = pk % stages
                if pk >= stages and not _wait_passes(empty[s], (pk // stages - 1) & 1):
                    assert empty[s] < pk // stages
                    continue
                assert pk < stages or empty[s] == pk // stages
                full[s] += 1  # expect_tx, then the copies land
                pk += 1
            else:
                k = ck[w]
                s = k % stages
                if not _wait_passes(full[s], (k // stages) & 1):
                    assert full[s] <= k // stages
                    continue
                assert full[s] == k // stages + 1
                arrivals[s] += 1
                if arrivals[s] == warps:
                    arrivals[s] = 0
                    empty[s] += 1
                ck[w] += 1


# --------------------------------------------------------------------------
# the reverse mode and the backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_reverse_is_the_old_composition(dt):
    dtype = DTYPES[dt]
    rng = np.random.default_rng(7)
    for shape in ((2, 1, 3), (2, 9, 5), (1, 40, 16)):
        a = torch.from_numpy(rng.uniform(-1.05, 1.05, shape)).to(dtype)
        g = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        g[0, -1, 0] = -0.0
        old = torch.flip(S._plain_scan(S._shift(torch.flip(a, [1])), torch.flip(g, [1])), [1])
        assert torch.equal(_bits(S._plain_scan(a, g, reverse=True)), _bits(old))


def test_backward_is_one_reverse_scan_and_no_flip(monkeypatch):
    calls = []
    plain = S.scan
    monkeypatch.setattr(S, "scan", lambda a, b, reverse=False: calls.append(reverse)
                        or plain(a, b, reverse))

    def no_flip(*args, **kwargs):
        raise AssertionError("the backward flipped")

    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.standard_normal((2, 7, 3))).requires_grad_()
            for _ in range(2))
    y = S.linear_scan(a, b, axis=1)
    monkeypatch.setattr(torch, "flip", no_flip)
    y.backward(torch.ones_like(y))
    assert calls == [False, True]
    assert a.grad is not None and b.grad is not None


@pytest.mark.parametrize("shape,axis", [((1, 1, 3), 1), ((3, 17, 4), 1), ((5, 6), 0),
                                        ((2, 3, 11), -1)])
def test_scan_fn_grads_match_jax_vjps(shape, axis):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(-1.05, 1.05, shape)
    b, g = rng.standard_normal(shape), rng.standard_normal(shape)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    S.linear_scan(ta, tb, axis=axis).backward(torch.from_numpy(g))
    with jmd.use_backend("numpy"):
        ja, jb, jg = (jmd.Tensor(x) for x in (a, b, g))
        ref_a = jdefs.linear_scan_grad_a(ja, jb, jg, axis=axis)
        ref_b = jdefs.linear_scan_grad_b(ja, jb, jg, axis=axis)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref_a._data), **TOL64)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref_b._data), **TOL64)


# --------------------------------------------------------------------------
# chip_smoke.py's A/B, cases and profiles, rehearsed
# --------------------------------------------------------------------------


def _rehearse(monkeypatch):
    monkeypatch.setattr(S, "_launch", lambda a, b, reverse=False, plan=None:
                        S._plain_scan(a, b, reverse))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "device_ms", lambda torch, fn, iters=50: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "lib_at", lambda source, path: None)
    monkeypatch.setattr(chip_smoke, "built_as", lambda source, lib: contextlib.nullcontext())
    monkeypatch.setattr(chip_smoke, "SSM_SCAN", (2, 24, 96))
    monkeypatch.setattr(chip_smoke, "SSM_TAPE_GATE", (2, 20, 40))
    monkeypatch.setattr(chip_smoke, "REQUESTS", [(16, 4), (130, 4)])
    return torch.Generator().manual_seed(0)


def test_route_ab_rehearsed(monkeypatch):
    gen = _rehearse(monkeypatch)
    shapes = chip_smoke.scan_ab_shapes()
    assert [s[1:] for s in shapes[:2]] == [(1, 24, 96), (2, 24, 96)]
    assert (("bfloat16", 1, 128, 96) in shapes and ("bfloat16", 1, 256, 96) in shapes
            and ("float32", 1, 256, 96) in shapes)
    out = chip_smoke.scan_route_ab(torch, gen, None)
    assert len(out) == len(shapes)
    for rec, (dn, lead, t, c) in zip(out, shapes):
        plan = S.scan_plan(lead, t, c, DTYPES[dn])
        assert rec["route"] == plan.route and rec["shape"] == [lead, t, c]
        assert {"old", "plan"} <= set(rec["us"]) and all(len(v) == 2 for v in rec["us"].values())
        assert set(rec["reverse_us"]) == {"old", "reverse"}
        if plan.route == "ring":
            assert any(k.startswith("tile ") for k in rec["us"])


def test_scan_cases_rehearsed(monkeypatch):
    gen = _rehearse(monkeypatch)
    cases = chip_smoke.scan_cases(torch, gen)
    assert [c["backward"] for c in cases] == [False, False, False, True]
    assert all(c["max_abs_err"] == 0.0 for c in cases)


@pytest.mark.parametrize("key,group", [
    ("void (anonymous namespace)::xent_row_kernel<float, 8, false>(float const*)", "xent_fwd"),
    ("_ZN12_GLOBAL__N_115xent_row_kernelI13__nv_bfloat16Li4ELb0EEEvPKT_", "xent_fwd"),
    ("void (anonymous namespace)::xent_row_kernel<__nv_bfloat16, 4, true>(x)", None),
    ("void (anonymous namespace)::xent_fwd_kernel<float, true>(float const*)", "xent_fwd"),
    ("void (anonymous namespace)::scan_ring_kernel<__nv_bfloat16, true>(x)", "scan"),
    ("void (anonymous namespace)::scan_kernel<float, 2, false>(x)", "scan"),
    ("void at::native::elementwise_kernel<128, 4, at::native::flip_kernel_impl<x>>", "flip"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<x>", "cat"),
    ("void (anonymous namespace)::norm_wave_kernel<float, 1, true, false>(x)", None),
])
def test_profile_groups(key, group):
    assert chip_smoke.step_group(key) == group
    want = "xent_bwd" if "xent_row_kernel" in key and "true" in key else None
    if group is None and "xent" in key:
        assert chip_smoke.bwd_instance(key) == want


def test_flip_route_gives_the_same_gradients(monkeypatch):
    # fwd_v1 swaps ScanFn for the flip composition (no builds on the CPU)
    rng = np.random.default_rng(9)
    a0, b0 = rng.uniform(0.5, 1.0, (2, 11, 6)), rng.standard_normal((2, 11, 6))
    grads = []
    for route in ("reverse", "flip"):
        ctx = chip_smoke.fwd_v1({"fwd_v1_libs": {}}) if route == "flip" else \
            contextlib.nullcontext()
        with ctx:
            a, b = (torch.from_numpy(x).float().requires_grad_() for x in (a0, b0))
            S.linear_scan(a, b, axis=1).pow(2).sum().backward()
            grads.append((a.grad, b.grad))
    assert S.ScanFn.__name__ == "ScanFn"
    for new, old in zip(*grads):
        assert torch.equal(_bits(new), _bits(old))
