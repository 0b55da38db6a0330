"""The launch plan and the bf16 ``wgmma`` tile of the port's matmul kernels,
on the CPU.

``kernels.matmul.mm_plan`` decides, from shapes and dtypes before launch,
which tile of ``csrc/matmul.cu`` a product takes: the ``wgmma`` tile (bf16
whose operands' contiguous dimensions are multiples of 8) at 128 x 256 (one
CTA per SM, a ring of 4 stages) or 128 x 128 (two, 3 stages) output columns
per CTA, the WMMA tile (other bf16), or the FFMA tile (f32).  The kernel
cannot run here, so these tests hold:

- the plan at the main path's shapes;
- a plain numpy emulation of the ``wgmma`` tile's address arithmetic,
  restated from the kernel: each stage's operand tiles as the TMA's boxes
  of 64 columns land them, in 128-byte swizzle atoms (``_tma_boxes``), the
  descriptors each consumer warpgroup gives every MMA (``_desc_read``
  reads them as the tensor cores do), the CTAs' tile order and the
  epilogue's register layout and staging.  The emulated product is held
  against ``kernels.matmul._plain`` and the JAX
  ``_pallas_matmul{,_nt,_tn}_2d`` in interpret mode;
- a step-by-step run of each CTA's producer / consumer ring (full and empty
  mbarriers, one release per consumer warp) at every K-tile count from 1
  to past twice the ring, which fails on a deadlock or an arrive that no
  thread awaits.

On the card, ``chip_smoke.py`` holds the kernel itself against the plain
version (``matmul_cases``) and times it against the WMMA tile
(``matmul_route_ab``) and at both tiles (``matmul_tile_ab``).
"""

from __future__ import annotations

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import matmul as MM
from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels import matmul as TMM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _interpret(monkeypatch):
    """Run the JAX matmul kernels' pallas_call in interpret mode."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(MM, "pl", patched)


BF16, F32 = torch.bfloat16, torch.float32

# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (variant, m, n, k, tile_n): the tape's matmul step, the MLP's layer-1
# forward and dW1 (K 784 = 12 x 64 + 16; M 784 in tn: 224 CTAs of 128 x
# 128), 1032^3 (no dimension a multiple of the tile; 81 CTAs of 128 x 128),
# one K tile and part of one
WGMMA_SHAPES = [(v, 4096, 4096, 4096, 256) for v in ("nn", "nt", "tn")] + [
    ("nn", 8192, 4096, 784, 256), ("tn", 784, 4096, 8192, 256),
    *[(v, 1032, 1032, 1032, 128) for v in ("nn", "nt", "tn")],
    *[(v, 8192, 8192, k, 128) for v in ("nn", "nt", "tn") for k in (64, 16)]]


@pytest.mark.parametrize("variant,m,n,k,tile_n", WGMMA_SHAPES)
def test_plan_at_the_main_path_shapes(variant, m, n, k, tile_n):
    assert TMM.mm_plan(variant, m, n, k, BF16) == ("wgmma", tile_n, TMM._GROUP)


def test_plan_takes_128_columns_at_one_k_tile_or_one_wave():
    for k in (8, 64, 72, 4096):
        for m in range(8, 2048, 40):
            for n in range(8, 3000, 56):
                one_wave = -(-m // 128) * -(-n // 128) <= _build.SMS
                assert TMM.mm_plan("nn", m, n, k, BF16).tile_n == (
                    128 if k <= 64 or one_wave else 256)


@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
def test_plan_unaligned_bf16_takes_wmma_and_f32_ffma(variant):
    # 1030^3: no operand row is a whole number of 16-byte copies
    assert TMM.mm_plan(variant, 1030, 1030, 1030, BF16) == ("wmma", 0, 1)
    for m, n, k in ((4096, 4096, 4096), (1030, 1030, 1030), (8192, 4096, 784),
                    (784, 4096, 8192), (2048, 2048, 2048)):
        assert TMM.mm_plan(variant, m, n, k, F32) == ("ffma", 0, 1)
    with pytest.raises(TypeError):
        TMM.mm_plan(variant, 4096, 4096, 4096, torch.float64)


def test_plan_reads_each_operands_contiguous_dimension():
    # nn: x (m, k), y (k, n); nt: x (m, k), y (n, k); tn: x (k, m), y (k, n)
    assert TMM.mm_plan("nn", 1030, 4096, 4096, BF16).route == "wgmma"
    assert TMM.mm_plan("nn", 4096, 1030, 4096, BF16).route == "wmma"
    assert TMM.mm_plan("nn", 4096, 4096, 1030, BF16).route == "wmma"
    assert TMM.mm_plan("nt", 1030, 1030, 4096, BF16).route == "wgmma"
    assert TMM.mm_plan("nt", 4096, 4096, 1030, BF16).route == "wmma"
    assert TMM.mm_plan("tn", 4096, 4096, 1030, BF16).route == "wgmma"
    assert TMM.mm_plan("tn", 1030, 4096, 4096, BF16).route == "wmma"
    assert TMM.mm_plan("tn", 4096, 1030, 4096, BF16).route == "wmma"


# ---------------------------------------------------------------------------
# the wgmma tile's addresses, restated from csrc/matmul.cu (namespace wg)
# ---------------------------------------------------------------------------

BM, BK = 128, 64


def _stages(tn):
    """The ring's depth: 4 stages at 128 x 256, 3 at 128 x 128."""
    return 4 if tn == 256 else 3


def _swizzle(byte):
    """The 128-byte swizzle on an absolute shared address (atoms are 1 KB
    aligned): 16-byte chunk bits 4-6 XOR row bits 7-9."""
    return byte ^ (((byte >> 7) & 7) << 4)


def _tma_boxes(smem, dst, src, r0, c0, rows, cols):
    """The producer's boxes of the window [r0, r0 + rows) x [c0, c0 + cols)
    of ``src``: box b (columns c0 + 64 b on) lands at byte dst + b * rows *
    128, row r at 128 r, element c at 2 c, 128-byte swizzled on the
    absolute address; zeros past the matrix.  ``smem`` holds one value per
    2 bytes."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    off = _swizzle(dst + (c // 64) * (rows * 128) + r * 128 + 2 * (c % 64))
    assert len(np.unique(off)) == off.size  # each element lands once
    ok = (r0 + r < src.shape[0]) & (c0 + c < src.shape[1])
    vals = np.zeros(off.shape)
    vals[ok] = src[(r0 + r)[ok], (c0 + c)[ok]]
    smem[off // 2] = vals


def _desc_read(smem, start, lbo, sbo, mn, k_major):
    """The (mn x 16) operand a 128-byte-swizzled descriptor gives wgmma,
    as [row of M or N, k]: K-major, rows of 8 x 128 bytes with 8-row
    groups ``sbo`` apart; MN-major, 64 columns per atom with atoms ``lbo``
    apart along M or N, K rows 128 bytes apart and 8-row groups ``sbo``."""
    row, k = np.meshgrid(np.arange(mn), np.arange(16), indexing="ij")
    if k_major:
        byte = start + (row % 8) * 128 + (row // 8) * sbo + 2 * k
    else:
        byte = start + (row % 64) * 2 + (row // 64) * lbo + (k % 8) * 128 + (k // 8) * sbo
    return smem[_swizzle(byte) // 2]


def _cta_origin(cta, m, n, tn, group):
    """mm_wgmma_kernel's tile order: bands of ``group`` tile-rows, walked
    column by column."""
    tiles_n = -(-n // tn)
    band, in_band = cta // (group * tiles_n), cta % (group * tiles_n)
    rows = min(-(-m // BM) - band * group, group)
    return (band * group + in_band % rows) * BM, (in_band // rows) * tn


def _emulate(variant, x, y, tn, group):
    """The wgmma kernel's product in f64 (every output once, through the
    epilogue's register layout and staging) and rounded to bf16 as it
    stores it."""
    m, n, k = TMM._mnk(variant, x.shape, y.shape)
    a_k, b_k = variant != "tn", variant == "nt"
    stage, stages = BM * BK * 2 + tn * BK * 2, _stages(tn)
    out = np.full((m, n), np.nan)
    written = np.zeros((m, n), int)
    for cta in range(-(-m // BM) * -(-n // tn)):
        m0, n0 = _cta_origin(cta, m, n, tn, group)
        acc = np.zeros((2, 64, tn))
        smem = np.full(stages * stage // 2, np.nan)  # its base 1 KB aligned
        for kt in range(-(-k // BK)):
            sa = (kt % stages) * stage
            sb, k0 = sa + BM * BK * 2, kt * BK
            if a_k:
                _tma_boxes(smem, sa, x, m0, k0, BM, BK)
            else:
                _tma_boxes(smem, sa, x, k0, m0, BK, BM)
            if b_k:
                _tma_boxes(smem, sb, y, n0, k0, tn, BK)
            else:
                _tma_boxes(smem, sb, y, k0, n0, BK, tn)
            for wg in range(2):
                for kk in range(BK // 16):
                    wa = sa + wg * 8192
                    a = (_desc_read(smem, wa + 32 * kk, 16, 1024, 64, True) if a_k
                         else _desc_read(smem, wa + 2048 * kk, 8192, 1024, 64, False))
                    b = (_desc_read(smem, sb + 32 * kk, 16, 1024, tn, True) if b_k
                         else _desc_read(smem, sb + 2048 * kk, 8192, 1024, tn, False))
                    acc[wg] += a @ b.T
        # the epilogue: thread (warp, lane) of warpgroup wg holds
        # acc[4 j + 2 h + e] at row 16 warp + lane / 4 + 8 h, column
        # 8 j + 2 (lane % 4) + e, and stages it as part of a bf16 pair at
        # byte 4 (lane % 4) + 2 e of chunk j % 8 ^ row % 8 of atom j / 8
        wg, warp, lane, j, h, e = np.meshgrid(
            np.arange(2), np.arange(4), np.arange(32), np.arange(tn // 8),
            np.arange(2), np.arange(2), indexing="ij")
        lr, lc = 16 * warp + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e
        staged = (wg * 64 * tn * 2 + (j // 8) * 8192 + lr * 128
                  + (((j % 8) ^ (lr & 7)) << 4) + 4 * (lane % 4) + 2 * e)
        assert staged.max() < stages * stage and len(np.unique(staged)) == staged.size
        smem[staged.ravel() // 2] = acc[wg, lr, lc].ravel()
        # then copier t of 128 stores the 16-byte chunks i = t + 128 jj of
        # its warpgroup's rows: chunk c = i % (tn / 8) of row i / (tn / 8)
        wg, i, q = np.meshgrid(np.arange(2), np.arange(64 * tn // 8), np.arange(8),
                               indexing="ij")
        row, c = i // (tn // 8), i % (tn // 8)
        gr, gc = m0 + 64 * wg + row, n0 + 8 * c + q
        keep = (gr < m) & (gc < n)
        src = (wg * 64 * tn * 2 + (c // 8) * 8192 + row * 128 + (((c % 8) ^ (row & 7)) << 4)
               + 2 * q)
        out[gr[keep], gc[keep]] = smem[src[keep] // 2]
        np.add.at(written, (gr[keep], gc[keep]), 1)
    assert np.all(written == 1), "every output element stored by one thread once"
    rounded = torch.from_numpy(out).float().to(BF16)
    return out, rounded


def _operands(variant, m, n, k, seed):
    rng = np.random.RandomState(seed)
    xs = (k, m) if variant == "tn" else (m, k)
    ys = (n, k) if variant == "nt" else (k, n)
    # bf16 values, held in f64 for the emulation
    x, y = (torch.from_numpy(rng.standard_normal(s)).to(BF16) for s in (xs, ys))
    return x, y


def _exact(variant, x, y):
    a, b = TMM._oriented(variant, x.double(), y.double())
    return (a @ b).numpy()


def _close(got, ref):
    """chip_smoke.py's TOL["matmul"] in bf16: both sides sum in f32 (here
    f64) and round once, so one bf16 ulp: 1e-2 of the largest value."""
    got, ref = got.float().numpy(), ref.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


# ragged shapes: M, N and K off the tiles, K under one K tile, an odd N in
# nt (the epilogue's single stores), two bands of tile-rows with group 1
RAGGED = [("nn", 136, 264, 72), ("nt", 136, 264, 72), ("tn", 136, 264, 72),
          ("nn", 200, 120, 40), ("tn", 200, 120, 40), ("nt", 130, 77, 64),
          ("nt", 8, 8, 8), ("nn", 264, 136, 136)]


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("variant,m,n,k", RAGGED)
def test_tile_emulation_matches_plain_on_ragged_shapes(variant, m, n, k, tn):
    x, y = _operands(variant, m, n, k, seed=m + n + k)
    for group in (1, 8):
        exact, rounded = _emulate(variant, x.double().numpy(), y.double().numpy(), tn, group)
        # the addresses are right: the f64 sums agree with the f64 product
        np.testing.assert_allclose(exact, _exact(variant, x, y), rtol=1e-12, atol=1e-12)
        _close(rounded, TMM._plain(variant, x, y))


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
def test_tile_emulation_matches_jax_kernel(_interpret, variant, tn):
    m, n, k = 256, 256, 128
    x, y = _operands(variant, m, n, k, seed=5)
    kernel = {"nn": MM._pallas_matmul_2d, "nt": MM._pallas_matmul_nt_2d,
              "tn": MM._pallas_matmul_tn_2d}[variant]
    ref = kernel(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                 jnp.asarray(y.float().numpy(), jnp.bfloat16), bm=128, bn=128, bk=64)
    _, rounded = _emulate(variant, x.double().numpy(), y.double().numpy(), tn, TMM._GROUP)
    _close(rounded, torch.from_numpy(np.asarray(ref, np.float32)))
    _close(rounded, TMM._plain(variant, x, y))


def test_tile_order_covers_each_tile_once():
    for m, n, tn, group in ((4096, 4096, 256, 8), (784, 4096, 128, 8), (1032, 1032, 128, 8),
                            (1032, 1032, 128, 1), (8192, 4096, 256, 3)):
        ctas = -(-m // BM) * -(-n // tn)
        seen = {_cta_origin(c, m, n, tn, group) for c in range(ctas)}
        assert len(seen) == ctas
        assert all(m0 < m and n0 < n and m0 % BM == 0 and n0 % tn == 0 for m0, n0 in seen)


# ---------------------------------------------------------------------------
# the producer / consumer ring, restated from mm_wgmma_kernel
# ---------------------------------------------------------------------------


class _Barrier:
    """An mbarrier: ``count`` arrivals complete a phase.  A wait names the
    phase it awaits by parity, so a phase may complete only once the one
    before it has been awaited by every thread that waits on it."""

    def __init__(self, count, waiters):
        self.count, self.waiters = count, waiters
        self.pending, self.done, self.awaited = 0, 0, []

    def arrive(self, k=1):
        self.pending += k
        assert self.pending <= self.count
        if self.pending == self.count:
            assert self.done == 0 or len(self.awaited[self.done - 1]) == self.waiters, (
                "a phase completes before the one before it was awaited")
            self.done, self.pending = self.done + 1, 0
            self.awaited.append(set())

    def ready(self, phase, who):
        assert self.done <= phase + 1, "the awaited phase was overrun"
        if self.done == phase + 1:
            self.awaited[phase].add(who)
            return True
        return False


def _producer(ktiles, stages):
    for n in range(ktiles):
        if n >= stages:
            yield ("wait", "empty", n % stages, n // stages - 1)
        # the TMA thread's arrive.expect_tx, completed by the boxes' bytes
        yield ("arrive", "full", n % stages, 1)


def _consumer_warp(ktiles, stages):
    for n in range(ktiles):
        yield ("wait", "full", n % stages, n // stages)
        yield ("mma", n)
        yield ("retired", n - 1)  # wgmma_wait<1>: K-tile n - 1's group
        if n > 0 and n - 1 + stages < ktiles:
            yield ("arrive", "empty", (n - 1) % stages, 1)
    yield ("retired", ktiles - 1)


def _run_cta(ktiles, order, stages):
    """Run the CTA's producer and 8 consumer warps (two warpgroups of 4)
    step by step in ``order`` until none can move.  A warpgroup's MMA of
    K-tile n is issued when its 4 warps have issued it, and retires after
    its MMA of n - 1."""
    bars = {"full": [_Barrier(1, 8) for _ in range(stages)],
            "empty": [_Barrier(8, 1) for _ in range(stages)]}
    agents = {"p": _producer(ktiles, stages),
              **{w: _consumer_warp(ktiles, stages) for w in range(8)}}
    steps = {a: next(g, None) for a, g in agents.items()}
    issued = [[0] * 2 for _ in range(ktiles)]  # warps of each warpgroup issued
    moved = True
    while moved:
        moved = False
        for a in order:
            while steps[a] is not None:
                kind = steps[a][0]
                if kind == "wait":
                    _, name, s, phase = steps[a]
                    if not bars[name][s].ready(phase, a):
                        break
                elif kind == "arrive":
                    _, name, s, k = steps[a]
                    bars[name][s].arrive(k)
                elif kind == "mma":
                    issued[steps[a][1]][a // 4] += 1
                elif kind == "retired":
                    n = steps[a][1]
                    if n >= 0 and issued[n][a // 4] < 4:
                        break
                steps[a] = next(agents[a], None)
                moved = True
    stuck = {a: s for a, s in steps.items() if s is not None}
    assert not stuck, f"{ktiles} K-tiles: deadlock at {stuck}"
    for name, group in bars.items():
        for b in group:
            assert b.pending == 0, f"{name}: a partial phase at exit"
            assert all(len(w) == b.waiters for w in b.awaited), (
                f"{name}: an arrive that no thread awaits")
    assert [b.done for b in bars["full"]] == [
        len(range(s, ktiles, stages)) for s in range(stages)]


# the ring's stages: 128 x 256, 128 x 128
RINGS = [4, 3]


@pytest.mark.parametrize("stages", RINGS)
@pytest.mark.parametrize("ktiles", range(1, 12))
def test_ring_runs_to_its_end(ktiles, stages):
    rng = np.random.RandomState(ktiles)
    agents = ["p", *range(8)]
    orders = [agents, agents[::-1]] + [list(rng.permutation(np.array(agents, object)))
                                       for _ in range(6)]
    for order in orders:
        _run_cta(ktiles, order, stages)


def test_ring_at_the_main_path_depths():
    # K 4096, 784 (12 + a part), 8192, 1032, 64, 16
    for k in (4096, 784, 8192, 1032, 64, 16):
        for stages in RINGS:
            _run_cta(-(-k // BK), ["p", *range(8)], stages)
            _run_cta(-(-k // BK), [*range(8), "p"], stages)
