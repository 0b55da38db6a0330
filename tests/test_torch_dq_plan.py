"""The launch plan of the port's ``dq_mm`` / ``dq_bmm`` / ``dq4_mm`` kernels,
on the CPU.

``kernels.quant.dq_plan`` decides, from shapes and dtypes before launch,
which tile of ``csrc/quant.cu`` a product takes (``dq_mm``'s 2-D int8
product takes ``dq_bmm``'s tiles with one expert) (the tensor-core tiles for
bf16 inside their rule, the SIMT tile for the rest, the plain product above
256 rows) and how K is split when the output tiles cannot fill the card.
The kernels cannot run here, so these tests hold the plan: the kernel's
split rule (``_split_rows``, restated from ``tc_body``) covers K exactly on
whole units (for int4 on group boundaries of both planes) at every plan's
split count, the decode shapes with few output tiles are split until their
CTAs cover the card, the split counts are the fastest that chip_smoke.py's
``dq_split_ab`` timed, and a plain emulation of the kernels' split order
(f32 partials over each split's rows, summed in split order, then scaled,
then cast) agrees with the plain versions and, through them, with the JAX
``_jnp_*`` functions.  On the card, ``dq_split_ab`` holds the kernel's own
split ranges at every split count against the plain version.

Tolerances (``_close``): float32 1e-5 relative plus 1e-6 of the output's
largest magnitude (f32 sums in another order); bfloat16 one ulp of the
output, 2^-7 relative (both sides sum in f32 and round once), as in
``tests/test_torch_quant.py``.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import quant as JQ
from minidiff_tpu_torch.kernels import quant as TQ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 1e-6)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16 = torch.bfloat16


def _close(got, ref, dtype: str):
    got = got.to(torch.float64).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    ref = ref.to(torch.float64).numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float64)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


# the 2-D int8 products (dq_mm) of the main path, (bits, rows, n, k, group,
# experts): the int8 model's decode (8 rows) and bench prefill (128 rows)
# projections at V512 d1024 (QKV, out, fc1, fc2, the head; the MoE model's
# attention projections, 8 heads over 4 KV heads, are [1024, 1024] like out)
DQ_MM = [(8, m, n, k, None, 1) for m in (8, 128)
         for k, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024), (1024, 512))]

# (bits, rows, n, k, group, experts): the main path's shapes (the MoE
# model's banks at decode and at the bench prefill, the int4 model's decode
# and prefill projections, V512 d1024, the int8 model's 2-D products), int4
# groups 64 and 256, a ragged N, one row, five rows per expert, and an int8
# K that is no multiple of a stage
SHAPES = DQ_MM + [
    (8, 8, 4096, 1024, None, 8), (8, 8, 1024, 2048, None, 8),
    (8, 128, 4096, 1024, None, 8), (8, 5, 4096, 1024, None, 8),
    (8, 8, 520, 1024, None, 8), (8, 40, 512, 1040, None, 3), (8, 1, 520, 1024, None, 1),
    (4, 8, 3072, 1024, 128, 1), (4, 8, 1024, 1024, 128, 1),
    (4, 8, 4096, 1024, 128, 1), (4, 8, 512, 1024, 128, 1),
    (4, 8, 1024, 4096, 128, 1), (4, 128, 3072, 1024, 128, 1),
    (4, 128, 4096, 1024, 128, 1), (4, 128, 1024, 4096, 128, 1),
    (4, 8, 3072, 1024, 64, 1), (4, 128, 3072, 1024, 256, 1),
    (4, 1, 1024, 1024, 128, 1), (4, 16, 520, 1024, 128, 1),
    (4, 200, 1024, 4096, 64, 1),
]


def _plan(bits, rows, n, k, group, experts, dtype=BF16):
    return TQ.dq_plan(bits, rows, n, k, dtype, group=group, experts=experts)


def _unit(bits, group, tile):
    """The stored weight rows of a split unit, as the kernel takes them
    (quant.cu tc_body): one stage for int8, one scale group for int4."""
    return group if bits == 4 else TQ.TILES[bits][tile][2]


def _split_rows(stored, unit, splits):
    """The stored rows [begin, end) of each split, by the kernel's rule
    (quant.cu tc_body): split s takes units [s * units // S, (s + 1) *
    units // S)."""
    units = -(-stored // unit)
    return [(s * units // splits * unit, min(stored, (s + 1) * units // splits * unit))
            for s in range(splits)]


@pytest.mark.parametrize("bits,rows,n,k,group,experts", SHAPES)
def test_splits_cover_k_on_unit_boundaries(bits, rows, n, k, group, experts):
    plan = _plan(bits, rows, n, k, group, experts)
    stored = k // 2 if bits == 4 else k
    assert plan.tile != "simt"
    tr, tc, stage = TQ.TILES[bits][plan.tile]
    # the unit: one stage for int8; one scale group for int4, which the
    # stages divide, so that every stage lies in one group of each plane
    unit = _unit(bits, group, plan.tile)
    assert unit % stage == 0
    bounds = _split_rows(stored, unit, plan.splits)
    assert len(bounds) == plan.splits >= 1
    assert bounds[0][0] == 0 and bounds[-1][1] == stored
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1  # contiguous: each stored row in exactly one split
    for b, e in bounds:
        assert e > b and b % unit == 0
        assert e % unit == 0 or e == stored
        if bits == 4:  # group boundaries of the low and the high plane
            assert b % group == 0 and (stored + b) % group == 0
            assert e % group == 0 and (stored + e) % group == 0
    units = -(-stored // unit)
    # the splits of a tile are the CTAs of one cluster: a power of two
    assert plan.splits <= min(units, TQ.MAX_SPLITS)
    assert plan.splits & (plan.splits - 1) == 0
    tiles = experts * -(-rows // tr) * -(-n // tc)
    assert plan.ctas == tiles * plan.splits
    # the splits double while the doubled count of CTAs stays within the
    # tile's SPLIT_CTAS and the units allow
    cap = TQ.SPLIT_CTAS[plan.tile]
    assert (plan.splits > 1) == (2 * tiles <= cap and units > 1)
    assert tiles * plan.splits <= cap or plan.splits == 1
    assert 2 * tiles * plan.splits > cap or 2 * plan.splits > min(units, TQ.MAX_SPLITS)


@pytest.mark.parametrize("bits,rows,n,k,group,experts", [
    (4, 8, 1024, 4096, 128, 1),   # int4 decode fc2: 16 output tiles
    (8, 8, 1024, 2048, None, 8),  # the MoE decode step's w2 bank: 128
    (4, 8, 3072, 1024, 128, 1),   # int4 decode QKV: 48
    (4, 8, 4096, 1024, 128, 1),   # int4 decode fc1: 64
])
def test_decode_shapes_with_few_tiles_split_to_cover_the_card(
        bits, rows, n, k, group, experts):
    plan = _plan(bits, rows, n, k, group, experts)
    tiles = plan.ctas // plan.splits
    assert tiles < TQ.SMS
    assert plan.splits > 1 and plan.ctas >= TQ.SMS
    # half the splits would not cover the card
    assert tiles * (plan.splits // 2) < TQ.SMS


@pytest.mark.parametrize("bits,rows,n,k,group,experts", [
    (8, 8, 4096, 1024, None, 8),    # the decode step's w1 bank: 512 tiles
    (8, 128, 4096, 1024, None, 8),  # the bench prefill's bank: 128 tiles, one per SM
    (8, 5, 4096, 1024, None, 8),
])
def test_shapes_that_fill_the_card_are_not_split(bits, rows, n, k, group, experts):
    plan = _plan(bits, rows, n, k, group, experts)
    assert plan.splits == 1 and 2 * plan.ctas > TQ.SPLIT_CTAS[plan.tile]
    assert _split_rows(k, _unit(bits, group, plan.tile), plan.splits) == [(0, k)]


@pytest.mark.parametrize("bits,rows,n,k,group,experts,splits", [
    (8, 128, 1024, 2048, None, 8, 2),   # the bench prefill's w2 bank: large
    (8, 128, 4096, 1024, None, 8, 1),   # its w1 bank
    (4, 128, 3072, 1024, 128, 1, 4),    # int4 prefill QKV: large
    (4, 128, 4096, 1024, 128, 1, 2),    # fc1
    (4, 128, 1024, 4096, 128, 1, 8),    # fc2
    (8, 8, 1024, 2048, None, 8, 2),     # the decode step's w2 bank: small8
    (4, 8, 1024, 4096, 128, 1, 16),     # int4 decode fc2
    (4, 8, 3072, 1024, 128, 1, 4),      # int4 decode QKV
    (8, 128, 3072, 1024, None, 1, 8),   # int8 prefill QKV (dq_mm): large
    (8, 128, 1024, 4096, None, 1, 16),  # its fc2
    (8, 128, 4096, 1024, None, 1, 4),   # its fc1
])
def test_split_counts_are_the_fastest_timed(bits, rows, n, k, group, experts, splits):
    # chip_smoke.py's dq_split_ab timed each of these shapes at every split
    # count its units allow (PERF.md §6): the plan takes the fastest
    assert _plan(bits, rows, n, k, group, experts).splits == splits


# dq_mm at decode (small8), us at each split count from chip_smoke.py's
# dq_split_ab (PERF.md §6): the rule's count is within 3% of the fastest,
# not the fastest.  The rule stays: no cap on a launch's CTAs fits every
# int8 small-tile reading (capping at the SMs would take fc2 to its fastest
# x8 but cost the MoE decode's w2 bank 4%: x1 against its fastest x2)
DECODE_READINGS = [
    ((8, 8, 3072, 1024, None, 1), {1: 6.19, 2: 5.55, 4: 5.60, 8: 5.99, 16: 6.93}),
    ((8, 8, 1024, 4096, None, 1), {1: 16.49, 2: 10.52, 4: 7.11, 8: 6.63, 16: 6.69}),
    ((8, 8, 1024, 2048, None, 8), {1: 9.76, 2: 9.39, 4: 10.03, 8: 12.60, 16: 16.69}),
]


@pytest.mark.parametrize("shape,us", DECODE_READINGS)
def test_decode_split_counts_within_3_percent_of_the_fastest_timed(shape, us):
    plan = _plan(*shape)
    k = shape[3]
    assert set(us) == {n for n in (1, 2, 4, 8, 16) if n <= k // 64}  # every count its units allow
    assert us[plan.splits] <= 1.03 * min(us.values())
    # a cap at the SMs misses the w2 bank's fastest by more
    w2 = DECODE_READINGS[2][1]
    assert w2[1] > 1.03 * min(w2.values())


@pytest.mark.parametrize("bits,rows,n,k,group,dtype,tile", [
    (8, 8, 4096, 1024, None, torch.float32, "simt"),   # f32: FFMA, no TF32
    (4, 8, 4096, 1024, 128, torch.float32, "simt"),
    (4, 128, 3072, 1024, 128, torch.float32, "simt"),
    (8, 8, 4096, 1000, None, BF16, "simt"),             # K % 16
    (4, 8, 4096, 1000, 125, BF16, "simt"),
    (8, 8, 516, 1024, None, BF16, "simt"),              # n % 8
    (4, 128, 1024, 1024, 16, BF16, "simt"),
    (4, 8, 1024, 1024, 32, BF16, "small8"),             # a stage of 32 packed rows
    (4, 8, 1024, 384, 128, BF16, "simt"),               # K/2 % group
    (4, 8, 1024, 1024, 64, BF16, "small8"),
    (4, 128, 1024, 1024, 64, BF16, "large"),
    (8, 1, 1024, 1024, None, BF16, "small8"),
    (8, 8, 1024, 1024, None, BF16, "small8"),
    (8, 9, 1024, 1024, None, BF16, "small16"),
    (4, 16, 1024, 1024, 256, BF16, "small16"),
    (8, 17, 1024, 1024, None, BF16, "large"),
    (8, 256, 1024, 1024, None, BF16, "large"),
    (8, 8, 520, 1024, None, BF16, "small8"),            # ragged n, masked
    (8, 8, 3072, 1024, None, BF16, "small8"),           # dq_mm: decode QKV
    (8, 16, 3072, 1024, None, BF16, "small16"),         # a 16-token bucket
    (8, 128, 1024, 4096, None, BF16, "large"),          # prefill fc2
    (8, 128, 3072, 1024, None, torch.float32, "simt"),  # f32 dq_mm
    (8, 257, 1024, 1024, None, BF16, "matmul"),         # > 256 rows
    (4, 384, 1024, 1024, 128, torch.float32, "matmul"),
])
def test_route_rule(bits, rows, n, k, group, dtype, tile):
    plan = TQ.dq_plan(bits, rows, n, k, dtype, group=group)
    assert plan.tile == tile
    assert TQ.uses_kernel(rows) == (tile != "matmul")
    if tile in ("simt", "matmul"):
        assert plan.splits == 1
    if tile != "matmul":
        assert plan.tile in TQ.TILE_CODES and plan.tile in TQ.TILES[bits]


def _emulate(bits, x, w, s, plan, group):
    """The kernels' arithmetic by ``plan``: per split, the f32 product over
    its stored rows (for int4, the low plane's rows against x's columns
    [b, e) and the high plane's against [K/2 + b, K/2 + e), on the weight
    rounded to x's dtype); the partials summed in split order, then scaled
    by the column scales (int8: (N,) for a 2-D product, (E, N) for a bank),
    then cast to x's dtype."""
    f32 = torch.float32
    total = None
    if bits == 4:
        kh = w.shape[0]
        wd = TQ._dequantized4(w, s, x.dtype).to(f32)
    stored = w.shape[-2]
    for b, e in _split_rows(stored, _unit(bits, group, plan.tile), plan.splits):
        if bits == 8:
            part = x[..., b:e].to(f32) @ w[..., b:e, :].to(f32)
        else:
            part = (x[:, b:e].to(f32) @ wd[b:e]
                    + x[:, kh + b:kh + e].to(f32) @ wd[kh + b:kh + e])
        total = part if total is None else total + part
    if bits == 8:
        total = total * (s if s.dim() == 1 else s[:, None, :])
    return total.to(x.dtype)


# (bits, rows, n, k, group, experts) at a small size; every plan splits K
EMULATED = [(8, 5, 136, 256, None, 3), (8, 16, 64, 320, None, 2),
            (8, 40, 256, 256, None, 2), (4, 8, 200, 512, 64, 1),
            (4, 1, 128, 1024, 128, 1), (4, 48, 128, 512, 64, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,rows,n,k,group,experts", EMULATED)
def test_split_emulation_matches_plain_and_jax(bits, rows, n, k, group, experts,
                                               dtype):
    # the bf16 plan's splits, emulated in both dtypes: f32 holds the split
    # arithmetic tightly, bf16 at the kernels' own dtype
    plan = _plan(bits, rows, n, k, group, experts)
    assert plan.tile != "simt" and plan.splits > 1
    rng = np.random.RandomState(bits * 1000 + rows + n)
    w = rng.standard_normal((experts, k, n) if bits == 8 else (k, n)).astype(np.float32)
    x = rng.standard_normal((experts, rows, k) if bits == 8 else (rows, k))
    x = x.astype(np.float32)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    xj = jnp.asarray(x, _JNP[dtype])
    if bits == 8:
        qj, sj = JQ.quantize_int8_stacked(jnp.asarray(w))
        qt, st = TQ.quantize_int8_stacked(torch.from_numpy(w))
        plain = TQ._plain_dequant_bmm(xt, qt, st)
        ref = JQ._jnp_dequant_bmm(xj, qj, sj)
    else:
        qj, sj = JQ.quantize_int4(jnp.asarray(w), group=group)
        qt, st = TQ.quantize_int4(torch.from_numpy(w), group=group)
        plain = TQ._plain_dequant_matmul4(xt, qt, st)
        ref = JQ._jnp_dequant_matmul4(xj, qj, sj)
    got = _emulate(bits, xt, qt, st, plan, group)
    assert got.dtype == _TORCH[dtype] and got.shape == plain.shape
    _close(got, plain, dtype)
    _close(plain, ref, dtype)
    _close(got, ref, dtype)


# (rows, n, k) of 2-D int8 products (dq_mm) at a small size, each plan split
# on its tile (small8, small16, large); N a multiple of the interpret-mode
# kernel's 256-column tile
EMULATED_2D = [(8, 256, 512), (16, 256, 256), (40, 512, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,k", EMULATED_2D)
def test_dq_mm_split_emulation_matches_plain_and_jax(rows, n, k, dtype, monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    plan = _plan(8, rows, n, k, None, 1)
    assert plan.tile != "simt" and plan.splits > 1
    rng = np.random.RandomState(rows + n + k)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    xj = jnp.asarray(x, _JNP[dtype])
    qj, sj = JQ.quantize_int8(jnp.asarray(w))
    qt, st = TQ.quantize_int8(torch.from_numpy(w))
    plain = TQ._plain_dequant_matmul(xt, qt, st)
    got = _emulate(8, xt, qt, st, plan, None)
    assert got.dtype == _TORCH[dtype] and got.shape == (rows, n)
    _close(got, plain, dtype)
    for ref in (JQ._jnp_dequant_matmul(xj, qj, sj), JQ._pallas_dequant_matmul(xj, qj, sj)):
        _close(plain, ref, dtype)
        _close(got, ref, dtype)
