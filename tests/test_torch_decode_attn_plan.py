"""The launch plans of the port's split decode-attention kernels, and their
split arithmetic, on the CPU.

``kernels.paged.paged_plan`` and ``kernels.quant.sdpa_int8_plan`` decide,
from shapes only and before launch, over how many CTAs of one thread-block
cluster ``csrc/paged.cu``'s ``paged_attn`` and ``csrc/quant.cu``'s
``sdpa_int8`` split each (row or slot, kv head), and how much shared memory
each CTA takes.  The kernels cannot run here, so these tests hold:

- the plans: at most ``MAX_SPLITS`` (16) splits, a power of two, and at
  most the 232,448 bytes an H100 CTA may use, at every shape on the port's
  paths and over a grid of shapes, among them ``sdpa_int8`` at g 4, head
  dim 128 and L 16,384 and 65,536, which the one-CTA kernel refused; every
  g <= 8 at c = 1 and L <= 65,536 fits, and past 16 splits the plan
  raises;
- each kernel's split arithmetic, restated in torch split by split in the
  kernel's order (``_paged_split`` and ``_sdpa_split``): against the plain
  versions and the JAX package's references and interpret-mode Pallas
  kernels, at 1, 2, 4 and 16 splits, with a split that gets no live page or
  key, a split that the window band masks entirely, ``pos`` on a page
  boundary, ``pos < 0`` and GQA at g 4;
- the split counts the plans hard-code: the fastest chip_smoke.py's
  ``decode_split_ab`` timed, or within 3% of it.

Tolerances (``_close``), as ``tests/test_torch_paged.py`` states them:
float32 1e-5 relative plus 1e-6 of the largest magnitude (the same f32
algebra in another summation order); bfloat16 2^-6 relative plus 2^-7 of
the largest (chip_smoke.py's ``TOL["attn"]``).  In bfloat16 the split
``paged_attn`` rounds the unnormalised probabilities against its split's
running max where the reference rounds the normalised ones (and the Pallas
kernel against its own running max); the split ``sdpa_int8`` rounds the
normalised p * vs at the plain version's point, but from f32 sums taken in
another order, which can move a rounding by one bf16 ulp.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import paged as JP
from minidiff_tpu.kernels import quant as JQ
from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels import paged as TP
from minidiff_tpu_torch.kernels import quant as TQ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAGE = TP.PAGE
LIMIT = 232448
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -6, 2 ** -7)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEG = -1e30
# the JAX references, each compiled once per shape (eagerly, each of their
# operations would compile apart)
_paged_ref = jax.jit(JP.paged_attention_reference, static_argnums=(5, 6, 7))
_sdpa_ref = jax.jit(JQ._jnp_sdpa_int8, static_argnums=(6, 7))


def _close(got, ref, dtype: str):
    got = np.asarray(got.to(torch.float64) if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    rtol, atol = TOL[dtype]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# (b, kv, g, hd, maxp) on the port's paths: chip_smoke.py's paged cases
# and paged server (8 slots, window 1024), the MoE model's paged server (8
# over 4 KV heads, window 256), the paged tests' shapes
PAGED_PATHS = [(8, 8, 1, 128, 8), (8, 2, 1, 256, 8), (8, 8, 4, 128, 8), (8, 4, 2, 128, 2),
               (2, 2, 1, 128, 4), (3, 2, 4, 128, 3), (2, 1, 2, 128, 4), (2, 2, 2, 64, 3),
               (2, 1, 2, 256, 3), (1, 1, 1, 64, 1), (4, 8, 8, 128, 64)]
# (b, kv, gc, hd, L) on the port's paths: chip_smoke.py's sdpa cases (the
# bench decode, the long-context decode, head dim 256, Mistral-7B's
# grouping at L 16,384), the int8-KV decode of the options model, a
# speculative chunk of 4 at g 2
SDPA_PATHS = [(8, 8, 1, 128, 256), (4, 8, 1, 128, 4096), (8, 2, 1, 256, 256),
              (1, 8, 4, 128, 16384), (8, 8, 4, 128, 1024), (2, 4, 8, 128, 512),
              (1, 8, 4, 128, 65536)]


def _paged_grid():
    for b in (1, 2, 8, 32):
        for kv in (1, 2, 8):
            for g in (1, 2, 3, 4, 8, 12):
                for hd in (64, 128, 256):
                    for maxp in (1, 3, 8, 64):
                        yield b, kv, g, hd, maxp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_plan_fits_a_cluster_and_the_block(dtype):
    for b, kv, g, hd, maxp in PAGED_PATHS + list(_paged_grid()):
        plan = TP.paged_plan(b, kv, g, hd, maxp, dtype)
        assert 1 <= plan.splits <= TP.MAX_SPLITS and plan.splits & (plan.splits - 1) == 0
        assert plan.splits <= maxp  # each split may get a page
        assert plan.smem <= LIMIT and plan.ctas == b * kv * plan.splits
        assert plan.rows == (1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else 8)
        # every count the split A/B times fits too
        for n in (1, 2, 4, 8, 16):
            assert TP.paged_plan(b, kv, g, hd, maxp, dtype, splits=n).smem <= LIMIT


def test_paged_ring_stages():
    # a quarter page of K or V per stage, 2-8 stages within 32 KB, or two:
    # f32 at head dim 256 (whose K and V pages the one-CTA kernel had to
    # share) takes two stages of 32 KB
    assert TP.paged_plan(8, 2, 1, 256, 8, torch.float32).stages == 2
    assert TP.paged_plan(8, 2, 1, 256, 8, torch.bfloat16).stages == 2
    assert TP.paged_plan(8, 8, 1, 128, 8, torch.bfloat16).stages == 4
    assert TP.paged_plan(8, 8, 1, 64, 8, torch.bfloat16).stages == 8


def _sdpa_grid():
    for b in (1, 4, 8):
        for kv in (1, 8):
            for gc in (1, 2, 3, 4, 6, 8):
                for hd in (64, 128, 256):
                    for L in (1, 100, 256, 4096, 16384, 65536):
                        yield b, kv, gc, hd, L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_int8_plan_fits_a_cluster_and_the_block(dtype):
    for b, kv, gc, hd, L in SDPA_PATHS + list(_sdpa_grid()):
        plan = TQ.sdpa_int8_plan(b, kv, gc, hd, L, dtype)
        assert 1 <= plan.splits <= TQ.MAX_SPLITS and plan.splits & (plan.splits - 1) == 0
        assert plan.smem <= LIMIT and plan.ctas == b * kv * plan.splits
        # never fewer than the least count whose score slice fits the block
        least = min(n for n in (1, 2, 4, 8, 16)
                    if TQ.sdpa_int8_plan(b, kv, gc, hd, L, dtype, splits=n).smem <= LIMIT)
        assert plan.splits >= least


def test_sdpa_int8_plan_takes_every_group_to_8_at_64k():
    # g <= 8 at c = 1 and L <= 65,536, every head dim: the scores of a split
    # fit at 16 splits at most (the smem grows with L, so L 65,536 bounds it)
    for hd in (64, 128, 256):
        for gc in range(1, 9):
            plan = TQ.sdpa_int8_plan(1, 8, gc, hd, 65536, torch.bfloat16)
            assert plan.smem <= LIMIT
    # the shapes the one-CTA kernel refused (its f32 scores of a whole
    # (row, head) above 13,376 keys at g 4): 16,384 at 4 splits or more
    one_cta = (4 * 128 + 4 * 16384 + 8 * 4 * 128) * 4
    assert one_cta > LIMIT
    assert TQ.sdpa_int8_plan(1, 8, 4, 128, 16384, torch.bfloat16).splits >= 2
    assert TQ.sdpa_int8_plan(1, 8, 4, 128, 65536, torch.bfloat16).splits == 16


def test_sdpa_int8_plan_raises_past_16_splits():
    with pytest.raises(ValueError, match="MAX_SPLITS = 16"):
        TQ.sdpa_int8_plan(1, 8, 8, 256, 80000, torch.bfloat16)
    with pytest.raises(ValueError, match="MAX_SPLITS"):
        TQ.sdpa_int8_plan(1, 1, 64, 128, 16384, torch.bfloat16)
    # the CPU path runs the plain version, as before, whatever the length
    q = torch.zeros(1, 8, 1, 128)
    k8 = torch.zeros(1, 1, 16, 128, dtype=torch.int8)
    s = torch.ones(1, 1, 16)
    assert TQ.sdpa_int8_cache(q, k8, s, k8, s, torch.tensor([3])).shape == q.shape


def test_plans_read_shapes_only():
    # the plans take no positions: the same shapes give the same plan
    assert TP.paged_plan(8, 8, 1, 128, 8, torch.bfloat16) == \
        TP.paged_plan(8, 8, 1, 128, 8, torch.bfloat16)
    assert "pos" not in TP.paged_plan.__code__.co_varnames
    assert "pos" not in TQ.sdpa_int8_plan.__code__.co_varnames
    assert _build.SMEM_LIMIT == LIMIT


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------


def _paged_split(q, pool_k, pool_v, table, pos, scale, window, sinks, splits):
    """csrc/paged.cu's split kernel restated: for each (slot, kv head), split
    s walks pages [s n / S, (s + 1) n / S) of n = min(maxp, max(pos, 0) /
    PAGE + 1) with the online softmax (f32 scores, p = exp(s - m_new)
    rounded to the pool dtype before PV, l summed unrounded), then the
    splits combine in rank order: m = max m_s, l = sum l_s e^(m_s - m),
    out = sum acc_s e^(m_s - m) / l."""
    b, kv, g, hd = q.shape
    maxp = table.shape[1]
    dt = pool_k.dtype
    out = torch.empty(b, kv, g, hd)
    for bi in range(b):
        p = int(pos[bi])
        n = min(maxp, max(p, 0) // PAGE + 1)
        qf = q[bi].float()  # (kv, g, hd)
        parts = []
        for s in range(splits):
            m = torch.full((kv, g, 1), NEG)
            l = torch.zeros(kv, g, 1)
            acc = torch.zeros(kv, g, hd)
            for pg in range(s * n // splits, (s + 1) * n // splits):
                pid = int(table[bi, pg])
                k = pool_k[pid].float()  # (kv, PAGE, hd)
                v = pool_v[pid].float()
                sc = torch.einsum("kgd,kld->kgl", qf, k) * scale
                lg = pg * PAGE + torch.arange(PAGE)
                sc = torch.where(TP._mask(lg, p, window, sinks), sc, torch.full_like(sc, NEG))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                e = torch.exp(sc - m_new)
                l = l * alpha + e.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("kgl,kld->kgd", e.to(dt).float(), v)
                m = m_new
            parts.append((m, l, acc))
        mg = parts[0][0]
        for m_s, _, _ in parts[1:]:
            mg = torch.maximum(mg, m_s)
        lt, ot = torch.zeros(kv, g, 1), torch.zeros(kv, g, hd)
        for m_s, l_s, a_s in parts:  # rank order
            w = torch.exp(m_s - mg)
            lt = lt + l_s * w
            ot = ot + a_s * w
        out[bi] = ot / lt
    return out.to(q.dtype)


def _paged_inputs(b, kv, g, hd, maxp, seed, dtype):
    rng = np.random.default_rng(seed)
    npages = 1 + b * maxp
    pk = rng.standard_normal((npages, kv, PAGE, hd)).astype(np.float32)
    pv = rng.standard_normal((npages, kv, PAGE, hd)).astype(np.float32)
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    table = (1 + rng.permutation(npages - 1)).reshape(b, maxp).astype(np.int32)
    t = [torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, pk, pv)]
    j = [jnp.asarray(a, _JNP[dtype]) for a in (q, pk, pv)]
    return t, j, table


# (g, pos per slot, window, sinks, splits) for 2 slots of 2 KV heads at
# head dim 64 over 4 pages: pos on a page boundary (the first and the last
# key of a page), splits with no live page (3 pages over 4 and 16 splits),
# a split the window band masks entirely (pos in page 3, window 100 and 2
# sinks: pages 1 and 2 hold no visible key at 4 splits), GQA at g 4, and
# one split (the one-CTA walk).  The interpret-mode Pallas kernels (about a
# second a call) run at PALLAS_CASES
PAGED_SPLIT_CASES = {
    "s1_boundary": (1, [128, 255], None, 0, 1),
    "s2_gqa4": (4, [300, 511], None, 0, 2),
    "s4_empty_split": (4, [256, 383], None, 0, 4),
    "s16_empty_splits": (1, [129, 400], None, 0, 16),
    "s4_window_masks_a_split": (4, [420, 511], 100, 2, 4),
    "s16_window_gqa4": (4, [500, 290], 300, 4, 16),
    "s2_boundary_first_key": (1, [0, 256], None, 0, 2),
}
PALLAS_CASES = {"s16_window_gqa4", "s4_neg_pos_chunk4"}


@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_matches_plain_and_jax(case, dtype):
    g, pos, window, sinks, splits = PAGED_SPLIT_CASES[case]
    (q, pk, pv), (jq, jpk, jpv), table = _paged_inputs(
        2, 2, g, 64, 4, list(PAGED_SPLIT_CASES).index(case), dtype)
    pos = np.array(pos, np.int32)
    scale = 64 ** -0.5
    got = _paged_split(q, pk, pv, torch.from_numpy(table), pos, scale, window, sinks, splits)
    plain = TP.paged_attention(q, pk, pv, torch.from_numpy(table), torch.from_numpy(pos),
                               window=window, sinks=sinks)
    _close(got, plain.float(), dtype)
    refs = [_paged_ref(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(pos), scale, window,
                       sinks)]
    if case in PALLAS_CASES:
        refs.append(JP._pallas_paged_attention(jq, jpk, jpv, jnp.asarray(table),
                                               jnp.asarray(pos), scale, window, sinks,
                                               interpret=True))
    for ref in refs:
        _close(got, np.asarray(ref, np.float32), dtype)


def test_paged_split_at_a_dead_slot_is_page_0s_mean():
    # pos < 0: the kernel reads page 0 only, every key masked, so each split
    # holds m = -1e30 and the combine weighs them all by 1: the mean of page
    # 0's V rows, finite, as the reference over the pages read (the JAX
    # Pallas kernel, which reads no page, and the one-CTA kernel give 0 / 0)
    (q, pk, pv), (jq, jpk, jpv), table = _paged_inputs(2, 2, 4, 64, 4, 9, "float32")
    pos = np.array([-1, 200], np.int32)
    read = np.asarray(_paged_ref(jq, jpk, jpv, jnp.asarray(table[:, :1]), jnp.asarray(pos),
                                 0.125, None, 0))
    full = np.asarray(_paged_ref(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(pos), 0.125,
                                 None, 0))
    for splits in (1, 2, 16):
        got = _paged_split(q, pk, pv, torch.from_numpy(table), pos, 0.125, None, 0, splits)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[0], pv[table[0, 0]].mean(1, keepdim=True).expand(2, 4, 64),
                                   rtol=1e-5, atol=1e-6)
        _close(got[0], read[0], "float32")
        _close(got[1], full[1], "float32")


def _sdpa_split(qg, k8, ks, v8, vs, pos, c, scale, splits):
    """csrc/quant.cu's split sdpa_int8 restated: split s scores the keys of
    units [s U / S, (s + 1) U / S) of [0, l_end) (16-key units) in f32,
    masked l <= pos + row % c; the global max and then the global sum come
    from the splits' values in rank order; each split rounds the normalised
    p * vs to q's dtype and sums it against v8 in f32; the partials are
    summed in rank order."""
    b, kv, gc, hd = qg.shape
    L = k8.shape[2]
    out = torch.empty(b, kv, gc, hd)
    rows = (torch.arange(gc) % c).reshape(1, gc, 1)
    for bi in range(b):
        p = int(pos[bi])
        l_end = min(L, p + c) if p >= 0 else L
        units = -(-l_end // 16)
        spans = [(16 * (s * units // splits), min(16 * ((s + 1) * units // splits), l_end))
                 for s in range(splits)]
        scores = []
        for k0, k1 in spans:
            ln = torch.arange(k0, max(k0, k1))
            sc = torch.einsum("kqd,kld->kql", qg[bi].float(), k8[bi, :, k0:k1].float())
            sc = sc * (ks[bi, :, k0:k1].float() * scale)[:, None, :]
            scores.append(torch.where(ln.reshape(1, 1, -1) <= p + rows, sc,
                                      torch.full_like(sc, NEG)))
        m = torch.full((kv, gc, 1), NEG)
        for sc in scores:
            if sc.shape[-1]:
                m = torch.maximum(m, sc.amax(-1, keepdim=True))
        total = torch.zeros(kv, gc, 1)
        for sc in scores:  # rank order
            total = total + torch.exp(sc - m).sum(-1, keepdim=True)
        acc = torch.zeros(kv, gc, hd)
        for (k0, k1), sc in zip(spans, scores):
            pv = (torch.exp(sc - m) / total * vs[bi, :, k0:k1].float()[:, None, :]).to(qg.dtype)
            acc = acc + torch.einsum("kql,kld->kqd", pv.float(), v8[bi, :, k0:k1].float())
        out[bi] = acc
    return out.to(qg.dtype)


def _sdpa_inputs(b, kv, gc, hd, L, seed, dtype):
    """The same cache on both sides: codes and scales from the port's
    quantizer (bit-identical to the JAX one, tests/test_torch_quant.py)."""
    rng = np.random.RandomState(seed)
    k8, ks = TQ.quantize_int8_rows(torch.from_numpy(rng.standard_normal((b, kv, L, hd))))
    v8, vs = TQ.quantize_int8_rows(torch.from_numpy(rng.standard_normal((b, kv, L, hd))))
    q = rng.standard_normal((b, kv, gc, hd)).astype(np.float32)
    t = (torch.from_numpy(q).to(_TORCH[dtype]), k8, ks, v8, vs)
    j = (jnp.asarray(q, _JNP[dtype]), *(jnp.asarray(a.numpy()) for a in (k8, ks, v8, vs)))
    return t, j


# (g, c, pos per row, splits) for 2 rows of 2 KV heads at head dim 128 over
# L 256: splits with no live key (pos 20 at 16 splits: 2 units), pos < 0
# (every key read, the softmax uniform where a row sees none), GQA at g 4,
# chunks of 2 and 4, one split (the one-CTA kernel's order)
SDPA_SPLIT_CASES = {
    "s1": (1, 1, [7, 200], 1),
    "s2_gqa4": (4, 1, [130, 255], 2),
    "s4_chunk2": (2, 2, [64, 190], 4),
    "s16_empty_splits": (1, 1, [20, 255], 16),
    "s16_neg_pos_gqa4": (4, 1, [-1, 100], 16),
    "s4_neg_pos_chunk4": (1, 4, [-2, 30], 4),
    "s8_gqa4": (4, 1, [255, 177], 8),
}


@pytest.mark.parametrize("case", list(SDPA_SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_int8_split_matches_plain_and_jax(case, dtype):
    g, c, pos, splits = SDPA_SPLIT_CASES[case]
    hd = 128
    (q, k8, ks, v8, vs), (jq, jk8, jks, jv8, jvs) = _sdpa_inputs(
        2, 2, g * c, hd, 256, list(SDPA_SPLIT_CASES).index(case), dtype)
    pos = np.array(pos, np.int32)
    scale = hd ** -0.5
    got = _sdpa_split(q, k8, ks, v8, vs, pos, c, scale, splits)
    plain = TQ._plain_sdpa_int8(q, k8, ks, v8, vs, torch.from_numpy(pos), c, scale)
    _close(got, plain.float(), dtype)
    refs = [_sdpa_ref(jq, jk8, jks, jv8, jvs, jnp.asarray(pos), c, scale)]
    if case in PALLAS_CASES:
        refs.append(JQ._pallas_sdpa_int8(jq, jk8, jks, jv8, jvs, jnp.asarray(pos), c, scale,
                                         interpret=True))
    for ref in refs:
        _close(got, np.asarray(ref, np.float32), dtype)


def test_sdpa_int8_split_spans_cover_the_live_keys():
    # the kernel's key ranges: every live key in exactly one split, on
    # 16-key boundaries, each at most split_keys(L, S) long (its scores'
    # shared memory)
    for L in (1, 15, 16, 100, 256, 4096, 16384):
        for pos in (-1, 0, 5, L // 2, L - 1):
            for c in (1, 3):
                for splits in (1, 2, 4, 8, 16):
                    l_end = min(L, pos + c) if pos >= 0 else L
                    units = -(-l_end // 16)
                    covered = []
                    for s in range(splits):
                        k0 = 16 * (s * units // splits)
                        k1 = min(16 * ((s + 1) * units // splits), l_end)
                        assert k0 % 16 == 0 and max(k1 - k0, 0) <= TQ.split_keys(L, splits)
                        covered += range(k0, k1)
                    assert covered == list(range(l_end))


# ---------------------------------------------------------------------------
# the measured split counts
# ---------------------------------------------------------------------------

# us at each split count from chip_smoke.py's decode_split_ab (bf16, NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md §6), at the (b, kv, g, hd, maxp) of
# chip_smoke.py's PAGED_CASES with every page of the table live, and the
# (b, kv, gc, hd, L) of its SDPA_CASES
PAGED_READINGS = [
    ((8, 8, 1, 128, 8), {1: 46.02, 2: 25.83, 4: 21.77, 8: 18.83, 16: 32.97}),
    ((8, 2, 1, 256, 8), {1: 73.31, 2: 39.43, 4: 21.85, 8: 16.61, 16: 21.01}),
    ((8, 8, 4, 128, 8), {1: 63.80, 2: 34.83, 4: 28.91, 8: 30.12, 16: 52.62}),
]
SDPA_READINGS = [
    ((8, 8, 1, 128, 256), {1: 8.38, 2: 9.01, 4: 10.58, 8: 18.54, 16: 34.69}),
    ((4, 8, 1, 128, 4096), {1: 92.29, 2: 43.63, 4: 31.89, 8: 25.56, 16: 31.51}),
    ((8, 2, 1, 256, 256), {1: 10.65, 2: 10.74, 4: 8.90, 8: 9.81, 16: 11.20}),
    ((1, 8, 4, 128, 16384), {2: 348.81, 4: 179.86, 8: 94.48, 16: 68.28}),
]


@pytest.mark.parametrize("shape,us", PAGED_READINGS)
def test_paged_split_counts_within_3_percent_of_the_fastest_timed(shape, us):
    assert set(us) == {1, 2, 4, 8, 16}
    plan = TP.paged_plan(*shape, torch.bfloat16)
    assert us[plan.splits] <= 1.03 * min(us.values())


@pytest.mark.parametrize("shape,us", SDPA_READINGS)
def test_sdpa_int8_split_counts_within_3_percent_of_the_fastest_timed(shape, us):
    # every count whose scores fit a CTA was timed (L 16,384 at g 4 needs 2)
    b, kv, gc, hd, L = shape
    fits = {n for n in (1, 2, 4, 8, 16)
            if TQ.sdpa_int8_plan(b, kv, gc, hd, L, torch.bfloat16, splits=n).smem <= LIMIT}
    assert set(us) == fits
    plan = TQ.sdpa_int8_plan(*shape, torch.bfloat16)
    assert us[plan.splits] <= 1.03 * min(us.values())


def test_paged_plan_sizes_a_slot_by_its_table_not_its_pages():
    # the plan cannot read pos: at 1 live page of 8 it keeps the splits of
    # a full table, which chip_smoke.py timed at 17.90 us where 1 split took
    # 8.57 (decode_split_ab at 8 slots x 8 heads x 1 page, PERF.md §6)
    assert TP.paged_plan(8, 8, 1, 128, 8, torch.bfloat16).splits == 8
