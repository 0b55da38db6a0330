"""The launch plan, the tile loops and the synchronisation of the port's bf16
flash backward, on the CPU.

``kernels.attention.flash_bwd_plan`` decides, from shapes and dtypes before
launch, the tiles of ``csrc/flash_bwd.cu``'s two ``wgmma`` kernels: one or
two consumer warpgroups per dK/dV CTA (64 keys each at head dim 128; at 256
two on the same 64 keys, 128 columns of dK and dV each) and per dQ CTA (64
query rows each), each streaming tiles of 64 rows.  The kernels cannot run
here, so these tests hold the plan; a plain emulation of each kernel's tile
loop (``_emulate_dkv``, ``_emulate_dq``: its CTAs and warpgroups, the live
tiles of each, -1e30 masks as P = 0 only on the tiles the kernel masks,
P^T / dS^T and dS rounded to bf16, f32 accumulation tile by tile) against
the JAX ``_flash_bwd`` run in interpret mode at the same ``bq`` / ``bk``
(where S is a multiple of them: its grid is S // bq) and against the port's
``_plain_flash_bwd`` on ragged shapes, under every mask the kernels take
(sinks, key-padding rows, segment ids; P = 1 on a fully masked row, as the
JAX kernels' exp(-1e30 - lse)); and a step-by-step run of each CTA's
producer ring, mbarriers and named-barrier turns (restated from the kernels)
at every length to 1,100.  On the card, ``chip_smoke.py`` holds the kernels
themselves against the plain version.

Tolerance (``TOL``), bf16, as ``tests/test_torch_kernels.py``'s
``test_flash_bwd_matches_jax_kernels``: both sides take the same q, k, v, dO,
o and lse, and P and dS round to bf16 at the same points, so the products
differ by the order of f32 sums plus an occasional ulp of P or dS flipped by
it (the kernels take exp2 of one fused multiply-add where JAX rounds s scale
first); the outputs round once more: 2 ulp (2^-6) relative, and 2^-6
absolute on gradients of order 1.
"""

from __future__ import annotations

import functools
import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import attention as A
from minidiff_tpu_torch.kernels import attention as TA


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
    """Run the JAX flash kernels' pallas_calls in interpret mode on the CPU."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(A, "pl", patched)


BF16 = torch.bfloat16
_LOG2E = 1.4426950408889634
TOL = dict(rtol=2 ** -6, atol=2 ** -6)


def _plan(d: int, dkv_wgs: int, dq_wgs: int) -> TA.BwdPlan:
    """A bf16 plan with the given warpgroups (the ones flash_bwd_plan can
    pick: dK/dV 1 or 2 at head dim 128, 2 at 256; dQ 1 or 2 at 128, 1 at
    256)."""
    keys = 64 if d == 256 else 64 * dkv_wgs
    return TA.BwdPlan(dkv_wgs, keys, 64, dq_wgs, 64 * dq_wgs, 64)


# every tile the plan can pick, as (head dim, dK/dV warpgroups, dQ
# warpgroups)
TILES = [(128, 2, 2), (128, 1, 1), (256, 2, 1)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


# (bh, sq, head dim, plan): the main path's flash backwards in bf16: the
# flagship train step (8 x 8 heads of 1,024), the options train step (8 x
# 32 heads), the head-dim-256 model's (8 x 2 heads), the MoE train step
# (8 x 4 heads of 512: 128 CTAs of 128 would not cover the card), the
# backward cases of chip_smoke.py at 8 x 384, and the lengths whose last
# 128-row tile has an empty second warpgroup (64 x 576: two waves of
# 128-row CTAs; 16 x 1088: one, where one warpgroup per CTA was faster)
MAIN_PATH = [(64, 1024, 128, _plan(128, 2, 2)), (256, 1024, 128, _plan(128, 2, 2)),
             (16, 1024, 256, _plan(256, 2, 1)), (32, 512, 128, _plan(128, 1, 1)),
             (8, 384, 128, _plan(128, 1, 1)), (64, 576, 128, _plan(128, 2, 2)),
             (16, 1088, 128, _plan(128, 1, 1)), (4, 200, 256, _plan(256, 2, 1))]


@pytest.mark.parametrize("bh,s,d,plan", MAIN_PATH)
def test_plan_at_the_main_path_shapes(bh, s, d, plan):
    assert TA.flash_bwd_plan(bh, s, s, d, BF16) == plan
    if d == 128:
        # two warpgroups per CTA where CTAs of 128 rows make two waves on
        # the card
        assert (plan.dkv_wgs == 2) == (bh * math.ceil(s / 128) >= 2 * TA.SMS)
        assert plan.dq_wgs == plan.dkv_wgs
    # f32 keeps the CUDA-core tile: 64 rows, 32 at head dim 256
    t = 64 if d == 128 else 32
    assert TA.flash_bwd_plan(bh, s, s, d, torch.float32) == TA.BwdPlan(0, t, t, 0, t, t)


def test_plan_decides_each_kernel_from_its_own_length():
    # dK/dV covers the card by key tiles, dQ by query tiles
    assert TA.flash_bwd_plan(16, 4096, 64, 128, BF16) == TA.BwdPlan(1, 64, 64, 2, 128, 64)
    assert TA.flash_bwd_plan(16, 64, 4096, 128, BF16) == TA.BwdPlan(2, 128, 64, 1, 64, 64)


@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float16, torch.float64])
def test_plan_raises_exactly_where_sdpa_composes(hd, dtype):
    # sdpa takes the flash kernels where flash_eligible holds (the JAX
    # _flash_eligible) and composes elsewhere; the plan, decided before any
    # launch, exists exactly for the former and raises for the latter
    t = torch.zeros(1, 2, 8, hd, dtype=dtype)
    if TA.flash_eligible(t, t, t):
        plan = TA.flash_bwd_plan(2, 8, 8, hd, dtype)
        assert (plan.dkv_wgs > 0) == (plan.dq_wgs > 0) == (dtype == BF16)
    else:
        with pytest.raises((TypeError, ValueError)):
            TA.flash_bwd_plan(2, 8, 8, hd, dtype)


# ---------------------------------------------------------------------------
# the tile loops
# ---------------------------------------------------------------------------


def _dkv_tiles(k0, keys, bq, sq, sk, causal, window, sinks=0):
    """(qt0, ntiles): the live query tiles [qt0, qt0 + ntiles) of the dK/dV
    CTA at key k0 (flash_bwd_dkv_wgmma_kernel): causal tiles wholly above
    the diagonal of its first key, and with a window those wholly past the
    band of its last, are skipped, unless it holds a sink key."""
    qt0, qt1 = 0, -(-sq // bq)
    if causal:
        qt0 = min(qt1, k0 // bq)
        if window and k0 >= sinks:
            qt1 = min(qt1, (min(k0 + keys, sk) - 1 + window - 1) // bq + 1)
    return qt0, qt1 - qt0


def _dkv_live(w0, qt0, ntiles, bq, sk, causal, window, sinks=0):
    """[na, nb): the CTA's tiles with a visible pair for the keys [w0, w0 +
    64) of one warpgroup."""
    na, nb = 0, ntiles if w0 < sk else 0
    if w0 < sk and causal:
        if window and w0 >= sinks:
            nb = min(nb, (min(w0 + 63, sk - 1) + window - 1) // bq + 1 - qt0)
        na = min(nb, max(0, w0 // bq - qt0))
    return na, nb


def _dq_tiles(q0, rows, bk, sq, sk, causal, window, sinks=0):
    """(kt0, ns, tiles): the key tiles of the dQ CTA at query row q0
    (flash_bwd_dq_wgmma_kernel, as the forward's): tile n of the CTA is key
    tile tiles[n], the ns sink tiles below the band first."""
    last = min(q0 + rows, sq) - 1
    kt0, kt1, ns = 0, -(-sk // bk), 0
    if causal:
        kt1 = min(kt1, last // bk + 1)
        if window:
            kt0 = max(0, q0 - window + 1) // bk
            ns = min(kt0, -(-sinks // bk))
    return kt0, ns, list(range(ns)) + list(range(kt0, kt1))


def _dq_live(w0, kt0, ns, ntiles, bk, sq, causal, window, sinks=0):
    """[na, nb): the CTA's tiles the warpgroup at query row w0 computes
    (with sinks every tile from 0 on)."""
    na, nb = 0, ntiles if w0 < sq else 0
    if w0 < sq and causal:
        nb = min(ntiles, min(w0 + 63, sq - 1) // bk + 1 - kt0 + ns)
        if window and not sinks:
            na = max(0, max(0, w0 - window + 1) // bk - kt0)
    return na, nb


def _rows(t, r0: int, n: int):
    """Rows [r0, r0 + n) of t (BH, S, ...) in f32, zeros past S (the
    copies' zero fill)."""
    out = torch.zeros(t.shape[0], n, *t.shape[2:])
    part = t[:, r0:r0 + n].float()
    out[:, :part.shape[1]] = part
    return out


def _ids(t, idx, n, h, fill):
    """t[:, idx] (t (B, n) int) for a run of indices, ``fill`` past n,
    repeated over the h heads of each batch row."""
    i0, m = int(idx.reshape(-1)[0]), idx.numel()
    out = torch.full((t.shape[0], m), fill, dtype=t.dtype)
    k = max(0, min(m, n - i0))
    out[:, :k] = t[:, i0:i0 + k]
    return out.repeat_interleave(h, 0)


def _visible(rows, cols, causal, window, sinks=0, kvm=None, seg=None, h=1, sq=None,
             sk=None):
    """(BH or 1, rows, cols): which (query, key) pairs of the index grids
    rows (R, 1) x cols (1, C) are visible, bounds apart."""
    keep = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool)
    if causal:
        keep = rows >= cols
        if window:
            keep = keep & ((rows - cols < window) | (cols < sinks))
    keep = keep[None]
    if kvm is not None:
        keep = keep & (_ids(kvm, cols, sk, h, 0) != 0)[:, None, :]
    if seg is not None:
        keep = keep & (_ids(seg, rows, sq, h, -2)[:, :, None]
                       == _ids(seg, cols, sk, h, -3)[:, None, :])
    return keep


def _emulate_dkv(q, k, v, do, lse, delta, scale, causal, window, plan, sinks=0, kvm=None,
                 seg=None, h=1):
    """(dk, dv) of the dK/dV kernel's tile loop, in plain torch f32: for each
    CTA of ``plan.dkv_keys`` keys its live query tiles, for each warpgroup
    (64 keys, or at head dim 256 the CTA's 64 keys and 128 columns) the
    tiles live for its keys, asserting that every other tile holds no
    visible pair; S^T and dP^T over the whole head dim, P^T = exp2(S^T
    scale log2 e - lse log2 e) with P = 0 (1 on a row whose lse is -1e30)
    only on the tiles the kernel masks (asserting that no other tile holds
    a masked pair), dS^T, both rounded to bf16, then dV += P^T dO and dK +=
    dS^T Q in f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sinks = sinks if window else 0
    keys, bq = plan.dkv_keys, plan.dkv_bq
    split = d == 256
    sl2 = float(np.float32(scale) * np.float32(_LOG2E))
    dk = torch.zeros(bh, sk, d, dtype=k.dtype)
    dv = torch.zeros(bh, sk, d, dtype=v.dtype)
    for k0 in range(0, sk, keys):
        qt0, ntiles = _dkv_tiles(k0, keys, bq, sq, sk, causal, window, sinks)
        for w in range(plan.dkv_wgs):
            w0 = k0 + (0 if split else 64 * w)
            cols = slice(128 * w, 128 * w + 128) if split else slice(0, d)
            na, nb = _dkv_live(w0, qt0, ntiles, bq, sk, causal, window, sinks)
            kr = torch.arange(w0, w0 + 64)[:, None]
            kw, vw = _rows(k, w0, 64), _rows(v, w0, 64)
            acck = torch.zeros(bh, 64, d // (2 if split else 1))
            accv = torch.zeros_like(acck)
            for qt in range(-(-sq // bq)):
                q0, n = qt * bq, qt - qt0
                qc = torch.arange(q0, q0 + bq)[None, :]
                keep = (_visible(qc.T, kr.T, causal, window, sinks, kvm, seg, h, sq, sk)
                        .transpose(1, 2) & (qc < sq))  # (keys, queries)
                if not (0 <= n < ntiles and na <= n < nb):
                    assert not (keep & (kr < sk)).any(), (
                        f"keys {w0}: query tile {qt} is skipped but holds a visible pair")
                    continue
                edge = q0 + bq > sq or kvm is not None or seg is not None or (
                    causal and (q0 < w0 + 63 or (window and q0 + bq - 1 - w0 >= window)))
                if not edge:
                    assert bool(keep.all()), "a tile the kernel does not mask holds a masked pair"
                qt_, dot = _rows(q, q0, bq), _rows(do, q0, bq)
                lq = _rows(lse[..., None], q0, bq)[..., 0]
                l2 = lq * _LOG2E
                dl = _rows(delta[..., None], q0, bq)[..., 0]
                st = kw @ qt_.transpose(1, 2)
                dpt = vw @ dot.transpose(1, 2)
                p = torch.exp2(st * sl2 - l2[:, None, :])
                if edge:
                    dead = (lq == -1e30)[:, None, :].expand_as(p)
                    p = torch.where(keep, p, dead.float())
                ds = p * (dpt - dl[:, None, :]) * scale
                accv += p.to(BF16).float() @ dot[..., cols]
                acck += ds.to(BF16).float() @ qt_[..., cols]
            n = min(64, sk - w0)
            if n > 0:
                dk[:, w0:w0 + n, cols] = acck[:, :n].to(k.dtype)
                dv[:, w0:w0 + n, cols] = accv[:, :n].to(v.dtype)
    return dk, dv


def _emulate_dq(q, k, v, do, lse, delta, scale, causal, window, plan, sinks=0, kvm=None,
                seg=None, h=1):
    """dq of the dQ kernel's tile loop, in plain torch f32: for each CTA of
    ``plan.dq_rows`` query rows its key tiles (the sink tiles below its band
    first), for each 64-row warpgroup the tiles it computes (asserting that
    every other tile holds no visible pair); S and dP, P = exp2(S scale
    log2 e - lse log2 e) with P = 0 (1 on a row whose lse is -1e30) only on
    the tiles the kernel masks, dS rounded to bf16, then dQ += dS K in
    f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sinks = sinks if window else 0
    rows, bk = plan.dq_rows, plan.dq_bk
    sl2 = float(np.float32(scale) * np.float32(_LOG2E))
    dq = torch.zeros(bh, sq, d, dtype=q.dtype)
    for q0 in range(0, sq, rows):
        kt0, ns, tiles = _dq_tiles(q0, rows, bk, sq, sk, causal, window, sinks)
        for w0 in range(q0, q0 + rows, 64):
            na, nb = _dq_live(w0, kt0, ns, len(tiles), bk, sq, causal, window, sinks)
            computed = {tiles[n] for n in range(na, nb)}
            qr = torch.arange(w0, w0 + 64)[:, None]
            qw, dow = _rows(q, w0, 64), _rows(do, w0, 64)
            lq = _rows(lse[..., None], w0, 64)[..., 0]
            l2 = lq * _LOG2E
            dl = _rows(delta[..., None], w0, 64)[..., 0]
            acc = torch.zeros(bh, 64, d)
            for kt in range(-(-sk // bk)):
                k0 = kt * bk
                kc = torch.arange(k0, k0 + bk)[None, :]
                keep = _visible(qr, kc, causal, window, sinks, kvm, seg, h, sq, sk) & (kc < sk)
                if kt not in computed:
                    assert not (keep & (qr < sq)).any(), (
                        f"rows {w0}: key tile {kt} is skipped but holds a visible pair")
                    continue
                edge = k0 + bk > sk or kvm is not None or seg is not None or (
                    causal and (k0 + bk - 1 > w0 or (window and w0 + 63 - k0 >= window)))
                if not edge:
                    assert bool(keep.all()), "a tile the kernel does not mask holds a masked pair"
                kt_, vt = _rows(k, k0, bk), _rows(v, k0, bk)
                s = qw @ kt_.transpose(1, 2)
                dp = dow @ vt.transpose(1, 2)
                p = torch.exp2(s * sl2 - l2[..., None])
                if edge:
                    dead = (lq == -1e30)[..., None].expand_as(p)
                    p = torch.where(keep, p, dead.float())
                ds = p * (dp - dl[..., None]) * scale
                acc += ds.to(BF16).float() @ kt_
            n = min(64, sq - w0)
            if n > 0:
                dq[:, w0:w0 + n] = acc[:, :n].to(q.dtype)
    return dq


def _operands(bh, s, d, causal, window, seed):
    """bf16 q, k, v, dO from a seed, and the plain forward's o and lse (both
    sides of each comparison take these), delta = rowsum(dO o) in f32."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32)).to(BF16)
                   for _ in range(4))
    o, lse = TA._plain_flash_fwd(q, k, v, d ** -0.5, causal, window)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


# (bh, s, head dim, dK/dV warpgroups, dQ warpgroups, causal, window) where S
# is a multiple of every tile: the emulation against the JAX kernels at the
# same bq / bk (dK/dV: its query tile and keys per CTA; dQ: its rows per
# CTA and key tile) and against the plain version
ALIGNED = [(1, 256, 128, 2, 2, True, None), (1, 256, 128, 2, 2, False, None),
           (1, 256, 128, 1, 1, True, None), (1, 256, 128, 2, 2, True, 48),
           (1, 256, 256, 2, 1, True, None), (1, 256, 256, 2, 1, True, 80)]


@pytest.mark.parametrize("bh,s,d,dkv_wgs,dq_wgs,causal,window", ALIGNED)
def test_tile_loops_match_jax_kernels_and_plain(_interpret, bh, s, d, dkv_wgs, dq_wgs,
                                                causal, window):
    plan = _plan(d, dkv_wgs, dq_wgs)
    scale = d ** -0.5
    q, k, v, do, o, lse, delta = _operands(bh, s, d, causal, window, seed=s + d + dkv_wgs)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, window, plan)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, window, plan)
    jq, jk, jv, jdo, jo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do, o))
    jl = jnp.asarray(lse.numpy())
    blocks = {(plan.dkv_bq, plan.dkv_keys), (plan.dq_rows, plan.dq_bk)}
    for bq, bk in blocks:
        rq, rk, rv = A._flash_bwd(jq, jk, jv, jo, jl, jdo, scale, causal, bq=bq, bk=bk,
                                  window=window)
        if (bq, bk) == (plan.dkv_bq, plan.dkv_keys):
            np.testing.assert_allclose(_np32(dk), _np32(rk), err_msg="dk vs JAX", **TOL)
            np.testing.assert_allclose(_np32(dv), _np32(rv), err_msg="dv vs JAX", **TOL)
        if (bq, bk) == (plan.dq_rows, plan.dq_bk):
            np.testing.assert_allclose(_np32(dq), _np32(rq), err_msg="dq vs JAX", **TOL)
    pq, pk, pv = TA._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
    for name, got, ref in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        np.testing.assert_allclose(_np32(got), _np32(ref), err_msg=f"{name} vs plain", **TOL)


# ragged S (masked by bounds, zero-filled copies): a window over a ragged
# S, head dim 256, a last 128-key tile whose second warpgroup has no keys
# (130), Sq 65 at head dim 256, a query length under one warpgroup
RAGGED = [(2, 200, 128, 2, 2, True, 64), (2, 200, 256, 2, 1, True, None),
          (3, 77, 128, 1, 1, False, None), (2, 130, 128, 2, 2, True, None),
          (2, 65, 256, 2, 1, False, None), (4, 16, 128, 1, 1, True, None)]


@pytest.mark.parametrize("bh,s,d,dkv_wgs,dq_wgs,causal,window", RAGGED)
def test_tile_loops_match_plain_on_ragged_shapes(bh, s, d, dkv_wgs, dq_wgs, causal, window):
    plan = _plan(d, dkv_wgs, dq_wgs)
    scale = d ** -0.5
    q, k, v, do, o, lse, delta = _operands(bh, s, d, causal, window, seed=s + d)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, window, plan)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, window, plan)
    pq, pk, pv = TA._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
    for name, got, ref in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        np.testing.assert_allclose(_np32(got), _np32(ref), err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# the synchronisation of a CTA
# ---------------------------------------------------------------------------


def _consumer_steps(ntiles: int, na: int, nb: int):
    """The synchronisation steps of one consumer warpgroup, in the order of
    ``flash_bwd.cu``'s kernels (restated here; both kernels share it):
    ("acquire", n) waits until tile n has landed in its stage, ("release",
    n) hands the stage back, ("turn",) is one turn at issuing MMAs (await
    the other warpgroup's hand-over, then hand over).  Each tile of the CTA
    takes two turns, the score products' and the accumulating products',
    live for the warpgroup's rows ([na, nb)) or not."""
    steps = [("resident",)]
    for n in range(na):
        steps += [("acquire", n), ("turn",), ("turn",), ("release", n)]
    for n in range(na, nb):
        steps += [("acquire", n), ("turn",), ("turn",), ("release", n)]
    for n in range(max(na, nb), ntiles):
        steps += [("acquire", n), ("turn",), ("turn",), ("release", n)]
    return steps


def _run_cta(ntiles: int, live: list, stages: int):
    """Run a CTA's producer and consumers (one per (na, nb) in ``live``),
    step by step, until none can move, and assert that all finished.  The
    producer first copies the resident tiles (K and V, or Q and dO), then
    fills tile n into stage n % stages once every consumer has released
    tile n - stages.  With two consumers, warpgroup 0's turns await
    warpgroup 1's hand-overs (the first made before the loop, where there
    are turns) and the other way round; a hand-over is 128 threads' arrive
    at a 256-thread named barrier, so one made while the last is still
    unawaited would complete the barrier on its own, and one never awaited
    is left pending at exit."""
    wgs = len(live)
    steps = [_consumer_steps(ntiles, na, nb) for na, nb in live]
    turns = 2 * ntiles
    pos, filled, released, resident = [0] * wgs, 0, [0] * ntiles, False
    taken = [0] * wgs
    handed = [1 if wgs == 2 and turns > 0 else 0, 0]  # hand-overs made to w
    moved = True
    while moved:
        moved = False
        if not resident:
            resident = moved = True
        elif filled < ntiles and (filled < stages or released[filled - stages] == wgs):
            filled += 1
            moved = True
        for w in range(wgs):
            while pos[w] < len(steps[w]):
                step = steps[w][pos[w]]
                if step[0] == "resident":
                    if not resident:
                        break
                elif step[0] == "acquire":
                    if filled <= step[1]:
                        break
                    # the stage still holds tile n, not a later one
                    assert filled <= step[1] + stages
                elif step[0] == "release":
                    released[step[1]] += 1
                elif wgs == 1:
                    taken[w] += 1
                else:
                    if handed[w] == taken[w]:
                        break
                    taken[w] += 1
                    if w == 0 or taken[w] < turns:
                        assert handed[1 - w] == taken[1 - w], (
                            f"warpgroup {w} hands over twice unawaited")
                        handed[1 - w] += 1
                pos[w] += 1
                moved = True
    stuck = [steps[w][pos[w]] for w in range(wgs) if pos[w] < len(steps[w])]
    assert not stuck, (f"deadlock: consumers wait at {stuck} with {filled} of "
                       f"{ntiles} tiles filled")
    assert filled == ntiles and all(r == wgs for r in released)
    assert taken == [turns] * wgs
    assert wgs == 1 or handed == taken


def _stages(d: int) -> int:
    """The ring of each instantiation (flash_bwd.cu dispatch_dkv /
    dispatch_dq): three stages at head dim 128, two at 256."""
    return 3 if d == 128 else 2


def _run_dkv(sq, sk, d, wgs, causal, window, sinks=0):
    plan = _plan(d, wgs, 1)
    for k0 in range(0, sk, plan.dkv_keys):
        qt0, ntiles = _dkv_tiles(k0, plan.dkv_keys, plan.dkv_bq, sq, sk, causal, window,
                                 sinks)
        w0s = [k0] * wgs if d == 256 else [k0 + 64 * w for w in range(wgs)]
        live = [_dkv_live(w0, qt0, ntiles, plan.dkv_bq, sk, causal, window, sinks)
                for w0 in w0s]
        _run_cta(ntiles, live, _stages(d))


def _run_dq(sq, sk, d, wgs, causal, window, sinks=0):
    plan = _plan(d, 2 if d == 256 else wgs, wgs)
    for q0 in range(0, sq, plan.dq_rows):
        kt0, ns, tiles = _dq_tiles(q0, plan.dq_rows, plan.dq_bk, sq, sk, causal, window,
                                   sinks)
        live = [_dq_live(q0 + 64 * w, kt0, ns, len(tiles), plan.dq_bk, sq, causal, window,
                         sinks) for w in range(wgs)]
        _run_cta(len(tiles), live, _stages(d))


def test_synchronisation_detects_a_skipped_turn(monkeypatch):
    # the run fails where a warpgroup skips the turns of tiles that are not
    # live for its rows (the flash forward's deadlock before its repair)
    def skipping(ntiles, na, nb):
        steps = [("resident",)]
        for n in range(ntiles):
            steps += [("acquire", n)] + [("turn",)] * (2 if na <= n < nb else 0) + [
                ("release", n)]
        return steps

    monkeypatch.setattr(sys.modules[__name__], "_consumer_steps", skipping)
    with pytest.raises(AssertionError, match="deadlock"):
        # a last 128-key tile whose second warpgroup has no keys while the
        # ring of query tiles wraps
        _run_dkv(1024, 1024 + 40, 128, 2, False, None)


# (sq, sk, causal, window): lengths whose last 128-row tile has an empty
# second warpgroup while the ring wraps (576, 1088, 130), a window whose
# second warpgroup skips a leading tile the first takes, the main path's S
# 1024, ragged, a short sequence, and queries against a longer key sequence
# and the other way round
PROTOCOL = [(576, 576, True, None), (576, 576, False, None), (1088, 1088, True, None),
            (576, 576, True, 300), (1024, 1024, True, None), (200, 200, True, 64),
            (16, 16, True, None), (130, 1000, False, None), (1000, 130, True, None)]


@pytest.mark.parametrize("d,dkv_wgs,dq_wgs", TILES)
@pytest.mark.parametrize("sq,sk,causal,window", PROTOCOL)
def test_cta_synchronisation_runs_to_its_end(sq, sk, causal, window, d, dkv_wgs, dq_wgs):
    _run_dkv(sq, sk, d, dkv_wgs, causal, window)
    _run_dq(sq, sk, d, dq_wgs, causal, window)


@pytest.mark.parametrize("d,dkv_wgs,dq_wgs", TILES)
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 100),
                                           (True, 300)])
def test_cta_synchronisation_at_every_length(causal, window, d, dkv_wgs, dq_wgs):
    # every length from 1 to 1,100: an empty second warpgroup, a window
    # cutting either warpgroup's first tile, at each tile count
    for s in range(1, 1101):
        _run_dkv(s, s, d, dkv_wgs, causal, window)
        _run_dq(s, s, d, dq_wgs, causal, window)


# ---------------------------------------------------------------------------
# the masks: sinks, key-padding rows, segment ids
# ---------------------------------------------------------------------------


def _masks(b, s, kind, seed):
    """(sinks, kvm, seg) of one case over b batch rows: key rows keeping a
    random prefix (the first row wholly masked in "dead"), ids of four
    documents and a padding tail (-1)."""
    rng = np.random.RandomState(seed)
    kvm = seg = None
    if "kvm" in kind:
        lens = rng.randint(1, s + 1, size=b)
        kvm = torch.from_numpy((np.arange(s)[None] < lens[:, None]).astype(np.int32))
        if "dead" in kind:
            kvm[0] = 0
    if "seg" in kind:
        cuts = np.sort(rng.randint(1, s, size=(b, 3)), axis=1)
        ids = (np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1)
        ids[:, s - 5:] = -1
        seg = torch.from_numpy(ids.astype(np.int32))
    return (4 if "sinks" in kind else 0), kvm, seg


def _masked_operands(b, h, s, d, causal, window, sinks, kvm, seg, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b * h, s, d)).astype(np.float32))
                   .to(BF16) for _ in range(4))
    o, lse = TA._plain_flash_fwd(q, k, v, d ** -0.5, causal, window, sinks, kvm, seg, h)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta


# (b, h, s, head dim, dK/dV warpgroups, dQ warpgroups, causal, window,
# kind) where S is a multiple of every tile: against the JAX kernels at the
# same bq / bk and the plain version.  Sinks below the band of later tiles;
# a key row with a fully masked batch row (P = 1 there, as on the TPU); ids
# under causality; sinks and ids together
MASKED_ALIGNED = [(1, 1, 384, 128, 2, 2, True, 160, "sinks"),
                  (1, 1, 384, 256, 2, 1, True, 150, "sinks"),
                  (2, 1, 256, 128, 2, 2, False, None, "kvm-dead"),
                  (2, 1, 256, 128, 2, 2, True, 96, "sinks-seg")]


@pytest.mark.parametrize("b,h,s,d,dkv_wgs,dq_wgs,causal,window,kind", MASKED_ALIGNED)
def test_masked_tile_loops_match_jax_kernels_and_plain(_interpret, b, h, s, d, dkv_wgs,
                                                       dq_wgs, causal, window, kind):
    plan = _plan(d, dkv_wgs, dq_wgs)
    scale = d ** -0.5
    sinks, kvm, seg = _masks(b, s, kind, seed=len(kind))
    q, k, v, do, o, lse, delta = _masked_operands(b, h, s, d, causal, window, sinks, kvm,
                                                  seg, seed=s + d + dkv_wgs)
    mk = dict(sinks=sinks, kvm=kvm, seg=seg, h=h)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, window, plan, **mk)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, window, plan, **mk)
    jq, jk, jv, jdo, jo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do, o))
    jl = jnp.asarray(lse.numpy())
    jm = dict(mask=None if kvm is None else jnp.asarray(kvm.numpy()), h=h,
              seg=None if seg is None else jnp.asarray(seg.numpy()), window=window,
              sinks=sinks)
    for bq, bk in {(plan.dkv_bq, plan.dkv_keys), (plan.dq_rows, plan.dq_bk)}:
        rq, rk, rv = A._flash_bwd(jq, jk, jv, jo, jl, jdo, scale, causal, bq=bq, bk=bk, **jm)
        if (bq, bk) == (plan.dkv_bq, plan.dkv_keys):
            np.testing.assert_allclose(_np32(dk), _np32(rk), err_msg="dk vs JAX", **TOL)
            np.testing.assert_allclose(_np32(dv), _np32(rv), err_msg="dv vs JAX", **TOL)
        if (bq, bk) == (plan.dq_rows, plan.dq_bk):
            np.testing.assert_allclose(_np32(dq), _np32(rq), err_msg="dq vs JAX", **TOL)
    pq, pk, pv = TA._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window, **mk)
    for name, got, ref in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        np.testing.assert_allclose(_np32(got), _np32(ref), err_msg=f"{name} vs plain", **TOL)


# ragged S under the masks, windows that are not tile multiples, and the
# one-warpgroup tiles under sinks and ids
MASKED_RAGGED = [(2, 1, 200, 128, 2, 2, True, 70, "sinks"),
                 (1, 1, 256, 128, 1, 1, True, 100, "sinks"),
                 (2, 1, 256, 128, 1, 1, True, None, "seg"),
                 (1, 2, 333, 256, 2, 1, True, 130, "sinks"),
                 (2, 1, 77, 128, 1, 1, False, None, "kvm"),
                 (2, 2, 300, 128, 2, 2, True, 90, "sinks-seg")]


@pytest.mark.parametrize("b,h,s,d,dkv_wgs,dq_wgs,causal,window,kind", MASKED_RAGGED)
def test_masked_tile_loops_match_plain_on_ragged_shapes(b, h, s, d, dkv_wgs, dq_wgs, causal,
                                                       window, kind):
    plan = _plan(d, dkv_wgs, dq_wgs)
    scale = d ** -0.5
    sinks, kvm, seg = _masks(b, s, kind, seed=s)
    q, k, v, do, o, lse, delta = _masked_operands(b, h, s, d, causal, window, sinks, kvm,
                                                  seg, seed=s + d)
    mk = dict(sinks=sinks, kvm=kvm, seg=seg, h=h)
    dk, dv = _emulate_dkv(q, k, v, do, lse, delta, scale, causal, window, plan, **mk)
    dq = _emulate_dq(q, k, v, do, lse, delta, scale, causal, window, plan, **mk)
    pq, pk, pv = TA._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window, **mk)
    for name, got, ref in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        np.testing.assert_allclose(_np32(got), _np32(ref), err_msg=name, **TOL)


@pytest.mark.parametrize("d,dkv_wgs,dq_wgs", TILES)
@pytest.mark.parametrize("s,window,sinks", [(576, 100, 4), (1088, 300, 70), (1000, 129, 1)])
def test_cta_synchronisation_with_sinks(s, window, sinks, d, dkv_wgs, dq_wgs):
    _run_dkv(s, s, d, dkv_wgs, True, window, sinks)
    _run_dq(s, s, d, dq_wgs, True, window, sinks)
