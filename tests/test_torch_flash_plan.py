"""The launch plan and the tile loop of the port's bf16 flash forward, on
the CPU.

``kernels.attention.flash_plan`` decides, from shapes and dtypes before
launch, how many query rows a CTA of ``csrc/flash_fwd.cu``'s ``wgmma``
kernel takes (64 or 128; the key tile follows from it and the head dim).
The kernel cannot run here, so these tests hold the plan, and a plain
emulation of the kernel's tile loop (``_emulate``: its query and key tiles,
the causal and window skips per CTA and per warpgroup, -1e30 masks applied
only on the tiles the kernel masks, the running max in base 2, P rounded to
bf16 against it, lse = m ln 2 + log l) against the JAX ``_flash_fwd`` run in
interpret mode at the same ``bq`` / ``bk`` (where S is a multiple of them:
its grid is S // bq) and against the port's ``_plain_flash_fwd`` everywhere,
under every mask the kernel takes: a window with attention sinks (the sink
tiles below a CTA's band streamed first, every tile of a warpgroup from 0
on), key-padding rows and segment ids (every tile masked), alone and
together, and a fully masked key row (lse -1e30).
On the card, ``chip_smoke.py`` holds the kernel itself against the plain
version at the main path's shapes.

Tolerance (``_close``), bf16 inputs: o within 2^-6 relative plus 2^-7 (the
kernel rounds the unnormalised probabilities to bf16 against the running
max, the plain version the normalised ones, then both round o: up to ~2
ulp), lse within 1e-4 (f32 on both sides), as ``chip_smoke.py``'s
``TOL["attn"]`` / ``TOL["lse"]``.
"""

from __future__ import annotations

import functools
import math
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
    """Run the JAX flash kernel's pallas_call in interpret mode on the CPU."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(A, "pl", patched)


BF16 = torch.bfloat16
_NEG = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _close(o, lse, o_ref, lse_ref):
    o, o_ref = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)
                for t in (o, o_ref))
    np.testing.assert_allclose(o, o_ref, rtol=2 ** -6, atol=2 ** -7)
    np.testing.assert_allclose(np.asarray(lse, np.float32), np.asarray(lse_ref, np.float32),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


# (bh, sq, head dim, rows): the main path's flash forwards in bf16: the
# serving prefill (8 sequences x 8 heads of 16 tokens), server prefills of
# 128 and 384 tokens, the flagship train step (8 x 8 heads of 1,024), the
# options train step (8 x 32 heads), the head-dim-256 model's train step
# (8 x 2 heads) and a ragged one
MAIN_PATH = [(64, 16, 128, 64), (8, 128, 128, 64), (8, 384, 128, 64), (64, 1024, 128, 128),
             (256, 1024, 128, 128), (16, 1024, 256, 64), (4, 200, 256, 64)]
# (bh, sq) whose 128-row CTAs would cover the card: head dim 128 takes them,
# head dim 256 keeps 64 rows (its two-warpgroup tile is not built)
COVERING = [(64, 1024), (256, 1024), (64, 576), (16, 1088), (132, 128)]


@pytest.mark.parametrize("bh,sq,d,rows", MAIN_PATH)
def test_plan_at_the_main_path_shapes(bh, sq, d, rows):
    assert TA.flash_plan(bh, sq, d, BF16) == rows
    assert rows in TA.FLASH_ROWS
    # 128-row CTAs at head dim 128 where they cover the card, else 64
    assert (rows == 128) == (d == 128 and bh * math.ceil(sq / 128) >= TA.SMS)
    # f32 keeps the CUDA-core tile of 64 rows
    assert TA.flash_plan(bh, sq, d, torch.float32) == 64


@pytest.mark.parametrize("bh,sq", COVERING)
def test_plan_takes_two_warpgroups_only_at_head_dim_128(bh, sq):
    assert bh * math.ceil(sq / 128) >= TA.SMS
    assert TA.flash_plan(bh, sq, 128, BF16) == 128
    assert TA.flash_plan(bh, sq, 256, BF16) == 64


@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float16, torch.float64])
def test_plan_raises_exactly_where_sdpa_composes(hd, dtype):
    # sdpa takes the flash kernels where flash_eligible holds (the JAX
    # _flash_eligible) and composes elsewhere; the plan, decided before any
    # launch, exists exactly for the former and raises for the latter
    t = torch.zeros(1, 2, 8, hd, dtype=dtype)
    if TA.flash_eligible(t, t, t):
        assert TA.flash_plan(2, 8, hd, dtype) in TA.FLASH_ROWS
    else:
        with pytest.raises((TypeError, ValueError)):
            TA.flash_plan(2, 8, hd, dtype)


# ---------------------------------------------------------------------------
# the tile loop
# ---------------------------------------------------------------------------


def _key_tile(rows: int, d: int) -> int:
    """The key tile of a plan (flash_fwd.cu wg::dispatch): 128 at head dim
    128 with 128-row CTAs, else 64."""
    return 128 if d == 128 and rows == 128 else 64


def _cta_tiles(q0: int, rows: int, d: int, sq: int, sk: int, causal: bool, window,
               sinks: int = 0):
    """(key tile, kt0, ns, tiles): the CTA at query row q0 streams key
    tiles ``tiles`` (tile n of the CTA is key tile ``tiles[n]``): causal
    tiles wholly above the diagonal of its last row, and with a window those
    wholly below the band of its first, are skipped, except the ns tiles
    that hold sink columns below the band, which come first."""
    bk = _key_tile(rows, d)
    last = min(q0 + rows, sq) - 1
    kt0, kt1, ns = 0, -(-sk // bk), 0
    if causal:
        kt1 = min(kt1, last // bk + 1)
        if window:
            kt0 = max(0, q0 - window + 1) // bk
            ns = min(kt0, -(-sinks // bk))
    return bk, kt0, ns, list(range(ns)) + list(range(kt0, kt1))


def _wg_tiles(w0: int, bk: int, kt0: int, ns: int, ntiles: int, sq: int, causal: bool,
              window, sinks: int = 0):
    """[na, nb): the CTA's tiles the warpgroup at row w0 computes (with
    sinks every tile from 0 on)."""
    na, nb = 0, ntiles if w0 < sq else 0
    if w0 < sq and causal:
        nb = min(ntiles, min(w0 + 63, sq - 1) // bk + 1 - kt0 + ns)
        if window and not sinks:
            na = max(0, max(0, w0 - window + 1) // bk - kt0)
    return na, nb


def _pad(t, r0: int, n: int):
    """Rows [r0, r0 + n) of t (BH, S, D) in f32, zeros past S (the copies'
    zero fill)."""
    out = torch.zeros(t.shape[0], n, t.shape[2])
    part = t[:, r0:r0 + n].float()
    out[:, :part.shape[1]] = part
    return out


def _keep(r, c, sq: int, sk: int, causal: bool, window, sinks: int, kvm, seg, h: int):
    """(BH, rows, cols) visibility of the index grids r (rows, 1) x c (1,
    cols): bounds, causal, window and sinks, the key rows and the ids (batch
    bh // h)."""
    keep = c < sk
    if causal:
        live = r >= c
        if window:
            live = live & ((r - c < window) | (c < sinks))
        keep = keep & live
    keep = keep[None]
    if kvm is not None:
        kv = torch.zeros(kvm.shape[0], c.shape[1], dtype=torch.bool)
        n = max(0, min(c.shape[1], sk - int(c[0, 0])))
        kv[:, :n] = kvm[:, int(c[0, 0]):int(c[0, 0]) + n] != 0
        keep = keep & kv.repeat_interleave(h, 0)[:, None, :]
    if seg is not None:
        def ids(idx, n):
            out = torch.full((seg.shape[0], idx.numel()), -2, dtype=seg.dtype)
            i0, m = int(idx.reshape(-1)[0]), max(0, min(idx.numel(), n - int(idx.reshape(-1)[0])))
            out[:, :m] = seg[:, i0:i0 + m]
            return out.repeat_interleave(h, 0)
        keep = keep & (ids(r, sq)[:, :, None] == ids(c, sk)[:, None, :])
    return keep


def _emulate(q, k, v, scale, causal, window, rows, sinks=0, kvm=None, seg=None, h=1):
    """(o, lse, first_masked) of the bf16 kernel's tile loop, in plain torch
    f32.  For each CTA of ``rows`` query rows (q0), its key tiles; for each
    64-row warpgroup (w0) the tiles [na, nb) it computes (asserting that the
    others hold no visible pair); the -1e30 masks only on the tiles the
    kernel's ``edge`` names (asserting that no other tile holds a masked
    pair); the online softmax in base 2 with P rounded to bf16 against the
    running max; o = acc * (1 / l) rounded to bf16, lse = m ln 2 + log l
    (-1e30 where m is still -1e30).  first_masked counts the rows whose
    first tile was wholly masked (a uniform P the next tile's zero alpha
    wipes)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sinks = sinks if window else 0
    sl2 = float(np.float32(scale) * np.float32(_LOG2E))
    o = torch.zeros(bh, sq, d, dtype=q.dtype)
    lse = torch.zeros(bh, sq)
    first_masked = 0
    for q0 in range(0, sq, rows):
        bk, kt0, ns, tiles = _cta_tiles(q0, rows, d, sq, sk, causal, window, sinks)
        for w0 in range(q0, min(q0 + rows, sq), 64):
            na, nb = _wg_tiles(w0, bk, kt0, ns, len(tiles), sq, causal, window, sinks)
            r = torch.arange(w0, w0 + 64)[:, None]
            qw = _pad(q, w0, 64)
            m = torch.full((bh, 64), _NEG)
            l = torch.zeros(bh, 64)
            acc = torch.zeros(bh, 64, d)
            seen = torch.zeros(bh, 64, dtype=torch.bool)
            computed = {tiles[n] for n in range(na, nb)}
            for kt in range(-(-sk // bk)):
                k0 = kt * bk
                c = torch.arange(k0, k0 + bk)[None, :]
                keep = _keep(r, c, sq, sk, causal, window, sinks, kvm, seg, h)
                if kt not in computed:
                    assert not (keep & (r < sq)).any(), (
                        f"rows {w0}: key tile {kt} is skipped but holds a visible pair")
                    continue
                s = (qw @ _pad(k, k0, bk).transpose(1, 2)) * sl2
                edge = (k0 + bk > sk or kvm is not None or seg is not None
                        or (causal and (k0 + bk - 1 > w0
                                        or (window and w0 + 63 - k0 >= window))))
                if edge:
                    s = torch.where(keep, s, torch.full_like(s, _NEG))
                else:
                    assert bool(keep.all()), "a tile the kernel does not mask holds a masked pair"
                rows_valid = (r[:, 0] < sq)[None]
                first_masked += int((~seen & ~keep.any(dim=2) & rows_valid).sum())
                seen |= True
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + p.to(BF16).float() @ _pad(v, k0, bk)
                m = m_new
            n = min(64, sq - w0)
            o[:, w0:w0 + n] = (acc * (1.0 / l)[..., None])[:, :n].to(q.dtype)
            lse[:, w0:w0 + n] = torch.where(m == _NEG, torch.full_like(m, _NEG),
                                            m * _LN2 + torch.log(l))[:, :n]
    return o, lse, first_masked


def _qkv(bh, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3)]


# (bh, s, head dim, rows, causal, window) where S is a multiple of both
# tiles: the emulation against the JAX kernel at the same bq / bk
ALIGNED = [(2, 256, 128, 128, True, None), (2, 256, 128, 128, False, None),
           (2, 256, 128, 64, True, None), (2, 256, 128, 128, True, 32),
           (1, 256, 256, 64, True, None), (1, 256, 256, 64, True, 48)]


@pytest.mark.parametrize("bh,s,d,rows,causal,window", ALIGNED)
def test_tile_loop_matches_jax_kernel_and_plain(_interpret, bh, s, d, rows, causal, window):
    q, k, v = _qkv(bh, s, d, seed=s + d + rows)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(t).to(BF16) for t in (q, k, v))
    o, lse, first_masked = _emulate(tq, tk, tv, scale, causal, window, rows)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    o_ref, lse_ref = A._flash_fwd(jq, jk, jv, scale, causal, bq=rows,
                                  bk=_key_tile(rows, d), window=window)
    _close(o, lse, np.asarray(o_ref.astype(jnp.float32)), np.asarray(lse_ref).reshape(bh, s))
    op, lp = TA._plain_flash_fwd(tq, tk, tv, scale, causal, window)
    _close(o, lse, op, lp)
    if window is not None:
        # rows whose first live tile lies wholly below their window: the
        # -1e30 semantic's uniform P, wiped by the next tile
        assert first_masked > 0


# ragged S (masked by bounds, zero-filled copies), a window over a ragged
# S, head dim 256, and a query length under one warpgroup
RAGGED = [(2, 200, 128, 128, True, 64), (2, 200, 256, 64, True, None),
          (3, 77, 128, 64, False, None), (2, 200, 128, 64, True, 100),
          (4, 16, 128, 64, True, None)]


@pytest.mark.parametrize("bh,s,d,rows,causal,window", RAGGED)
def test_tile_loop_matches_plain_on_ragged_shapes(bh, s, d, rows, causal, window):
    q, k, v = (torch.from_numpy(t).to(BF16) for t in _qkv(bh, s, d, seed=s + d))
    o, lse, _ = _emulate(q, k, v, d ** -0.5, causal, window, rows)
    op, lp = TA._plain_flash_fwd(q, k, v, d ** -0.5, causal, window)
    _close(o, lse, op, lp)


# ---------------------------------------------------------------------------
# the synchronisation of a CTA
# ---------------------------------------------------------------------------


def _consumer_steps(q0: int, wg: int, rows: int, sq: int, sk: int, causal: bool, window,
                    sinks: int = 0):
    """The synchronisation steps of consumer warpgroup ``wg`` of the CTA at
    q0, in the order of ``flash_fwd.cu``'s ``flash_fwd_wgmma_kernel``
    (restated here): ("acquire", n) waits until key tile n has landed in its
    stage, ("release", n) hands the stage back, ("turn",) is one turn at
    issuing MMAs (await the other warpgroup's hand-over, then hand over).
    Turn n is taken for each key tile n >= 1 of the CTA, live for the
    warpgroup's rows or not."""
    bk, kt0, ns, tiles = _cta_tiles(q0, rows, 128, sq, sk, causal, window, sinks)
    ntiles = len(tiles)
    w0 = q0 + 64 * wg
    na, nb = _wg_tiles(w0, bk, kt0, ns, ntiles, sq, causal, window, sinks)
    steps = []

    def turns_to(n):
        steps.extend([("turn",)] * (n - steps.count(("turn",))))

    for n in range(na):
        steps.append(("acquire", n))
        turns_to(n)
        steps.append(("release", n))
    if na < nb:
        steps.append(("acquire", na))
        turns_to(na)
        for n in range(na + 1, nb):
            steps += [("acquire", n), ("turn",), ("release", n - 1)]
        steps.append(("release", nb - 1))
    for n in range(max(na, nb), ntiles):
        steps.append(("acquire", n))
        turns_to(n)
        steps.append(("release", n))
    turns_to(ntiles - 1)
    return steps, ntiles


def _run_cta(q0: int, rows: int, sq: int, sk: int, causal: bool, window, sinks: int = 0):
    """Run the CTA's producer and consumers, step by step, until none can
    move, and assert that all finished.  The producer fills tile n into
    stage n % stages once every consumer has released tile n - stages.  With
    two consumers, warpgroup 0's turns await warpgroup 1's hand-overs (the
    first made before the loop, where there are turns) and the other way
    round; a hand-over is 128 threads' arrive at a 256-thread named barrier,
    so one made while the last is still unawaited would complete the barrier
    on its own, and one never awaited is left pending at exit."""
    wgs, stages = rows // 64, (3 if rows == 128 else 2)
    progs = [_consumer_steps(q0, w, rows, sq, sk, causal, window, sinks) for w in range(wgs)]
    steps, ntiles = [p[0] for p in progs], progs[0][1]
    turns = ntiles - 1
    pos, filled, released = [0] * wgs, 0, [0] * ntiles
    taken = [0] * wgs
    handed = [1 if wgs == 2 and turns > 0 else 0, 0]  # hand-overs made to w
    moved = True
    while moved:
        moved = False
        if filled < ntiles and (filled < stages or released[filled - stages] == wgs):
            filled += 1
            moved = True
        for w in range(wgs):
            while pos[w] < len(steps[w]):
                step = steps[w][pos[w]]
                if step[0] == "acquire":
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
                            f"q0 {q0}: warpgroup {w} hands over twice unawaited")
                        handed[1 - w] += 1
                pos[w] += 1
                moved = True
    stuck = [steps[w][pos[w]] for w in range(wgs) if pos[w] < len(steps[w])]
    assert not stuck, (f"CTA at q0 {q0} of sq {sq} deadlocks: consumers wait at "
                       f"{stuck} with {filled} of {ntiles} tiles filled")
    assert filled == ntiles and all(r == wgs for r in released)
    assert taken == [turns] * wgs
    assert wgs == 1 or handed == taken


# (sq, sk, causal, window): shapes whose last 128-row CTA has an empty second
# warpgroup while the ring wraps (S 576 and 1088), a window whose second
# warpgroup skips a leading tile the first takes, the main path's S 1024,
# ragged, a short prefill, and queries against a longer key sequence
PROTOCOL = [(576, 576, True, None), (576, 576, False, None), (1088, 1088, True, None),
            (576, 576, True, 300), (1024, 1024, True, None), (200, 200, True, 64),
            (16, 16, True, None), (130, 1000, False, None)]


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", PROTOCOL)
def test_cta_synchronisation_runs_to_its_end(sq, sk, causal, window, rows):
    for q0 in range(0, sq, rows):
        _run_cta(q0, rows, sq, sk, causal, window)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 100),
                                           (True, 300)])
def test_cta_synchronisation_at_every_length(causal, window):
    # every query length to 1,100 at 128 rows: an empty second warpgroup,
    # and a window cutting either warpgroup's first tile, at each tile count
    for sq in range(1, 1100, 3):
        for q0 in range(0, sq, 128):
            _run_cta(q0, 128, sq, sq, causal, window)


# ---------------------------------------------------------------------------
# the masks: sinks, key-padding rows, segment ids
# ---------------------------------------------------------------------------


def _mask_operands(b, h, s, kind, seed):
    """(sinks, kvm, seg) of one mask case over b batch rows of s keys: the
    key rows keep a random prefix of each row (at least 1), the ids split
    each row into four documents with a padding tail (-1)."""
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


def _jax_masks(kvm, seg):
    return dict(mask=None if kvm is None else jnp.asarray(kvm.numpy()),
                seg=None if seg is None else jnp.asarray(seg.numpy()))


# (b, h, s, head dim, rows, causal, window, kind) where S is a multiple of
# both tiles: the emulation against the JAX kernel at the same bq / bk and
# the plain version.  Sinks with a window that leaves sink tiles below the
# band; a key row, non-causal, with and without a fully masked batch row;
# ids under causality; everything at once (no row left without a key: the
# ids' documents start at or after each row's key)
MASKED_ALIGNED = [(1, 2, 512, 128, 128, True, 192, "sinks"),
                  (1, 2, 512, 128, 64, True, 100, "sinks"),
                  (1, 1, 512, 256, 64, True, 150, "sinks"),
                  (2, 1, 256, 128, 128, False, None, "kvm"),
                  (2, 1, 256, 128, 64, False, None, "kvm-dead"),
                  (2, 1, 256, 256, 64, False, None, "kvm-dead"),
                  (2, 1, 256, 128, 128, True, None, "seg"),
                  (2, 1, 256, 128, 128, True, 96, "sinks-seg")]


@pytest.mark.parametrize("b,h,s,d,rows,causal,window,kind", MASKED_ALIGNED)
def test_masked_tile_loop_matches_jax_kernel_and_plain(_interpret, b, h, s, d, rows, causal,
                                                       window, kind):
    q, k, v = _qkv(b * h, s, d, seed=s + d + rows + len(kind))
    sinks, kvm, seg = _mask_operands(b, h, s, kind, seed=len(kind))
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(t).to(BF16) for t in (q, k, v))
    o, lse, _ = _emulate(tq, tk, tv, scale, causal, window, rows, sinks, kvm, seg, h)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    o_ref, lse_ref = A._flash_fwd(jq, jk, jv, scale, causal, bq=rows, bk=_key_tile(rows, d),
                                  h=h, window=window, sinks=sinks, **_jax_masks(kvm, seg))
    _close(o, lse, np.asarray(o_ref.astype(jnp.float32)), np.asarray(lse_ref).reshape(b * h, s))
    op, lp = TA._plain_flash_fwd(tq, tk, tv, scale, causal, window, sinks, kvm, seg, h)
    _close(o, lse, op, lp)
    if "dead" in kind:
        # the fully masked row: lse -1e30, o the mean of v, as on the TPU
        assert bool((lse[:h] == _NEG).all())
        np.testing.assert_allclose(o[:h].float().numpy(),
                                   tv[:h].float().mean(1, keepdim=True).expand(h, s, d).numpy(),
                                   rtol=2 ** -6, atol=2 ** -7)


# ragged S under the masks, a window that is not a tile multiple with sinks
# past the first tile, and a key row with ids and sinks together
MASKED_RAGGED = [(2, 1, 200, 128, 128, True, 70, "sinks"),
                 (1, 2, 333, 128, 64, True, 130, "sinks"),
                 (2, 1, 77, 128, 64, False, None, "kvm"),
                 (2, 1, 200, 256, 64, True, None, "seg"),
                 (2, 2, 300, 128, 128, True, 90, "sinks-seg")]


@pytest.mark.parametrize("b,h,s,d,rows,causal,window,kind", MASKED_RAGGED)
def test_masked_tile_loop_matches_plain_on_ragged_shapes(b, h, s, d, rows, causal, window,
                                                        kind):
    q, k, v = (torch.from_numpy(t).to(BF16) for t in _qkv(b * h, s, d, seed=s + d))
    sinks, kvm, seg = _mask_operands(b, h, s, kind, seed=s)
    o, lse, _ = _emulate(q, k, v, d ** -0.5, causal, window, rows, sinks, kvm, seg, h)
    op, lp = TA._plain_flash_fwd(q, k, v, d ** -0.5, causal, window, sinks, kvm, seg, h)
    _close(o, lse, op, lp)


def test_sink_tiles_come_first_and_stay_live():
    # S 4,608 at window 4,096 and 4 sinks (the path's prefill): the last
    # CTAs stream key tile 0 before their band, and a CTA whose band starts
    # at tile 0 streams it once
    bk, kt0, ns, tiles = _cta_tiles(4480, 128, 128, 4608, 4608, True, 4096, 4)
    assert (bk, ns, tiles[0], tiles[1]) == (128, 1, 0, kt0) and kt0 > 1
    assert _cta_tiles(0, 128, 128, 4608, 4608, True, 4096, 4)[3] == [0]
    # without sinks the band alone
    assert _cta_tiles(4480, 128, 128, 4608, 4608, True, 4096, 0)[3][0] == kt0


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("sq,window,sinks", [(576, 100, 4), (1088, 300, 70), (1000, 129, 1),
                                             (4608, 4096, 4)])
def test_cta_synchronisation_with_sinks(sq, window, sinks, rows):
    for q0 in range(0, sq, rows):
        _run_cta(q0, rows, sq, sq, True, window, sinks)
