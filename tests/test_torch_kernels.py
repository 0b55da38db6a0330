"""The port's kernel modules against the JAX package's kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each against
this same plain version).  The JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own CPU tests do, and its jnp / composed
references.  Inputs come from a numpy seed and pass between the frameworks
as numpy arrays.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import attention as A
from minidiff_tpu.kernels import layernorm as LN
from minidiff_tpu.kernels import matmul as MM
from minidiff_tpu.kernels import xent as XE
from minidiff_tpu_torch.kernels import attention as TA
from minidiff_tpu_torch.kernels import layernorm as TLN
from minidiff_tpu_torch.kernels import matmul as TMM
from minidiff_tpu_torch.kernels import xent as TXE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them (a
    float64 gradcheck took 450 s that way instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32: both sides compute the same f32 statistics; only the summation order
# differs (~1e-7 relative), so 1e-5 is far above the noise.  bf16: the
# outputs round to bf16 once from those f32 values, so they may differ by one
# bf16 ulp (2^-8 relative) where the f32 values straddle a rounding edge.
_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ln_inputs(dtype: str, rows: int = 16, d: int = 256, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((rows, d)) * 3 + 1
    a = rng.standard_normal((rows, d))
    g = 1 + 0.1 * rng.standard_normal(d)
    b = 0.1 * rng.standard_normal(d)
    jx = [jnp.asarray(v, dtype) for v in (x, a, g, b)]
    # the torch operands are the JAX operands' exact values
    tx = [torch.tensor(np.asarray(v, np.float32)).to(_TORCH[dtype])
          for v in jx]
    return jx, tx


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


# The jnp references, each jitted: run eagerly, every jnp operation compiles
# on its own, which made the references most of this file's time.
_ref_layernorm = jax.jit(LN._jnp_layernorm, static_argnums=3)
_ref_ln_grads = jax.jit(LN._jnp_ln_grads, static_argnums=3)
_ref_sdpa = jax.jit(A._composed_sdpa, static_argnums=(3, 4),
                    static_argnames=("window",))
_ref_xent = jax.jit(XE._jnp_xent)
_ref_xent_grad = jax.jit(XE._jnp_xent_grad)


_ref_rmsnorm = jax.jit(LN._jnp_rmsnorm, static_argnums=2)
_ref_rms_grads = jax.jit(LN._jnp_rms_grads, static_argnums=3)


@jax.jit
def _ref_add_rmsnorm(x, a, g):
    t = x + a
    return jnp.stack([t, LN._jnp_rmsnorm(t, g, 1e-6)])


@jax.jit
def _ref_addrms_dx(x, g, dy, g0):
    return LN._jnp_rms_grads(x, g, dy, 1e-6)[0] + g0


@jax.jit
def _ref_add_layernorm(x, a, g, b):
    t = x + a
    return jnp.stack([t, LN._jnp_layernorm(t, g, b, 1e-5)])


@jax.jit
def _ref_addln_dx(x, g, dy, g0):
    return LN._jnp_ln_grads(x, g, dy, 1e-5)[0] + g0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax_kernel(dtype):
    (x, _, g, b), (tx, _, tg, tb) = _ln_inputs(dtype)
    y = _to_np(TLN.layernorm(tx, tg, tb, 1e-5))
    kernel = LN._pallas_ln_fwd(x, g, b, 1e-5, 8, interpret=True)
    np.testing.assert_allclose(y, _np32(kernel), **_TOL[dtype])
    np.testing.assert_allclose(y, _np32(_ref_layernorm(x, g, b, 1e-5)),
                               **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_layernorm_matches_jax_kernel(dtype):
    (x, a, g, b), (tx, ta, tg, tb) = _ln_inputs(dtype, seed=1)
    pair = TLN.add_layernorm(tx, ta, tg, tb, 1e-5)
    assert pair.shape == (2,) + tuple(tx.shape) and pair.dtype == tx.dtype
    kernel = LN._pallas_addln_fwd(x, a, g, b, 1e-5, 8, interpret=True)
    # t = x + a is one rounding of the same sum on both sides: exact
    np.testing.assert_array_equal(_to_np(pair[0]), _np32(kernel[0]))
    np.testing.assert_allclose(_to_np(pair[1]), _np32(kernel[1]), **_TOL[dtype])
    ref = _ref_add_layernorm(x, a, g, b)
    np.testing.assert_allclose(_to_np(pair), _np32(ref), **_TOL[dtype])


def test_layernorm_keeps_float64():
    # f64 stays f64 end to end, as the JAX package's acc-dtype rule says
    (x, _, g, b), _ = _ln_inputs("float32", seed=2)
    x64, g64, b64 = (np.asarray(v, np.float64) for v in (x, g, b))
    y = TLN.layernorm(*(torch.from_numpy(v) for v in (x64, g64, b64)), 1e-5)
    assert y.dtype == torch.float64
    ref = _ref_layernorm(jnp.asarray(x64), jnp.asarray(g64), jnp.asarray(b64),
                         1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


@pytest.fixture
def _interpret(monkeypatch):
    """Run the JAX flash kernel's pallas_call in interpret mode on the CPU."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(A, "pl", patched)
    yield A


def _qkv(bh: int, s: int, d: int = 128, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_jax_kernel(_interpret, causal):
    q, k, v = _qkv(2, 256)
    scale = 1.0 / 128 ** 0.5
    o_ref, lse_ref = A._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale, causal, bq=128,
                                  bk=128)
    o, lse = TA.flash_fwd(*(torch.from_numpy(t) for t in (q, k, v)), scale,
                          causal)
    assert o.shape == q.shape and lse.shape == (2, 256)
    assert lse.dtype == torch.float32
    # f32 scores and softmax on both sides; the kernel's online softmax
    # rescales across two key blocks, which moves the last few bits
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("s,causal", [(16, True), (200, True), (200, False)])
def test_sdpa_matches_composed_ragged(s, causal):
    q, k, v = (t.reshape(2, 2, s, 128) for t in _qkv(4, s, seed=s))
    ref = _ref_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           1.0 / 128 ** 0.5, causal)
    out = TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    assert out.shape == (2, 2, s, 128)
    # the same composed f32 algebra on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sdpa_window_matches_composed():
    q, k, v = (t.reshape(1, 2, 200, 128) for t in _qkv(2, 200, seed=3))
    ref = _ref_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           0.1, True, window=64)
    out = TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), causal=True,
                  scale=0.1, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="causal"):
        TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), window=64)


# the JAX ``_flash_eligible`` (with its Pallas switch on) and the port's
# ``flash_eligible`` agree on every head dim and dtype: the kernels take
# head dims 128 and 256 in f32 and bf16, everything else composes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256, 384])
def test_flash_eligible_follows_the_jax_rule(monkeypatch, hd, dtype):
    monkeypatch.setattr(A, "_pallas_enabled", lambda: True)
    shape = (2, 2, 16, hd)
    want = A._flash_eligible(*(jnp.zeros(shape, dtype) for _ in range(3)))
    tdt = {"float64": torch.float64, **_TORCH}[dtype]
    t = torch.zeros(shape, dtype=tdt)
    assert TA.flash_eligible(t, t, t) == want
    assert want == (hd in (128, 256) and dtype != "float64")
    # mixed dtypes and mismatched K/V never take the kernels
    assert not TA.flash_eligible(t, t, t.to(torch.float16))
    assert not TA.flash_eligible(t, t[:, :1], t)


def test_composed_route_at_head_dim_32_matches_jax(monkeypatch):
    # TransformerLM()'s own head dim: the composed forward under torch
    # autograd, value and gradients against JAX's composed path (f64)
    flash = []
    fwd = TA.flash_fwd
    monkeypatch.setattr(TA, "flash_fwd", lambda *a: flash.append(1) or fwd(*a))
    rng = np.random.RandomState(13)
    q, k, v, do = (rng.standard_normal((2, 2, 24, 32)) for _ in range(4))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = TA.sdpa(tq, tk, tv, causal=True)
    assert not flash
    out.backward(torch.from_numpy(do))
    ref, vjp = jax.vjp(lambda a, b, c: A._composed_sdpa(a, b, c, 32 ** -0.5, True),
                       *(jnp.asarray(t) for t in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)
    for got, want in zip((tq, tk, tv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10)
    # head dim 128 in f32 goes to the flash Function
    q4 = torch.zeros(1, 1, 8, 128, requires_grad=True)
    TA.sdpa(q4, q4, q4)
    assert flash == [1]


def test_norm_rule_composes_wide_and_ragged_rows(monkeypatch):
    # the kernels take f32 / bf16 rows their 16-byte vectors divide, up to
    # MAX_WIDTH (shrunk here); wider or ragged rows, and f64, compose
    monkeypatch.setattr(TLN, "MAX_WIDTH", 128)
    f32, bf16 = torch.float32, torch.bfloat16
    rule = TLN.uses_kernel
    assert rule(torch.zeros(4, 128, dtype=f32)) and rule(torch.zeros(2, 120, dtype=bf16))
    assert not rule(torch.zeros(4, 256, dtype=f32))      # above MAX_WIDTH
    assert not rule(torch.zeros(4, 130, dtype=f32))      # 130 % 4
    assert not rule(torch.zeros(4, 124, dtype=bf16))     # 124 % 8
    assert not rule(torch.zeros(4, 64, dtype=torch.float64))
    # the composed rows give the plain version's values, forward and back
    rng = np.random.RandomState(14)
    x, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
            for s in ((4, 256), (256,)))
    y = TLN.rmsnorm(x, g)
    y.backward(torch.ones_like(y))
    torch.testing.assert_close(y, TLN._plain_rmsnorm(x, g), rtol=0, atol=0)
    dx, dg = TLN._plain_rms_grads(x.detach(), g.detach(), torch.ones_like(y))
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(g.grad, dg, rtol=0, atol=0)


def _ln_bwd_inputs(dtype: str, seed: int):
    """x, g, dy, g0 as JAX and torch operands of the same values."""
    (x, a, g, _), (tx, ta, tg, _) = _ln_inputs(dtype, seed=seed)
    rng = np.random.RandomState(seed + 100)
    dy = rng.standard_normal(x.shape)
    jdy = jnp.asarray(dy, x.dtype)
    tdy = torch.tensor(np.asarray(jdy, np.float32)).to(_TORCH[dtype])
    return (x, g, jdy, a), (tx, tg, tdy, ta)


# dx as the forward's bf16 rule (one rounding of f32 values summed in
# another order); dg and db are f32 sums over 16 rows cast once to g's dtype
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_grads_match_jax_kernel(dtype):
    (x, g, dy, _), (tx, tg, tdy, _) = _ln_bwd_inputs(dtype, seed=4)
    got = TLN.ln_grads(tx, tg, tdy, 1e-5)
    kernel = LN._pallas_ln_bwd(x, g, dy, 1e-5, 8, interpret=True)
    ref = _ref_ln_grads(x, g, dy, 1e-5)
    for out, k, r in zip(got, kernel, ref):
        assert out.dtype == _TORCH[dtype]
        np.testing.assert_allclose(_to_np(out), _np32(k), **_TOL[dtype])
        np.testing.assert_allclose(_to_np(out), _np32(r), **_TOL[dtype])


# dx = round(dx_ln) + g0 rounds twice in bf16: the first rounding may differ
# by one ulp of dx_ln (values of order 1) before g0 is added, so bf16 takes
# an absolute 2^-6 beside the relative ulp
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_addln_grads_match_jax_kernel(dtype):
    (x, g, dy, g0), (tx, tg, tdy, tg0) = _ln_bwd_inputs(dtype, seed=5)
    got = TLN.addln_grads(tx, tg, tdy, tg0, 1e-5)
    kernel = LN._pallas_addln_bwd(x, g, dy, g0, 1e-5, 8, interpret=True)
    tol = dict(_TOL[dtype], atol=2 ** -6) if dtype == "bfloat16" else _TOL[dtype]
    for out, k in zip(got, kernel):
        np.testing.assert_allclose(_to_np(out), _np32(k), **tol)
    np.testing.assert_allclose(_to_np(got[0]), _np32(_ref_addln_dx(x, g, dy, g0)),
                               **tol)


# RMSNorm at d = 256 over 24 rows (no power of two; the Pallas row block
# is 8).  f32: both sides compute the same f32 statistics in another
# summation order (~1e-7 relative): 1e-6.  bf16: the outputs round to bf16
# once from those f32 values: one bf16 ulp (2^-7 relative).  dg is an f32
# sum over the 24 rows cast once to g's dtype.
_RMS_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
            "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


def _rms_inputs(dtype: str, seed: int):
    """x, a, g, dy, g0 (24, 256) as JAX and torch operands of the same values."""
    (x, a, g, _), (tx, ta, tg, _) = _ln_inputs(dtype, rows=24, seed=seed)
    rng = np.random.RandomState(seed + 100)
    jdy, jg0 = (jnp.asarray(rng.standard_normal(x.shape), x.dtype) for _ in range(2))
    tdy, tg0 = (torch.tensor(np.asarray(v, np.float32)).to(_TORCH[dtype])
                for v in (jdy, jg0))
    return (x, a, g, jdy, jg0), (tx, ta, tg, tdy, tg0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax_kernels(dtype):
    (x, a, g, _, _), (tx, ta, tg, _, _) = _rms_inputs(dtype, seed=11)
    y = TLN.rmsnorm(tx, tg, 1e-6)
    assert y.dtype == tx.dtype
    kernel = LN._pallas_rms_fwd(x, g, 1e-6, 8, interpret=True)
    np.testing.assert_allclose(_to_np(y), _np32(kernel), **_RMS_TOL[dtype])
    np.testing.assert_allclose(_to_np(y), _np32(_ref_rmsnorm(x, g, 1e-6)),
                               **_RMS_TOL[dtype])
    pair = TLN.add_rmsnorm(tx, ta, tg, 1e-6)
    assert pair.shape == (2,) + tuple(tx.shape) and pair.dtype == tx.dtype
    kernel = LN._pallas_addrms_fwd(x, a, g, 1e-6, 8, interpret=True)
    # t = x + a is one rounding of the same sum on both sides: exact
    np.testing.assert_array_equal(_to_np(pair[0]), _np32(kernel[0]))
    np.testing.assert_allclose(_to_np(pair[1]), _np32(kernel[1]),
                               **_RMS_TOL[dtype])
    np.testing.assert_allclose(_to_np(pair), _np32(_ref_add_rmsnorm(x, a, g)),
                               **_RMS_TOL[dtype])


# dx as the forward's rule; the add's dx = round(dx_rms) + g0 rounds twice
# in bf16, so a one-ulp difference of dx_rms (values of order 1) stays
# absolute after g0 is added: 2^-6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_grads_match_jax_kernels(dtype):
    (x, _, g, dy, g0), (tx, _, tg, tdy, tg0) = _rms_inputs(dtype, seed=12)
    got = TLN.rms_grads(tx, tg, tdy, 1e-6)
    kernel = LN._pallas_rms_bwd(x, g, dy, 1e-6, 8, interpret=True)
    ref = _ref_rms_grads(x, g, dy, 1e-6)
    for out, k, r in zip(got, kernel, ref):
        assert out.dtype == _TORCH[dtype]
        np.testing.assert_allclose(_to_np(out), _np32(k), **_RMS_TOL[dtype])
        np.testing.assert_allclose(_to_np(out), _np32(r), **_RMS_TOL[dtype])
    got = TLN.addrms_grads(tx, tg, tdy, tg0, 1e-6)
    kernel = LN._pallas_addrms_bwd(x, g, dy, g0, 1e-6, 8, interpret=True)
    tol = (dict(_RMS_TOL[dtype], atol=2 ** -6) if dtype == "bfloat16"
           else _RMS_TOL[dtype])
    for out, k in zip(got, kernel):
        np.testing.assert_allclose(_to_np(out), _np32(k), **tol)
    np.testing.assert_allclose(_to_np(got[0]),
                               _np32(_ref_addrms_dx(x, g, dy, g0)), **tol)


def test_rms_functions_pass_gradcheck_in_float64():
    rng = np.random.RandomState(13)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    x, a, g = leaf(2, 3, 8), leaf(2, 3, 8), leaf(8)
    assert torch.autograd.gradcheck(lambda x, g: TLN.rmsnorm(x, g, 1e-5), (x, g))
    assert torch.autograd.gradcheck(lambda x, a, g: TLN.add_rmsnorm(x, a, g, 1e-5),
                                    (x, a, g))


def _xent_inputs(dtype: str, rows: int = 128, v: int = 256, seed: int = 6):
    rng = np.random.RandomState(seed)
    z = jnp.asarray(rng.standard_normal((rows, v)) * 3, dtype)
    lab = rng.randint(0, v, rows)
    g = rng.standard_normal(rows).astype(np.float32)
    tz = torch.tensor(np.asarray(z, np.float32)).to(_TORCH[dtype])
    return (z, jnp.asarray(lab), jnp.asarray(g)), (
        tz, torch.from_numpy(lab), torch.from_numpy(g))


# the loss is f32 on both sides from the same f32 row statistics: 1e-5.  dz
# rounds to the logits' dtype once from those values (bf16: one ulp)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_matches_jax_kernels(dtype):
    (z, lab, g), (tz, tlab, tg) = _xent_inputs(dtype)
    loss = TXE.xent_fwd(tz, tlab)
    assert loss.dtype == torch.float32 and loss.shape == (128,)
    np.testing.assert_allclose(
        loss.numpy(), _np32(XE._pallas_xent_fwd(z, lab, 128, interpret=True)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), _np32(_ref_xent(z, lab)),
                               rtol=1e-5, atol=1e-5)
    dz = TXE.xent_grad(tz, tlab, tg)
    assert dz.dtype == tz.dtype
    np.testing.assert_allclose(
        _to_np(dz), _np32(XE._pallas_xent_bwd(z, lab, g, 128, interpret=True)),
        **_TOL[dtype])
    np.testing.assert_allclose(_to_np(dz), _np32(_ref_xent_grad(z, lab, g)),
                               **_TOL[dtype])


# the tape's entries, kernels.xent.loss / loss_grad, on (..., V) logits with
# V = 10: the tape MLP's rows, which are no whole number of the CUDA kernels'
# 16-byte vectors.  float64 takes the plain version on every device.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_xent_tape_entries_match_jax(dtype):
    rng = np.random.RandomState(7)
    z = jnp.asarray(rng.standard_normal((24, 10)) * 3, dtype)
    lab = rng.randint(0, 10, 24)
    g = rng.standard_normal(24).astype(np.float64 if dtype == "float64"
                                       else np.float32)
    # the torch operands are the JAX operands' exact values
    tz = torch.from_numpy(np.array(z, np.float64)).to(
        _TORCH.get(dtype, torch.float64)).reshape(4, 6, 10)
    tlab, tg = torch.from_numpy(lab).reshape(4, 6), torch.from_numpy(g).reshape(4, 6)
    f64 = dtype == "float64"
    as_np = (lambda a: np.asarray(a)) if f64 else _np32
    loss = TXE.loss(tz, tlab)
    assert loss.shape == (4, 6)
    assert loss.dtype == (torch.float64 if f64 else torch.float32)
    np.testing.assert_allclose(loss.reshape(-1).numpy(), as_np(_ref_xent(z, lab)),
                               rtol=1e-12 if f64 else 1e-5,
                               atol=1e-12 if f64 else 1e-5)
    dz = TXE.loss_grad(tz, tlab, tg)
    assert dz.shape == (4, 6, 10) and dz.dtype == tz.dtype
    np.testing.assert_allclose(
        _to_np(dz).reshape(24, 10), as_np(_ref_xent_grad(z, lab, jnp.asarray(g))),
        **(dict(rtol=1e-12, atol=1e-12) if f64 else _TOL[dtype]))


# every tape entry (the norms', the quantized ops', the loss's) takes the
# kernel's wrapper by the leading operand's dtype alone: an f32 or bf16 x
# with an operand of another dtype still reaches the wrapper, whose checks
# raise on the card; f64 takes the plain version
@pytest.mark.parametrize("x_dtype,other,route", [
    (torch.float32, torch.float32, "kernel"),
    (torch.bfloat16, torch.bfloat16, "kernel"),
    (torch.float32, torch.bfloat16, "kernel"),
    (torch.bfloat16, torch.float64, "kernel"),
    (torch.float64, torch.float64, "plain"),
    (torch.float64, torch.float32, "plain")])
def test_tape_entry_chooses_by_leading_dtype(x_dtype, other, route):
    from minidiff_tpu_torch.kernels import _build
    from minidiff_tpu_torch.kernels import quant as TQ

    entry = _build.tape_entry("op", lambda x, g: "kernel", lambda x, g: "plain")
    assert entry.__name__ == "op"
    assert entry(torch.zeros(2, 8, dtype=x_dtype), torch.ones(8, dtype=other)) == route
    # the shipped entries take that rule: on the CPU both routes run the
    # plain version, so an f32 x with a bf16 gain gives the plain value
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((3, 16))).to(x_dtype)
    g = torch.linspace(0.5, 1.5, 16, dtype=other)
    torch.testing.assert_close(TLN.for_tape("rmsnorm")(x, g, 1e-5),
                               TLN._plain_rmsnorm(x, g, 1e-5), rtol=0, atol=0)
    assert TQ.for_tape("dequant_matmul").__name__ == "dequant_matmul"


# both sides take the same q, k, v, do and the same o and lse (the port's
# plain forward's: the forward is held to the JAX kernel above), so only the
# order of f32 sums differs (2 key or query tiles of 128): 2e-5 in f32.
# bf16: P and dS round to bf16 at the same points, so the three products
# differ by accumulation order plus an occasional ulp of P or dS flipped by
# it; the outputs round once more: 2 ulp (2^-6) relative, and 2^-6 absolute
# on gradients of order 1.
@pytest.mark.parametrize("s,causal,window,dtype", [
    (256, True, None, "float32"), (128, False, None, "float32"),
    (256, True, 100, "float32"), (256, True, None, "bfloat16")])
def test_flash_bwd_matches_jax_kernels(_interpret, s, causal, window, dtype):
    rng = np.random.RandomState(7)
    q, k, v, do = (jnp.asarray(rng.standard_normal((2, s, 128)), dtype)
                   for _ in range(4))
    scale = 1.0 / 128 ** 0.5

    def tt(a):
        return torch.tensor(np.asarray(a, np.float32)).to(_TORCH[dtype])

    o, lse = TA._plain_flash_fwd(tt(q), tt(k), tt(v), scale, causal, window)
    ref = A._flash_bwd(q, k, v, jnp.asarray(_to_np(o), dtype),
                       jnp.asarray(lse.numpy()), do, scale, causal, bq=128,
                       bk=128, window=window)
    got = TA.flash_bwd(tt(q), tt(k), tt(v), o, lse, tt(do), scale, causal,
                       window)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=2 ** -6, atol=2 ** -6))
    for name, out, r in zip("qkv", got, ref):
        assert out.shape == (2, s, 128) and out.dtype == _TORCH[dtype]
        np.testing.assert_allclose(_to_np(out), _np32(r), err_msg=f"d{name}",
                                   **tol)


def test_plain_flash_bwd_matches_autograd_of_composed_attention():
    # the composed f64 attention differentiated by autograd: an independent
    # check of the closed-form backward, with a window
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 40, 16)))
                   for _ in range(4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = TA._plain_flash_fwd(*qkv, 0.3, True, 7)
    o.backward(do)
    got = TA.flash_bwd(q, k, v, o.detach(), lse.detach(), do, 0.3, True, 7)
    for out, t in zip(got, qkv):
        np.testing.assert_allclose(out.numpy(), t.grad.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_functions_pass_gradcheck_in_float64():
    rng = np.random.RandomState(9)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    x, a, g, b = leaf(2, 3, 8), leaf(2, 3, 8), leaf(8), leaf(8)
    assert torch.autograd.gradcheck(TLN.layernorm, (x, g, b))
    assert torch.autograd.gradcheck(TLN.add_layernorm, (x, a, g, b))
    q, k, v = leaf(1, 1, 8, 4), leaf(1, 1, 8, 4), leaf(1, 1, 8, 4)
    for causal, window in ((True, None), (False, None), (True, 3)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: TA.sdpa(q, k, v, causal=causal, scale=0.4,
                                    window=window), (q, k, v))
    lab = torch.from_numpy(rng.randint(0, 10, (2, 3)))
    assert torch.autograd.gradcheck(lambda z: TXE.softmax_xent(z, lab),
                                    (leaf(2, 3, 10),))


def test_cpu_wrappers_launch_nothing():
    from minidiff_tpu_torch import kernels

    kernels.reset_launch_counts()
    (_, _, _, _), (tx, ta, tg, tb) = _ln_inputs("float32")
    for t in (tx, ta, tg, tb):
        t.requires_grad_()
    out = TLN.layernorm(tx, tg, tb).sum() + TLN.add_layernorm(tx, ta, tg, tb).sum()
    q, k, v = (torch.from_numpy(t).reshape(1, 1, 16, 128).requires_grad_()
               for t in _qkv(1, 16))
    out = out + TA.sdpa(q, k, v, causal=True).sum()
    z = torch.from_numpy(_qkv(1, 16)[0][0]).requires_grad_()
    out = out + TXE.softmax_xent(z, torch.arange(16)).sum()
    out.backward()
    from minidiff_tpu_torch.kernels import paged as TPG
    from minidiff_tpu_torch.kernels import quant as TQ

    x = torch.randn(8, 256)
    TQ.dequant_matmul(x, *TQ.quantize_int8(torch.randn(256, 64)))
    TQ.dequant_matmul4(x, *TQ.quantize_int4(torch.randn(256, 64)))
    TQ.dequant_matmul_bmm(x.reshape(2, 4, 256),
                          *TQ.quantize_int8_stacked(torch.randn(2, 256, 64)))
    k8, ks = TQ.quantize_int8_rows(torch.randn(1, 2, 128, 64))
    TQ.sdpa_int8_cache(torch.randn(1, 2, 1, 64), k8, ks, k8, ks, torch.tensor([5]))
    pool = torch.randn(2, 2, 128, 64)
    TPG.paged_attention(torch.randn(1, 2, 1, 64), pool, pool,
                        torch.tensor([[1]], dtype=torch.int32),
                        torch.tensor([5], dtype=torch.int32))
    xr, ar, gr = (torch.randn(*shape, requires_grad=True)
                  for shape in ((4, 256), (4, 256), (256,)))
    (TLN.rmsnorm(xr, gr).sum() + TLN.add_rmsnorm(xr, ar, gr).sum()).backward()
    from minidiff_tpu_torch.kernels import scan as TS

    sa, sb = (torch.rand(2, 16, 8, requires_grad=True) for _ in range(2))
    TS.linear_scan(sa, sb, axis=1).sum().backward()
    assert kernels.launch_counts() == {
        "ln_fwd": 0, "addln_fwd": 0, "ln_bwd": 0, "addln_bwd": 0,
        "rms_fwd": 0, "addrms_fwd": 0, "rms_bwd": 0, "addrms_bwd": 0,
        "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
        "xent_fwd": 0, "xent_bwd": 0,
        "matmul_nn": 0, "matmul_nt": 0, "matmul_tn": 0,
        "dq_mm": 0, "dq4_mm": 0, "dq_bmm": 0, "sdpa_int8": 0, "paged_attn": 0,
        "scan": 0}


@pytest.fixture
def _interpret_matmul(monkeypatch):
    """Run the JAX matmul kernels' pallas_call in interpret mode."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(MM, "pl", patched)
    yield MM


# the plain versions (an f32 accumulator, one cast) against the Pallas
# kernels at 128-tiles.  f32: the same f32 products summed in another order
# over K = 256: 1e-5.  bf16: both round the f32 sums to bf16 once; a sum
# near a rounding edge may round the other way: one bf16 ulp, 1e-2 relative.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
def test_plain_matmul_matches_jax_kernel(_interpret_matmul, variant, dtype):
    m, n, k = 256, 128, 256
    rng = np.random.RandomState(11)
    xs = {"nn": (m, k), "nt": (m, k), "tn": (k, m)}[variant]
    ys = {"nn": (k, n), "nt": (n, k), "tn": (k, n)}[variant]
    x = jnp.asarray(rng.standard_normal(xs), dtype)
    y = jnp.asarray(rng.standard_normal(ys), dtype)
    kernel = {"nn": MM._pallas_matmul_2d, "nt": MM._pallas_matmul_nt_2d,
              "tn": MM._pallas_matmul_tn_2d}[variant]
    ref = kernel(x, y, bm=128, bn=128, bk=128)

    def tt(a):
        return torch.tensor(np.asarray(a, np.float32)).to(_TORCH[dtype])

    got = TMM._plain(variant, tt(x), tt(y))
    assert got.shape == (m, n) and got.dtype == _TORCH[dtype]
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_to_np(got), _np32(ref), rtol=tol, atol=tol)


def test_matmul_dispatch_rule(monkeypatch):
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    rule = TMM.uses_kernel
    # 2-D, one dtype of f32 / bf16, at least 2^31 flops
    assert rule("nn", (4096, 4096), (4096, 4096), bf16, bf16)
    assert rule("nn", (1024, 1024), (1024, 1024), f32, f32)  # 2 * 2^30
    assert not rule("nn", (1024, 1024), (1024, 1023), f32, f32)
    assert rule("tn", (8192, 784), (8192, 4096), f32, f32)  # the MLP's dW1
    assert not rule("nt", (8192, 10), (4096, 10), f32, f32)  # its dh: 0.67 GF
    assert not rule("nn", (4096, 4096), (4096, 4096), f64, f64)
    assert not rule("nn", (4096, 4096), (4096, 4096), f32, bf16)
    assert not rule("nn", (2, 4096, 4096), (4096, 4096), f32, f32)
    assert not rule("nt", (4096, 4096), (4096, 4095), f32, f32)  # k differs
    assert rule("nt", (4096, 4096), (4096, 4096), f32, f32)
    # the plan picks a tile inside the kernel: which products launch does
    # not depend on it, at any of its routes, at and under 2^31 flops
    for variant, (m, n, k), dtype, route in (
            ("nn", (4096,) * 3, bf16, "wgmma"), ("nt", (1030,) * 3, bf16, "wmma"),
            ("tn", (2048,) * 3, f32, "ffma"), ("nt", (8192, 8192, 16), bf16, "wgmma"),
            ("tn", (784, 4096, 8192), f32, "ffma"), ("nn", (512,) * 3, bf16, "wgmma")):
        assert TMM.mm_plan(variant, m, n, k, dtype).route == route
        xs = (k, m) if variant == "tn" else (m, k)
        ys = (n, k) if variant == "nt" else (k, n)
        assert rule(variant, xs, ys, dtype, dtype) == (2 * m * n * k >= 2 ** 31)
    assert set(TMM.LAUNCHES) == {"matmul_nn", "matmul_nt", "matmul_tn"}
    # a product that meets the rule runs the plain version on the CPU and
    # launches nothing; one that does not goes to torch.matmul
    from minidiff_tpu_torch import kernels

    monkeypatch.setattr(TMM, "_MIN_FLOPS", 2 * 8 * 8 * 8)
    rng = np.random.RandomState(12)
    x, y = (torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
            for _ in range(2))
    plain = []
    monkeypatch.setattr(TMM, "_plain", lambda *a: plain.append(a[0]) or x)
    kernels.reset_launch_counts()
    TMM.matmul(x, y), TMM.matmul_nt(x, y), TMM.matmul_tn(x, y)
    assert plain == ["nn", "nt", "tn"]
    TMM.matmul(x[:4], y[:, :4].double())  # mixed dtypes: numpy promotion
    assert plain == ["nn", "nt", "tn"]
    assert set(kernels.launch_counts().values()) == {0}
    # a launch passes the plan's tile and group to the C entry and counts
    # one launch under its variant's name, whatever the tile
    import contextlib

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(TMM._build, "function", lambda name: entry)
    monkeypatch.setattr(TMM._build, "stream", lambda: 0)
    monkeypatch.setattr(TMM.torch.cuda, "device", lambda d: contextlib.nullcontext())
    for variant, (m, n, k), dtype in (("nn", (64, 64, 64), bf16), ("nt", (40, 24, 1030), bf16),
                                      ("tn", (24, 40, 16), f32)):
        before = dict(TMM.LAUNCHES)
        xs = (k, m) if variant == "tn" else (m, k)
        ys = (n, k) if variant == "nt" else (k, n)
        out = TMM._launch(variant, torch.zeros(xs, dtype=dtype), torch.zeros(ys, dtype=dtype))
        assert out.shape == (m, n) and out.dtype == dtype
        plan = TMM.mm_plan(variant, m, n, k, dtype)
        assert calls[-1][3:-1] == (m, n, k, TMM._VARIANTS[variant],
                                   TMM._build.DTYPE_CODES[dtype], plan.tile_n, plan.group)
        assert {name: TMM.LAUNCHES[name] - before[name] for name in before} == {
            name: int(name == f"matmul_{variant}") for name in before}
    kernels.reset_launch_counts()

