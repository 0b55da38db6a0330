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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minidiff_tpu.kernels import attention as A
from minidiff_tpu.kernels import layernorm as LN
from minidiff_tpu_torch.kernels import attention as TA
from minidiff_tpu_torch.kernels import layernorm as TLN

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
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax_kernel(dtype):
    (x, _, g, b), (tx, _, tg, tb) = _ln_inputs(dtype)
    y = _to_np(TLN.layernorm(tx, tg, tb, 1e-5))
    kernel = LN._pallas_ln_fwd(x, g, b, 1e-5, 8, interpret=True)
    np.testing.assert_allclose(y, _np32(kernel), **_TOL[dtype])
    np.testing.assert_allclose(y, _np32(LN._jnp_layernorm(x, g, b, 1e-5)),
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
    t = x + a
    ref = jnp.stack([t, LN._jnp_layernorm(t, g, b, 1e-5)])
    np.testing.assert_allclose(_to_np(pair), _np32(ref), **_TOL[dtype])


def test_layernorm_keeps_float64():
    # f64 stays f64 end to end, as the JAX package's acc-dtype rule says
    (x, _, g, b), _ = _ln_inputs("float32", seed=2)
    x64, g64, b64 = (np.asarray(v, np.float64) for v in (x, g, b))
    y = TLN.layernorm(*(torch.from_numpy(v) for v in (x64, g64, b64)), 1e-5)
    assert y.dtype == torch.float64
    ref = LN._jnp_layernorm(jnp.asarray(x64), jnp.asarray(g64),
                            jnp.asarray(b64), 1e-5)
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
    ref = A._composed_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           1.0 / 128 ** 0.5, causal)
    out = TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    assert out.shape == (2, 2, s, 128)
    # the same composed f32 algebra on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sdpa_window_matches_composed():
    q, k, v = (t.reshape(1, 2, 200, 128) for t in _qkv(2, 200, seed=3))
    ref = A._composed_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           0.1, True, window=64)
    out = TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), causal=True,
                  scale=0.1, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="causal"):
        TA.sdpa(*(torch.from_numpy(t) for t in (q, k, v)), window=64)


def test_cpu_wrappers_launch_nothing():
    from minidiff_tpu_torch import kernels

    kernels.reset_launch_counts()
    (_, _, _, _), (tx, ta, tg, tb) = _ln_inputs("float32")
    TLN.layernorm(tx, tg, tb)
    TLN.add_layernorm(tx, ta, tg, tb)
    q, k, v = (torch.from_numpy(t).reshape(1, 1, 16, 128) for t in _qkv(1, 16))
    TA.sdpa(q, k, v, causal=True)
    assert kernels.launch_counts() == {"ln_fwd": 0, "addln_fwd": 0,
                                       "flash_fwd": 0}
