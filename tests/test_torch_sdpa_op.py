"""The tape's ``sdpa`` op in the port against the JAX package's, on the CPU.

``md.sdpa(q, k, v, causal=, scale=, mask=, window=, sinks=, segment_ids=)``
with each mask the JAX op takes: the value, the three first-order
gradients and a second-order ``hvp``, both sides in float64 (the JAX side on
its numpy backend: the composed attention; the port's composed VJPs in
framework ops), 1e-10.  At head dim 128 in float32 the port's forward is
the flash forward and its first-order VJPs one run of the flash backward
(``kernels.attention.flash_grads``; their plain versions here), held to the
JAX op within 1e-5.  A fully masked key row is held to the JAX flash
kernels in interpret mode (o the mean of v, lse -1e30, P = 1 in the
backward), as ``tests/test_torch_flash_plan.py`` runs them.
"""

from __future__ import annotations

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minidiff_tpu as jmd
import minidiff_tpu_torch as md
from minidiff_tpu.kernels import attention as A
from minidiff_tpu_torch.kernels import attention as TA
from minidiff_tpu_torch.ops import definitions as tdefs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    with jmd.use_backend("numpy"), md.use_backend("cpu"):
        yield


def _np(t):
    d = t._data
    return d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


B, H, S, D = 2, 2, 10, 4
_KV = (np.arange(S)[None] < np.array([7, 10])[:, None])
_SEG = np.array([[0, 0, 0, 1, 1, 1, 1, 2, 2, -1], [0] * 4 + [1] * 6])
# keys masked inside documents, none a diagonal: every row keeps a key (a
# row with none is held to the flash kernels below, where the JAX
# package's composed and flash paths part)
_KV_SPARSE = np.ones((B, S), bool)
_KV_SPARSE[0, [1, 5]] = _KV_SPARSE[1, 6] = False
# (name, kwargs): each mask the JAX op takes, alone and together
CASES = [
    ("causal", dict(causal=True)),
    ("window_sinks", dict(causal=True, window=3, sinks=2)),
    ("window_no_sinks", dict(causal=True, window=4, scale=0.3)),
    ("kv_mask_4d", dict(mask=_KV.reshape(B, 1, 1, S))),
    ("kv_mask_1d", dict(causal=True, mask=_KV[1])),
    ("dense_mask_3d", dict(mask=np.tril(np.ones((S, S)), 1)[None].repeat(B, 0) > 0)),
    ("segments", dict(causal=True, segment_ids=_SEG)),
    ("segments_window_kv", dict(causal=True, window=5, sinks=1, segment_ids=_SEG,
                                mask=_KV_SPARSE.reshape(B, 1, 1, S))),
]


def _qkv(seed=0, d=D, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, S, d)).astype(dtype) for _ in range(4)]


def _run(mod, q, k, v, ct, kw, wrap):
    ts = [mod.Tensor(a, allow_grad=True) for a in (q, k, v)]
    kw = {n: (wrap(a) if n in ("mask", "segment_ids") else a) for n, a in kw.items()}
    out = mod.sdpa(*ts, **kw)
    (out * mod.Tensor(ct)).sum().backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_value_and_grads_match_jax(name, kw):
    q, k, v, ct = _qkv(seed=len(name))
    ref, rgrads = _run(jmd, q, k, v, ct, kw, jmd.Tensor)
    out, grads = _run(md, q, k, v, ct, kw, md.Tensor)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-10, atol=1e-10)
    for n, g, r in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-10, atol=1e-10, err_msg=n)


@pytest.mark.parametrize("name,kw", [CASES[1], CASES[3], CASES[7]],
                         ids=[CASES[1][0], CASES[3][0], CASES[7][0]])
def test_second_order_hvp_matches_jax(name, kw):
    q, k, v, _ = _qkv(seed=11)
    tangent = np.random.RandomState(12).standard_normal(q.shape)

    def hv(mod):
        kk, vv = mod.Tensor(k), mod.Tensor(v)
        extra = {n: (mod.Tensor(a) if n in ("mask", "segment_ids") else a)
                 for n, a in kw.items()}

        def f(x):
            o = mod.sdpa(x, kk, vv, **extra)
            return (o * o).sum()
        return mod.hvp(f)(mod.Tensor(q), mod.Tensor(tangent))

    got, ref = hv(md), hv(jmd)
    got = got[1] if isinstance(got, tuple) else got
    ref = ref[1] if isinstance(ref, tuple) else ref
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,kw", [CASES[1], CASES[3], CASES[6], CASES[7]],
                         ids=[CASES[1][0], CASES[3][0], CASES[6][0], CASES[7][0]])
def test_first_order_runs_the_flash_backward(name, kw, monkeypatch):
    # head dim 128, float32: the flash forward and one flash backward for
    # the three VJPs (counted), held to the JAX op in float64
    q, k, v, ct = _qkv(seed=3, d=128, dtype=np.float32)
    calls = []
    real = TA.flash_grads
    monkeypatch.setattr(TA, "flash_grads",
                        lambda *a, **kw_: calls.append(1) or real(*a, **kw_))
    out, grads = _run(md, q, k, v, ct, kw, md.Tensor)
    assert len(calls) == 1
    ref, rgrads = _run(jmd, *(a.astype(np.float64) for a in (q, k, v, ct)), kw, jmd.Tensor)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    for n, g, r in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-5, atol=1e-5, err_msg=n)


def test_only_key_padding_masks_ride_into_the_flash_kernels():
    assert TA._kv_mask_shape_ok((S,), B, S) and TA._kv_mask_shape_ok((B, 1, 1, S), B, S)
    assert TA._kv_mask_shape_ok((1, S), B, S) and TA._kv_mask_shape_ok((B, 1, S), B, S)
    assert not TA._kv_mask_shape_ok((S, S), B, S)  # aligns against Sq
    assert not TA._kv_mask_shape_ok((B, H, 1, S), B, S)
    assert TA._seg_shape_ok((S,), B, S, S) and TA._seg_shape_ok((1, S), B, S, S)
    assert not TA._seg_shape_ok((S,), B, S, S + 1)
    q = torch.zeros(B, H, S, 128)
    assert TA.flash_grads_decision(q, q, q, True, mask=_KV.reshape(B, 1, 1, S))
    assert not TA.flash_grads_decision(q, q, q, True, mask=np.ones((B, H, S, S)))
    assert not TA.flash_grads_decision(q, q, q, False, window=4)
    with pytest.raises(ValueError, match="S_q == S_k"):
        TA.sdpa(q, q[:, :, :5], q[:, :, :5], segment_ids=_SEG)


@pytest.fixture
def _interpret(monkeypatch):
    """Run the JAX flash kernels' pallas_calls in interpret mode on the CPU."""
    import jax.experimental.pallas as realpl

    patched = types.SimpleNamespace(
        **{n: getattr(realpl, n) for n in dir(realpl) if not n.startswith("_")})
    patched.pallas_call = functools.partial(realpl.pallas_call, interpret=True)
    monkeypatch.setattr(A, "pl", patched)


def test_fully_masked_key_row_matches_jax_kernels(_interpret):
    # batch row 0 masks every key: its rows average v (lse -1e30), and the
    # backward takes P = 1 there, as the JAX kernels do; f32, 1e-5
    b, h, s, d = 2, 2, 128, 128
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.standard_normal((b * h, s, d)).astype(np.float32) for _ in range(4))
    kvm = np.ones((b, s), np.int32)
    kvm[0] = 0
    kvm[1, 100:] = 0
    jo, jl = A._flash_fwd(*(jnp.asarray(t) for t in (q, k, v)), 0.1, False, bq=128, bk=128,
                          mask=jnp.asarray(kvm), h=h)
    tt = [torch.from_numpy(t) for t in (q, k, v, do)]
    o, lse = TA.flash_fwd(*tt[:3], 0.1, False, kvm=torch.from_numpy(kvm), h=h)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(lse.numpy()[:h], np.full((h, s), -1e30, np.float32))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.numpy()[:h], np.broadcast_to(v[:h].mean(1, keepdims=True),
                                                             (h, s, d)), rtol=1e-5, atol=1e-5)
    ref = A._flash_bwd(*(jnp.asarray(t) for t in (q, k, v)), jo, jl, jnp.asarray(do), 0.1,
                       False, bq=128, bk=128, mask=jnp.asarray(kvm), h=h)
    got = TA.flash_bwd(*tt[:3], torch.from_numpy(np.asarray(jo)),
                       torch.from_numpy(np.asarray(jl)), tt[3], 0.1, False,
                       kvm=torch.from_numpy(kvm), h=h)
    for n, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4, err_msg=n)


def test_sdpa_is_an_op_of_the_port():
    assert "sdpa" in tdefs.__all__ and callable(md.sdpa)
