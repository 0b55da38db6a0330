"""The port's functional transforms against the JAX package's, on the CPU.

``value_and_grad`` (pytrees, ``has_aux``), ``grad``, ``vjp``, ``jvp``,
``hvp`` and ``hessian`` on seeded float64 inputs through ``minidiff_tpu``
(numpy backend) and ``minidiff_tpu_torch`` (``"cpu"`` backend); then the two
paths that ``chip_smoke.py`` drives on the card, at a tiny size: the
matmul step of the JAX repo's ``bench.py`` and the MLP of
``benchmarks/mlp_bench.py``.  The same float64 arithmetic on both sides:
1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minidiff_tpu as jmd
import minidiff_tpu_torch as md

TOL = dict(rtol=1e-10, atol=1e-10)


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


def _r(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape)


def _np(t):
    return np.asarray(t, dtype=np.float64)


def _close(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def _rosen(m):
    def f(t):
        return m.sum(100.0 * (t[1:] - t[:-1] ** 2) ** 2 + (1.0 - t[:-1]) ** 2)

    return f


def _rosen_hessian(x):
    """The closed form of the Rosenbrock Hessian."""
    n = x.size
    h = np.zeros((n, n))
    for i in range(n - 1):
        h[i, i] += 1200 * x[i] ** 2 - 400 * x[i + 1] + 2
        h[i + 1, i + 1] += 200
        h[i, i + 1] = h[i + 1, i] = -400 * x[i]
    return h


def test_value_and_grad_of_pytrees_with_aux():
    params = {"w": _r(4, 3), "b": _r(3, seed=1), "layers": [_r(3, 3, seed=2)]}
    xv = _r(5, 4, seed=3)
    out = []
    for m in (jmd, md):
        p = {"w": m.Tensor(params["w"]), "b": m.Tensor(params["b"]),
             "layers": [m.Tensor(params["layers"][0])]}

        def loss(p, x):
            h = m.tanh(x @ p["w"] + p["b"]) @ p["layers"][0]
            return m.mean(h ** 2), h

        (value, aux), grads = m.value_and_grad(loss, has_aux=True)(p, m.Tensor(xv))
        assert set(grads) == {"w", "b", "layers"} and len(grads["layers"]) == 1
        assert p["w"].grad is None  # the caller's leaves are left alone
        out.append((value, aux, grads["w"], grads["b"], grads["layers"][0]))
    for r, g in zip(*out):
        _close(g, r)


def test_grad_over_several_argnums():
    av, bv = _r(3, 4), _r(4, seed=1)
    out = []
    for m in (jmd, md):
        ga, gb = m.grad(lambda a, b: m.sum(m.sin(a) * b), argnums=(0, 1))(
            m.Tensor(av), m.Tensor(bv))
        out.append((ga, gb))
    for r, g in zip(*out):
        _close(g, r)


def test_vjp_with_two_cotangents():
    av, c1, c2 = _r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2)
    out = []
    for m in (jmd, md):
        y, f = m.vjp(lambda a: m.exp(a) * a, m.Tensor(av))
        out.append((y, f(m.Tensor(c1)), f(m.Tensor(c2))))
    for r, g in zip(*out):
        _close(g, r)
    _close(out[1][1], c1 * np.exp(av) * (1 + av))


def test_jvp_and_hvp():
    xv, vv = _r(6), _r(6, seed=1)
    out = []
    for m in (jmd, md):
        y, t = m.jvp(lambda x: m.sin(x) * x)(m.Tensor(xv), m.Tensor(vv))
        hv = m.hvp(_rosen(m))(m.Tensor(xv), m.Tensor(vv))
        out.append((y, t, hv))
    for r, g in zip(*out):
        _close(g, r)
    _close(out[1][1], (np.cos(xv) * xv + np.sin(xv)) * vv)
    _close(out[1][2], _rosen_hessian(xv) @ vv)


def test_hessian_of_rosenbrock():
    xv = np.linspace(-1.2, 1.2, 8)
    ref = jmd.hessian(_rosen(jmd))(jmd.Tensor(xv))
    got = md.hessian(_rosen(md))(md.Tensor(xv))
    assert got.shape == (8, 8)
    _close(got, ref)
    _close(got, _rosen_hessian(xv))


def test_matmul_step_of_bench():
    # bench.py:196-234 at a tiny size in float64: value_and_grad of
    # sum(tanh(x @ w)), then the SGD update with lr 1e-6, three steps
    n = 16
    x0, w0 = _r(n, n), _r(n, n, seed=1) / np.sqrt(n)
    out = []
    for m in (jmd, md):
        vag = m.value_and_grad(lambda x, w: m.sum(m.tanh(x @ w)), argnums=(0, 1))
        x, w = m.Tensor(x0), m.Tensor(w0)
        values = []
        for _ in range(3):
            v, (gx, gw) = vag(x, w)
            values.append(float(v.item()))
            x, w = x - 1e-6 * gx, w - 1e-6 * gw
        out.append((np.array(values), gx, gw, x, w))
    for r, g in zip(*out):
        _close(g, r)


def _mlp_loss(m):
    # mlp_bench.py:80-84's network over a params dict, with the tape ops
    def loss(p, x, y):
        h = m.maximum(x @ p["w1"] + p["b1"], 0.0)
        logits = h @ p["w2"] + p["b2"]
        return m.mean(m.softmax_xent(logits, y))

    return loss


def test_mlp_loss_and_grads_of_mlp_bench():
    rng = np.random.RandomState(0)
    centroids = np.random.RandomState(42).standard_normal((10, 24))
    yv = rng.randint(0, 10, 16)
    xv = centroids[yv] + 0.3 * rng.standard_normal((16, 24))
    params = {"w1": _r(24, 32, seed=1) / np.sqrt(24), "b1": 0.1 * _r(32, seed=2),
              "w2": _r(32, 10, seed=3) / np.sqrt(32), "b2": 0.1 * _r(10, seed=4)}
    out = []
    for m in (jmd, md):
        p = {k: m.Tensor(v) for k, v in params.items()}
        losses = []
        for _ in range(3):
            loss, g = m.value_and_grad(_mlp_loss(m))(p, m.Tensor(xv), m.Tensor(yv))
            losses.append(float(loss.item()))
            p = {k: p[k] - 0.1 * g[k] for k in p}
        out.append((np.array(losses), *(g[k] for k in sorted(g)),
                    *(p[k] for k in sorted(p))))
    for r, g in zip(*out):
        _close(g, r)
    assert out[1][0][2] < out[1][0][0]  # the loss falls
