"""The port's tape engine against the JAX package's, on the CPU.

Each test runs the same seeded float64 inputs through ``minidiff_tpu`` (on
its numpy backend: the same tape over numpy arrays, no XLA compiles) and
``minidiff_tpu_torch`` (on its ``"cpu"`` backend) and compares the values
to 1e-12: both sides do the same float64 arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minidiff_tpu as jmd
import minidiff_tpu_torch as md

TOL = dict(rtol=1e-12, atol=1e-12)


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


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape)


def _both(fn):
    """fn(package) for each package, its results as numpy arrays."""
    out = []
    for m in (jmd, md):
        res = fn(m)
        out.append([None if r is None else np.asarray(r, dtype=np.float64)
                    for r in res])
    return out


def _assert_same(fn):
    ref, got = _both(fn)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if r is None or g is None:
            assert r is None and g is None
        else:
            assert r.shape == g.shape
            np.testing.assert_allclose(g, r, **TOL)


X = np.array([[0., 2., -2., 1.], [-1., -1., -2., -2.]])
Y = np.array([[2., 3., 4., 5.], [0., -1., -3., 2.]])


@pytest.mark.parametrize("ints", [False, True])
def test_readme_demo_first_and_second_order(ints):
    # the README's inputs are integers; numpy promotes sin of them to f64
    xv, yv = (X.astype(np.int64), Y.astype(np.int64)) if ints else (X, Y)

    def run(m):
        x = m.Tensor(xv, allow_grad=True)
        y = m.Tensor(yv, allow_grad=True)
        f = 2 * y * m.sin(x) - x ** 2
        f.backward(allow_higher_order=True)
        first = (f, x.grad, y.grad)
        x.grad.backward()
        return (*first, x.grad, y.grad)

    _assert_same(run)
    _, got = _both(run)
    np.testing.assert_allclose(got[1], 2 * Y * np.cos(X) - 2 * X, **TOL)
    np.testing.assert_allclose(got[2], 2 * np.sin(X), **TOL)
    np.testing.assert_allclose(got[3], -2 * Y * np.sin(X) - 2, **TOL)
    np.testing.assert_allclose(got[4], 2 * np.cos(X), **TOL)


def test_grads_only_on_allow_grad_leaves():
    def run(m):
        a = m.Tensor(_rand(3, 4), allow_grad=True)
        b = m.Tensor(_rand(3, 4, seed=1))  # no gradient wanted
        c = a * b
        d = m.sum(m.exp(c) + b)
        d.backward()
        assert b.grad is None and c.grad is None  # intermediates freed
        return (a.grad,)

    _assert_same(run)


def test_backward_on_leaf_or_untracked_is_a_noop():
    for m in (jmd, md):
        leaf = m.Tensor(_rand(3), allow_grad=True)
        leaf.backward()
        assert leaf.grad is None
        untracked = m.Tensor(_rand(3)) * 2
        untracked.backward()
        assert untracked.grad is None and untracked.op_node is None
        with m.no_grad():
            t = m.Tensor(_rand(3), allow_grad=True) * 2
        assert t.op_node is None
        t.backward()
        assert t.grad is None


def test_broadcasting_is_undone():
    def run(m):
        a = m.Tensor(_rand(4, 3), allow_grad=True)
        b = m.Tensor(_rand(3, seed=1), allow_grad=True)
        c = m.Tensor(_rand(4, 1, seed=2), allow_grad=True)
        s = m.Tensor(_rand(seed=3), allow_grad=True)  # 0-d
        out = m.sum((a * b + c) * s)
        out.backward()
        assert b.grad.shape == (3,) and c.grad.shape == (4, 1) and s.grad.shape == ()
        return a.grad, b.grad, c.grad, s.grad, m.unbroadcast(a, (1, 3))

    _assert_same(run)


def test_grads_accumulate_without_reset():
    def run(m):
        a = m.Tensor(_rand(5), allow_grad=True)
        out1 = m.sum(m.sin(a) * a)
        out1.backward()
        g1 = a.grad
        out2 = m.sum(m.exp(a))
        out2.backward(reset_grads=False)
        return g1, a.grad

    _assert_same(run)
    _, (g1, g2) = _both(run)
    a = _rand(5)
    np.testing.assert_allclose(g2 - g1, np.exp(a), **TOL)


@pytest.mark.parametrize("mode", ["keep", "prune", "destroy"])
def test_cleanup_modes(mode):
    def run(m):
        a = m.Tensor(_rand(3, 3), allow_grad=True)
        h = m.tanh(a @ a)
        out = m.sum(h * h)
        out.backward(cleanup_mode=mode, retain_grads=True)
        g1 = a.grad
        states = [h.op_node is None, out.op_node is None, h.grad is None]
        if mode == "destroy":
            # every tensor of the sweep is cut (the root is not in it)
            assert h.op_node is None
            return g1, np.array(states, float)
        # the graph survived: a second sweep gives the same gradient
        out.backward(cleanup_mode=mode)
        return g1, a.grad, np.array(states, float)

    _assert_same(run)


def test_higher_order_keeps_the_graph_under_destroy():
    def run(m):
        a = m.Tensor(_rand(4), allow_grad=True)
        out = m.sum(m.sin(a) ** 3)
        out.backward(allow_higher_order=True, cleanup_mode="destroy")
        assert out.op_node is not None  # destroy became prune
        g = a.grad
        g.backward()
        return g, a.grad

    _assert_same(run)


def test_reuse_graph_replays_the_cached_order():
    def build(m, seed):
        a = m.Tensor(_rand(3, 3, seed=seed), allow_grad=True)
        b = m.Tensor(_rand(3, seed=seed + 1), allow_grad=True)
        h = m.tanh(a @ a + b)
        return a, b, m.sum(h * m.exp(h) + a)

    plain = {}
    for seed in (0, 10):
        a, b, out = build(md, seed)
        out.backward()
        plain[seed] = (a.grad, b.grad)

    def run(m):
        results = []
        with m.reuse_graph():
            for i, seed in enumerate((0, 10)):
                a, b, out = build(m, seed)
                if i == 1:
                    # the same structure: the index paths come from the memo
                    memo = m.caching._replay_paths.get()
                    assert len(memo) == 1
                    assert m.backward_indices_for_root(out.op_node) is next(
                        iter(memo.values()))
                out.backward()
                results += [a.grad, b.grad]
        return results

    _assert_same(run)
    _, got = _both(run)
    for i, seed in enumerate((0, 10)):
        np.testing.assert_allclose(got[2 * i], np.asarray(plain[seed][0]), **TOL)
        np.testing.assert_allclose(got[2 * i + 1], np.asarray(plain[seed][1]), **TOL)


def test_probes_raise():
    for m in (jmd, md):
        p = m.Tensor(_rand(3), allow_grad=True)
        q = p * 2
        with pytest.raises(ValueError, match="mutate"):
            p += 1
        with pytest.raises(ValueError, match="cleanup_mode"):
            m.sum(q).backward(cleanup_mode="bogus")
        with pytest.raises(ValueError, match="intermediate"):
            q.allow_grad = False
        leaf = m.Tensor(_rand(3))
        leaf += 1  # an untracked tensor may change


def test_dtypes_follow_numpy_promotion():
    ints = np.arange(3)
    for m in (jmd, md):
        assert str(m.Tensor(2.0).dtype).endswith("float64")
        assert str(m.Tensor(ints).dtype).endswith("int64")
        assert str((m.Tensor(ints) * 0.5).dtype).endswith("float64")
        assert str((m.Tensor(ints) / 2).dtype).endswith("float64")
        assert str(m.sin(m.Tensor(ints)).dtype).endswith("float64")
        assert str((m.Tensor(ints) * 2).dtype).endswith("int64")
        assert str(m.ones(3).dtype).endswith("float64")
        assert str(m.arange(3).dtype).endswith("int64")
        f32 = m.Tensor(np.ones(3, np.float32))
        assert str((f32 * 2.5).dtype).endswith("float32")
        assert str((2.5 - f32).dtype).endswith("float32")


def test_default_backend_is_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert set(md.available_backends()) == {"cpu", "cuda"}
    with md.use_backend("cuda"):
        assert md.backend_name() == "cuda"
        with pytest.raises(RuntimeError, match=r'use_backend\("cpu"\)'):
            md.Tensor([1.0])
    assert md.backend_name() == "cpu"


# the graph-free factories: the same values as the JAX package's for the
# deterministic ones; the random ones draw from another generator, so only
# their shapes, dtypes and ranges are held
FACTORIES = [
    ("full_int", lambda m: m.full((2, 3), 3)),
    ("full_float", lambda m: m.full(4, 2.5)),
    ("full_like", lambda m: m.full_like(m.Tensor([1.0, 2.0]), 7)),
    ("ones_zeros", lambda m: m.stack([m.ones(3), m.zeros(3)], axis=1)),
    ("arange", lambda m: m.arange(0, 1, 0.25)),
    ("concatenate", lambda m: m.concatenate([m.Tensor(X), Y], axis=1)),
    ("tile", lambda m: m.tile(m.Tensor(X), 2)),
    ("repeat", lambda m: m.repeat(m.Tensor(X), 2, axis=0)),
    ("split", lambda m: m.stack(m.split(m.Tensor(X), 2, axis=1))),
    ("take_along_axis", lambda m: m.take_along_axis(
        m.Tensor(X), m.Tensor(np.array([[3], [0]])), axis=1)),
    ("isin", lambda m: m.isin(m.Tensor(X), m.Tensor([2.0, -2.0]))),
    ("unravel_index", lambda m: m.unravel_index(m.Tensor(np.array([5, 1])), (2, 3))),
    ("vmap", lambda m: m.vmap(lambda r: m.sum(m.sin(r) * r))(m.Tensor(X))),
]


@pytest.mark.parametrize("name,fn", FACTORIES, ids=[f[0] for f in FACTORIES])
def test_factories_match_jax(name, fn):
    ref, got = (np.asarray(fn(m)) for m in (jmd, md))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, **TOL)


def test_mutating_factories_match_jax():
    def run(m):
        a = m.zeros(4)
        m.index_add(a, np.array([0, 0, 3]), 1.5)
        b = m.zeros((2, 3))
        m.put_along_axis(b, m.Tensor(np.array([[0], [2]])), 5.0, axis=1)
        c = m.Tensor(X)
        c[1, ::2] = 9.0
        return a, b, c

    _assert_same(run)


def test_random_factories_draw_from_the_seeded_generator():
    md.seed(5)
    first = [np.asarray(t) for t in (md.rand(2, 3), md.randn(4), md.randint(0, 5, size=(6,)))]
    md.seed(5)
    again = [np.asarray(t) for t in (md.rand(2, 3), md.randn(4), md.randint(0, 5, size=(6,)))]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert first[0].dtype == np.float64 and first[0].shape == (2, 3)
    assert ((first[0] >= 0) & (first[0] < 1)).all()
    assert first[2].dtype == np.int64 and ((first[2] >= 0) & (first[2] < 5)).all()
    assert sorted(np.asarray(md.permutation(5)).tolist()) == [0, 1, 2, 3, 4]
    draws = np.asarray(md.choice(md.Tensor([1.0, 2.0, 3.0]), size=2, replace=False))
    assert len(set(draws.tolist())) == 2 and set(draws.tolist()) <= {1.0, 2.0, 3.0}
    b = np.asarray(md.binomial(10, 0.5, size=4))
    assert b.shape == (4,) and ((b >= 0) & (b <= 10)).all()
    t = md.Tensor(np.arange(6.0))
    md.shuffle(t)
    assert sorted(np.asarray(t).tolist()) == list(np.arange(6.0))
