"""The port's ``md.jit`` against the JAX package's, on the CPU.

``minidiff_tpu_torch.jit`` captures a tape program as a CUDA graph per key
(``func.py``; a ``StepProgram`` over static buffers); on the CPU the same
program runs ``fn`` on Tensors rebuilt over those buffers.  Here the
counterparts of ``tests/test_func.py``'s jit tests run on both packages
from the same numpy inputs, the JAX side through its own ``md.jit`` on the
xla backend (float64: the suite enables x64), and their values (1e-10)
and ``_cache`` counts are held equal, but for a new shape, which the
port's key holds (a graph is one shape's).  Also held: donation gives the
same values and consumes the donated Tensor; the caller's Tensors stay as
they were; outputs are fresh; numbers and arrays are dynamic leaves; a
draw from the library's generator inside ``fn`` draws anew at each call
(the JAX package bakes it in as a constant: an accepted divergence); and a
host copy or a host read inside ``fn`` shows on the dispatcher, where the
card's capture refuses it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import minidiff_tpu as jmd
import minidiff_tpu_torch as md


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
    """The port's tape on the CPU, the JAX package's on xla."""
    with md.use_backend("cpu"), jmd.use_backend("xla"):
        yield


def _loss(lib):
    def loss_fn(w, x):
        return lib.sum(lib.tanh(x @ w) ** 2)

    return loss_fn


def _both(fn_of_lib, *arrays, allow_grad=()):
    """``fn_of_lib(lib)`` on both packages over Tensors of ``arrays``."""
    out = []
    for lib in (md, jmd):
        ts = [lib.Tensor(a, allow_grad=i in allow_grad) for i, a in enumerate(arrays)]
        out.append(fn_of_lib(lib, *ts))
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12)


def test_jit_matches_eager_and_jax():
    rng = np.random.RandomState(0)
    wn, xn = rng.randn(4, 3), rng.randn(5, 4)

    def run(lib, w, x):
        vag = lib.value_and_grad(_loss(lib))
        jitted = lib.jit(vag)
        return vag(w, x), jitted(w, x), jitted(w, x)

    (eager, first, again), (_, jax_out, _) = _both(run, wn, xn, allow_grad=(0,))
    for got in (first, again):
        _close(got[0], eager[0])
        _close(got[1], eager[1])
        _close(got[0], jax_out[0])
        _close(got[1], jax_out[1])


def test_jit_caches_by_structure():
    rng = np.random.RandomState(1)
    counts = []
    for lib in (md, jmd):
        jitted = lib.jit(lib.value_and_grad(_loss(lib)))
        w = lib.Tensor(rng.randn(4, 3), allow_grad=True)
        x = lib.Tensor(rng.randn(5, 4))
        jitted(w, x)
        jitted(w, x)
        jitted(lib.Tensor(rng.randn(4, 3), allow_grad=True), x)
        n_same = len(jitted._cache)
        jitted(lib.Tensor(rng.randn(4, 3), allow_grad=True), lib.Tensor(rng.randn(6, 4)))
        counts.append((n_same, len(jitted._cache)))
    # another shape: the port's key holds the shapes (a graph is one
    # shape's), where the JAX wrapper keeps one jax.jit that retraces
    assert counts == [(1, 2), (1, 1)]


def test_jit_static_leaves():
    for lib in (md, jmd):
        def f(x, mode, lib=lib):
            if mode == "double":
                return lib.sum(x * 2)
            return lib.sum(x * 3)

        jitted = lib.jit(f)
        x = lib.Tensor(np.arange(3.0))
        assert float(jitted(x, "double").item()) == pytest.approx(6.0)
        assert float(jitted(x, "triple").item()) == pytest.approx(9.0)
        assert float(jitted(x, "double").item()) == pytest.approx(6.0)
        assert len(jitted._cache) == 2


def test_jit_pytree_args():
    rng = np.random.RandomState(2)
    wn, bn, xn = rng.randn(3, 2), rng.randn(2), rng.randn(4, 3)
    outs = []
    for lib in (md, jmd):
        def f(params, x, lib=lib):
            return lib.sum(lib.tanh(x @ params["w"]) + params["b"])

        params = {"w": lib.Tensor(wn, allow_grad=True), "b": lib.Tensor(bn, allow_grad=True)}
        vag = lib.value_and_grad(f)
        out, grads = lib.jit(vag)(params, lib.Tensor(xn))
        assert grads["w"].shape == (3, 2) and grads["b"].shape == (2,)
        out_e, grads_e = vag(params, lib.Tensor(xn))
        _close(grads["w"], grads_e["w"])
        outs.append((out, grads))
    _close(outs[0][0], outs[1][0])
    for k in ("w", "b"):
        _close(outs[0][1][k], outs[1][1][k])


def test_jit_train_step_with_update():
    # an entire SGD step, forward, backward and update, in one program
    rng = np.random.RandomState(3)
    wn, xn = rng.randn(4, 3), rng.randn(5, 4)
    losses = []
    for lib in (md, jmd):
        loss_fn = _loss(lib)

        def train_step(w, x, lib=lib, loss_fn=loss_fn):
            val, g = lib.value_and_grad(loss_fn)(w.detach(allow_grad=True), x)
            return w - 0.1 * g, val

        jitted = lib.jit(train_step)
        w, x = lib.Tensor(wn), lib.Tensor(xn)
        run = []
        for _ in range(10):
            w, val = jitted(w, x)
            run.append(float(val.item()))
        assert run[-1] < run[0] and len(jitted._cache) == 1
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-10)


def test_jit_unhashable_static_raises_cleanly():
    class Cfg:
        __hash__ = None  # unhashable

    for lib in (md, jmd):
        f = lib.jit(lambda x, cfg: x * 2)
        with pytest.raises(TypeError, match="hashable"):
            f(lib.Tensor(np.ones(2)), Cfg())


def test_jit_shardings_come_later():
    with pytest.raises(NotImplementedError, match="parallel layers"):
        md.jit(lambda x: x, in_shardings=[None])


@pytest.mark.parametrize("donation", [dict(donate=True), dict(donate_argnums=(0,))])
def test_donation_gives_the_same_values_and_consumes_the_tensor(donation):
    rng = np.random.RandomState(4)
    wn, xn = rng.randn(4, 3), rng.randn(5, 4)

    def train_step(w, x):
        val, g = md.value_and_grad(_loss(md))(w.detach(allow_grad=True), x)
        return w - 0.1 * g, val

    plain, donating = md.jit(train_step), md.jit(train_step, **donation)
    w1 = w2 = md.Tensor(wn)
    for _ in range(3):
        old, x = w2, md.Tensor(xn)
        w1, v1 = plain(w1, md.Tensor(xn))
        w2, v2 = donating(w2, x)
        assert float(v1.item()) == float(v2.item())
        assert torch.equal(w1._data, w2._data)
        with pytest.raises(RuntimeError, match="donated"):
            old.shape  # the donated Tensor must not be read after the call
        with pytest.raises(RuntimeError, match="donated"):
            np.asarray(old)
        # x went in as arg 1: consumed under donate=True only
        if donation.get("donate"):
            with pytest.raises(RuntimeError, match="donated"):
                x.item()
        else:
            assert x.shape == (5, 4)


def test_callers_tensors_stay_as_they_were():
    rng = np.random.RandomState(5)
    w = md.Tensor(rng.randn(4, 3), allow_grad=True)
    x = md.Tensor(rng.randn(5, 4))
    data, before = w._data, w._data.clone()
    out, g = md.jit(md.value_and_grad(_loss(md)))(w, x)
    assert w._data is data and torch.equal(w._data, before)
    assert w.grad is None and w.op_node is None and w.consumer_refs == 0
    assert w.allow_grad and g.op_node is None and not g.allow_grad


def test_outputs_are_fresh_and_numbers_and_arrays_are_dynamic():
    def f(x, scale, shift):
        return x * scale + md.sum(md.Tensor(shift))

    jitted = md.jit(f)
    x = md.Tensor(np.ones(3))
    a = jitted(x, 2.0, np.ones(2))
    b = jitted(x, 3.0, np.zeros(2))
    assert len(jitted._cache) == 1  # another number and array: the same key
    np.testing.assert_array_equal(np.asarray(a), [4.0, 4.0, 4.0])
    np.testing.assert_array_equal(np.asarray(b), [3.0, 3.0, 3.0])
    assert a._data.data_ptr() != b._data.data_ptr()
    jitted(x, 2, np.ones(2))  # an int: another dtype, another key
    jitted(md.Tensor(np.ones(3), allow_grad=True), 2.0, np.ones(2))  # allow_grad
    assert len(jitted._cache) == 3


def test_library_draws_are_fresh_at_every_call():
    """An accepted divergence: the JAX package turns a draw inside ``fn``
    into a trace-time constant; the port draws anew at each call, from the
    library's generator, so the same seed gives the eager function's
    numbers."""
    def f(x):
        return x + md.randn(3)

    x = md.Tensor(np.zeros(3))
    runs = {}
    for name, fn in (("eager", f), ("jit", md.jit(f))):
        md.seed(7)
        runs[name] = [np.asarray(fn(x)) for _ in range(3)]
    assert not np.array_equal(runs["jit"][0], runs["jit"][1])
    for a, b in zip(runs["jit"], runs["eager"]):
        np.testing.assert_array_equal(a, b)
    g = jmd.jit(lambda x: x + jmd.randn(3))
    xj = jmd.Tensor(np.zeros(3))
    np.testing.assert_array_equal(np.asarray(g(xj)), np.asarray(g(xj)))


_SYNCS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
          "aten::is_nonzero", "aten::equal"}
_HOST_COPIES = {"aten::lift_fresh"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case,flagged", [
    ("clean", set()), ("host_copy", _HOST_COPIES), ("item", {"aten::_local_scalar_dense"}),
    ("full_like", {"aten::_local_scalar_dense"})])
def test_a_host_copy_or_read_inside_fn_fails_the_no_sync_check(case, flagged):
    def f(x):
        y = md.tanh(x @ x) * 0.5 + 1.0
        if case == "host_copy":
            y = y + md.Tensor(np.ones((4, 4)))  # a numpy array made a Tensor
        elif case == "item":
            y = y * float(md.sum(y).item())
        elif case == "full_like":  # a device value as a fill reads it back
            y = y + md.full_like(y, md.sum(y))
        return md.sum(y)

    jitted = md.jit(md.value_and_grad(f))
    x = md.Tensor(np.random.RandomState(6).randn(4, 4))
    jitted(x)
    (program,) = jitted._cache.values()
    with _Ops() as ops:
        program.fn()
    assert ops.names & (_SYNCS | _HOST_COPIES) == flagged


def test_jit_cache_keeps_the_32_latest_keys():
    jitted = md.jit(lambda x: x * 2.0)
    for n in range(1, 34):
        jitted(md.Tensor(np.ones(n)))
    assert len(jitted._cache) == 32  # the first shape went
    np.testing.assert_array_equal(np.asarray(jitted(md.Tensor(np.ones(1)))), [2.0])
    assert len(jitted._cache) == 32  # and came back in the place of another
