"""Every op of the port, forward and VJPs, against the JAX package's.

Each case makes its inputs from a numpy seed (float64), runs the op through
``minidiff_tpu`` on its numpy backend and through ``minidiff_tpu_torch`` on
its ``"cpu"`` backend, and compares the outputs; then it sweeps
``sum(out * ct)`` for a seeded cotangent ``ct`` back to every
differentiable input and compares the gradients.  Both sides run the same
float64 arithmetic, in orders that may differ: 1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minidiff_tpu as jmd
import minidiff_tpu_torch as md
from minidiff_tpu.ops import definitions as jdefs
from minidiff_tpu_torch.ops import definitions as tdefs
from minidiff_tpu_torch.utils import compute_grads

TOL = dict(rtol=1e-10, atol=1e-10)

# the JAX package's ops that wait for later slices of the port
LATER = {
    "linear_scan",  # SSM
    "psum", "ppermute", "pmean", "all_gather", "psum_scatter", "all_to_all",
    "dequant_matmul", "dequant_matmul4", "dequant_matmul_bmm",
    "sdpa_int8_cache",  # quantized serving
    "sdpa", "layernorm", "add_layernorm", "rmsnorm", "add_rmsnorm",  # models
    "conv2d", "conv2d_input_grad", "conv2d_kernel_grad",  # CNN
}


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


def _r(*shape, seed=0, lo=None):
    a = np.random.RandomState(seed).standard_normal(shape)
    return np.abs(a) + lo if lo is not None else a


def _i(*shape, seed=0, high=5):
    return np.random.RandomState(seed).randint(0, high, shape)


A34, B34, C4 = _r(3, 4), _r(3, 4, seed=1), _r(4, seed=2)
POS34 = _r(3, 4, seed=3, lo=0.5)

# (id, fn(package, *tensors), inputs, indices of differentiable inputs)
DIFF = [
    ("absolute", lambda m, a: m.absolute(a), [A34], [0]),
    ("abs", lambda m, a: m.abs(a), [A34], [0]),
    ("atleast_1d", lambda m, a: m.atleast_1d(a), [np.float64(1.5)], [0]),
    ("atleast_2d", lambda m, a: m.atleast_2d(a), [C4], [0]),
    ("atleast_3d", lambda m, a: m.atleast_3d(a), [A34], [0]),
    ("copy", lambda m, a: m.copy(a), [A34], [0]),
    ("cos", lambda m, a: m.cos(a), [A34], [0]),
    ("cosh", lambda m, a: m.cosh(a), [A34], [0]),
    ("erf", lambda m, a: m.erf(a), [A34], [0]),
    ("exp", lambda m, a: m.exp(a), [A34], [0]),
    ("flatten", lambda m, a: m.flatten(a), [A34], [0]),
    ("flatten_F", lambda m, a: m.flatten(a, order="F"), [A34], [0]),
    ("flip", lambda m, a: m.flip(a, axis=1), [A34], [0]),
    ("log", lambda m, a: m.log(a), [POS34], [0]),
    ("max", lambda m, a: m.max(a, axis=1), [A34], [0]),
    ("max_ties", lambda m, a: m.max(a), [np.array([[1., 3.], [3., 2.]])], [0]),
    ("min", lambda m, a: m.min(a, axis=0, keepdims=True), [A34], [0]),
    ("mean", lambda m, a: m.mean(a, axis=(0, 1)), [A34], [0]),
    ("prod", lambda m, a: m.prod(a, axis=1), [A34], [0]),
    ("ravel_F", lambda m, a: m.ravel(a, order="F"), [A34], [0]),
    ("sin", lambda m, a: m.sin(a), [A34], [0]),
    ("sinh", lambda m, a: m.sinh(a), [A34], [0]),
    ("sqrt", lambda m, a: m.sqrt(a), [POS34], [0]),
    ("square", lambda m, a: m.square(a), [A34], [0]),
    ("squeeze", lambda m, a: m.squeeze(a, axis=1), [_r(3, 1, 2)], [0]),
    ("std", lambda m, a: m.std(a, axis=1, ddof=1), [A34], [0]),
    ("var", lambda m, a: m.var(a, axis=0), [A34], [0]),
    ("sum", lambda m, a: m.sum(a, axis=-1, keepdims=True), [A34], [0]),
    ("cumsum", lambda m, a: m.cumsum(a, axis=1), [A34], [0]),
    ("cumsum_flat", lambda m, a: m.cumsum(a), [A34], [0]),
    ("einsum_mm", lambda m, a, b: m.einsum("ij,kj->ik", a, b), [A34, B34], [0, 1]),
    ("einsum_diag", lambda m, a: m.einsum("ii->i", a), [_r(4, 4)], [0]),
    ("einsum_ellipsis", lambda m, a, b: m.einsum("...ij,...jk", a, b),
     [_r(2, 3, 4), _r(2, 4, 2, seed=1)], [0, 1]),
    ("sort", lambda m, a: m.sort(a, axis=1), [A34], [0]),
    ("gather", lambda m, a, i: m.gather(a, i, axis=1), [A34, _i(3, 2, high=4)], [0]),
    ("topk", lambda m, a: m.topk(a, 2)[0], [A34], [0]),
    ("tan", lambda m, a: m.tan(a), [A34 * 0.5], [0]),
    ("tanh", lambda m, a: m.tanh(a), [A34], [0]),
    ("transpose", lambda m, a: m.transpose(a, axes=(2, 0, 1)), [_r(2, 3, 4)], [0]),
    ("add", lambda m, a, b: m.add(a, b), [A34, C4], [0, 1]),
    ("astype", lambda m, a: m.astype(a, m.float64), [A34], [0]),
    ("broadcast_to", lambda m, a: m.broadcast_to(a, (3, 4)), [C4], [0]),
    ("dot", lambda m, a, b: m.dot(a, b), [A34, _r(4, 2)], [0, 1]),
    ("dot_nd", lambda m, a, b: m.dot(a, b), [_r(2, 3, 4), _r(5, 4, 2, seed=1)], [0, 1]),
    ("expand_dims", lambda m, a: m.expand_dims(a, 1), [A34], [0]),
    ("getitem_slice", lambda m, a: a[1:, ::2], [A34], [0]),
    ("getitem_fancy", lambda m, a: a[[0, 2, 0], 1:], [A34], [0]),
    ("getitem_mask", lambda m, a: a[a > 0], [A34], [0]),
    ("matmul", lambda m, a, b: m.matmul(a, b), [A34, _r(4, 5)], [0, 1]),
    ("matmul_batched", lambda m, a, b: m.matmul(a, b), [_r(2, 3, 4), _r(4, 5)], [0, 1]),
    ("matmul_vec", lambda m, a, b: m.matmul(a, b), [A34, C4], [0, 1]),
    ("matmul_vecmat", lambda m, a, b: m.matmul(a, b), [_r(3), A34], [0, 1]),
    ("matmul_nt", lambda m, a, b: m.matmul_nt(a, b), [A34, _r(5, 4)], [0, 1]),
    ("matmul_tn", lambda m, a, b: m.matmul_tn(a, b), [A34, _r(3, 5)], [0, 1]),
    ("maximum", lambda m, a, b: m.maximum(a, b), [A34, B34], [0, 1]),
    ("minimum", lambda m, a, b: m.minimum(a, b), [A34, C4], [0, 1]),
    ("mod", lambda m, a, b: m.mod(a, b), [A34 * 3, POS34], [0, 1]),
    ("multiply", lambda m, a, b: m.multiply(a, b), [A34, B34], [0, 1]),
    ("power", lambda m, a, b: m.power(a, b), [POS34, B34], [0, 1]),
    ("power_scalar", lambda m, a: a ** 3, [A34], [0]),
    ("reshape_F", lambda m, a: m.reshape(a, (2, 6), order="F"), [A34], [0]),
    ("subtract", lambda m, a, b: m.subtract(a, b), [A34, C4], [0, 1]),
    ("tensordot", lambda m, a, b: m.tensordot(a, b, axes=([1, 0], [0, 2])),
     [_r(3, 4, 2), _r(4, 5, 3, seed=1)], [0, 1]),
    ("true_divide", lambda m, a, b: m.true_divide(a, b), [A34, POS34], [0, 1]),
    ("unbroadcast", lambda m, a: m.unbroadcast(a, (1, 4)), [A34], [0]),
    ("scatter_add", lambda m, t, v: m.scatter_add(t, (np.array([0, 2, 0]),), v),
     [A34, B34], [1]),
    ("softmax_xent", lambda m, z, lab: m.softmax_xent(z, lab),
     [_r(2, 3, 7), _i(2, 3, high=7)], [0]),
    ("concat", lambda m, a, b: m.concat([a, b], axis=1), [A34, _r(3, 2)], [0, 1]),
    ("clip", lambda m, a: m.clip(a, -0.5, 0.5), [A34], [0]),
    ("swapaxes", lambda m, a: m.swapaxes(a, 0, 2), [_r(2, 3, 4)], [0]),
    ("where", lambda m, c, a, b: m.where(c, a, b), [A34 > 0, A34, C4], [1, 2]),
]

NON_DIFF = [
    ("all", lambda m, a: m.all(a > -1, axis=1), [A34]),
    ("any", lambda m, a: m.any(a > 1), [A34]),
    ("argmax", lambda m, a: m.argmax(a, axis=1), [A34]),
    ("argmin", lambda m, a: m.argmin(a), [A34]),
    ("argwhere", lambda m, a: m.argwhere(a > 0), [A34]),
    ("ceil", lambda m, a: m.ceil(a), [A34]),
    ("floor", lambda m, a: m.floor(a), [A34]),
    ("invert", lambda m, a: m.invert(a), [_i(3, 4)]),
    ("logical_not", lambda m, a: m.logical_not(a > 0), [A34]),
    ("sign", lambda m, a: m.sign(a), [A34]),
    ("argsort", lambda m, a: m.argsort(a, axis=0), [A34]),
    ("equal", lambda m, a, b: m.equal(a, b), [_i(3, 4), _i(3, 4, seed=1)]),
    ("not_equal", lambda m, a, b: m.not_equal(a, b), [_i(3, 4), _i(3, 4, seed=1)]),
    ("floor_divide", lambda m, a, b: m.floor_divide(a, b), [A34 * 4, POS34]),
    ("greater", lambda m, a, b: m.greater(a, b), [A34, B34]),
    ("greater_equal", lambda m, a, b: m.greater_equal(a, b), [A34, C4]),
    ("less", lambda m, a, b: m.less(a, b), [A34, B34]),
    ("less_equal", lambda m, a, b: m.less_equal(a, b), [A34, C4]),
    ("logical_and", lambda m, a, b: m.logical_and(a > 0, b > 0), [A34, B34]),
    ("logical_or", lambda m, a, b: m.logical_or(a > 0, b > 0), [A34, B34]),
    ("logical_xor", lambda m, a, b: m.logical_xor(a > 0, b > 0), [A34, B34]),
]


def _forward(m, fn, inputs, diff):
    ts = [m.Tensor(v, allow_grad=i in diff) for i, v in enumerate(inputs)]
    return ts, fn(m, *ts)


def _np(t):
    return np.asarray(t, dtype=np.float64)


@pytest.mark.parametrize("name,fn,inputs,diff", DIFF, ids=[c[0] for c in DIFF])
def test_op_forward_and_vjps_match_jax(name, fn, inputs, diff):
    results = []
    for m in (jmd, md):
        ts, out = _forward(m, fn, inputs, diff)
        ct = m.Tensor(np.random.RandomState(99).standard_normal(out.shape))
        m.sum(out * ct).backward()
        results.append((out, [ts[i].grad for i in diff]))
    (ref, ref_grads), (got, grads) = results
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    for i, r, g in zip(diff, ref_grads, grads):
        assert g is not None and g.shape == r.shape, (name, i)
        np.testing.assert_allclose(_np(g), _np(r), err_msg=f"{name} input {i}", **TOL)


@pytest.mark.parametrize("name,fn,inputs", NON_DIFF, ids=[c[0] for c in NON_DIFF])
def test_non_differentiable_op_matches_jax(name, fn, inputs):
    ref = fn(jmd, *(jmd.Tensor(v, allow_grad=True) for v in inputs))
    ts = [md.Tensor(v, allow_grad=True) for v in inputs]
    got = fn(md, *ts)
    np.testing.assert_array_equal(_np(got), _np(ref))
    assert got.op_node is None  # no VJP to record


def test_the_op_list_is_the_jax_list_less_the_later_slices():
    assert LATER <= set(jdefs.__all__)
    assert set(tdefs.__all__) == set(jdefs.__all__) - LATER
    for name in tdefs.__all__:
        assert callable(getattr(md, name)), name


def test_softmax_xent_f32_first_order_is_the_kernel_wiring():
    # f32 logits: the first-order VJP is the xent_bwd kernel's plain
    # version here, against the JAX package's composed f32 VJP (one f32
    # rounding of the same row statistics: 1e-6)
    z = _r(6, 9).astype(np.float32)
    lab = _i(6, high=9)
    grads = []
    for m in (jmd, md):
        zt = m.Tensor(z, allow_grad=True)
        m.mean(m.softmax_xent(zt, m.Tensor(lab))).backward()
        grads.append(_np(zt.grad))
    assert md.Tensor(z).dtype == torch.float32
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6, atol=1e-6)


def test_second_order_through_softmax_xent_takes_the_composed_form():
    z, lab = _r(4, 5), _i(4, high=5)
    out = []
    for m in (jmd, md):
        zt = m.Tensor(z, allow_grad=True)
        m.sum(m.softmax_xent(zt, m.Tensor(lab))).backward(allow_higher_order=True)
        g = zt.grad
        m.sum(g * g).backward()
        out.append(_np(zt.grad))
    np.testing.assert_allclose(out[1], out[0], **TOL)


# a few ops through the port's own finite-difference oracle (f64: central
# differences at h = 1e-7 carry ~1e-7 of truncation and rounding error)
@pytest.mark.parametrize("fn,shapes", [
    (lambda a, b: md.sum(md.tanh(a @ b) * a[:, :1]), [(3, 4), (4, 2)]),
    (lambda a: md.sum(md.sort(a, axis=0) * md.arange(12).reshape((3, 4))), [(3, 4)]),
    (lambda a, b: md.sum(md.einsum("ij,j->i", a, b) ** 2), [(3, 4), (4,)]),
    (lambda z: md.sum(md.softmax_xent(z, md.Tensor(np.array([1, 0, 3])))), [(3, 4)]),
])
def test_gradcheck_oracle(fn, shapes):
    ts = [md.Tensor(_r(*s, seed=i)) for i, s in enumerate(shapes)]
    for t in ts:
        t.allow_grad = True
    numeric, analytic = compute_grads(*ts, func=fn)
    for n, a in zip(numeric, analytic):
        np.testing.assert_allclose(_np(a), _np(n), rtol=1e-5, atol=1e-6)
