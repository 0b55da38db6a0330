"""Every op of the port: forwards and per-input VJPs.

The port of ``minidiff_tpu/ops/definitions.py``: the same ops with the same
VJP code, written in framework ops, so backward sweeps re-tape under grad
mode and higher-order differentiation works by construction.  Each forward
resolves its backend function at call time (``backend/torch_backend.py``).

* Reduction grads reshape the cotangent to keepdims and broadcast.
* max/min grads use an equality mask; ties share the gradient evenly.
* matmul grads take batched operands through the transpose-free
  ``matmul_nt`` / ``matmul_tn``, which reach the CUDA kernels for large 2-D
  f32 and bf16 products (``kernels/matmul.py``).
* dot grads delegate to the general tensordot VJP.
* mod keeps the JAX package's semantics: both grads pass ``grad`` through
  except where x % y == 0.
* softmax_xent's first-order VJP is the ``xent_bwd`` kernel; under grad
  mode it takes the composed form, so second order works.  rmsnorm's and
  add_rmsnorm's first-order VJPs share one ``rms_bwd`` / ``addrms_bwd``
  launch in the same way.
* the quantized serving ops (``dequant_matmul``, ``dequant_matmul4``,
  ``dequant_matmul_bmm``, ``sdpa_int8_cache``) run the ``kernels/quant.py``
  kernels for f32 and bf16; their gradient flows to x only.
* linear_scan's two VJPs share one reversed scan (the ``scan`` kernel for
  f32 and bf16) through a single-entry memo.
* sdpa's forward is the flash forward where it is eligible (the composed
  attention elsewhere), with the JAX op's causal, window / sinks, mask and
  segment-id arguments; its three first-order VJPs share one run of the
  flash backward kernels through a single-entry memo, and under grad mode
  take the composed form, so second order works.

Not ported yet (each waits for the slice that needs it): the collectives,
``layernorm`` and ``add_layernorm`` as tape ops, and the conv2d family.
"""

from __future__ import annotations

from builtins import any as py_any
from builtins import bool as py_bool
from builtins import max as py_max
from math import prod as py_prod
from typing import TYPE_CHECKING

import minidiff_tpu_torch as md
import minidiff_tpu_torch.ops.wrapping as wrapping
from minidiff_tpu_torch.kernels import layernorm as _ln
from minidiff_tpu_torch.kernels import xent as _xent
from minidiff_tpu_torch.ops.wrapping import as_tensor_func, backend_fn

if TYPE_CHECKING:
    from typing import Any, Optional, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# axis helpers
# ---------------------------------------------------------------------------

def _normalize_axes(
    axis: "Optional[Union[int, Sequence[int]]]", ndim: int
) -> "Optional[Tuple[int, ...]]":
    """None stays None (= all axes); ints/sequences become sorted non-negative tuples."""
    if axis is None:
        return None
    if ndim == 0:
        return ()  # numpy permits axis=-1/0 on 0-d arrays; nothing to reduce
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(sorted(a % ndim if a < 0 else a for a in axis))


def _keepdims_shape(shape: "Tuple[int, ...]", axes: "Optional[Tuple[int, ...]]"):
    if axes is None:
        return (1,) * len(shape)
    return tuple(1 if i in axes else d for i, d in enumerate(shape))


def _grad_as_keepdims(x: "md.Tensor", grad: "md.Tensor", axes) -> "md.Tensor":
    """Reshape an incoming reduction cotangent to the keepdims shape.

    Works whether the forward was called with keepdims=True or False — the
    element count is the same either way.
    """
    kd = _keepdims_shape(x.shape, axes)
    if grad.shape == kd:
        return grad
    return grad.reshape(kd)


# ---------------------------------------------------------------------------
# nontrivial VJPs
# ---------------------------------------------------------------------------

def sum_grad(x, grad, axis=None, **kwargs):
    """d(sum)/dx: broadcast the cotangent back over the reduced axes."""
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return grad.reshape(x.shape)
    return broadcast_to(_grad_as_keepdims(x, grad, axes), x.shape)


def mean_grad(x, grad, axis=None, **kwargs):
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return grad.reshape(x.shape)
    kd = _keepdims_shape(x.shape, axes)
    n = x.size // py_prod(kd) if x.size else 1
    return broadcast_to(_grad_as_keepdims(x, grad, axes) / n, x.shape)


def max_grad(x, grad, axis=None, **kwargs):
    """Equality-mask VJP for max: ties share the cotangent evenly (no scatter)."""
    return _extremum_grad(max, x, grad, axis)


def min_grad(x, grad, axis=None, **kwargs):
    return _extremum_grad(min, x, grad, axis)


def _extremum_grad(extremum_op, x, grad, axis):
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return grad.reshape(x.shape)
    m = extremum_op(x, axis=axes, keepdims=True)
    mask = (x == m).astype(x.dtype)
    counts = md.sum(mask, axis=axes, keepdims=True)
    return _grad_as_keepdims(x, grad, axes) * mask / counts


def prod_grad(x, grad, axis=None, **kwargs):
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return grad.reshape(x.shape)
    total = prod(x, axis=axes, keepdims=True)
    grad_kd = _grad_as_keepdims(x, grad, axes)
    # zero where x == 0, for stability
    return md.where(x == 0, 0, grad_kd * total / x)


def std_grad(x, grad, axis=None, ddof=0, **kwargs):
    """d(std)/dx_i = (x_i - mu) / ((N - ddof) * sigma), same-ddof sigma."""
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return md.zeros_like(x)
    kd = _keepdims_shape(x.shape, axes)
    n = x.size // py_prod(kd) if x.size else 1
    mu = mean(x, axis=axes, keepdims=True)
    sigma = std(x, axis=axes, keepdims=True, ddof=ddof)
    return _grad_as_keepdims(x, grad, axes) * (x - mu) / (sigma * (n - ddof))


def var_grad(x, grad, axis=None, ddof=0, **kwargs):
    """d(var)/dx_i = 2 (x_i - mu) / (N - ddof), broadcast over reduced axes.

    mu stays the plain mean regardless of ddof (only the normalizer changes
    in numpy's variance), so the gradient divides by N - ddof.
    """
    axes = _normalize_axes(axis, x.ndim)
    if axes == ():
        return md.zeros_like(x)
    kd = _keepdims_shape(x.shape, axes)
    n = x.size // py_prod(kd) if x.size else 1
    mu = mean(x, axis=axes, keepdims=True)
    return _grad_as_keepdims(x, grad, axes) * (x - mu) * (2.0 / (n - ddof))


def squeeze_grad(a, grad, axis=None, **kwargs):
    if axis is None:
        axis = tuple(i for i, dim in enumerate(a.shape) if dim == 1)
    if isinstance(axis, int):
        axis = (axis,)
    if not axis:
        return grad
    return expand_dims(grad, tuple(axis))


def transpose_grad(x, grad, axes=None):
    if axes is None:
        return transpose(grad)
    inverse = [0] * len(axes)
    for i, dim in enumerate(axes):
        inverse[int(dim)] = i
    return transpose(grad, axes=inverse)


def unbroadcast_forward(x: "md.Tensor", target_shape: "Sequence[int]") -> "md.Tensor":
    """Undo NumPy-style broadcasting: sum prepended axes, then stretched ones.

    Used both as the public `unbroadcast` op and by the engine whenever a VJP
    result's shape disagrees with its input (tape.py update_grads).
    """
    target_shape = tuple(target_shape)
    if x.shape == target_shape:
        # a fresh view, never the input object itself: the op wrapper would
        # otherwise attach a node to a LEAF input, creating a self-cycle
        return x.detach(allow_grad=x.allow_grad)
    n_prepended = x.ndim - len(target_shape)
    if n_prepended > 0:
        x = x.sum(axis=tuple(range(n_prepended)))
    stretched = tuple(
        i
        for i, (xd, td) in enumerate(zip(x.shape, target_shape))
        if td == 1 and xd > 1
    )
    if stretched:
        x = x.sum(axis=stretched, keepdims=True)
    if x.size == py_prod(target_shape):
        return x.reshape(target_shape)
    return broadcast_to(x, target_shape)


def getitem_grad(x, key, grad):
    # scatter_add is itself a differentiable op (VJP = gather at key), so
    # second-order gradients flow through indexing
    return scatter_add(x, key, grad)


def _tensordot_axes(x_ndim: int, y_ndim: int, axes) -> "Tuple[Tuple[int, ...], Tuple[int, ...]]":
    if isinstance(axes, int):
        return tuple(range(x_ndim - axes, x_ndim)), tuple(range(axes))
    ax, ay = axes
    if isinstance(ax, int):
        ax = (ax,)
    if isinstance(ay, int):
        ay = (ay,)
    ax = tuple(a % x_ndim if a < 0 else a for a in ax)
    ay = tuple(a % y_ndim if a < 0 else a for a in ay)
    return ax, ay


def tensordot_grad_x(x, y, grad, axes=2):
    """dL/dx = tensordot(grad, y over y's free dims), permuted back to x order.

    tensordot(x, y, (ax, ay)) has dims [x_free..., y_free...]; contracting
    grad's trailing dims with y's free dims leaves [x_free..., sorted(ay) dims
    of y], where y dim ay[k] pairs with x dim ax[k]: a permutation lookup.
    """
    ax, ay = _tensordot_axes(x.ndim, y.ndim, axes)
    x_free = tuple(i for i in range(x.ndim) if i not in ax)
    y_free = tuple(i for i in range(y.ndim) if i not in ay)
    grad_trailing = tuple(range(grad.ndim - len(y_free), grad.ndim))
    raw = tensordot(grad, y, axes=(grad_trailing, y_free))
    # raw dim i corresponds to x dim perm[i]
    perm = list(x_free) + [ax[ay.index(d)] for d in sorted(ay)]
    return transpose(raw, axes=[perm.index(d) for d in range(x.ndim)])


def tensordot_grad_y(x, y, grad, axes=2):
    ax, ay = _tensordot_axes(x.ndim, y.ndim, axes)
    x_free = tuple(i for i in range(x.ndim) if i not in ax)
    y_free = tuple(i for i in range(y.ndim) if i not in ay)
    grad_leading = tuple(range(len(x_free)))
    raw = tensordot(x, grad, axes=(x_free, grad_leading))
    # raw dims: [sorted(ax) dims of x (≙ y dims via the pairing), y_free...]
    perm = [ay[ax.index(d)] for d in sorted(ax)] + list(y_free)
    return transpose(raw, axes=[perm.index(d) for d in range(y.ndim)])


def matmul_grad_x(x, y, grad):
    """Batched-correct matmul VJP; batch broadcasting is undone by the engine.

    Uses the transpose-free NT contraction (dx = grad @ y^T) so no transposed
    copy of y is made.
    """
    if x.ndim == 1 and y.ndim == 1:
        return grad * y
    if y.ndim == 1:
        # out = x @ y contracts x's last dim: dx = grad ⊗ y over the last axes
        return expand_dims(grad, -1) * y
    if x.ndim == 1:
        # dx_k = sum_n y[..., k, n] g[..., n]; engine unbroadcast sums batches
        return squeeze(matmul(y, expand_dims(grad, -1)), axis=-1)
    return matmul_nt(grad, y)


def matmul_grad_y(x, y, grad):
    if x.ndim == 1 and y.ndim == 1:
        return grad * x
    if x.ndim == 1:
        # out = x @ y: dy = outer(x, grad) over the matrix axes
        return matmul(expand_dims(x, -1), expand_dims(grad, -2))
    if y.ndim == 1:
        # np.matmul promotes 1-D y to a column; keep grad a column too or a
        # batched x^T would misread a (batch, m) grad as a matrix
        return squeeze(
            matmul(swapaxes(x, -1, -2), expand_dims(grad, -1)), axis=-1
        )
    return matmul_tn(x, grad)


def _dot_axes(x, y):
    # np.dot contracts the last axis of x with the second-to-last of y (or the
    # only axis when y is 1-D)
    return ((x.ndim - 1,), (py_max(y.ndim - 2, 0),))


def dot_grad_x(x, y, grad):
    return tensordot_grad_x(x, y, grad, axes=_dot_axes(x, y))


def dot_grad_y(x, y, grad):
    return tensordot_grad_y(x, y, grad, axes=_dot_axes(x, y))


def clip_grad_x(*args, **kwargs):
    """VJP of clip wrt x; pass-through inside the active interval.

    Robust to both positional clip(x, lo, hi) and keyword clip(x, a_min=lo,
    a_max=hi) call forms (the engine appends the cotangent after op_inputs).
    """
    grad = args[-1]
    x = args[0]
    rest = args[1:-1]
    a_min = rest[0] if len(rest) > 0 else kwargs.get("a_min")
    a_max = rest[1] if len(rest) > 1 else kwargs.get("a_max")
    if a_min is None and a_max is None:
        return grad
    if a_min is None:
        return grad * (x < a_max)
    if a_max is None:
        return grad * (x > a_min)
    return grad * logical_and(x > a_min, x < a_max)


# ---------------------------------------------------------------------------
# unary ops
# ---------------------------------------------------------------------------

absolute = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("absolute")),
    grad=lambda x, grad: grad * sign(x),
)
abs = absolute
all = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("all")), is_differentiable=False
)
any = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("any")), is_differentiable=False
)
argmax = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("argmax")), is_differentiable=False
)
argmin = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("argmin")), is_differentiable=False
)
argwhere = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("argwhere")), is_differentiable=False
)
atleast_1d = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("atleast_1d")),
    grad=lambda x, grad: grad.reshape(x.shape),
)
atleast_2d = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("atleast_2d")),
    grad=lambda x, grad: grad.reshape(x.shape),
)
atleast_3d = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("atleast_3d")),
    grad=lambda x, grad: grad.reshape(x.shape),
)
ceil = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("ceil")), is_differentiable=False
)
copy = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("copy")),
    grad=lambda x, grad: grad,
)
cos = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("cos")),
    grad=lambda x, grad: grad * -sin(x),
)
cosh = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("cosh")),
    grad=lambda x, grad: grad * sinh(x),
)
def exp_grad(x, grad, _output=None):
    # reuse the forward value when the engine supplies it
    return grad * (exp(x) if _output is None else _output)


exp_grad.needs_output = True

exp = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("exp")),
    grad=exp_grad,
)
flatten = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("flatten")),
    grad=lambda x, grad, order="C": reshape(grad, x.shape, order=order),
    # without kwarg propagation the VJP un-flattens in C order regardless of
    # the forward's `order` — wrong gradients for order="F"
    kwargs_to_grads=True,
)
flip = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("flip")),
    grad=lambda x, grad, **kwargs: flip(grad, **kwargs),
    kwargs_to_grads=True,
)
floor = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("floor")), is_differentiable=False
)
invert = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("invert")), is_differentiable=False
)
log = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("log")),
    grad=lambda x, grad: grad / x,
)
logical_not = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("logical_not")), is_differentiable=False
)
max = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("max")),
    grad=max_grad,
    kwargs_to_grads=True,
)
mean = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("mean")),
    grad=mean_grad,
    kwargs_to_grads=True,
)
min = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("min")),
    grad=min_grad,
    kwargs_to_grads=True,
)
prod = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("prod")),
    grad=prod_grad,
    kwargs_to_grads=True,
)
ravel = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("ravel")),
    grad=lambda x, grad, order="C": reshape(grad, x.shape, order=order),
    kwargs_to_grads=True,  # same order-aware VJP requirement as flatten
)
sign = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("sign")), is_differentiable=False
)
erf = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("erf")),
    # d/dx erf(x) = 2/sqrt(pi) * exp(-x^2)
    grad=lambda x, grad: grad * 1.1283791670955126 * exp(-(x * x)),
)
sin = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("sin")),
    grad=lambda x, grad: grad * cos(x),
)
sinh = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("sinh")),
    grad=lambda x, grad: grad * cosh(x),
)
squeeze = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("squeeze")),
    grad=squeeze_grad,
    # squeeze_grad must know WHICH axes were removed: with an explicit
    # `axis=` the un-propagated default (re-insert every size-1 axis) is
    # wrong whenever other size-1 axes survive the forward
    kwargs_to_grads=True,
)
std = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("std")),
    grad=std_grad,
    kwargs_to_grads=True,
)
var = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("var")),
    grad=var_grad,
    kwargs_to_grads=True,
)
sum = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("sum")),
    grad=sum_grad,
    kwargs_to_grads=True,
)


def cumsum_grad(x, grad, axis=None, **kwargs):
    """d(cumsum)/dx = reverse cumsum of the cotangent along the scan axis.

    With axis=None numpy scans the flattened array, so the cotangent arrives
    flat and the reversed scan runs flat before reshaping back to x.
    """
    if axis is None:
        return flip(cumsum(flip(grad))).reshape(x.shape)
    return flip(cumsum(flip(grad, axis=axis), axis=axis), axis=axis)


cumsum = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("cumsum")),
    grad=cumsum_grad,
    kwargs_to_grads=True,
)


# linear_scan(a, b, axis): y_t = a_t * y_{t-1} + b_t along ``axis``, y_{-1}
# = 0.  Forward: the scan kernel for f32 and bf16 (``kernels.scan``, the
# plain loop on the CPU and for other dtypes).  Its VJPs are themselves a
# reversed linear scan with a shifted decay, so the backward runs the same
# kernel; both VJPs need the same cotangent, kept in a single-entry memo
# keyed by the operands (the JAX package's ``_linear_scan_r_memo``; the memo
# holds the operands, so their ids stay unique while it does).  The memo'd
# value is a framework Tensor: under grad mode the two VJPs are two
# consumers of one tape node, so higher-order re-taping works.


def _scan_shift(t, axis):
    """t_{i-1} along ``axis`` with a zero slab at i=0 (framework ops only,
    so the shift re-tapes under higher-order differentiation)."""
    ax = axis % t.ndim
    pre = (slice(None),) * ax
    zero = md.zeros_like(t[pre + (slice(0, 1),)])
    return concat((zero, t[pre + (slice(0, -1),)]), axis=ax)


_linear_scan_memo: dict = {}


def _linear_scan_cotangent(a, b, grad, axis):
    """r_t = g_t + a_{t+1} r_{t+1}: the scan run in reverse (flip time,
    shift the decay one step, linear_scan, flip back)."""
    key = (id(a), id(b), id(grad), axis, md.grad_allowed_())
    if _linear_scan_memo.get("key") != key:
        ar = flip(a, axis=axis)
        r = flip(linear_scan(_scan_shift(ar, axis), flip(grad, axis=axis),
                             axis=axis), axis=axis)
        _linear_scan_memo.update(key=key, refs=(a, b, grad), val=r)
    return _linear_scan_memo["val"]


def linear_scan_grad_b(a, b, grad, axis=-1, _output=None):
    return _linear_scan_cotangent(a, b, grad, axis)


def linear_scan_grad_a(a, b, grad, axis=-1, _output=None):
    """dy_t/da_t = y_{t-1}, scaled by the accumulated cotangent r_t."""
    y = linear_scan(a, b, axis=axis) if _output is None else _output
    return _linear_scan_cotangent(a, b, grad, axis) * _scan_shift(y, axis)


linear_scan_grad_a.needs_output = True


def _linear_scan_forward(a, b, axis=-1):
    if a.shape != b.shape:
        raise ValueError(
            f"linear_scan requires matching shapes, got {tuple(a.shape)} vs "
            f"{tuple(b.shape)} (broadcast explicitly before scanning)")
    return backend_fn("linear_scan")(a, b, axis=axis)


linear_scan = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(_linear_scan_forward),
    grad_x=linear_scan_grad_a,
    grad_y=linear_scan_grad_b,
    kwargs_to_grads=True,
)


# ---------------------------------------------------------------------------
# einsum (extension op) — any number of operands, ellipsis, repeated-index
# diagonals; differentiable and higher-order capable (the VJPs are
# themselves einsums over framework ops, with a delta-mask scatter for
# diagonal operands).
# ---------------------------------------------------------------------------


def _einsum_parse(subscripts: str, n_ops: int):
    spec = subscripts.replace(" ", "")
    if "." in spec:
        raise ValueError(
            "einsum: ellipsis must be expanded before parsing (internal)")
    lhs, arrow, rhs = spec.partition("->")
    ins = lhs.split(",")
    if len(ins) != n_ops:
        raise ValueError(f"einsum spec {subscripts!r} expects {len(ins)} "
                         f"operands, got {n_ops}")
    if arrow and len(set(rhs)) != len(rhs):
        raise ValueError("einsum: repeated index in the output term")
    if not arrow:  # numpy implicit mode: once-seen indices, alphabetical
        from collections import Counter

        counts = Counter("".join(ins))
        rhs = "".join(sorted(c for c, n in counts.items() if n == 1))
    return ins, rhs


def _expand_ellipsis(subscripts: str, operands) -> str:
    """Resolve ``...`` into explicit letters (shared, right-aligned).

    Ellipsis-covered axes must agree in size across operands (no broadcasting
    inside the ellipsis — the one numpy einsum feature not supported); the
    backend raises on mismatch.
    """
    spec = subscripts.replace(" ", "")
    if "..." not in spec:
        if "." in spec:
            raise ValueError(f"einsum: invalid subscripts {subscripts!r}")
        return spec
    lhs, arrow, rhs = spec.partition("->")
    ins = lhs.split(",")
    if py_any("." in t.replace("...", "") for t in ins) or \
            "." in rhs.replace("...", ""):
        raise ValueError(f"einsum: invalid subscripts {subscripts!r}")

    import string

    used = {c for c in spec if c.isalpha()}
    pool = [c for c in string.ascii_letters if c not in used]
    n_ell = 0
    for t, op in zip(ins, operands):
        if "..." in t:
            n = op.ndim - (len(t) - 3)
            if n < 0:
                raise ValueError(
                    f"einsum: operand of rank {op.ndim} too small for "
                    f"term {t!r}")
            n_ell = py_max(n_ell, n)
    if n_ell > len(pool):
        raise ValueError("einsum: too many ellipsis axes")
    ell = "".join(pool[:n_ell])
    new_ins = []
    for t, op in zip(ins, operands):
        if "..." in t:
            n = op.ndim - (len(t) - 3)
            new_ins.append(t.replace("...", ell[n_ell - n:] if n else ""))
        else:
            new_ins.append(t)
    if arrow:
        new_rhs = rhs.replace("...", ell)
        return f"{','.join(new_ins)}->{new_rhs}"
    # implicit mode with ellipsis: ellipsis axes lead, then once-seen
    # EXPLICIT letters alphabetically (numpy semantics)
    from collections import Counter

    counts = Counter("".join(t.replace("...", "") for t in ins))
    tail = "".join(sorted(c for c, n in counts.items() if n == 1))
    return f"{','.join(new_ins)}->{ell}{tail}"


def _diag_delta(term: str, shape) -> "md.Tensor":
    """Boolean Tensor of ``shape``: True where every repeated letter's axes
    hold equal indices (the Kronecker delta of the diagonal constraint).
    Built from framework ops so it lives on device and both backends agree."""
    nd = len(term)
    mask = None
    seen: dict = {}
    for pos, c in enumerate(term):
        if c not in seen:
            seen[c] = pos
            continue
        first = seen[c]
        a = reshape(md.arange(shape[first]),
                    tuple(shape[first] if d == first else 1 for d in range(nd)))
        b = reshape(md.arange(shape[pos]),
                    tuple(shape[pos] if d == pos else 1 for d in range(nd)))
        m = equal(a, b)
        mask = m if mask is None else logical_and(mask, m)
    return mask


def _einsum_pullback(term: str, other_terms: "list", out: str, grad,
                     others: "list", shape):
    """Cotangent for a repeat-free operand term: contract the cotangent
    (indexed by ``out``) with every other operand back to ``term``'s
    indices; axes summed away in the forward broadcast back."""
    avail = set(out)
    for t in other_terms:
        avail |= set(t)
    reachable = "".join(c for c in term if c in avail)
    in_specs = ",".join([out, *other_terms])
    sub = einsum(f"{in_specs}->{reachable}", grad, *others)
    if reachable == term:
        return sub
    # re-insert the summed-away axes and broadcast
    for pos, c in enumerate(term):
        if c not in reachable:
            sub = expand_dims(sub, pos)
            reachable = reachable[:pos] + c + reachable[pos:]
    return broadcast_to(sub, tuple(shape))


def _einsum_operand_grad(term: str, other_terms: "list", out: str, grad,
                         others: "list", x):
    """d(einsum)/d(operand with index-string ``term``).

    Repeat-free terms use the standard reverse-einsum rule.  A term with
    repeated letters (diagonal) is equivalent to the repeat-free einsum over
    its extracted diagonal; the cotangent for the full operand scatters the
    diagonal cotangent back through a delta mask (zero off-diagonal).
    """
    if len(set(term)) == len(term):
        return _einsum_pullback(term, other_terms, out, grad, others, x.shape)
    dedup = "".join(dict.fromkeys(term))
    shape = tuple(x.shape)
    dedup_shape = tuple(shape[term.index(c)] for c in dedup)
    sub = _einsum_pullback(dedup, other_terms, out, grad, others, dedup_shape)
    # align the diagonal cotangent to the full term's axes: duplicate
    # positions get size-1 axes (left to right keeps order), then broadcast
    seen: set = set()
    for pos, c in enumerate(term):
        if c in seen:
            sub = expand_dims(sub, pos)
        else:
            seen.add(c)
    sub = broadcast_to(sub, shape)
    delta = _diag_delta(term, shape)
    return sub * delta.astype(sub.dtype)


def _einsum_forward_raw(*operands, subscripts=""):
    import minidiff_tpu_torch.backend as _backend

    return _backend.get_backend().einsum(subscripts, *operands)


def _make_einsum_grad(i: int, n: int):
    def grad_fn(*args_and_grad, subscripts=""):
        *ops, grad = args_and_grad
        ins, out = _einsum_parse(subscripts, n)
        return _einsum_operand_grad(
            ins[i], ins[:i] + ins[i + 1:], out, grad,
            list(ops[:i]) + list(ops[i + 1:]), ops[i],
        )

    return grad_fn


# one manufactured op per arity, created on first use
_einsum_ops: dict = {}


def _einsum_n(n: int):
    if n not in _einsum_ops:
        _einsum_ops[n] = wrapping.create_op_func(
            forward_func=as_tensor_func(_einsum_forward_raw),
            grad_funcs=[_make_einsum_grad(i, n) for i in range(n)],
            kwargs_to_grads=True,
            op_name="einsum",
            tensor_only=True,
        )
    return _einsum_ops[n]


def einsum(subscripts: str, *operands: "md.Tensor") -> "md.Tensor":
    """Differentiable Einstein summation — any operand count, explicit or
    numpy-implicit specs, ellipsis, and repeated-index diagonals.

    VJPs are reverse einsums in framework ops (diagonal terms scatter
    through a delta mask), so higher-order gradients re-tape as usual.
    Not supported: broadcasting of mismatched sizes inside an ellipsis.
    """
    if not operands:
        raise ValueError("einsum needs at least one operand")
    operands = tuple(
        t if isinstance(t, md.Tensor) else md.Tensor(t) for t in operands
    )
    spec = _expand_ellipsis(subscripts, operands)
    ins, out = _einsum_parse(spec, len(operands))  # validate eagerly
    canonical = f"{','.join(ins)}->{out}"
    return _einsum_n(len(operands))(*operands, subscripts=canonical)


# ---------------------------------------------------------------------------
# ordering ops
# ---------------------------------------------------------------------------

argsort = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("argsort")),
    is_differentiable=False,
    kwargs_to_grads=True,
)


def gather(x: "md.Tensor", indices: "md.Tensor", axis: int = -1) -> "md.Tensor":
    """Differentiable take-along-axis: out[..., i, ...] = x[..., idx[..., i,
    ...], ...].  ``indices`` has x's ndim with any size on ``axis``.  Built
    on the differentiable getitem (VJP = scatter_add), unlike the graph-free
    ``take_along_axis`` factory.
    """
    nd = x.ndim
    ax = axis % nd
    key = []
    for d in range(nd):
        if d == ax:
            key.append(indices)
        else:
            view = (1,) * d + (x.shape[d],) + (1,) * (nd - d - 1)
            key.append(md.arange(x.shape[d]).reshape(view))
    return getitem(x, tuple(key))


def sort_grad(x, grad, axis=-1, **kwargs):
    """Route each sorted slot's cotangent back to its source position.

    sort(x) = gather(x, argsort(x)); a permutation's scatter transpose is a
    gather by the inverse permutation, and argsort(argsort(x)) IS that
    inverse — so the VJP stays gather-only (differentiable, no scatter).
    """
    if axis is None:  # numpy sorts the flattened array
        flat = x.reshape((x.size,))
        perm = argsort(flat)
        return gather(grad, argsort(perm)).reshape(x.shape)
    perm = argsort(x, axis=axis)
    return gather(grad, argsort(perm, axis=axis), axis=axis)


sort = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("sort")),
    grad=sort_grad,
    kwargs_to_grads=True,
)


_top_k_indices = as_tensor_func(backend_fn("top_k_indices"))


def topk(x: "md.Tensor", k: int, axis: int = -1):
    """(values, indices) of the k largest along ``axis``, descending.

    ``values`` is differentiable (gather routes the cotangent to the picked
    positions); ``indices`` is integer/non-diff.  Ties follow the backend's
    top-k order.  Uses O(n log k) device top-k on the last axis.
    """
    nd = x.ndim
    ax = axis % nd
    moved = swapaxes(x, ax, nd - 1) if ax != nd - 1 else x
    idx = _top_k_indices(moved, k)
    vals = gather(moved, idx, axis=-1)
    if ax != nd - 1:
        vals = swapaxes(vals, ax, nd - 1)
        idx = swapaxes(idx, ax, nd - 1)
    return vals, idx


def _extremum_pick_grad(pick_x: bool):
    """maximum/minimum VJP: route the cotangent to the winning operand;
    exact ties split it evenly (matching the max/min reduction convention)."""

    def grad_fn(x, y, grad):
        win = (x > y) if pick_x else (x < y)
        tie = x == y
        return grad * (win.astype(grad.dtype) + 0.5 * tie.astype(grad.dtype))

    return grad_fn


maximum = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("maximum")),
    grad_x=_extremum_pick_grad(True),
    grad_y=_extremum_pick_grad(False),
)
minimum = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("minimum")),
    grad_x=_extremum_pick_grad(False),
    grad_y=_extremum_pick_grad(True),
)


tan = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("tan")),
    grad=lambda x, grad: grad * (1 / cos(x) ** 2),
)
def tanh_grad(x, grad, _output=None):
    # sech^2 = 1 - tanh^2, reusing the forward tanh when available
    t = tanh(x) if _output is None else _output
    return grad * (1 - t**2)


tanh_grad.needs_output = True

tanh = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("tanh")),
    grad=tanh_grad,
)
transpose = wrapping.create_unary_op_func(
    forward_func=as_tensor_func(backend_fn("transpose")),
    grad=transpose_grad,
    kwargs_to_grads=True,
)

def sqrt(a: "md.Tensor", **kwargs: "Any") -> "md.Tensor":
    return power(a, 0.5, **kwargs)


def square(a: "md.Tensor", **kwargs: "Any") -> "md.Tensor":
    return power(a, 2, **kwargs)


# ---------------------------------------------------------------------------
# binary ops
# ---------------------------------------------------------------------------

add = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("add")),
    grad_x=lambda x, y, grad: grad,
    grad_y=lambda x, y, grad: grad,
)
astype = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("astype")),
    grad_x=lambda x, dtype, grad: grad.astype(x.dtype),
)
broadcast_to = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("broadcast_to")),
    grad_x=lambda x, shape, grad: unbroadcast(grad, x.shape),
)
dot = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("dot")),
    grad_x=dot_grad_x,
    grad_y=dot_grad_y,
)
equal = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("equal")), is_differentiable=False
)
expand_dims = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("expand_dims")),
    grad_x=lambda x, axis, grad: squeeze(grad, axis=axis),
)
floor_divide = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("floor_divide")), is_differentiable=False
)
getitem = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("getitem")),
    grad_x=getitem_grad,
    op_name="index",
)
greater = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("greater")), is_differentiable=False
)
greater_equal = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("greater_equal")), is_differentiable=False
)
less = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("less")), is_differentiable=False
)
less_equal = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("less_equal")), is_differentiable=False
)
logical_and = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("logical_and")), is_differentiable=False
)
logical_or = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("logical_or")), is_differentiable=False
)
logical_xor = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("logical_xor")), is_differentiable=False
)
matmul = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("matmul")),
    grad_x=matmul_grad_x,
    grad_y=matmul_grad_y,
    tensor_only=True,
)
# Transpose-free contractions (extension ops): matmul_nt(a,b) = a @ b^T,
# matmul_tn(a,b) = a^T @ b over the last two axes.  The three matmul forms'
# VJPs close over each other, so higher-order gradients stay transpose-free.
matmul_nt = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("matmul_nt")),
    grad_x=lambda x, y, grad: matmul(grad, y),
    grad_y=lambda x, y, grad: matmul_tn(grad, x),
    tensor_only=True,
)
matmul_tn = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("matmul_tn")),
    grad_x=lambda x, y, grad: matmul_nt(y, grad),
    grad_y=lambda x, y, grad: matmul(x, grad),
    tensor_only=True,
)
mod = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("mod")),
    grad_x=lambda x, y, grad: md.where(x % y == 0, 0, grad),
    grad_y=lambda x, y, grad: md.where(x % y == 0, 0, grad),
)
multiply = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("multiply")),
    grad_x=lambda x, y, grad: grad * y,
    grad_y=lambda x, y, grad: grad * x,
)
not_equal = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("not_equal")), is_differentiable=False
)
def power_grad_x(x, y, grad):
    # guard the y == 0 slots: the naive grad*y*x**(y-1) is 0 * inf = NaN at
    # x = 0 even though d/dx x^0 = 0 exactly
    if not isinstance(y, md.Tensor):
        if y == 0:
            return md.zeros_like(x)
        return grad * y * (x ** (y - 1))
    return md.where(md.equal(y, 0), 0.0, grad * y * (x ** (y - 1)))


power = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("power")),
    grad_x=power_grad_x,
    grad_y=lambda x, y, grad: grad * log(x) * x**y,
)
reshape = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("reshape")),
    # the inverse of an order-o reshape is the order-o reshape back
    grad_x=lambda x, shape, grad, order="C", **kw:
        reshape(grad, x.shape, order=order),
    kwargs_to_grads=True,
)
subtract = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("subtract")),
    grad_x=lambda x, y, grad: grad,
    grad_y=lambda x, y, grad: -grad,
)
tensordot = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("tensordot")),
    grad_x=tensordot_grad_x,
    grad_y=tensordot_grad_y,
    tensor_only=True,
    kwargs_to_grads=True,
)
true_divide = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("true_divide")),
    grad_x=lambda x, y, grad: grad / y,
    grad_y=lambda x, y, grad: grad * (-x / y**2),
)
unbroadcast = wrapping.create_binary_op_func(
    forward_func=unbroadcast_forward,
    grad_x=lambda x, shape, grad: broadcast_to(grad, x.shape),
)
# scatter_add(template, key, values): zeros shaped like `template` with
# `values` scatter-added at `key` (repeats accumulate); it exists so that
# getitem's VJP is differentiable.
scatter_add = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("scatter_add")),
    grad_z=lambda x, key, values, grad: getitem(grad, key),
)


# softmax_xent: per-row softmax cross-entropy over integer labels; the
# forward is the xent_fwd kernel for f32 and bf16 logits.  Labels are class
# ids with no cotangent (grad slot None).  First order: ``kernels.xent``'s
# ``loss_grad`` (the xent_bwd kernel for f32 and bf16, a plain version on the
# CPU and for other dtypes), as the JAX package's XLA path takes its fused
# kernel.  Under grad mode (a higher-order sweep): the composed closed form
# (softmax - onehot) in framework ops.


def softmax_xent_grad_z(z, lab, grad):
    if not md.grad_allowed_():
        return md.Tensor(_xent.loss_grad(z._data, lab._data, grad._data))
    acc = z.dtype if z.dtype in (md.float64, md.float32) else md.float32
    za = z.astype(acc)
    m = md.max(za, axis=-1, keepdims=True)
    e = md.exp(za - m)
    p = e / md.sum(e, axis=-1, keepdims=True)
    v = z.shape[-1]
    onehot = md.equal(md.expand_dims(lab, -1), md.arange(v)).astype(acc)
    dz = (p - onehot) * md.expand_dims(grad.astype(acc), -1)
    return dz.astype(z.dtype)


softmax_xent = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("softmax_xent")),
    grad_x=softmax_xent_grad_z,
    grad_y=None,
)


# rmsnorm(x, g, eps): last-axis RMSNorm; add_rmsnorm(x, a, g, eps): the
# stacked pair (2, *x.shape), [0] = t = x + a, [1] = RMSNorm(t).  Forwards:
# the rms_fwd / addrms_fwd kernels for f32 and bf16 (``kernels.layernorm``,
# plain versions on the CPU and for other dtypes).  First order: one
# rms_bwd / addrms_bwd launch serves every input's VJP, kept in a
# single-entry memo keyed by the operands (the JAX package's
# ``_rms_fused_memo`` / ``_addnorm_fused_memo``; the memo holds the
# operands, so their ids stay unique while it does).  Under grad mode (a
# higher-order sweep): the composed closed form in framework ops.

_rms_memo: dict = {}


def _rms_kernel_grads(x, g, grad, eps, output=None):
    """(dx, dg) arrays of rmsnorm (``output`` None) or add_rmsnorm; each VJP
    wraps its own Tensor around them, as the JAX memo's callers do."""
    key = (id(x), id(g), id(grad), id(output), float(eps))
    if _rms_memo.get("key") != key:
        if output is None:
            val = _ln.for_tape("rms_grads")(x._data, g._data, grad._data, eps)
        else:
            val = _ln.for_tape("addrms_grads")(output._data[0], g._data,
                                               grad._data[1], grad._data[0], eps)
        _rms_memo.update(key=key, refs=(x, g, grad, output), val=val)
    return _rms_memo["val"]


def _rms_xhat(t, eps):
    acc = t.dtype if t.dtype in (md.float64, md.float32) else md.float32
    ta = t.astype(acc)
    rsig = 1.0 / md.sqrt(md.mean(ta * ta, axis=-1, keepdims=True) + eps)
    return ta * rsig, rsig, acc


def _rms_dx(t, g, dy, eps):
    xhat, rsig, acc = _rms_xhat(t, eps)
    w = dy.astype(acc) * g.astype(acc)
    m = md.mean(w * xhat, axis=-1, keepdims=True)
    return ((w - xhat * m) * rsig).astype(t.dtype)


def _rms_dg(t, g, dy, eps):
    xhat, _, acc = _rms_xhat(t, eps)
    s = dy.astype(acc) * xhat
    red = tuple(range(len(t.shape) - 1))
    if red:
        s = md.sum(s, axis=red)
    return s.astype(g.dtype)


def rmsnorm_grad_x(x, g, grad, eps=1e-6):
    if not md.grad_allowed_():
        return md.Tensor(_rms_kernel_grads(x, g, grad, eps)[0])
    return _rms_dx(x, g, grad, eps)


def rmsnorm_grad_g(x, g, grad, eps=1e-6):
    if not md.grad_allowed_():
        return md.Tensor(_rms_kernel_grads(x, g, grad, eps)[1])
    return _rms_dg(x, g, grad, eps)


rmsnorm = wrapping.create_binary_op_func(
    forward_func=as_tensor_func(backend_fn("rmsnorm")),
    grad_x=rmsnorm_grad_x,
    grad_y=rmsnorm_grad_g,
    kwargs_to_grads=True,
)


def add_rmsnorm_grad_x(x, a, g, grad, eps=1e-6, _output=None):
    if not md.grad_allowed_() and _output is not None:
        return md.Tensor(_rms_kernel_grads(x, g, grad, eps, _output)[0])
    t = _output[0] if _output is not None else x + a
    return grad[0] + _rms_dx(t, g, grad[1], eps)


def add_rmsnorm_grad_g(x, a, g, grad, eps=1e-6, _output=None):
    if not md.grad_allowed_() and _output is not None:
        return md.Tensor(_rms_kernel_grads(x, g, grad, eps, _output)[1])
    t = _output[0] if _output is not None else x + a
    return _rms_dg(t, g, grad[1], eps)


for _f in (add_rmsnorm_grad_x, add_rmsnorm_grad_g):
    _f.needs_output = True

add_rmsnorm = wrapping.create_op_func(
    forward_func=as_tensor_func(backend_fn("add_rmsnorm")),
    grad_funcs=[add_rmsnorm_grad_x, add_rmsnorm_grad_x, add_rmsnorm_grad_g],
    kwargs_to_grads=True,
    op_name="add_rmsnorm",
)


# ---------------------------------------------------------------------------
# concat — differentiable concatenation.  `concatenate` is a graph-free
# factory (using it inside a model severs gradients); `md.concat` is a real
# op whose VJPs slice the cotangent, so gradients (including higher-order,
# via the differentiable getitem) flow.
# ---------------------------------------------------------------------------


def concat(tensors: "Sequence[md.Tensor]", axis: int = 0) -> "md.Tensor":
    tensors = [t if isinstance(t, md.Tensor) else md.Tensor(t) for t in tensors]
    nd = tensors[0].ndim
    ax = axis % nd if nd else 0
    sizes = [int(t.shape[ax]) for t in tensors]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + size)

    def make_grad(i: int):
        def grad_fn(*args_and_grad: "Any", axis: int = 0) -> "md.Tensor":
            grad = args_and_grad[-1]
            key = tuple(
                slice(offsets[i], offsets[i + 1]) if d == ax else slice(None)
                for d in range(nd)
            )
            return grad[key]

        return grad_fn

    forward = as_tensor_func(
        lambda *raw, axis=0: wrapping.backend.concatenate(raw, axis=axis)
    )
    forward.__name__ = "concat"
    # stable structural token: per-call closures would never repeat a
    # reuse_graph hash (and recycled id()s could alias stale cache entries)
    forward._structural_id = ("concat", ax, tuple(offsets))
    op = wrapping.create_op_func(
        forward_func=forward,
        grad_funcs=[make_grad(i) for i in range(len(tensors))],
        kwargs_to_grads=True,
        tensor_only=True,
        op_name="concat",
    )
    return op(*tensors, axis=ax)


# ---------------------------------------------------------------------------
# ternary ops
# ---------------------------------------------------------------------------

clip = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("clip")),
    grad_x=clip_grad_x,
    kwargs_to_grads=True,
)
swapaxes = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("swapaxes")),
    grad_x=lambda x, axis1, axis2, grad, **kwargs: swapaxes(grad, axis1, axis2, **kwargs),
    kwargs_to_grads=True,
)
where = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("where")),
    # select-based VJPs: dtype-safe for bool conditions and themselves
    # differentiable wrt grad for higher-order sweeps
    grad_y=lambda condition, y, z, grad: md.where(condition, grad, 0),
    grad_z=lambda condition, y, z, grad: md.where(condition, 0, grad),
)


# ---------------------------------------------------------------------------
# quantized serving ops (kernels/quant.py): differentiable in x only, as in
# the JAX package (definitions.py:1065-1116); q, p and s are quantization
# constants with no cotangent.  The VJPs dequantize the weight and contract
# through matmul_nt, so they re-tape for higher order.
# ---------------------------------------------------------------------------


def _dequant_matmul_grad_x(x, q, s, grad):
    # the contraction in the promoted (grad * s) dtype (f32 for bf16
    # grads), the cotangent back in x's dtype
    gs = grad * s
    return matmul_nt(gs, q.astype(gs.dtype)).astype(x.dtype)


dequant_matmul = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("dequant_matmul")),
    grad_x=_dequant_matmul_grad_x,
    tensor_only=True,
)


def _dequant_matmul4_grad_x(x, p, s, grad):
    import minidiff_tpu_torch.backend as _backend

    with md.no_grad():
        q = md.Tensor(_backend.get_backend().unpack_int4(p._data))
        group = q.shape[0] // s.shape[0]
        wdt = (s.reshape((-1,))[:1] * grad.reshape((-1,))[:1]).dtype
        w = q.astype(wdt) * md.repeat(s.astype(wdt), group, axis=0)
    return matmul_nt(grad.astype(wdt), w).astype(x.dtype)


dequant_matmul4 = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("dequant_matmul4")),
    grad_x=_dequant_matmul4_grad_x,
    tensor_only=True,
)

# the stacked sibling for an MoE expert bank: x (E, C, K) @ (q (E, K, N) *
# s (E, N)); the gradient flows to x only, through the frozen dequantized bank
def _dequant_matmul_bmm_grad_x(x, q, s, grad):
    wdt = (s.reshape((-1,))[:1] * grad.reshape((-1,))[:1]).dtype
    w = q.astype(wdt) * md.expand_dims(s.astype(wdt), 1)  # (E, K, N)
    return matmul_nt(grad.astype(wdt), w).astype(x.dtype)


dequant_matmul_bmm = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("dequant_matmul_bmm")),
    grad_x=_dequant_matmul_bmm_grad_x,
    tensor_only=True,
)

# attention over an int8 KV cache (q, k8, ks, v8, vs, pos; kwarg scale):
# serving only, non-differentiable by design, as in the JAX package
sdpa_int8_cache = wrapping.create_op_func(
    forward_func=as_tensor_func(backend_fn("sdpa_int8_cache")),
    grad_funcs=[None] * 6,
    is_differentiable=False,
    tensor_only=True,
)

# ---------------------------------------------------------------------------
# sdpa: scaled dot-product attention (the JAX ops/definitions.py:1202-1366).
# The forward is the flash forward where it is eligible
# (kernels/attention.py); the VJPs below are the composed formulation in
# framework ops, so higher-order gradients re-tape like every other op.
# ---------------------------------------------------------------------------


def _sdpa_scale(q: "md.Tensor", scale) -> float:
    return float(scale) if scale is not None else 1.0 / float(q.shape[-1]) ** 0.5


def _sdpa_probs(q, k, causal, scale, mask=None, window=None, sinks=0,
                segment_ids=None):
    s = matmul(q, swapaxes(k, -1, -2)) * _sdpa_scale(q, scale)
    if causal:
        sq, sk = int(s.shape[-2]), int(s.shape[-1])
        rows = reshape(md.arange(sq), (sq, 1))
        cols = reshape(md.arange(sk), (1, sk))
        cm = greater_equal(rows, cols)
        if window is not None:
            # only the last `window` positions are visible, except the
            # first `sinks` keys (attention sinks), as the flash kernels
            live = less(rows - cols, int(window))
            if sinks:
                live = logical_or(live, less(cols, int(sinks)))
            cm = logical_and(cm, live)
        s = where(cm, s, -1e30)
    if mask is not None:
        if not isinstance(mask, md.Tensor):
            mask = md.Tensor(mask)
        s = where(mask, s, -1e30)
    if segment_ids is not None:
        # same-document visibility (sequence packing): ids compare (Sq, 1)
        # against (1, Sk) per batch row
        sg = (segment_ids if isinstance(segment_ids, md.Tensor)
              else md.Tensor(segment_ids))
        if len(sg.shape) == 1:
            sg = reshape(sg, (1,) + tuple(sg.shape))
        b, ss = int(sg.shape[0]), int(sg.shape[1])
        if len(s.shape) == 4:
            sm = equal(reshape(sg, (b, 1, ss, 1)), reshape(sg, (b, 1, 1, ss)))
        else:
            sm = equal(reshape(sg, (b, ss, 1)), reshape(sg, (b, 1, ss)))
        s = where(sm, s, -1e30)
    m = max(s, axis=-1, keepdims=True)
    e = exp(s - m)
    return e / sum(e, axis=-1, keepdims=True)


def _sdpa_ds(q, k, v, grad, causal, scale, mask=None, window=None, sinks=0,
             segment_ids=None):
    p = _sdpa_probs(q, k, causal, scale, mask, window=window, sinks=sinks,
                    segment_ids=segment_ids)
    dp = matmul_nt(grad, v)
    return p, p * (dp - sum(dp * p, axis=-1, keepdims=True))


# The first-order backward runs the flash backward kernels
# (kernels/attention.py flash_grads): the engine calls the three grad
# functions back to back with the same operands, so a single-entry memo
# computes (dq, dk, dv) once; it holds the operands, so their ids stay
# unique while it does.
_sdpa_fused_memo: dict = {}


def _sdpa_fused(q, k, v, grad, causal, scale, mask, window=None, sinks=0,
                segment_ids=None):
    if md.grad_allowed_():
        return None  # higher order re-tapes the composed form
    mraw = mask._data if isinstance(mask, md.Tensor) else mask
    sraw = segment_ids._data if isinstance(segment_ids, md.Tensor) else segment_ids
    key = (id(q), id(k), id(v), id(grad), py_bool(causal), scale,
           0 if mraw is None else id(mraw), window, sinks,
           0 if sraw is None else id(sraw))
    if _sdpa_fused_memo.get("key") != key:
        from minidiff_tpu_torch.kernels import attention as _att

        qr, kr, vr = q._data, k._data, v._data
        if not _att.flash_grads_decision(qr, kr, vr, causal, mask=mraw, window=window,
                                         sinks=sinks, segment_ids=sraw):
            return None
        _sdpa_fused_memo["key"] = key
        _sdpa_fused_memo["refs"] = (q, k, v, grad, mraw, sraw)
        _sdpa_fused_memo["val"] = _att.flash_grads(
            qr, kr, vr, grad._data, _sdpa_scale(q, scale), py_bool(causal),
            mask=mraw, window=window, sinks=sinks, segment_ids=sraw)
    return _sdpa_fused_memo["val"]


def sdpa_grad_q(q, k, v, grad, causal=False, scale=None, mask=None,
                window=None, sinks=0, segment_ids=None):
    fused = _sdpa_fused(q, k, v, grad, causal, scale, mask, window, sinks, segment_ids)
    if fused is not None:
        return md.Tensor(fused[0])
    _, ds = _sdpa_ds(q, k, v, grad, causal, scale, mask, window, sinks,
                     segment_ids=segment_ids)
    return matmul(ds, k) * _sdpa_scale(q, scale)


def sdpa_grad_k(q, k, v, grad, causal=False, scale=None, mask=None,
                window=None, sinks=0, segment_ids=None):
    fused = _sdpa_fused(q, k, v, grad, causal, scale, mask, window, sinks, segment_ids)
    if fused is not None:
        return md.Tensor(fused[1])
    _, ds = _sdpa_ds(q, k, v, grad, causal, scale, mask, window, sinks,
                     segment_ids=segment_ids)
    return matmul_tn(ds, q) * _sdpa_scale(q, scale)


def sdpa_grad_v(q, k, v, grad, causal=False, scale=None, mask=None,
                window=None, sinks=0, segment_ids=None):
    fused = _sdpa_fused(q, k, v, grad, causal, scale, mask, window, sinks, segment_ids)
    if fused is not None:
        return md.Tensor(fused[2])
    p = _sdpa_probs(q, k, causal, scale, mask, window, sinks, segment_ids=segment_ids)
    return matmul_tn(p, grad)


sdpa = wrapping.create_ternary_op_func(
    forward_func=as_tensor_func(backend_fn("sdpa")),
    grad_x=sdpa_grad_q,
    grad_y=sdpa_grad_k,
    grad_z=sdpa_grad_v,
    kwargs_to_grads=True,
)

__all__ = [
    "absolute",
    "abs",
    "all",
    "any",
    "argmax",
    "argmin",
    "argwhere",
    "atleast_1d",
    "atleast_2d",
    "atleast_3d",
    "ceil",
    "copy",
    "cos",
    "cosh",
    "erf",
    "exp",
    "flatten",
    "flip",
    "floor",
    "invert",
    "log",
    "logical_not",
    "max",
    "min",
    "mean",
    "prod",
    "ravel",
    "sign",
    "sin",
    "sinh",
    "sqrt",
    "square",
    "squeeze",
    "std",
    "var",
    "sum",
    "cumsum",
    "linear_scan",
    "einsum",
    "sort",
    "argsort",
    "gather",
    "topk",
    "tan",
    "tanh",
    "transpose",
    "add",
    "astype",
    "broadcast_to",
    "dot",
    "equal",
    "expand_dims",
    "floor_divide",
    "getitem",
    "greater",
    "greater_equal",
    "less",
    "less_equal",
    "logical_and",
    "logical_or",
    "logical_xor",
    "matmul",
    "matmul_nt",
    "matmul_tn",
    "maximum",
    "minimum",
    "mod",
    "multiply",
    "not_equal",
    "power",
    "reshape",
    "subtract",
    "tensordot",
    "true_divide",
    "unbroadcast",
    "scatter_add",
    "softmax_xent",
    "rmsnorm",
    "add_rmsnorm",
    "concat",
    "clip",
    "swapaxes",
    "where",
    "dequant_matmul",
    "dequant_matmul4",
    "dequant_matmul_bmm",
    "sdpa",
    "sdpa_int8_cache",
]
