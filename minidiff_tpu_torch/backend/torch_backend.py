"""The array backend of the port: numpy semantics on torch tensors of one device.

The port's own copy of the parts of ``minidiff_tpu/backend/torch_backend.py``
that the tape engine needs, with three changes:

* a backend is bound to a ``torch.device`` (``"cuda"`` or ``"cpu"``): every
  array it creates lives there, and an input that is not a tensor (a list, a
  numpy array) moves there;
* nothing on the device path round-trips through numpy: scatter-adds use
  ``index_add_`` over the flat positions a key selects, and Python scalars
  stay scalars (torch's wrapped-number promotion is numpy's), so an op with
  a constant starts no host-to-device copy;
* random draws come from a ``torch.Generator`` on the backend's device that
  ``md.seed`` sets.

The numpy semantics shims the JAX package's torch backend carries
(``torch_backend.py:10-22``) stay: ``order="F"`` reshapes, numpy's axis
conventions, numpy's strict ``split``, float64 creation defaults.  Where
torch and numpy promote differently (an integer array with a Python float,
or divided by an integer), the result is numpy's float64.

``matmul`` / ``matmul_nt`` / ``matmul_tn`` go to ``kernels.matmul`` (the
hand-written CUDA kernels for large 2-D f32/bf16 products) and
``softmax_xent`` to ``kernels.xent``.  Autograd is the tape's: torch tensors
here never require grad.
"""

from __future__ import annotations

import operator
from builtins import bool as py_bool
from typing import TYPE_CHECKING

import numpy as np
import torch

from minidiff_tpu_torch.kernels import matmul as _mm
from minidiff_tpu_torch.kernels import xent as _xent

if TYPE_CHECKING:
    from typing import Any, Callable

_NP_TO_TORCH = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _dt(dtype: "Any") -> "torch.dtype":
    """numpy / str / Python-type / torch spellings of a dtype, as torch's."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (TypeError, KeyError):
        name = getattr(dtype, "__name__", str(dtype))
        resolved = getattr(torch, name.replace("bool_", "bool"), None)
        if isinstance(resolved, torch.dtype):
            return resolved
        raise TypeError(f"cannot map {dtype!r} to a torch dtype") from None


def _axis_tuple(axis, ndim: int):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim for a in axis)
    return (int(axis) % ndim,)


def _f_order_perm(ndim: int):
    return tuple(reversed(range(ndim)))


def _shape(shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _fix_scalar(s, t: "torch.Tensor"):
    """numpy gives float64 for an integer or bool array with a Python
    float; torch would give its default float32.  ``torch.full`` fills on
    the device: no host-to-device copy."""
    if isinstance(s, float) and not (t.is_floating_point() or t.is_complex()):
        return torch.full((), s, dtype=torch.float64, device=t.device)
    return s


def _float_unary(fn):
    """``fn`` with numpy's promotion: integers and bools go to float64
    (torch would give float32)."""
    def f(a):
        return fn(a if a.is_floating_point() or a.is_complex() else a.double())

    f.__name__ = fn.__name__
    return f


def _binary(op):
    """A backend method applying ``op`` to two operands, either of them a
    Python scalar."""
    def f(self, a, b):
        return op(*self._pair(a, b))

    f.__name__ = op.__name__
    return f


def _as_tensor(s, like: "torch.Tensor") -> "torch.Tensor":
    """A Python scalar as a 0-d tensor beside ``like``, numpy's dtype."""
    if isinstance(s, torch.Tensor):
        return s
    s = _fix_scalar(s, like)
    if isinstance(s, torch.Tensor):
        return s
    if isinstance(s, py_bool):
        dtype = torch.bool
    elif isinstance(s, int):
        dtype = like.dtype if like.dtype != torch.bool else torch.int64
    else:
        dtype = like.dtype
    return torch.full((), s, dtype=dtype, device=like.device)


class TorchBackend:
    """numpy-semantics array functions on the tensors of one device."""

    tensor_class = torch.Tensor
    nan = float("nan")

    dtype = torch.dtype
    float64 = torch.float64
    float32 = torch.float32
    float16 = torch.float16
    bfloat16 = torch.bfloat16
    uint64 = torch.uint64
    uint32 = torch.uint32
    uint16 = torch.uint16
    uint8 = torch.uint8
    int64 = torch.int64
    int32 = torch.int32
    int16 = torch.int16
    int8 = torch.int8
    bool = torch.bool

    def __init__(self, device: "torch.device"):
        self.device = device
        self._generator = None

    # ---- construction ----
    def tensor_constructor(self, data: "Any", dtype: "Any" = None):
        if isinstance(data, torch.Tensor):
            out = data.detach().to(self.device)
        else:
            arr = np.asarray(data)
            if arr.dtype.name == "bfloat16":  # ml_dtypes arrays
                out = torch.as_tensor(arr.astype(np.float32),
                                      device=self.device).to(torch.bfloat16)
            else:
                # torch takes no negative strides (a flipped numpy view)
                out = torch.as_tensor(arr if arr.flags.c_contiguous else arr.copy(),
                                      device=self.device)
        if dtype is not None:
            out = out.to(_dt(dtype))
        return out

    def _t(self, x):
        """Tensors pass, Python scalars stay scalars, the rest moves here."""
        if isinstance(x, (torch.Tensor, py_bool, int, float)):
            return x
        return self.tensor_constructor(x)

    def _pair(self, a, b):
        a, b = self._t(a), self._t(b)
        if not isinstance(a, torch.Tensor):
            a = _fix_scalar(a, b)
        elif not isinstance(b, torch.Tensor):
            b = _fix_scalar(b, a)
        return a, b

    def _tensors(self, a, b):
        """Both operands as tensors (for torch functions without scalar
        overloads)."""
        a, b = self._t(a), self._t(b)
        if not isinstance(a, torch.Tensor):
            a = _as_tensor(a, b)
        if not isinstance(b, torch.Tensor):
            b = _as_tensor(b, a)
        return a, b

    # ---- elementwise unary ----
    absolute = staticmethod(torch.absolute)
    ceil = staticmethod(torch.ceil)
    copy = staticmethod(torch.clone)
    cos = staticmethod(_float_unary(torch.cos))
    cosh = staticmethod(_float_unary(torch.cosh))
    erf = staticmethod(_float_unary(torch.erf))
    exp = staticmethod(_float_unary(torch.exp))
    floor = staticmethod(torch.floor)
    invert = staticmethod(torch.bitwise_not)
    log = staticmethod(_float_unary(torch.log))
    logical_not = staticmethod(torch.logical_not)
    sign = staticmethod(torch.sign)
    sin = staticmethod(_float_unary(torch.sin))
    sinh = staticmethod(_float_unary(torch.sinh))
    sqrt = staticmethod(_float_unary(torch.sqrt))
    square = staticmethod(torch.square)
    tan = staticmethod(_float_unary(torch.tan))
    tanh = staticmethod(_float_unary(torch.tanh))

    # ---- shape unary ----
    atleast_1d = staticmethod(torch.atleast_1d)
    atleast_2d = staticmethod(torch.atleast_2d)
    atleast_3d = staticmethod(torch.atleast_3d)

    @staticmethod
    def flatten(a, order: str = "C"):
        if order == "F":
            a = a.permute(_f_order_perm(a.ndim))
        return a.reshape(-1).clone()

    def ravel(self, a, order: str = "C"):
        return self.flatten(a, order=order)

    @staticmethod
    def squeeze(a, axis=None):
        if axis is None:
            return a.squeeze()
        return a.squeeze(axis if isinstance(axis, int) else tuple(axis))

    @staticmethod
    def transpose(a, axes=None):
        if axes is None:
            axes = _f_order_perm(a.ndim)
        return a.permute(tuple(int(x) for x in axes))

    @staticmethod
    def flip(a, axis=None):
        return torch.flip(a, _axis_tuple(axis, a.ndim))

    # ---- reductions / search ----
    @staticmethod
    def all(a, axis=None, keepdims: py_bool = False):
        if not a.ndim:
            return torch.all(a)
        return torch.all(a.bool(), dim=_axis_tuple(axis, a.ndim),
                         keepdim=keepdims)

    @staticmethod
    def any(a, axis=None, keepdims: py_bool = False):
        if not a.ndim:
            return torch.any(a)
        return torch.any(a.bool(), dim=_axis_tuple(axis, a.ndim),
                         keepdim=keepdims)

    @staticmethod
    def argmax(a, axis=None, keepdims: py_bool = False):
        return torch.argmax(a, dim=axis, keepdim=keepdims)

    @staticmethod
    def argmin(a, axis=None, keepdims: py_bool = False):
        return torch.argmin(a, dim=axis, keepdim=keepdims)

    argwhere = staticmethod(torch.argwhere)

    @staticmethod
    def max(a, axis=None, keepdims: py_bool = False):
        dims = _axis_tuple(axis, a.ndim)
        return torch.amax(a, dim=dims, keepdim=keepdims) if dims else a.clone()

    @staticmethod
    def min(a, axis=None, keepdims: py_bool = False):
        dims = _axis_tuple(axis, a.ndim)
        return torch.amin(a, dim=dims, keepdim=keepdims) if dims else a.clone()

    @staticmethod
    def sum(a, axis=None, keepdims: py_bool = False):
        dims = _axis_tuple(axis, a.ndim)
        return torch.sum(a, dim=dims, keepdim=keepdims) if dims else a.clone()

    @staticmethod
    def mean(a, axis=None, keepdims: py_bool = False):
        if not a.is_floating_point():
            a = a.double()  # numpy's mean of integers is float64
        dims = _axis_tuple(axis, a.ndim)
        return torch.mean(a, dim=dims, keepdim=keepdims) if dims else a.clone()

    @staticmethod
    def prod(a, axis=None, keepdims: py_bool = False):
        dims = sorted(_axis_tuple(axis, a.ndim), reverse=True)
        if not dims:
            return a.clone()
        out = a
        for d in dims:  # torch.prod reduces one dim at a time
            out = torch.prod(out, dim=d, keepdim=True)
        if not keepdims:
            for d in dims:
                out = out.squeeze(d)
        return out

    @staticmethod
    def std(a, axis=None, ddof: int = 0, keepdims: py_bool = False):
        if not a.is_floating_point():
            a = a.double()
        return torch.std(a, dim=_axis_tuple(axis, a.ndim) or None,
                         correction=ddof, keepdim=keepdims)

    @staticmethod
    def var(a, axis=None, ddof: int = 0, keepdims: py_bool = False):
        if not a.is_floating_point():
            a = a.double()
        return torch.var(a, dim=_axis_tuple(axis, a.ndim) or None,
                         correction=ddof, keepdim=keepdims)

    @staticmethod
    def cumsum(a, axis=None):
        if axis is None:
            return torch.cumsum(a.reshape(-1), dim=0)
        return torch.cumsum(a, dim=axis)

    @staticmethod
    def sort(a, axis=-1):
        if axis is None:
            return torch.sort(a.reshape(-1), dim=0).values
        return torch.sort(a, dim=axis).values

    @staticmethod
    def argsort(a, axis=-1):
        if axis is None:
            return torch.argsort(a.reshape(-1), dim=0)
        return torch.argsort(a, dim=axis)

    @staticmethod
    def top_k_indices(a, k: int):
        return torch.topk(a, k, dim=-1, sorted=True).indices

    # ---- binary: Python's operators on tensors and scalars ----
    add = _binary(operator.add)
    subtract = _binary(operator.sub)
    multiply = _binary(operator.mul)
    floor_divide = _binary(operator.floordiv)
    mod = _binary(operator.mod)  # torch.remainder: numpy's sign convention
    power = _binary(operator.pow)
    equal = _binary(operator.eq)
    not_equal = _binary(operator.ne)
    greater = _binary(operator.gt)
    greater_equal = _binary(operator.ge)
    less = _binary(operator.lt)
    less_equal = _binary(operator.le)

    def true_divide(self, a, b):
        a, b = self._pair(a, b)
        if not any(isinstance(v, float) or (isinstance(v, torch.Tensor)
                                            and v.is_floating_point())
                   for v in (a, b)):
            # numpy divides integers into float64, torch into float32
            a, b = self._tensors(a, b)
            a, b = a.double(), b.double()
        return a / b

    def logical_and(self, a, b):
        return torch.logical_and(*self._tensors(a, b))

    def logical_or(self, a, b):
        return torch.logical_or(*self._tensors(a, b))

    def logical_xor(self, a, b):
        return torch.logical_xor(*self._tensors(a, b))

    def maximum(self, a, b):
        return torch.maximum(*self._tensors(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._tensors(a, b))

    @staticmethod
    def astype(a, dtype, **kwargs):
        return a.to(_dt(dtype))

    @staticmethod
    def broadcast_to(a, shape):
        return torch.broadcast_to(a, _shape(shape))

    @staticmethod
    def dot(a, b):
        if a.ndim == 0 or b.ndim == 0:
            return a * b
        if a.ndim == 1 and b.ndim == 1:
            return torch.dot(a, b)
        # numpy N-D dot: a's last axis against b's second-to-last (or only)
        return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))

    @staticmethod
    def expand_dims(a, axis):
        if isinstance(axis, int):
            axis = (axis,)
        out_ndim = a.ndim + len(axis)
        for ax in sorted(int(x) % out_ndim for x in axis):
            a = a.unsqueeze(ax)
        return a

    @staticmethod
    def getitem(a, key):
        return a[key]

    matmul = staticmethod(_mm.matmul)
    matmul_nt = staticmethod(_mm.matmul_nt)
    matmul_tn = staticmethod(_mm.matmul_tn)

    def einsum(self, spec, *ops):
        return torch.einsum(spec, *[self._t(o) for o in ops])

    @staticmethod
    def reshape(a, shape, order: str = "C"):
        shape = _shape(shape)
        if order == "F":
            # numpy's F-order reshape: read in F order, write in F order
            flat = a.permute(_f_order_perm(a.ndim)).reshape(-1)
            rev = tuple(reversed(shape))
            return flat.reshape(rev).permute(_f_order_perm(len(rev)))
        return a.reshape(shape)

    @staticmethod
    def tensordot(a, b, axes=2):
        if isinstance(axes, (list, tuple)):
            ax_a, ax_b = axes
            if isinstance(ax_a, int):
                ax_a, ax_b = [ax_a], [ax_b]
            return torch.tensordot(a, b, dims=(list(ax_a), list(ax_b)))
        return torch.tensordot(a, b, dims=int(axes))

    # per-row loss of (..., V) logits: the xent_fwd kernel or its plain version
    softmax_xent = staticmethod(_xent.loss)

    # ---- ternary ----
    @staticmethod
    def clip(a, a_min=None, a_max=None):
        return torch.clamp(a, min=a_min, max=a_max)

    @staticmethod
    def swapaxes(a, ax1, ax2):
        return torch.swapaxes(a, int(ax1), int(ax2))

    def where(self, condition, x, y):
        return torch.where(self._t(condition).bool(), self._t(x), self._t(y))

    # ---- creation (float64 by default, as numpy) ----
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)

    def ones(self, shape, dtype=None):
        return torch.ones(_shape(shape), dtype=_dt(dtype) or torch.float64,
                          device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(_shape(shape), dtype=_dt(dtype) or torch.float64,
                           device=self.device)

    @staticmethod
    def _fill_dtype(v):
        if isinstance(v, torch.Tensor):
            return v.dtype
        if isinstance(v, (py_bool, np.bool_)):
            return torch.bool
        if isinstance(v, (int, np.integer)):
            return torch.int64
        return torch.float64

    def full_like(self, a, v):
        return torch.full_like(a, v.item() if isinstance(v, torch.Tensor) else v)

    def full(self, shape, fill_value, dtype=None):
        dt = _dt(dtype) or self._fill_dtype(fill_value)
        if isinstance(fill_value, torch.Tensor):
            fill_value = fill_value.item()
        return torch.full(_shape(shape), fill_value, dtype=dt, device=self.device)

    def concatenate(self, arrays, axis=0):
        arrays = [self._t(a) for a in arrays]
        if axis is None:
            arrays, axis = [a.reshape(-1) for a in arrays], 0
        return torch.cat(arrays, dim=axis)

    def arange(self, *args):
        args = [a.item() if isinstance(a, torch.Tensor) else a for a in args]
        dt = (torch.float64 if any(isinstance(a, (float, np.floating)) for a in args)
              else torch.int64)
        return torch.arange(*args, dtype=dt, device=self.device)

    def stack(self, arrays, axis=0):
        return torch.stack([self._t(a) for a in arrays], dim=axis)

    @staticmethod
    def tile(a, reps):
        reps = reps.tolist() if isinstance(reps, torch.Tensor) else reps
        return torch.tile(a, tuple(int(r) for r in np.atleast_1d(reps)))

    def repeat(self, a, repeats, axis=None):
        if not isinstance(repeats, int):
            repeats = self._t(repeats)
        return torch.repeat_interleave(a, repeats, dim=axis)

    # ---- indexing / scatter (each returns the result) ----
    @staticmethod
    def _flat_index(a, key):
        """The flat position of every element ``a[key]`` selects: numpy's
        indexing rules (slices, ints, None, masks, repeated indices) come
        from torch's indexing of a position map."""
        return torch.arange(a.numel(), device=a.device).reshape(a.shape)[key]

    def _add_at(self, out, key, b):
        idx = self._flat_index(out, key)
        vals = torch.broadcast_to(_as_tensor(self._t(b), out).to(out.dtype),
                                  idx.shape)
        flat = out.reshape(-1)
        flat.index_add_(0, idx.reshape(-1), vals.reshape(-1))
        return flat.reshape(out.shape)

    def index_add(self, a, indices, b):
        return self._add_at(a.clone(), indices, b)

    def scatter_add(self, a, indices, b):
        return self._add_at(torch.zeros_like(a), indices, b)

    def put_along_axis(self, arr, indices, values, axis):
        arr = arr.clone()
        idx = self._t(indices).long()
        vals = torch.broadcast_to(_as_tensor(self._t(values), arr).to(arr.dtype),
                                  idx.shape)
        if axis is None:
            flat = arr.reshape(-1)
            flat.scatter_(0, idx.reshape(-1), vals.reshape(-1))
            return flat.reshape(arr.shape)
        arr.scatter_(axis, idx, vals)
        return arr

    def take_along_axis(self, a, indices, axis):
        idx = self._t(indices).long()
        if axis is None:
            return torch.take_along_dim(a.reshape(-1), idx.reshape(-1), dim=0)
        return torch.take_along_dim(a, idx, dim=axis)

    def setitem(self, a, key, value):
        a = a.clone()
        value = self._t(value)
        a[key] = value.to(a.dtype) if isinstance(value, torch.Tensor) else value
        return a

    def isin(self, e, t):
        return torch.isin(self._t(e), self._t(t))

    def unravel_index(self, indices, shape):
        return torch.stack(torch.unravel_index(self._t(indices).long(),
                                               _shape(shape)))

    @staticmethod
    def split(a, sections, axis=0):
        # numpy: int sections must divide exactly; a list gives boundaries
        if isinstance(sections, int):
            if a.shape[axis] % sections != 0:
                raise ValueError(
                    "array split does not result in an equal division")
            return list(torch.chunk(a, sections, dim=axis))
        return list(torch.tensor_split(a, [int(s) for s in sections], dim=axis))

    # ---- random: a torch.Generator on this device, float64 draws ----
    def _gen(self):
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        return self._generator

    def seed(self, value: int) -> None:
        self._gen().manual_seed(int(value))

    def rand(self, *dims: int):
        return torch.rand(dims, dtype=torch.float64, generator=self._gen(),
                          device=self.device)

    def randn(self, *dims: int):
        return torch.randn(dims, dtype=torch.float64, generator=self._gen(),
                           device=self.device)

    def randint(self, low, high=None, size=None):
        if high is None:
            low, high = 0, low
        shape = () if size is None else _shape(size)
        return torch.randint(int(low), int(high), shape, generator=self._gen(),
                             device=self.device)

    def binomial(self, n, p, size=None):
        nt, pt = (self.tensor_constructor(v).double() for v in (n, p))
        shape = (_shape(size) if size is not None
                 else torch.broadcast_shapes(nt.shape, pt.shape))
        nt, pt = (torch.broadcast_to(t, shape).contiguous() for t in (nt, pt))
        return torch.binomial(nt, pt, generator=self._gen()).long()

    def choice(self, a, size=None, replace: py_bool = True, p=None):
        pool = (torch.arange(int(a), device=self.device)
                if isinstance(a, (int, np.integer)) else self._t(a))
        count = int(np.prod(size)) if size is not None else 1
        weights = (torch.ones(pool.shape[0], dtype=torch.float64, device=self.device)
                   if p is None else self._t(p).double())
        out = pool[torch.multinomial(weights, count, replacement=replace,
                                     generator=self._gen())]
        return out[0] if size is None else out.reshape(_shape(size))

    def permutation(self, x):
        if isinstance(x, (int, np.integer)):
            return torch.randperm(int(x), generator=self._gen(), device=self.device)
        x = self._t(x)
        return x[torch.randperm(x.shape[0], generator=self._gen(), device=self.device)]

    def shuffle(self, x):
        return self.permutation(x)

    # ---- io ----
    def save(self, file, arr):
        np.save(file, self.as_numpy(arr))

    def load(self, file):
        return self.tensor_constructor(np.load(file))

    # ---- functional ----
    def vmap(self, fun: "Callable") -> "Callable":
        """A loop over the leading axis (the JAX package's torch backend's)."""
        def mapped(arr, *args, **kwargs):
            return torch.stack([fun(row, *args, **kwargs) for row in self._t(arr)])

        return mapped

    # ---- properties ----
    @staticmethod
    def tensor_shape(data):
        return tuple(data.shape)

    @staticmethod
    def tensor_size(data) -> int:
        return data.numel()

    @staticmethod
    def tensor_ndim(data) -> int:
        return data.ndim

    @staticmethod
    def tensor_dtype(data):
        return data.dtype

    @staticmethod
    def tensor_item(data):
        return data.item()

    @staticmethod
    def repr(data) -> str:
        return repr(data)

    @staticmethod
    def len(data) -> int:
        return data.shape[0]

    def array(self, data, dtype=None, copy=None):
        out = self.as_numpy(data)
        if dtype is not None and np.dtype(dtype) != out.dtype:
            if copy is False:
                raise ValueError("attempted cast, but copies are not permitted")
            return out.astype(dtype)
        return out.copy() if copy else out

    @staticmethod
    def as_numpy(a: "Any") -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        return np.asarray(a)
