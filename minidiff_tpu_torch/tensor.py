"""Tensor: a torch tensor of the active backend plus the tape's state.

The port of ``minidiff_tpu/tensor.py``: ``._data`` holds a torch tensor that
never requires grad (the tape differentiates), beside ``grad``,
``op_node``, ``consumer_refs`` and ``allow_grad``; the operator surface, the
mutation guard, the grad-mode contexts and the factory functions are the JAX
package's.  In-place operators rebind ``._data`` to a fresh tensor, as the
JAX package does for its immutable arrays.  A Tensor takes a numpy array (or
a list, a scalar or a torch tensor); numpy reads it back through
``__array__``.
"""

from __future__ import annotations

from builtins import bool as py_bool
from contextvars import ContextVar
from typing import TYPE_CHECKING

import torch

import minidiff_tpu_torch as md
import minidiff_tpu_torch.backend as backend

if TYPE_CHECKING:
    from typing import Any, List, Literal, Optional, Sequence, Tuple, Union

    from numpy import ndarray

    from minidiff_tpu_torch.tape import OpNode


_allow_grad = ContextVar("allow_grad", default=True)
_allow_new_grads = ContextVar("allow_new_grads", default=True)


def set_allow_grad(allow: py_bool) -> None:
    _allow_grad.set(allow)


def grad_allowed_() -> py_bool:
    return _allow_grad.get()


def set_allow_new_grads(allow: py_bool) -> None:
    _allow_new_grads.set(allow)


def new_grads_allowed_() -> py_bool:
    return _allow_new_grads.get()


class no_grad:
    """Build no graph inside the context."""

    def __enter__(self):
        self._prev = _allow_grad.get()
        set_allow_grad(False)

    def __exit__(self, exc_type, exc, tb):
        set_allow_grad(self._prev)


class enable_grad:
    """Set grad mode to an explicit boolean inside the context."""

    def __init__(self, enable: py_bool = True):
        self.enable = enable

    def __enter__(self):
        self._prev = _allow_grad.get()
        set_allow_grad(self.enable)

    def __exit__(self, exc_type, exc, tb):
        set_allow_grad(self._prev)


class disable_new_grads:
    """Disable both grad mode and new-grad creation inside the context."""

    def __enter__(self):
        self._prev_grad = _allow_grad.get()
        self._prev_new = _allow_new_grads.get()
        set_allow_grad(False)
        set_allow_new_grads(False)

    def __exit__(self, exc_type, exc, tb):
        set_allow_grad(self._prev_grad)
        set_allow_new_grads(self._prev_new)


def try_unwrap(t: Any) -> Any:
    """Strip Tensors to their torch tensors, through tuples, lists and dicts."""
    if isinstance(t, Tensor):
        return t._data
    if isinstance(t, tuple):
        return tuple(try_unwrap(x) for x in t)
    if isinstance(t, list):
        return [try_unwrap(x) for x in t]
    if isinstance(t, dict):
        return {k: try_unwrap(v) for k, v in t.items()}
    return t


class Tensor:
    __array_priority__ = 100  # numpy defers binary ops to us
    __slots__ = ("_data", "_allow_grad", "consumer_refs", "grad", "op_node",
                 "__weakref__")

    def __init__(self, data: Any, allow_grad: py_bool = False,
                 dtype: Optional[Any] = None):
        data = try_unwrap(data)
        if data is None:
            data = []
        if not isinstance(data, torch.Tensor):
            data = backend.tensor_constructor(data)
        if dtype is not None:
            data = backend.astype(data, dtype)
        self._data = data
        self._allow_grad = allow_grad
        self.consumer_refs = 0
        self.grad: Optional[Tensor] = None
        self.op_node: Optional[OpNode] = None

    # -------- graph state --------
    @property
    def graphed(self) -> py_bool:
        """True when part of a tracked graph."""
        return self.consumer_refs > 0 or self.op_node is not None

    @property
    def is_leaf(self) -> py_bool:
        return self.op_node is None

    @property
    def allow_grad(self) -> py_bool:
        return self._allow_grad

    @allow_grad.setter
    def allow_grad(self, allow_grad: py_bool) -> None:
        # the chain rule would stop silently at an intermediate: fail fast
        if not allow_grad and not self.is_leaf:
            raise ValueError(
                "cannot disable gradient tracking on an intermediate tensor: "
                "the chain rule would silently stop at this node during "
                "backprop (detach() it instead)")
        if self._allow_grad == allow_grad:
            return
        self.grad = None
        self._allow_grad = allow_grad

    # -------- array properties --------
    @property
    def T(self) -> Tensor:
        return md.transpose(self)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    def as_numpy(self) -> "ndarray":
        return backend.as_numpy(self._data)

    # -------- autodiff --------
    def backward(
        self,
        retain_grads: py_bool = False,
        cleanup_mode: Literal["keep", "prune", "destroy"] = "prune",
        allow_higher_order: py_bool = False,
        reset_grads: py_bool = True,
    ) -> None:
        """Reverse-mode sweep from this tensor, seeded with ones.

        A silent no-op on leaves and on tensors that track no gradient."""
        if not self._allow_grad or self.is_leaf:
            return
        self.grad = md.ones_like(self, allow_grad=allow_higher_order)
        self.op_node.backward(
            self.grad,
            retain_grads=retain_grads,
            cleanup_mode=cleanup_mode,
            allow_higher_order=allow_higher_order,
            reset_grads=reset_grads,
            root_output=self,
        )

    def wipe(self) -> None:
        """Cut this tensor from the subgraph that produced it."""
        self.op_node = None

    def detach(self, allow_grad: py_bool = False) -> Tensor:
        return Tensor(self._data, allow_grad=allow_grad)

    # -------- method sugar --------
    def ravel(self, order: str = "C") -> Tensor:
        return md.ravel(self, order=order)

    def flatten(self, order: str = "C") -> Tensor:
        return md.flatten(self, order=order)

    def astype(self, dtype: Any) -> Tensor:
        return md.astype(self, dtype)

    def transpose(self, axes: Optional[Union[int, Sequence[int]]] = None) -> Tensor:
        return md.transpose(self, axes=axes)

    def item(self) -> Any:
        if self.size != 1:
            raise ValueError(
                f"item() needs a single-element tensor, got shape {self.shape}")
        return self._data.item()

    def sum(self, axis=None, dtype: Optional[Any] = None, out: Optional[Any] = None,
            keepdims: py_bool = False) -> Tensor:
        # dtype/out exist so that numpy's np.sum(tensor) dispatches here
        if out is not None:
            raise ValueError("out= is not supported")
        result = md.sum(self, axis=axis, keepdims=keepdims)
        return result if dtype is None else result.astype(dtype)

    def mean(self, axis=None, keepdims: py_bool = False) -> Tensor:
        return md.mean(self, axis=axis, keepdims=keepdims)

    def copy(self) -> Tensor:
        return md.copy(self)

    def clip(self, a_min: Any = None, a_max: Any = None) -> Tensor:
        return md.clip(self, a_min, a_max)

    def reshape(self, shape: Union[int, Sequence[int]], **kwargs: Any) -> Tensor:
        return md.reshape(self, shape, **kwargs)

    def dot(self, other: Any) -> Tensor:
        return md.dot(self, other)

    def matmul(self, other: Any) -> Tensor:
        return md.matmul(self, other)

    def add(self, other: Any) -> Tensor:
        return md.add(self, other)

    def multiply(self, other: Any) -> Tensor:
        return md.multiply(self, other)

    # -------- mutation guard --------
    def _graph_tracking(self) -> py_bool:
        return self._allow_grad and grad_allowed_() and self.graphed

    def _validate_mutation(self) -> None:
        if self._graph_tracking():
            raise ValueError(
                "refusing to mutate a tensor the tape still references; "
                "in-place updates would corrupt the recorded graph")

    def _inplace(self, fn, other: Any) -> Tensor:
        self._validate_mutation()
        self._data = fn(self._data, try_unwrap(other))
        return self

    # -------- operators --------
    def __mod__(self, other: Any) -> Tensor:
        return md.mod(self, other)

    def __rmod__(self, other: Any) -> Tensor:
        return md.mod(other, self)

    def __imod__(self, other: Any) -> Tensor:
        return self._inplace(backend.mod, other)

    def __matmul__(self, other: Any) -> Tensor:
        return md.matmul(self, other)

    def __rmatmul__(self, other: Any) -> Tensor:
        return md.matmul(other, self)

    def __imatmul__(self, other: Any) -> Tensor:
        return self._inplace(backend.matmul, Tensor(other))

    def __add__(self, other: Any) -> Tensor:
        return md.add(self, other)

    def __radd__(self, other: Any) -> Tensor:
        return md.add(other, self)

    def __iadd__(self, other: Any) -> Tensor:
        return self._inplace(backend.add, other)

    def __sub__(self, other: Any) -> Tensor:
        return md.subtract(self, other)

    def __rsub__(self, other: Any) -> Tensor:
        return md.subtract(other, self)

    def __isub__(self, other: Any) -> Tensor:
        return self._inplace(backend.subtract, other)

    def __mul__(self, other: Any) -> Tensor:
        return md.multiply(self, other)

    def __rmul__(self, other: Any) -> Tensor:
        return md.multiply(other, self)

    def __imul__(self, other: Any) -> Tensor:
        return self._inplace(backend.multiply, other)

    def __truediv__(self, other: Any) -> Tensor:
        return md.true_divide(self, other)

    def __rtruediv__(self, other: Any) -> Tensor:
        return md.true_divide(other, self)

    def __itruediv__(self, other: Any) -> Tensor:
        return self._inplace(backend.true_divide, other)

    def __floordiv__(self, other: Any) -> Tensor:
        return md.floor_divide(self, other)

    def __rfloordiv__(self, other: Any) -> Tensor:
        return md.floor_divide(other, self)

    def __ifloordiv__(self, other: Any) -> Tensor:
        return self._inplace(backend.floor_divide, other)

    def __pow__(self, other: Any) -> Tensor:
        return md.power(self, other)

    def __rpow__(self, other: Any) -> Tensor:
        return md.power(other, self)

    def __ipow__(self, other: Any) -> Tensor:
        return self._inplace(backend.power, other)

    def __neg__(self) -> Tensor:
        return -1 * self

    def __pos__(self) -> Tensor:
        return self

    def __abs__(self) -> Tensor:
        return md.absolute(self)

    def __repr__(self) -> str:
        return repr(self._data)

    def __len__(self) -> int:
        return self._data.shape[0]

    def __getitem__(self, key: Any) -> Tensor:
        return md.getitem(self, key)

    def __setitem__(self, key: Any, val: Any) -> None:
        self._validate_mutation()
        self._data = backend.setitem(self._data, try_unwrap(key), try_unwrap(val))

    def __gt__(self, value: Any) -> Tensor:
        return md.greater(self, value)

    def __ge__(self, value: Any) -> Tensor:
        return md.greater_equal(self, value)

    def __lt__(self, value: Any) -> Tensor:
        return md.less(self, value)

    def __le__(self, value: Any) -> Tensor:
        return md.less_equal(self, value)

    def __eq__(self, value: Any) -> Tensor:  # type: ignore[override]
        return md.equal(self, value)

    def __ne__(self, value: Any) -> Tensor:  # type: ignore[override]
        return md.not_equal(self, value)

    # __eq__ returns a Tensor; the engine keys every structure on id()
    __hash__ = object.__hash__

    def __and__(self, value: Any) -> Tensor:
        return md.logical_and(self, value)

    def __or__(self, value: Any) -> Tensor:
        return md.logical_or(self, value)

    def __xor__(self, value: Any) -> Tensor:
        return md.logical_xor(self, value)

    def __invert__(self) -> Tensor:
        return md.invert(self)

    def __bool__(self) -> py_bool:
        return py_bool(self._data)

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d tensor")
        return (self[i] for i in range(len(self)))

    # -------- numpy protocol --------
    def __array__(self, dtype: Optional[Any] = None,
                  copy: Optional[py_bool] = None) -> "ndarray":
        return backend.array(self._data, dtype=dtype, copy=copy)


# ---------------------------------------------------------------------------
# factory functions: graph-free constructors on the active backend
# ---------------------------------------------------------------------------

def ones_like(a: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.ones_like(try_unwrap(a)), allow_grad=allow_grad)


def ones(shape: Union[int, Sequence[int]], allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.ones(shape), allow_grad=allow_grad)


def zeros_like(a: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.zeros_like(try_unwrap(a)), allow_grad=allow_grad)


def zeros(shape: Union[int, Sequence[int]], allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.zeros(shape), allow_grad=allow_grad)


def full_like(a: Any, x: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.full_like(try_unwrap(a), try_unwrap(x)),
                  allow_grad=allow_grad)


def full(shape: Union[int, Sequence[int]], fill_value: Any = 0,
         allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.full(shape, try_unwrap(fill_value)),
                  allow_grad=allow_grad)


def concatenate(arrays: Sequence[Any], axis: Optional[int] = 0,
                allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.concatenate(try_unwrap(list(arrays)), axis=axis),
                  allow_grad=allow_grad)


def index_add(a: Tensor, indices: Any, b: Any = None) -> None:
    """Scatter-add ``b`` into ``a`` at ``indices`` (repeats accumulate)."""
    a._validate_mutation()
    a._data = backend.index_add(a._data, try_unwrap(indices), try_unwrap(b))


def isin(element: Any, test_elements: Any) -> Any:
    return backend.isin(try_unwrap(element), try_unwrap(test_elements))


def unravel_index(indices: Any, shape: Sequence[int],
                  allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.unravel_index(try_unwrap(indices), shape),
                  allow_grad=allow_grad)


def vmap(fun: Any) -> Any:
    """Map a Tensor function over the leading axis (a loop, stacked)."""

    def backend_func(arr, *args, **kwargs):
        args = [Tensor(x) for x in args]
        kwargs = {k: Tensor(v) for k, v in kwargs.items()}
        return fun(Tensor(arr), *args, **kwargs)._data

    vmapped = backend.vmap(backend_func)

    def wrapper(*args, **kwargs) -> Tensor:
        return Tensor(vmapped(*try_unwrap(args), **try_unwrap(kwargs)))

    return wrapper


def take_along_axis(arr: Tensor, indices: Tensor, axis: Optional[int] = None,
                    allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.take_along_axis(try_unwrap(arr), try_unwrap(indices),
                                          axis=axis), allow_grad=allow_grad)


def put_along_axis(arr: Tensor, indices: Tensor, values: Any,
                   axis: Optional[int]) -> None:
    arr._validate_mutation()
    arr._data = backend.put_along_axis(arr._data, try_unwrap(indices),
                                       try_unwrap(values), axis)


def repeat(a: Any, repeats: Union[int, Sequence[int]], allow_grad: py_bool = False,
           axis: Optional[int] = None) -> Tensor:
    return Tensor(backend.repeat(try_unwrap(a), repeats, axis=axis),
                  allow_grad=allow_grad)


def tile(A: Any, reps: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.tile(try_unwrap(A), try_unwrap(reps)),
                  allow_grad=allow_grad)


def arange(*args: Union[int, float], allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.arange(*try_unwrap(args)), allow_grad=allow_grad)


def stack(arrays: Sequence[Tensor], axis: Optional[int] = 0,
          allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.stack(try_unwrap(list(arrays)), axis=axis),
                  allow_grad=allow_grad)


def save(file: Any, arr: Any) -> None:
    backend.save(file, try_unwrap(arr))


def load(file: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.load(file), allow_grad=allow_grad)


def choice(a: Any, size: Any = None, replace: py_bool = True, p: Any = None) -> Tensor:
    return Tensor(backend.choice(try_unwrap(a), size=size, replace=replace,
                                 p=try_unwrap(p)))


def rand(*dims: int, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.rand(*dims), allow_grad=allow_grad)


def randint(low: Any, high: Any = None, size: Any = None,
            allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.randint(try_unwrap(low), high=try_unwrap(high), size=size),
                  allow_grad=allow_grad)


def randn(*dims: int, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.randn(*dims), allow_grad=allow_grad)


def binomial(n: Any, p: Any, size: Any = None, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.binomial(try_unwrap(n), try_unwrap(p), size=size),
                  allow_grad=allow_grad)


def permutation(x: Any, allow_grad: py_bool = False) -> Tensor:
    return Tensor(backend.permutation(try_unwrap(x)), allow_grad=allow_grad)


def shuffle(x: Tensor) -> None:
    x._validate_mutation()
    x._data = backend.shuffle(x._data)


def seed(value: int) -> None:
    """Seed the active backend's torch.Generator."""
    backend.seed(value)


def split(ary: Tensor, indices_or_sections: Union[int, Sequence[int]], axis: int = 0,
          allow_grad: py_bool = False) -> List[Tensor]:
    sections = backend.split(try_unwrap(ary), try_unwrap(indices_or_sections),
                             axis=axis)
    return [Tensor(s, allow_grad=allow_grad) for s in sections]


newaxis = None

# dtype symbols: torch's, on every backend
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
dtype = torch.dtype
nan = float("nan")
dtypes = [float64, float32, float16, bfloat16, uint64, uint32, uint16, uint8,
          int64, int32, int16, int8, bool]

__all__ = [
    "Tensor", "no_grad", "enable_grad", "disable_new_grads", "set_allow_grad",
    "grad_allowed_", "set_allow_new_grads", "new_grads_allowed_", "try_unwrap",
    "ones_like", "ones", "zeros_like", "zeros", "full_like", "full",
    "concatenate", "index_add", "isin", "unravel_index", "vmap",
    "take_along_axis", "put_along_axis", "repeat", "tile", "arange", "stack",
    "save", "load", "choice", "rand", "randint", "randn", "binomial",
    "permutation", "shuffle", "seed", "split", "newaxis",
    "float64", "float32", "float16", "bfloat16", "uint64", "uint32", "uint16",
    "uint8", "int64", "int32", "int16", "int8", "bool", "dtype", "nan", "dtypes",
]
