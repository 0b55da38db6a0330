"""Functional transforms driven by the tape engine.

The port of ``minidiff_tpu/func.py:51-220``: ``value_and_grad``, ``grad``,
``vjp``, ``jvp``, ``hvp`` and ``hessian``, each built on ``OpNode.backward``
(no torch autograd).  Arguments may be Tensors or pytrees (dicts, lists,
tuples) of Tensors; small helpers here stand in for ``jax.tree``.
``hessian`` takes one hvp per basis direction, the JAX package's loop off
XLA.  ``jit`` (``minidiff_tpu/func.py:229-347``) captures a tape program
as a CUDA graph over static buffers, a ``StepProgram``
(``models/capture.py``) per key.  ``remat``, ``scan``, ``cond``,
``while_loop`` and ``lower`` are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import TYPE_CHECKING

import numpy as np
import torch

import minidiff_tpu_torch as md
import minidiff_tpu_torch.backend as backend
from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.models.capture import StepProgram, cached_program

if TYPE_CHECKING:
    from typing import Any, Callable, Optional, Sequence, Union

_JIT_CACHE_MAX = 32


def _is_tensor(x: "Any") -> bool:
    return isinstance(x, md.Tensor)


def _tree_map(fn: "Callable[[Any], Any]", tree: "Any") -> "Any":
    """``fn`` on every leaf of nested dicts, lists and tuples (a Tensor is a
    leaf; None stays None, as an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_tensor(tree):
        out = [_tree_map(fn, v) for v in tree]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def _tree_flatten(tree: "Any"):
    """(leaves, structure) of nested dicts, lists and tuples, in
    ``_tree_map``'s order: a Tensor and any other object is a leaf, None an
    empty subtree.  The structure is hashable."""
    leaves: list = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            return ("dict", tuple(t), tuple(walk(v) for v in t.values()))
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), tuple(walk(v) for v in t))
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def _tree_unflatten(structure: tuple, leaves: "Sequence[Any]") -> "Any":
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        out = [build(c) for c in s[2]]
        if s[1] is list:
            return out
        return s[1](*out) if hasattr(s[1], "_fields") else s[1](out)

    return build(structure)


def _tree_detach(tree: "Any", allow_grad: bool) -> "Any":
    return _tree_map(lambda t: t.detach(allow_grad=allow_grad) if _is_tensor(t) else t,
                    tree)


def _tree_grads(tree: "Any") -> "Any":
    return _tree_map(lambda t: t.grad if _is_tensor(t) else None, tree)


def value_and_grad(fn: "Callable[..., md.Tensor]",
                   argnums: "Union[int, Sequence[int]]" = 0, has_aux: bool = False):
    """Fresh leaves, a tape build, one backward sweep.

    ``argnums`` entries may be Tensors or pytrees of Tensors; the grads
    mirror their structure.  ``has_aux=True``: ``fn`` returns (loss, aux) and
    the wrapper returns ``((loss, aux), grads)`` with the loss's gradients.
    """
    single = isinstance(argnums, int)
    nums = (argnums,) if single else tuple(argnums)

    def wrapper(*args: "Any", **kwargs: "Any"):
        copies = list(args)
        for i in nums:
            copies[i] = _tree_detach(args[i], allow_grad=True)
        with md.enable_grad(True):
            out = fn(*copies, **kwargs)
            aux = None
            if has_aux:
                out, aux = out
            out.backward()
        grads = tuple(_tree_grads(copies[i]) for i in nums)
        value = (out, aux) if has_aux else out
        return value, (grads[0] if single else grads)

    return wrapper


def vjp(fn: "Callable[..., md.Tensor]", *primals: "Any"):
    """Returns (out, vjp_fn), vjp_fn(cotangent) -> grads of the primals.

    The tape is built once; each ``vjp_fn`` call sweeps it again
    (``cleanup_mode="keep"``) seeded with the given cotangent.  Grads mirror
    the primal pytrees, None where a leaf was unreachable from the output.
    """
    copies = tuple(_tree_detach(p, allow_grad=True) for p in primals)
    with md.enable_grad(True):
        out = fn(*copies)

    def vjp_fn(cotangent: "Any"):
        ct = cotangent if _is_tensor(cotangent) else md.Tensor(cotangent)
        ct = ct.astype(out.dtype)
        if out.op_node is not None:
            out.op_node.backward(ct, cleanup_mode="keep", reset_grads=True,
                                 root_output=out)
            grads = tuple(_tree_grads(c) for c in copies)
        else:
            # fn passed a primal leaf straight through: the cotangent flows
            # to that leaf, nothing elsewhere
            grads = tuple(_tree_map(lambda leaf: ct if leaf is out else None, c)
                          for c in copies)
        return grads[0] if len(copies) == 1 else grads

    return out.detach(), vjp_fn


def grad(fn: "Callable[..., md.Tensor]", argnums: "Union[int, Sequence[int]]" = 0,
         has_aux: bool = False):
    vag = value_and_grad(fn, argnums, has_aux=has_aux)

    def wrapper(*args: "Any", **kwargs: "Any"):
        value, grads = vag(*args, **kwargs)
        return (grads, value[1]) if has_aux else grads

    return wrapper


def jvp(fn: "Callable[[md.Tensor], md.Tensor]"):
    """Forward-mode directional derivative by double backward.

    With g(u) = Jᵀu (one backward, linear in u), a second backward of
    <g(u), v> with respect to u gives J v; evaluated at u = 0, exact for any
    f.  Returns (f(x), J v).
    """

    def wrapper(x: "md.Tensor", v: "md.Tensor"):
        x = x.detach(allow_grad=True)
        with md.enable_grad(True):
            y = fn(x)
            u = md.zeros_like(y).detach(allow_grad=True)
            s = md.sum(u * y)
            s.backward(allow_higher_order=True)
            g = x.grad  # Jᵀu, still on tape (linear in u)
            if g is None:  # output independent of x: zero tangent
                return y.detach(), md.zeros_like(y)
            t = md.sum(g * v.detach())
            t.backward()
        # u absent from the second tape (fn linear in x): J v is 0
        tangent = u.grad if u.grad is not None else md.zeros_like(y)
        return y.detach(), tangent

    return wrapper


def hessian(fn: "Callable[[md.Tensor], md.Tensor]"):
    """Full Hessian of a scalar function: one hvp per basis direction."""

    def wrapper(x: "md.Tensor"):
        n = int(x.size)
        hv = hvp(fn)
        rows = []
        for i in range(n):
            e = np.zeros(n)
            e[i] = 1.0
            rows.append(hv(x, md.Tensor(e.reshape(x.shape))))
        return md.stack(rows)

    return wrapper


def hvp(fn: "Callable[[md.Tensor], md.Tensor]"):
    """Hessian-vector product by double backward (tape re-tracing).

    The first backward runs with ``allow_higher_order=True`` so that the
    gradient itself carries a tape; d(g·v)/dx is then a second sweep.
    """

    def wrapper(x: "md.Tensor", v: "md.Tensor") -> "md.Tensor":
        x = x.detach(allow_grad=True)
        with md.enable_grad(True):
            out = fn(x)
            out.backward(allow_higher_order=True)
            g = x.grad
            if g is None:
                return md.zeros_like(x)
            # the second tape (of <g, v>) may not reach x when fn is affine,
            # and backward's reset touches only its own traversal: clear
            # x.grad or the first-order gradient would come back as the hvp
            x.grad = None
            s = md.sum(g * v.detach())
            s.backward()
        return x.grad if x.grad is not None else md.zeros_like(x)

    return wrapper


def _is_dynamic_leaf(x: "Any") -> bool:
    return isinstance(x, (md.Tensor, torch.Tensor, np.ndarray, np.generic,
                          int, float, complex))


class _Donated:
    """What a donated Tensor holds after the call: reading it raises, as
    reading a deleted JAX array does."""

    __slots__ = ()

    def _deleted(self, *args: "Any", **kwargs: "Any"):
        raise RuntimeError("md.jit: this Tensor was donated to a compiled "
                           "program and must not be read after the call")

    __getattr__ = __array__ = __len__ = __iter__ = _deleted

    def __repr__(self) -> str:
        return "<donated>"


def jit(fn: "Callable[..., Any]", in_shardings: "Any" = None,
        out_shardings: "Any" = None, donate: bool = False,
        donate_argnums: "Optional[Sequence[int]]" = None):
    """Capture a Tensor program as one CUDA graph per key.

    ``fn`` may build tapes, call ``backward()`` and update parameters out of
    place (an optimizer step), anything the eager engine supports except
    data-dependent Python control flow and host reads (``.item()``, a
    numpy array or list turned into a Tensor inside ``fn``: a capture
    refuses both, and they raise).  The leaves of args and kwargs are keyed
    as the JAX package keys them: Tensors by ``allow_grad``, shape and
    dtype; torch tensors, numpy arrays and numbers as dynamic arrays by
    shape and dtype (``fn`` receives them as tensors on the device); any
    other leaf as a static, which must be hashable; plus the active
    backend's device and the library epoch.  ``wrapper._cache`` holds one
    program per key, an LRU of 32 as the decode programs' (a program of an
    earlier library epoch is never used again and ages out); the graphs of
    one wrapper share one memory pool.

    Each program owns static buffers on the device, one per dynamic leaf.
    Every call copies the leaves in, and ``fn`` runs on Tensors rebuilt over
    those buffers, never on the caller's: the caller's Tensors are not
    changed, as the JAX package's ``pure`` leaves them.  On ``"cuda"`` the
    first call of a key runs ``fn`` eagerly (the warm-up) and returns its
    result, and the step is captured right after it; later calls replay the
    graph.  On ``"cpu"`` every call runs ``fn`` on the buffers.  Outputs
    come back as fresh detached Tensors.  A draw from the library's
    generator (``md.randn`` and the rest) inside ``fn`` draws anew at every
    call, on the CPU and on the card (the capture registers the generator
    with its graph), where the JAX package bakes it in as a trace-time
    constant.

    ``donate=True`` donates every input, ``donate_argnums`` the listed
    positional args: a donated Tensor is consumed by the call (reading it
    afterwards raises) and its storage is released to the caller's
    allocator, as JAX deletes a donated buffer.  Results are the same with
    and without donation.  ``in_shardings`` / ``out_shardings`` come with
    the parallel layers.
    """
    if in_shardings is not None or out_shardings is not None:
        raise NotImplementedError(
            "md.jit: in_shardings / out_shardings come with the parallel "
            "layers, a later slice of the port")
    cache: "OrderedDict" = OrderedDict()
    pools: dict = {}  # device -> the graphs' memory pool
    donate_set = frozenset(donate_argnums or ())

    def wrapper(*args: "Any", **kwargs: "Any"):
        leaves, structure = _tree_flatten((args, kwargs))
        gives = [donate] * len(leaves)  # whether each leaf is donated
        if donate_set and not donate:
            gives = [pos in donate_set for pos, a in enumerate(args)
                     for _ in _tree_flatten(a)[0]]
            gives += [False] * (len(leaves) - len(gives))  # kwargs: never
        meta, dynamic, donated = [], [], []
        for leaf, give in zip(leaves, gives):
            if _is_tensor(leaf):
                data = leaf._data
                meta.append(("tensor", leaf.allow_grad, tuple(data.shape), data.dtype))
                dynamic.append(data)
                if give:
                    donated.append(leaf)
            elif _is_dynamic_leaf(leaf):
                value = (leaf if isinstance(leaf, torch.Tensor)
                         else torch.as_tensor(np.asarray(leaf)))  # on the host
                meta.append(("array", None, tuple(value.shape), value.dtype))
                dynamic.append(value)
            else:
                # hashable non-array (str, dtype, shape tuple, ...) -> static
                meta.append(("static", leaf, None, None))
        device = backend.get_backend().device
        key = (structure, tuple(meta), str(device), _build.epoch())
        try:
            hash(key)
        except TypeError as e:
            raise TypeError(
                "md.jit arguments must be Tensors, arrays, numbers, or "
                f"hashable statics; got an unhashable static leaf: {e}") from None

        def build():
            if device.type == "cuda" and device not in pools:
                pools[device] = torch.cuda.graph_pool_handle()
            return _jit_program(fn, structure, meta, dynamic, device,
                                pools.get(device))

        program = cached_program(cache, key, build, _JIT_CACHE_MAX)
        program.load(**{str(i): v for i, v in enumerate(dynamic)})
        for leaf in donated:
            leaf._data = _Donated()
        out = program.replay()
        return _tree_map(lambda r: md.Tensor(r.clone()) if isinstance(r, torch.Tensor)
                         else r, out)

    wrapper._cache = cache  # exposed for tests / cache inspection
    return wrapper


def _jit_program(fn: "Callable[..., Any]", structure: tuple, meta: list,
                 dynamic: list, device: "torch.device", pool: "Any") -> StepProgram:
    """The program of one ``jit`` key: a buffer per dynamic leaf, and a step
    that runs ``fn`` on Tensors rebuilt over them and returns its outputs'
    torch tensors."""
    buffers = {str(i): torch.empty(v.shape, dtype=v.dtype, device=device)
               for i, v in enumerate(dynamic)}
    bufs = [buffers[str(i)] for i in range(len(dynamic))]

    def step():
        it = iter(bufs)
        rebuilt = []
        for kind, info, _, _ in meta:
            if kind == "tensor":
                rebuilt.append(md.Tensor(next(it), allow_grad=info))
            elif kind == "array":
                rebuilt.append(next(it))
            else:
                rebuilt.append(info)
        a, k = _tree_unflatten(structure, rebuilt)
        out = fn(*a, **k)
        return _tree_map(lambda t: t._data if _is_tensor(t) else t, out)

    return StepProgram(step, buffers, device, pool=pool, grad=True,
                       generators=backend.drawn_generators)


__all__ = ["value_and_grad", "grad", "vjp", "jvp", "hvp", "hessian", "jit"]
