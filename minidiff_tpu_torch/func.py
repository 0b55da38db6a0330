"""Functional transforms driven by the tape engine.

The port of ``minidiff_tpu/func.py:51-220``: ``value_and_grad``, ``grad``,
``vjp``, ``jvp``, ``hvp`` and ``hessian``, each built on ``OpNode.backward``
(no torch autograd).  Arguments may be Tensors or pytrees (dicts, lists,
tuples) of Tensors; small helpers here stand in for ``jax.tree``.
``hessian`` takes one hvp per basis direction, the JAX package's loop off
XLA.  ``jit``, ``remat``, ``scan``, ``cond``, ``while_loop`` and ``lower``
are not ported yet; the decode programs are captured as CUDA graphs
(``models/capture.py``), and ``jit``'s capture of a tape step comes next.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

import minidiff_tpu_torch as md

if TYPE_CHECKING:
    from typing import Any, Callable, Sequence, Union


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


__all__ = ["value_and_grad", "grad", "vjp", "jvp", "hvp", "hessian"]
