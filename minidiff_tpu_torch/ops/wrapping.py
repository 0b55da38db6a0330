"""Op factory: wraps backend array functions into differentiable Tensor ops.

The port of ``minidiff_tpu/ops/wrapping.py``: an op is a callable that (1)
validates its inputs, (2) decides grad tracking from the inputs and the
ambient grad mode, (3) runs the forward on unwrapped torch tensors, and (4)
attaches an OpNode carrying per-input VJP callables.  VJPs are written in
terms of the framework's own ops, so a backward sweep under grad mode
re-tapes and higher-order differentiation works by construction.  Forwards
resolve the backend function at call time (``backend_fn('sin')``), so the
``cuda`` and ``cpu`` backends stay swappable at run time.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import minidiff_tpu_torch as md
import minidiff_tpu_torch.backend as backend
from minidiff_tpu_torch.tape import OpNode

if TYPE_CHECKING:
    from typing import Any, Callable, Optional, Sequence, Type


def backend_fn(name: str) -> "Callable[..., Any]":
    """A forward that looks up ``backend.<name>`` at call time, cached per
    backend epoch: one int compare per call instead of a module
    ``__getattr__``."""
    cached_epoch = -1
    cached_fn = None

    def forward(*args: Any, **kwargs: Any) -> Any:
        nonlocal cached_epoch, cached_fn
        if backend.epoch() != cached_epoch:
            cached_fn = getattr(backend.get_backend(), name)
            cached_epoch = backend.epoch()
        return cached_fn(*args, **kwargs)

    forward.__name__ = name
    forward.__qualname__ = f"<backend fn '{name}'>"
    return forward


def _should_allow_grad(op_inputs: "Sequence[Any]") -> bool:
    """Track gradients iff grad mode is on and any input Tensor wants them."""
    if not md.grad_allowed_():
        return False
    return any(isinstance(x, md.Tensor) and x.allow_grad for x in op_inputs)


def _validate_op_inputs(op_inputs: "Sequence[Any]", tensor_only: bool) -> None:
    seen_tensor = False
    for t in op_inputs:
        if isinstance(t, md.Tensor):
            seen_tensor = True
        elif tensor_only:
            raise ValueError(
                "every argument to this op must be a minidiff_tpu_torch Tensor")
    if not seen_tensor:
        raise ValueError(
            "at least one argument to this op must be a minidiff_tpu_torch Tensor")


def as_tensor_func(func: "Callable[..., Any]") -> "Callable[..., md.Tensor]":
    """Lift an array function to a Tensor function."""

    def wrapper(*args: Any, **kwargs: Any) -> md.Tensor:
        allow_grad = _should_allow_grad(args)
        output = func(*md.try_unwrap(args), **md.try_unwrap(kwargs))
        return md.Tensor(output, allow_grad=allow_grad)

    wrapper.__name__ = func.__name__
    wrapper.__qualname__ = getattr(func, "__qualname__", func.__name__)
    return wrapper


as_minidiff = as_tensor_func


def create_op_func(
    forward_func: "Callable[..., md.Tensor]",
    grad_funcs: "Sequence[Optional[Callable[..., md.Tensor]]]",
    kwargs_to_grads: bool = False,
    is_differentiable: bool = True,
    tensor_only: bool = False,
    op_name: "Optional[str]" = None,
) -> "Callable[..., md.Tensor]":
    """Manufacture a graph-building op.

    Non-differentiable ops keep their arity but carry all-``None`` VJP slots,
    so backprop skips them silently instead of erroring; their outputs still
    inherit allow_grad so a consumer's backward accumulates a ``.grad`` on
    them that stops there.
    """
    name = op_name if op_name is not None else forward_func.__name__
    vjps = list(grad_funcs) if is_differentiable else [None] * len(grad_funcs)

    def record_on_tape(result: md.Tensor, inputs: tuple, kwargs: dict) -> None:
        result.op_node = OpNode(
            forward_func=forward_func,
            grad_functions=vjps,
            op_inputs=inputs,
            op_kwargs=kwargs,
            op_name=name,
            kwargs_to_grads=kwargs_to_grads,
        )

    def op(*inputs: Any, **kwargs: Any) -> md.Tensor:
        _validate_op_inputs(inputs, tensor_only)
        track = _should_allow_grad(inputs)
        result = forward_func(*inputs, **kwargs)
        if result.op_node is not None:
            # forward handed back a tensor another graph already owns — take
            # a detached view so THIS op becomes its sole producer
            result = result.detach()
        result.allow_grad = track
        if track and is_differentiable and md.grad_allowed_():
            record_on_tape(result, inputs, kwargs)
        return result

    op.__name__ = name
    op.__qualname__ = f"op:{name}"
    return op


class OpClass:
    """Stateful-op protocol: a fresh forward and fresh grads per call."""

    def create_forward(self) -> "Callable[..., md.Tensor]":
        raise NotImplementedError

    def create_grads(self) -> "Sequence[Optional[Callable[..., md.Tensor]]]":
        raise NotImplementedError


class UnaryOpClass(OpClass):
    pass


class BinaryOpClass(OpClass):
    pass


class TernaryOpClass(OpClass):
    pass


def create_stateful_op_func(
    op_class: "Type[OpClass]",
    kwargs_to_grads: bool = False,
    tensor_only: bool = False,
    op_name: "Optional[str]" = None,
) -> "Callable[..., md.Tensor]":
    if op_name is None:
        op_name = op_class.__name__

    def op(*op_inputs: Any, **op_kwargs: Any) -> md.Tensor:
        _validate_op_inputs(op_inputs, tensor_only)
        allow_grad = _should_allow_grad(op_inputs)
        instance = op_class()
        forward = instance.create_forward()
        # per-call closures need a stable structural token or reuse_graph's
        # hash would never repeat (and recycled id()s could alias)
        forward._structural_id = ("stateful", op_class.__module__, op_class.__qualname__)
        output = forward(*op_inputs, **op_kwargs)
        if output.op_node is not None:
            output = output.detach()
        output.allow_grad = allow_grad

        if allow_grad and md.grad_allowed_():
            output.op_node = OpNode(
                forward_func=forward,
                grad_functions=instance.create_grads(),
                op_inputs=op_inputs,
                op_kwargs=op_kwargs,
                op_name=op_name,
                kwargs_to_grads=kwargs_to_grads,
            )
        return output

    op.__name__ = op_name
    op.__qualname__ = f"stateful_op[{op_name}]"
    return op


def create_unary_op_func(
    forward_func: "Callable[..., md.Tensor]",
    grad: "Optional[Callable[..., md.Tensor]]" = None,
    **kwargs: Any,
) -> "Callable[..., md.Tensor]":
    kwargs.setdefault("tensor_only", True)
    return create_op_func(forward_func=forward_func, grad_funcs=[grad], **kwargs)


def create_binary_op_func(
    forward_func: "Callable[..., md.Tensor]",
    grad_x: "Optional[Callable[..., md.Tensor]]" = None,
    grad_y: "Optional[Callable[..., md.Tensor]]" = None,
    **kwargs: Any,
) -> "Callable[..., md.Tensor]":
    return create_op_func(forward_func=forward_func, grad_funcs=[grad_x, grad_y], **kwargs)


def create_ternary_op_func(
    forward_func: "Callable[..., md.Tensor]",
    grad_x: "Optional[Callable[..., md.Tensor]]" = None,
    grad_y: "Optional[Callable[..., md.Tensor]]" = None,
    grad_z: "Optional[Callable[..., md.Tensor]]" = None,
    **kwargs: Any,
) -> "Callable[..., md.Tensor]":
    return create_op_func(
        forward_func=forward_func, grad_funcs=[grad_x, grad_y, grad_z], **kwargs
    )


# decorator sugar
def op_func(**kwargs: Any):
    def wrapper(func):
        return create_op_func(forward_func=func, **kwargs)

    return wrapper


def unary_op_func(**kwargs: Any):
    def wrapper(func):
        return create_unary_op_func(forward_func=func, **kwargs)

    return wrapper


def binary_op_func(**kwargs: Any):
    def wrapper(func):
        return create_binary_op_func(forward_func=func, **kwargs)

    return wrapper


def ternary_op_func(**kwargs: Any):
    def wrapper(func):
        return create_ternary_op_func(forward_func=func, **kwargs)

    return wrapper


__all__ = [
    "OpClass",
    "UnaryOpClass",
    "BinaryOpClass",
    "TernaryOpClass",
    "op_func",
    "unary_op_func",
    "binary_op_func",
    "ternary_op_func",
    "as_tensor_func",
    "as_minidiff",
    "backend_fn",
    "create_op_func",
    "create_stateful_op_func",
    "create_unary_op_func",
    "create_binary_op_func",
    "create_ternary_op_func",
]
