"""Finite-difference oracle: the numerical contract for every op's VJP.

The port of ``minidiff_tpu/utils/gradcheck.py``, with its contract and step
sizes: central differences (f(x+h) - f(x-h)) / 2h per element of each
differentiable input, evaluated through ``md.vmap`` over one batch of
perturbed copies (``flat ± h·I``, the identity from an ``arange``
equality), and ``compute_grads`` returning them beside the tape's
gradients; ``exclude`` skips inputs.
"""

from __future__ import annotations

from copy import deepcopy
from typing import TYPE_CHECKING

import minidiff_tpu_torch as md

if TYPE_CHECKING:
    from typing import List, Optional, Sequence, Tuple

    from typing import Callable


def _default_h(tensor: "md.Tensor") -> float:
    """Step size matched to the input's precision: 1e-7 is BELOW the f32 ulp
    near |x| ~ 2 (x + h rounds back to x -> FD grad silently 0), so f32
    inputs get 1e-3 and only f64 keeps the tight step."""
    name = str(tensor.dtype)
    return 1e-7 if "64" in name else 1e-3


def calculate_finite_differences(
    *input_tensors: "md.Tensor",
    func: "Callable[..., md.Tensor]",
    h: "Optional[float]" = None,
    exclude: "Optional[Sequence[md.Tensor]]" = None,
) -> "List[Optional[md.Tensor]]":
    manual_gradients: list = []
    excluded_ids = {id(x) for x in (exclude or [])}

    with md.no_grad():
        for i, input_tensor in enumerate(input_tensors):
            if (
                not isinstance(input_tensor, md.Tensor)
                or not input_tensor.allow_grad
                or id(input_tensor) in excluded_ids
            ):
                manual_gradients.append(None)
                continue

            n = input_tensor.size
            step_h = h if h is not None else _default_h(input_tensor)

            def f(perturbed, i=i):
                return func(*input_tensors[:i], perturbed,
                            *input_tensors[i + 1:])

            # Perturbation batch in one broadcast: row j of ``flat + h·I``
            # is the input with ONLY element j shifted by +h (and -h below).
            base = input_tensor.detach().copy()
            flat = base.reshape((1, n))
            lane = md.arange(n)
            bump = (lane.reshape((n, 1)) == lane.reshape((1, n))).astype(
                base.dtype) * step_h
            batch_shape = (n,) + tuple(input_tensor.shape)
            f_plus = md.vmap(f)((flat + bump).reshape(batch_shape))
            f_minus = md.vmap(f)((flat - bump).reshape(batch_shape))

            grads = ((f_plus - f_minus) / (2 * step_h)).reshape(
                input_tensor.shape)
            manual_gradients.append(grads)

    return manual_gradients


def compute_grads(
    *input_tensors: "md.Tensor",
    func: "Callable[..., md.Tensor]",
    h: "Optional[float]" = None,
    exclude: "Optional[Sequence[md.Tensor]]" = None,
) -> "Tuple[List[Optional[md.Tensor]], List[Optional[md.Tensor]]]":
    """Return (finite-difference grads, tape grads) for each input of func."""
    excluded_ids = {id(x) for x in (exclude or [])}
    copied_inputs: list = []
    copied_exclude: list = []

    for t in input_tensors:
        copied = (
            t.copy().detach(allow_grad=True) if isinstance(t, md.Tensor) else deepcopy(t)
        )
        copied_inputs.append(copied)
        if id(t) in excluded_ids:
            copied_exclude.append(copied)

    computed = func(*copied_inputs)
    computed.backward(retain_grads=True)

    automatic_gradients = [
        t.grad if isinstance(t, md.Tensor) else None for t in copied_inputs
    ]
    manual_gradients = calculate_finite_differences(
        *copied_inputs, func=func, h=h, exclude=copied_exclude
    )
    return manual_gradients, automatic_gradients
