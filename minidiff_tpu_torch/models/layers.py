"""Linear layer and device resolution.

Port of ``minidiff_tpu/models/layers.py``.  Weights keep the JAX package's
(in, out) layout, so ``y = x @ w + b`` and a JAX checkpoint loads unchanged
(``models/convert.py``).  A Linear quantized for serving
(``models/quant.py``) holds the buffers ``w_q`` (int8) and ``w_s`` (f32),
or ``w_q4`` (packed int4) and ``w_s4`` (group scales), in place of ``w``,
under the JAX tree's names, and multiplies through the dequant-matmul
kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from minidiff_tpu_torch.kernels import quant


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def check_device(model: nn.Module, device) -> torch.device:
    """Resolve ``device`` and require that ``model`` lives there."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"model lives on {have}, not on the requested {dev}")
    return have


def uniform(shape, bound: float, gen: torch.Generator, dtype, device):
    """U(-bound, bound) drawn on the CPU from ``gen`` (the same numbers on
    every device), then placed."""
    w = torch.rand(shape, generator=gen, dtype=torch.float64)
    return w.mul_(2 * bound).sub_(bound).to(device=device, dtype=dtype)


class Linear(nn.Module):
    """y = x @ w + b, weight (in, out), Kaiming-uniform init."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, dtype, device, generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)
        self.w = nn.Parameter(uniform((in_features, out_features), bound,
                                      generator, dtype, device))
        self.b = (nn.Parameter(uniform((out_features,), bound, generator,
                                       dtype, device)) if bias else None)
        # the quantized forms (models/quant.py), empty until quantized
        for name in ("w_q", "w_s", "w_q4", "w_s4"):
            self.register_buffer(name, None)

    def forward(self, x):
        if self.w_q is not None:
            out = quant.dequant_matmul(x, self.w_q, self.w_s)
        elif self.w_q4 is not None:
            out = quant.dequant_matmul4(x, self.w_q4, self.w_s4)
        else:
            out = x @ self.w
        if self.b is not None:
            out = out + self.b
        return out
