"""Post-training weight-only quantization for serving.

Port of ``minidiff_tpu/models/quant.py`` for the port's modules.
``quantize_for_serving`` returns a copy of a model in which every large 2-D
Linear weight ``w`` (K, N) is replaced by the buffers ``w_q`` int8 and
``w_s`` f32 (N,) (symmetric per output column), or with ``bits=4`` by
``w_q4`` (packed int4, (K/2, N)) and ``w_s4`` f32 (K/group, N); the Linear
then multiplies through the dequant-matmul kernels (``kernels/quant.py``).
The buffers carry the JAX tree's names, so a quantized JAX tree loads into a
quantized port model with ``load_state_dict(params_from_jax(tree))``.

The selection rules are the JAX package's: a weight is quantized when it is
2-D with at least ``min_elements`` entries (the attention QKV and output
projections, the MLP and the untied head); int4 falls back to int8 for a K
that is odd or not a multiple of ``group``; LayerNorm gains and biases,
Linear biases and the embeddings stay as they are.
"""

from __future__ import annotations

import copy

import torch

from minidiff_tpu_torch.kernels import quant
from minidiff_tpu_torch.models.layers import Linear

__all__ = ["quantize_for_serving", "quantized_bytes"]


def _quantize(lin: Linear, bits: int, group: int) -> None:
    w = lin.w.detach()
    k = w.shape[0]
    if bits == 4 and k % 2 == 0 and k % group == 0:
        lin.w_q4, lin.w_s4 = quant.quantize_int4(w, group)
    else:
        lin.w_q, lin.w_s = quant.quantize_int8(w)
    del lin.w
    lin.w = None


def quantize_for_serving(model, min_elements: int = 128 * 128, bits: int = 8,
                         group: int = 128):
    """A copy of ``model`` with its large Linear weights quantized to int8
    (``bits=8``) or int4 (``bits=4``, ``group``-row scales).  The input
    model is left as it was and shares no storage with the copy."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = copy.deepcopy(model)
    with torch.no_grad():
        for mod in out.modules():
            if (isinstance(mod, Linear) and mod.w is not None
                    and mod.w.dim() == 2 and mod.w.numel() >= min_elements):
                _quantize(mod, bits, group)
    return out


def quantized_bytes(model) -> int:
    """Bytes of every parameter and buffer of a (possibly quantized) model:
    the weight stream a decode step reads."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())
