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
Linear biases and the embeddings stay as they are.  An MoE expert bank, a
3-D ``w1`` / ``w2`` (E, K, N) with at least ``min_elements`` entries, becomes
``w1_q`` / ``w1_s`` (and ``w2_q`` / ``w2_s``): int8 per (expert, output
column) at either ``bits``, multiplied through ``dequant_matmul_bmm``.  The
MoE router (no ``Linear``) stays full precision.
"""

from __future__ import annotations

import copy

import torch

from minidiff_tpu_torch.kernels import quant
from minidiff_tpu_torch.models.layers import Linear
from minidiff_tpu_torch.models.moe import Experts

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
            elif isinstance(mod, Experts):
                _quantize_banks(mod, min_elements)
    return out


def _quantize_banks(ex: Experts, min_elements: int) -> None:
    for name in ("w1", "w2"):
        w = getattr(ex, name)
        if w is not None and w.dim() == 3 and w.numel() >= min_elements:
            q, s = quant.quantize_int8_stacked(w.detach())
            setattr(ex, name + "_q", q)
            setattr(ex, name + "_s", s)
            delattr(ex, name)
            setattr(ex, name, None)


def quantized_bytes(model) -> int:
    """Bytes of every parameter and buffer of a (possibly quantized) model:
    the weight stream a decode step reads."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())
