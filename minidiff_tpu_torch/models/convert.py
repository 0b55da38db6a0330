"""Carry a JAX-package checkpoint into the port.

The JAX ``TransformerLM.init()`` pytree, with its leaves as numpy arrays,
flattens with "." joins into exactly the port's ``state_dict`` names
(``blocks.0.attn.qkv.w``, ``ln_f.g``, ...).  Layouts are carried unchanged:
(in, out) weights and the head-major (h, 3, hd) fused QKV columns.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree) -> "dict[str, torch.Tensor]":
    """JAX parameter pytree (dicts, lists, numpy leaves) -> the port's state
    dict, for ``model.load_state_dict``."""
    flat: "dict[str, torch.Tensor]" = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = _to_torch(node)

    walk(tree, "")
    return flat
