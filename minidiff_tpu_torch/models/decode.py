"""KV-cached autoregressive decoding.

Port of ``minidiff_tpu/models/decode.py`` ``generate_compiled``.  The JAX
package lowers the whole loop into one ``lax.scan`` program; here it runs
eagerly, with one parallel prefill and a Python loop of one-token steps,
over a static cache window ``L = min(max_seq_len, ceil((total+1)/128)*128)``
exactly as the JAX program sizes it.  Capturing the step in a CUDA graph is
later work.

The one-token step is ``_chunk_step`` with c = 1, the same code the decode
server runs, so a request decodes through the same arithmetic alone or
batched.  (The JAX package keeps a scalar-position twin of it in
``_block_decode_step``; the masks and results are the same.)  ``kv_quant``
keeps the cache as int8 lines with per-row f32 scales, read through the
``sdpa_int8`` kernel (``decode.py:111-143, 303-327``).
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import check_device
from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill

_DECODE_BLOCK = 128


def generate_compiled(model, prompt, max_new_tokens: int, greedy: bool = True,
                      temperature: float = 1.0, top_k=None, top_p=None,
                      min_p=None, seed: int = 0, device="cuda",
                      kv_quant: bool = False):
    """prompt (B, S0) int -> (B, S0 + max_new_tokens) int64 on the model's
    device.

    Greedy mode takes the argmax.  ``greedy=False`` draws a Gumbel-max
    sample at ``temperature`` (truncated by ``top_k`` / ``top_p`` /
    ``min_p``) with noise keyed by (seed, position): deterministic per seed.
    ``device`` must be where the model lives; "cuda" without a GPU raises.
    ``kv_quant=True`` stores the KV cache as int8 lines with per-row f32
    scales (tokens may differ from the full-precision cache's near logit
    ties).
    """
    dev = check_device(model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, s0 = prompt.shape
    if s0 < 1 or max_new_tokens < 1:
        raise ValueError("generate_compiled needs a non-empty prompt and "
                         "max_new_tokens >= 1")
    total = s0 + max_new_tokens - 1
    if total > model.max_seq_len:
        raise ValueError("prompt + new tokens exceed max_seq_len")
    if kv_quant and getattr(model, "window", None) is not None:
        raise NotImplementedError(
            "kv_quant decode does not support sliding-window models "
            "(sdpa_int8_cache masks by position only)")
    L = min(model.max_seq_len,
            -(-(total + 1) // _DECODE_BLOCK) * _DECODE_BLOCK)
    seed = int(seed) & 0xFFFFFFFF

    def select(logits, i):
        noise = None if greedy else F.gumbel_noise(logits.shape, (seed, i), dev)
        return F.select_next(logits, greedy, temperature, top_k, top_p,
                             min_p, noise)

    with torch.inference_mode():
        caches, logits = _prefill(model, prompt, L, kv_quant=kv_quant)
        tok = select(logits, s0 - 1)
        out = [tok]
        pos = torch.full((b,), s0, dtype=torch.long, device=dev)
        for j in range(max_new_tokens - 1):
            logits = _chunk_step(model, caches, tok.reshape(b, 1), pos + j, L)
            tok = select(logits[:, 0], s0 + j)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
