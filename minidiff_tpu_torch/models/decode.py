"""KV-cached autoregressive decoding.

Port of ``minidiff_tpu/models/decode.py`` ``decode_program`` and
``generate_compiled``.  The JAX package lowers the whole loop into one
``lax.scan`` program; here ``decode_program`` builds a ``DecodeLoop``
(``models/capture.py``): one parallel prefill, eager, then one one-token
step captured as a CUDA graph and replayed once per token, over a static
cache window ``L = min(max_seq_len, ceil((total+1)/128)*128)`` exactly as
the JAX program sizes it.  On the CPU the same program runs its step
function without a graph.  Programs are cached per (model, shapes,
sampling config, device, library epoch) in an LRU of 32, as the JAX
package caches its compiled programs; the seed is a runtime input, so
varying seeds reuse one capture.

The one-token step is ``_chunk_step`` with c = 1, the same code the decode
server runs, so a request decodes through the same arithmetic alone or
batched.  (The JAX package keeps a scalar-position twin of it in
``_block_decode_step``; the masks and results are the same.)  ``kv_quant``
keeps the cache as int8 lines with per-row f32 scales, read through the
``sdpa_int8`` kernel (``decode.py:111-143, 303-327``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.capture import DecodeLoop, cached_program, weights_key
from minidiff_tpu_torch.models.layers import check_device
from minidiff_tpu_torch.models.speculative import _alloc_caches, _chunk_step, _prefill

_DECODE_BLOCK = 128

# program key -> DecodeLoop.  LRU-bounded as the JAX package's cache: each
# program pins its model, its caches and its graph's memory
_DECODE_CACHE_MAX = 32
_decode_cache: "OrderedDict" = OrderedDict()


def decode_program(model, prompt, max_new_tokens: int, greedy: bool = True,
                   temperature: float = 1.0, top_k=None, top_p=None, min_p=None,
                   kv_quant: bool = False, device="cuda"):
    """The captured ``(prompt, seed) -> (B, S0 + max_new_tokens)`` program
    behind ``generate_compiled`` for ``prompt``'s shape, cached per (model,
    batch, prompt length, new tokens, dtypes, sampling config, kv_quant) as
    the JAX package keys it, and per device, library epoch
    (``kernels._build.epoch``) and weight storage (``weights_key``)."""
    dev = check_device(model, device)
    prompt = torch.as_tensor(prompt)
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
    key = (id(model), b, s0, max_new_tokens, str(model.dtype), str(prompt.dtype),
           greedy, float(temperature), top_k,
           None if top_p is None else float(top_p),
           None if min_p is None else float(min_p), kv_quant,
           str(dev), _build.epoch(), weights_key(model))

    def build():
        caches = _alloc_caches(model, b, L, kv_quant, dev)
        rows = torch.arange(b, device=dev)

        def prefill(toks):
            return _prefill(model, toks, L, kv_quant=kv_quant, caches=caches)[1]

        def forward(tok, pos):
            return _chunk_step(model, caches, tok.reshape(b, 1), pos, L)[:, 0]

        def select(logits, seed, pos):
            noise = (None if greedy
                     else F.gumbel_noise(seed, pos, rows, logits.shape[-1]))
            return F.select_next(logits, greedy, temperature, top_k, top_p,
                                 min_p, noise)

        return DecodeLoop(b, s0, max_new_tokens, dev, prefill, forward, select)

    return cached_program(_decode_cache, key, build, _DECODE_CACHE_MAX)


def generate_compiled(model, prompt, max_new_tokens: int, greedy: bool = True,
                      temperature: float = 1.0, top_k=None, top_p=None,
                      min_p=None, seed: int = 0, device="cuda",
                      kv_quant: bool = False):
    """prompt (B, S0) int -> (B, S0 + max_new_tokens) int64 on the model's
    device, through ``decode_program``: on the card one CUDA graph replay
    per token after the first.

    Greedy mode takes the argmax.  ``greedy=False`` draws a Gumbel-max
    sample at ``temperature`` (truncated by ``top_k`` / ``top_p`` /
    ``min_p``) with noise keyed by (seed, position, row), drawn on the
    model's device (``functional.gumbel_noise``): deterministic per seed.
    ``device`` must be where the model lives; "cuda" without a GPU raises.
    ``kv_quant=True`` stores the KV cache as int8 lines with per-row f32
    scales (tokens may differ from the full-precision cache's near logit
    ties).
    """
    prompt = torch.as_tensor(prompt)
    return decode_program(model, prompt, max_new_tokens, greedy, temperature,
                          top_k, top_p, min_p, kv_quant, device)(prompt, seed)
