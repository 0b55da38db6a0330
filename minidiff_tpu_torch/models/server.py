"""Continuous batching: a slot-based decode server.

Port of ``DecodeServer`` from ``minidiff_tpu/models/server.py``.  A fixed
pool of ``max_batch`` slots shares one batched KV cache of ``window``
positions; every live request advances together in one batched step per
token, and a finished slot is released (on ``collect``) and refilled by a new
request without touching the others.  Prompts pad to multiples of 128 for
their one-row prefill, whose cache row then replaces the slot's row
entirely.  Pad rows land at positions >= the request's length, which the
read mask ``l <= pos`` hides until decode overwrites them; inactive slots
keep decoding garbage into their own rows, which is ignored.

Greedy outputs are token-for-token identical to decoding each request alone
through ``generate_compiled``.  Prefix caching, chunked prefill and the
speculative server come with a later slice.  ``PagedDecodeServer``
(``models/paged.py``) and ``SSMDecodeServer`` (below) keep the host API and
replace the cache through the ``_resolve_window`` / ``_alloc_caches`` /
``_prefill_slot`` / ``_step_logits`` hooks.
"""

from __future__ import annotations

import numpy as np
import torch

from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import check_device
from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill

__all__ = ["DecodeServer", "SSMDecodeServer"]

_BUCKET = 128


class DecodeServer:
    """Fixed-slot continuous-batching decode server.

    >>> srv = DecodeServer(model, max_batch=4, window=512)
    >>> slot = srv.submit([1, 2, 3], max_new_tokens=64)
    >>> while srv.active():
    ...     for s, tok in srv.step().items():  # one batched step, all slots
    ...         ...
    >>> tokens = srv.collect(slot)             # releases the finished slot

    ``greedy=False`` draws Gumbel-max samples at ``temperature`` (truncated
    by ``top_k`` / ``top_p`` / ``min_p``) with noise keyed by (request seed,
    request-local step): each request's stream is deterministic in its seed.
    """

    def __init__(self, model, max_batch: int = 8, window=None,
                 greedy: bool = True, temperature: float = 1.0, top_k=None,
                 top_p=None, min_p=None, device="cuda"):
        self.device = check_device(model, device)
        self.model = model
        self.max_batch = max_batch
        self.greedy = greedy
        self.temperature = float(temperature)
        self.top_k, self.top_p, self.min_p = top_k, top_p, min_p
        self.window = self._resolve_window(window)
        self._caches = self._alloc_caches()
        # host-side slot state
        self._pos = np.zeros(max_batch, np.int64)      # position of last token
        self._tok = np.zeros(max_batch, np.int64)      # last emitted token
        self._free = list(range(max_batch))
        self._budget = np.zeros(max_batch, np.int64)   # tokens still to emit
        self._out: "dict[int, list]" = {}
        self._seed = [0] * max_batch
        self._steps = np.zeros(max_batch, np.int64)    # slot-local step count

    def _resolve_window(self, window):
        """The KV window: ``window`` (``max_seq_len`` by default), a multiple
        of 128 within ``max_seq_len``."""
        model = self.model
        w = int(window or model.max_seq_len)
        if w % _BUCKET:
            raise ValueError(f"window {w} must be a multiple of {_BUCKET}")
        # the JAX server's rule for every model; without RoPE, positions
        # beyond max_seq_len would also index past pos_emb
        if w > model.max_seq_len:
            why = "" if model.rope else " (positions past pos_emb)"
            raise ValueError(f"window {w} exceeds model.max_seq_len "
                             f"{model.max_seq_len}{why}")
        return w

    def _alloc_caches(self):
        """One dense (max_batch, kv, window, hd) K and V cache per layer."""
        blk = self.model.blocks[0].attn
        shape = (self.max_batch, blk.num_kv_heads, self.window, blk.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.model.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.model.dtype, device=self.device)}
                for _ in self.model.blocks]

    def _select(self, logits, slots):
        """Next tokens from (n, V) logits, one row per slot in ``slots``."""
        noise = None
        if not self.greedy:
            v = logits.shape[-1]
            noise = torch.stack([
                F.gumbel_noise((v,), (self._seed[s], self._steps[s]), self.device)
                for s in slots])
        return F.select_next(logits, self.greedy, self.temperature, self.top_k,
                             self.top_p, self.min_p, noise).tolist()

    def active(self) -> bool:
        """True while any slot is still decoding (finished but uncollected
        slots do not count)."""
        return any(s not in self._free and self._budget[s] > 0
                   for s in range(self.max_batch))

    def submit(self, prompt, max_new_tokens: int, seed: int = 0) -> int:
        """Admit a request into a free slot (raises when the pool is full);
        runs its bucketed prefill and emits the first token."""
        prompt = self._check_request(prompt, max_new_tokens)
        s0 = len(prompt)
        slot = self._free.pop(0)
        sb = -(-s0 // _BUCKET) * _BUCKET
        padded = torch.zeros((1, sb), dtype=torch.long)
        padded[0, :s0] = torch.tensor(prompt)
        self._seed[slot] = int(seed) & 0xFFFFFFFF
        self._steps[slot] = 0
        with torch.inference_mode():
            logits = self._prefill_slot(slot, padded.to(self.device), s0)
            tok = self._select(logits, [slot])[0]
        self._pos[slot] = s0          # position the new token will occupy
        self._tok[slot] = tok
        self._budget[slot] = max_new_tokens - 1
        self._out[slot] = [tok]
        self._steps[slot] = 1
        return slot

    def _check_request(self, prompt, max_new_tokens: int) -> "list[int]":
        """The prompt as ints; raises when no slot is free or the request
        does not fit the window."""
        if not self._free:
            raise RuntimeError(
                "no free slots — step() until a request finishes and "
                "collect() it (collect releases the slot)")
        prompt = [int(t) for t in prompt]
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        if self.window is not None and len(prompt) + max_new_tokens > self.window:
            raise ValueError(f"prompt + new tokens exceed the window {self.window}")
        return prompt

    def _prefill_slot(self, slot: int, padded, s0: int):
        """One-row prefill of the bucketed prompt into ``slot``'s cache rows;
        returns the logits (1, V) at position s0 - 1."""
        rows, logits = _prefill(self.model, padded, self.window, last=s0 - 1)
        for cache, row in zip(self._caches, rows):
            cache["k"][slot] = row["k"][0]
            cache["v"][slot] = row["v"][0]
        return logits

    def _step_logits(self, toks, pos):
        """Logits (B, 1, V) of one batched step of every slot."""
        return _chunk_step(self.model, self._caches, toks, pos, self.window)

    def step(self) -> "dict[int, int]":
        """One batched decode step for every live slot; returns {slot:
        emitted token}.  Slots whose budget hits zero finish."""
        live = [s for s in range(self.max_batch)
                if s not in self._free and self._budget[s] > 0]
        if not live:
            return {}
        with torch.inference_mode():
            toks = torch.as_tensor(self._tok, device=self.device)
            pos = torch.as_tensor(self._pos, device=self.device)
            logits = self._step_logits(toks.reshape(-1, 1), pos)
            nxt = self._select(logits[:, 0], range(self.max_batch))
        emitted: "dict[int, int]" = {}
        for s in live:
            tok = nxt[s]
            emitted[s] = tok
            self._out[s].append(tok)
            self._pos[s] += 1
            self._tok[s] = tok
            self._steps[s] += 1
            self._budget[s] -= 1
        return emitted

    def done(self, slot: int) -> bool:
        return self._budget[slot] == 0 and slot in self._out

    def collect(self, slot: int) -> "list[int]":
        """Generated tokens for ``slot`` (first token included).  Collecting
        a finished request releases its slot for reuse."""
        out = list(self._out[slot])
        if self._budget[slot] == 0 and slot not in self._free:
            self._free.append(slot)
        return out


class SSMDecodeServer(DecodeServer):
    """Continuous batching for the Mamba family (``models/ssm.py``).

    The slot state is the O(1) recurrent state of each block, the hidden
    ``h`` (max_batch, d_inner, n) and the conv window (max_batch, K-1,
    d_inner): no KV window and no per-request length limit.  A slot's
    prefill runs its bucketed prompt as one ragged ``MambaLM.prefill``
    (``lengths``, one scan per block) and swaps its row in; the shared step
    is the batched ``MambaLM.step``.  Greedy outputs are token-for-token
    those of ``generate_compiled_ssm`` on each request alone.
    """

    def _resolve_window(self, window):
        return None  # no KV window: context length is unbounded

    def _alloc_caches(self):
        return self.model.init_state(self.max_batch)

    def _prefill_slot(self, slot: int, padded, s0: int):
        lengths = torch.tensor([s0], device=self.device)
        logits, rows = self.model.prefill(padded, lengths=lengths)
        for state, row in zip(self._caches, rows):
            state["h"][slot] = row["h"][0]
            state["conv"][slot] = row["conv"][0]
        return logits

    def _step_logits(self, toks, pos):
        logits, self._caches = self.model.step(self._caches, toks[:, 0])
        return logits[:, None]
