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

The batched step (``_step_logits`` plus the next-token choice over all
``max_batch`` slots, one fixed shape) is a ``StepProgram``
(``models/capture.py``): captured as a CUDA graph at the first step and
replayed at every step after, its tokens, positions, seeds and steps copied
into static buffers first, and the tokens read back with one ``.tolist()``
after the replay, as the JAX server's jitted step returns them.  On the CPU
the same program runs the step without a graph.  A prefill stays eager and
writes its slot's rows into the cache in place, so the graph's caches are
the server's own tensors and are never re-allocated.

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

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.capture import StepProgram
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
    request-local step), drawn on the device: each request's stream is
    deterministic in its seed.  The model must stay where it was when the
    server was built: the captured steps read its weights there.
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
        self._seed = np.zeros(max_batch, np.int64)
        self._steps = np.zeros(max_batch, np.int64)    # slot-local step count
        # (program key, library epoch) -> the captured step; one memory pool
        self._programs: "dict[tuple, StepProgram]" = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._logits = None

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

    def _choose(self, logits, seeds, steps):
        """Next tokens (n,) on the device from (n, V) logits and the slots'
        seed and step tensors (n,): a slot's noise is keyed by its request's
        (seed, step) alone."""
        noise = None
        if not self.greedy:
            noise = F.gumbel_noise(seeds, steps, torch.zeros_like(seeds),
                                   logits.shape[-1])
        return F.select_next(logits, self.greedy, self.temperature, self.top_k,
                             self.top_p, self.min_p, noise)

    @property
    def last_logits(self):
        """The (max_batch, V) logits of the last step, one row per slot;
        the next step overwrites them."""
        return self._logits

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
            seed = torch.full((1,), self._seed[slot], dtype=torch.long,
                              device=self.device)
            tok = int(self._choose(logits, seed, torch.zeros_like(seed))[0])
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

    def _step_inputs(self) -> dict:
        """The host values the step's static buffers take for this step."""
        return {"toks": self._tok, "pos": self._pos, "seeds": self._seed,
                "steps": self._steps}

    def _program_key(self, inputs: dict):
        """What else tells one captured step from another: nothing here."""
        return None

    def _step_state(self) -> list:
        """The tensors a step changes that a second run of it would not
        change alike (none: the KV writes of a step depend on its inputs
        alone, so the warm-up's writes are the replay's)."""
        return []

    def _device_step(self, toks, pos, seeds, steps, **rest):
        """The captured step: (logits (B, V), next tokens (B,))."""
        logits = self._step_logits(toks.reshape(-1, 1), pos, **rest)[:, 0]
        return logits, self._choose(logits, seeds, steps)

    def _program(self, inputs: dict) -> StepProgram:
        key = (self._program_key(inputs), _build.epoch())
        program = self._programs.get(key)
        if program is None:
            buffers = {name: torch.zeros(np.shape(v), dtype=torch.as_tensor(v).dtype,
                                         device=self.device)
                       for name, v in inputs.items()}
            program = self._programs[key] = StepProgram(
                lambda: self._device_step(**buffers), buffers, self.device,
                pool=self._pool, restore=self._step_state())
        return program

    def _run_step(self, inputs: dict):
        """(logits (B, V), next tokens (B,)) of one step on ``inputs``: a
        replay of the captured step."""
        return self._program(inputs).run(**inputs)

    def step(self) -> "dict[int, int]":
        """One batched decode step for every live slot (one replay of the
        captured step); returns {slot: emitted token}.  Slots whose budget
        hits zero finish."""
        live = [s for s in range(self.max_batch)
                if s not in self._free and self._budget[s] > 0]
        if not live:
            return {}
        with torch.inference_mode():
            self._logits, nxt = self._run_step(self._step_inputs())
            nxt = nxt.tolist()
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

    def _step_state(self) -> list:
        # the recurrence advances h and the conv window on every run
        return [t for state in self._caches for t in state.values()]

    def _step_logits(self, toks, pos):
        logits, new = self.model.step(self._caches, toks[:, 0])
        for state, row in zip(self._caches, new):
            for name, t in row.items():
                state[name].copy_(t)
        return logits[:, None]
