"""Paged KV-cache serving: block tables over a shared page pool.

Port of ``PagedDecodeServer`` from ``minidiff_tpu/models/paged.py:60-381``.
``DecodeServer`` reserves a dense ``window``-long KV row per slot; this
server keeps ONE pool of 128-token pages per layer and a page table per
slot.  Pages are taken from the pool at submit for the bucketed prompt and
each time decoding crosses a 128 boundary, and go back on ``collect``.
``num_pages`` (default ``max_batch * window / 128``, the dense capacity) may
be set lower to oversubscribe the pool against the requests' real lengths;
an exhausted pool raises ``RuntimeError`` at submit or step, and nothing is
evicted.

Page 0 is the reserved garbage page and never handed out: released slots
keep stepping, and their zeroed table rows send both their writes and their
(masked) reads there, so a live slot's pages are never touched.  The page
table lives on the host; each step copies the write pages and offsets and
the table's columns up to the furthest page a live slot reads into the
static buffers of its captured step (``DecodeServer.step``), one graph per
table width, captured at the width's first step and kept in the server, so
that the kernel's launch plan (``kernels.paged.paged_plan``, which reads
shapes only) splits each slot over the pages in use and not over the
window.
The prefill writes its rows page by page into the slot's pages; a step
appends each slot's new KV line with ``append_kv`` and attends through the
``paged_attn`` kernel (``kernels/paged.py``) with ``q`` cast to the pool
dtype.

Greedy outputs are token-identical to ``generate_compiled``.  Prefix caching
and chunked prefill wait for the dense server's ``register_prefix`` and
``prefill_chunk`` in a later slice; asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from minidiff_tpu_torch.kernels.paged import PAGE, append_kv, paged_attention
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.server import _BUCKET, DecodeServer
from minidiff_tpu_torch.models.speculative import _prefill

__all__ = ["PAGE", "PagedDecodeServer"]

_LATER = "prefix caching and chunked prefill come with a later slice of the port"


class PagedDecodeServer(DecodeServer):
    """Continuous batching over a paged KV cache.

    >>> srv = PagedDecodeServer(model, max_batch=8, window=2048,
    ...                         num_pages=64)   # 64 pooled pages, not 128
    >>> slot = srv.submit([1, 2, 3], max_new_tokens=64)
    >>> while srv.active():
    ...     srv.step()
    >>> tokens = srv.collect(slot)              # its pages return to the pool
    """

    def __init__(self, model, max_batch: int = 8, window=None, num_pages=None,
                 prefill_chunk=None, **kw):
        if prefill_chunk is not None:
            raise NotImplementedError(f"prefill_chunk: {_LATER}")
        self._num_pages = num_pages  # resolved in _alloc_caches
        super().__init__(model, max_batch=max_batch, window=window, **kw)

    # -- pool ------------------------------------------------------------

    def _alloc_caches(self):
        self._maxp = self.window // PAGE
        if self._num_pages is None:
            self._num_pages = self.max_batch * self._maxp
        if self._num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self._num_pages}")
        self._num_pages += 1  # page 0: the garbage page
        self._free_pages = list(range(1, self._num_pages))
        self._slot_pages: "dict[int, list[int]]" = {}
        self._table_np = np.zeros((self.max_batch, self._maxp), np.int32)
        blk = self.model.blocks[0].attn
        shape = (self._num_pages, blk.num_kv_heads, PAGE, blk.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.model.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.model.dtype, device=self.device)}
                for _ in self.model.blocks]

    def pages_in_use(self) -> int:
        return (self._num_pages - 1) - len(self._free_pages)

    def free_page_count(self) -> int:
        return len(self._free_pages)

    def kv_bytes(self) -> int:
        """Device bytes held by the KV pool (all layers, K and V)."""
        return sum(t.numel() * t.element_size()
                   for pool in self._caches for t in pool.values())

    def _take_page(self, slot: int) -> None:
        if not self._free_pages:
            raise RuntimeError(
                f"KV page pool exhausted ({self._num_pages - 1} usable pages, "
                f"all in use) — collect() finished requests to free their "
                f"pages, or construct the server with a larger num_pages")
        pid = self._free_pages.pop(0)
        pages = self._slot_pages.setdefault(slot, [])
        self._table_np[slot, len(pages)] = pid
        pages.append(pid)

    def _release_pages(self, slot: int) -> None:
        self._free_pages.extend(self._slot_pages.pop(slot, []))
        self._table_np[slot, :] = 0

    # -- host API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, seed: int = 0,
               prefix=None) -> int:
        """Admit a request: take the pages of its bucketed prompt, then
        prefill into them (raises when no slot or no page is free)."""
        if prefix is not None:
            raise NotImplementedError(f"prefix: {_LATER}")
        prompt = self._check_request(prompt, max_new_tokens)
        slot = self._free[0]  # the slot the base submit will take
        self._release_pages(slot)  # stale pages of an uncollected past
        sb = -(-len(prompt) // _BUCKET) * _BUCKET
        for _ in range(sb // PAGE):
            self._take_page(slot)
        return super().submit(prompt, max_new_tokens, seed=seed)

    def step(self) -> "dict[int, int]":
        # the page the incoming token lands in, where decoding crosses a
        # 128 boundary this step
        for s in range(self.max_batch):
            if s in self._free or self._budget[s] <= 0:
                continue
            if int(self._pos[s]) // PAGE >= len(self._slot_pages.get(s, [])):
                self._take_page(s)
        return super().step()

    def collect(self, slot: int) -> "list[int]":
        out = super().collect(slot)
        if self._budget[slot] == 0:
            self._release_pages(slot)
        return out

    # -- device work -------------------------------------------------------

    def _prefill_slot(self, slot: int, padded, s0: int):
        sb = padded.shape[1]
        rows, logits = _prefill(self.model, padded, sb, last=s0 - 1)
        pids = torch.as_tensor(self._table_np[slot, :sb // PAGE].astype(np.int64),
                               device=self.device)
        for pool, row in zip(self._caches, rows):
            for name in ("k", "v"):
                # (1, h, sb, hd) -> its sb / PAGE pages (npg, h, PAGE, hd)
                pages = row[name][0].reshape(row[name].shape[1], -1, PAGE,
                                             row[name].shape[3]).transpose(0, 1)
                pool[name][pids] = pages
        return logits

    def _step_inputs(self) -> dict:
        b = self.max_batch
        pidx = np.maximum(self._pos, 0) // PAGE
        # the columns up to the furthest page a live slot reads: a slot reads
        # pages 0 .. pos // PAGE, and a released slot (a zeroed row) any
        live = [s for s in range(b) if s not in self._free and self._budget[s] > 0]
        width = max((int(pidx[s]) + 1 for s in live), default=1)
        return {**super()._step_inputs(),
                "page_ids": self._table_np[np.arange(b), pidx].astype(np.int64),
                "offsets": self._pos % PAGE,
                "table": np.ascontiguousarray(self._table_np[:, :width])}

    def _program_key(self, inputs: dict):
        return inputs["table"].shape[1]

    def _step_logits(self, toks, pos, page_ids, offsets, table):
        model, b = self.model, self.max_batch
        pos32 = pos.to(torch.int32)
        pos2d = pos.reshape(b, 1)
        x = model.tok_emb[toks]
        if not model.rope:
            x = x + model.pos_emb[pos2d]
        for blk, pool in zip(model.blocks, self._caches):
            h, kv, hd = blk.attn.num_heads, blk.attn.num_kv_heads, blk.attn.head_dim
            q, kk, vv = F.block_qkv(blk, x, pos2d)      # (B, h | kv, 1, hd)
            append_kv(pool["k"], kk.reshape(b, kv, hd), page_ids, offsets)
            append_kv(pool["v"], vv.reshape(b, kv, hd), page_ids, offsets)
            # each KV head's query group: (B, kv, g, hd)
            q4 = q.reshape(b, kv, h // kv, hd).to(pool["k"].dtype)
            o = paged_attention(q4, pool["k"], pool["v"], table, pos32,
                                window=model.window, sinks=model.sinks)
            x = F.block_finish(blk, x, o.reshape(b, h, 1, hd).to(q.dtype))
        return model.lm_head(model.ln_f(x))
