"""Sequence packing: train on many documents per row without cross-talk.

Port of ``minidiff_tpu/models/pack.py``.  Packing concatenates documents
into full rows and keeps them independent with per-token tables computed on
the host (``pack_documents``) and read as data by the step:

* ``segment_ids`` (B, S): document index per token (-1 = padding).  The
  attention confines visibility to equal ids, as id rows inside the flash
  kernels (``kernels/attention.py``), never a dense (S, S) mask;
* ``positions`` (B, S): the position WITHIN the document, so learned
  positional embeddings index correctly and RoPE restarts per document;
* ``targets`` / ``loss_mask`` (B, S): next-token labels, with positions
  whose next token crosses a document boundary (or is padding) masked out
  of the loss.

``make_packed_train_step`` trains a ``TransformerLM`` in place on such
batches through ``make_train_step``; with ``jit=True`` (the default) the
step is a captured ``StepProgram`` (``models/capture.py``) whose five
tables are static inputs, so a new batch of the same shape replays the
same graph.
"""

from __future__ import annotations

import numpy as np
import torch

from minidiff_tpu_torch.models.mlp import make_train_step
from minidiff_tpu_torch.models.transformer import lm_loss

__all__ = ["pack_documents", "segment_positions", "make_packed_train_step"]

# the tables of a packed batch, each (B, S) int64
TABLES = ("tokens", "segment_ids", "positions", "targets", "loss_mask")


def segment_positions(segment_ids) -> np.ndarray:
    """Within-document positions for contiguous-run segment ids.

    (B, S) or (S,) int array -> same-shape int array: 0, 1, 2, ... restarting
    wherever the id changes; padding (-1) runs get positions too (masked out
    of everything downstream, so their value never matters).
    """
    seg = np.asarray(segment_ids)
    one = seg.reshape(1, -1) if seg.ndim == 1 else seg
    b, s = one.shape
    idx = np.arange(s)
    out = np.zeros_like(one)
    for r in range(b):
        starts = np.ones(s, bool)
        starts[1:] = one[r, 1:] != one[r, :-1]
        # last start at or before each position
        last_start = np.maximum.accumulate(np.where(starts, idx, -1))
        out[r] = idx - last_start
    return out.reshape(seg.shape)


def pack_documents(docs, seq_len: int, pad_id: int = 0) -> dict:
    """Greedy first-fit packing of token documents into (B, S) rows.

    Documents longer than ``seq_len`` are split into ``seq_len``-sized
    pieces (each piece its own segment).  Returns a dict of equal-shape
    (B, S) int64 numpy arrays: ``tokens``, ``segment_ids`` (-1 on padding),
    ``positions``, ``targets`` and ``loss_mask`` (next-token labels inside
    each document; the final token of every document is unscored).
    """
    pieces = []
    for doc in docs:
        doc = list(doc)
        for i in range(0, len(doc), seq_len):
            pieces.append(doc[i:i + seq_len])
    # first-fit over open rows
    rows, space = [], []
    for piece in pieces:
        for r, free in enumerate(space):
            if len(piece) <= free:
                rows[r].append(piece)
                space[r] -= len(piece)
                break
        else:
            rows.append([piece])
            space.append(seq_len - len(piece))
    b = len(rows)
    tokens = np.full((b, seq_len), pad_id, np.int64)
    seg = np.full((b, seq_len), -1, np.int64)
    targets = np.full((b, seq_len), pad_id, np.int64)
    loss_mask = np.zeros((b, seq_len), np.int64)
    for r, row in enumerate(rows):
        at = 0
        for d, piece in enumerate(row):
            n = len(piece)
            tokens[r, at:at + n] = piece
            seg[r, at:at + n] = d
            targets[r, at:at + n - 1] = piece[1:]
            loss_mask[r, at:at + n - 1] = 1
            at += n
    return {"tokens": tokens, "segment_ids": seg, "positions": segment_positions(seg),
            "targets": targets, "loss_mask": loss_mask}


def _packed_loss(logits, y):
    """The masked mean next-token cross-entropy of y = (targets, loss_mask)."""
    return lm_loss(logits, y[0], mask=y[1])


def make_packed_train_step(model, optimizer=None, jit: bool = True, donate: bool = False,
                           device="cuda"):
    """Build ``step(batch) -> loss`` that trains ``model`` in place on a
    packed batch (``pack_documents``' dict of (B, S) tables, numpy or
    tensors): the masked mean next-token cross-entropy
    (``lm_loss(..., mask=loss_mask)``) of ``model(tokens, segment_ids=,
    positions=)``, its backward, and ``optimizer.step`` (``SGD(0.1)`` by
    default, as in the JAX package).

    It is ``make_train_step`` (``models/mlp.py``) over the tables stacked
    as x = (tokens, segment_ids, positions) and y = (targets, loss_mask):
    with ``jit=True`` (the default) one ``StepProgram`` per batch shape in
    ``step._cache``, the tables copied into its static buffers, so a new
    batch replays the same graph; ``jit=False`` runs the same step eagerly.
    The returned loss is a fresh detached tensor.
    """
    inner = make_train_step(
        model, optimizer, loss_fn=_packed_loss, jit=jit, donate=donate, device=device,
        apply_fn=lambda x: model(x[0], segment_ids=x[1], positions=x[2]))

    def step(batch, rng=None):
        tables = [torch.as_tensor(batch[name]).to(torch.int64) for name in TABLES]
        shape = tuple(tables[0].shape)
        for name, t in zip(TABLES, tables):
            if tuple(t.shape) != shape:
                raise ValueError(f"table {name} {tuple(t.shape)} is not {shape}")
        return inner(torch.stack(tables[:3]), torch.stack(tables[3:]), rng)

    step._cache = inner._cache
    return step
