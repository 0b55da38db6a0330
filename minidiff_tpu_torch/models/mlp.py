"""The train step: forward, backward, optimizer update.

Port of ``make_train_step`` from ``minidiff_tpu/models/mlp.py``.  The
gradients come from PyTorch's autograd, through the kernels' own backward
``torch.autograd.Function``s; the update is one of ``models/optim.py``'s
optimizers, in place on the model's parameters and on its own state.

``jit=True``, the default as in the JAX package, where it compiles the
whole step into one XLA program, runs the step as a ``StepProgram``
(``models/capture.py``) with ``grad=True``: on the card the first call of
a key is the first real step, after which the step is captured into one
CUDA graph, forward, backward, the microbatches of ``grad_accum`` and the
update; each later call copies ``x`` and ``y`` into the program's static
buffers and replays it.  On the CPU the same program runs the step function
on those buffers.  ``jit=False`` runs the same step function eagerly on
``x`` and ``y``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.capture import StepProgram, cached_program, weights_key
from minidiff_tpu_torch.models.layers import check_device
from minidiff_tpu_torch.models.optim import SGD

_LATER = "a later slice of the port"
_TRAIN_CACHE_MAX = 32


def make_train_step(model, optimizer=None, loss_fn=F.cross_entropy,
                    jit: bool = True, apply_fn=None, grad_accum: int = 1,
                    donate: bool = False, trainable=None, device="cuda"):
    """Build ``step(x, y) -> loss`` that trains ``model`` in place.

    One step runs the forward, ``backward()`` and ``optimizer.step`` over
    ``model.parameters()`` (``optimizer`` defaults to ``SGD(0.1)``, as in the
    JAX package).  ``loss_fn`` receives ``apply_fn(x)`` (``model(x)`` by
    default; an MoE model trains with ``apply_fn=model.forward_with_aux``,
    whose (logits, aux) ``make_moe_loss`` takes) and the targets.
    ``grad_accum > 1`` splits the batch
    into that many microbatches, runs forward and backward on each, sums
    their gradients and losses, and scales both once before the single
    update, as the JAX step does.  ``x`` and ``y`` move to the model's
    device; ``device`` must be where the model lives (``"cuda"`` raises
    without a GPU).  The returned loss is a fresh detached tensor, which no
    later step overwrites.

    ``jit=True`` keeps one program per (``x`` and ``y``'s shapes and
    dtypes, device, library epoch, parameter storage) in ``step._cache``,
    an LRU of 32 as the decode programs' (a program of an earlier epoch is
    never used again and ages out); a step that cannot be captured raises
    on the card.  The graphs of one ``step`` share one memory pool, which
    holds about one step's activations, whatever the number of programs.
    """
    if trainable is not None:
        raise NotImplementedError(
            f"trainable (LoRA fine-tuning) comes with {_LATER}")
    if donate:
        raise NotImplementedError(f"donate comes with {_LATER}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = check_device(model, device)
    optimizer = optimizer or SGD(0.1)
    apply = apply_fn or model
    params = list(model.parameters())

    def run(x, y):
        """One step on ``x`` and ``y`` on the model's device: no host sync,
        so that a graph can hold it."""
        for p in params:
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(apply(x), y)
            loss.backward()
        else:
            n = x.shape[0] // grad_accum
            loss = None
            for i in range(grad_accum):
                li = loss_fn(apply(x[i * n:(i + 1) * n]), y[i * n:(i + 1) * n])
                li.backward()  # sums into each .grad
                loss = li.detach() if loss is None else loss + li.detach()
            scale = 1.0 / grad_accum
            loss = loss * scale
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        optimizer.step(params)
        return loss.detach()

    cache: "OrderedDict" = OrderedDict()
    pool = torch.cuda.graph_pool_handle() if jit and dev.type == "cuda" else None

    def program(x, y) -> StepProgram:
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype, str(dev),
               _build.epoch(), weights_key(model))

        def build():
            bufs = {name: torch.empty(t.shape, dtype=t.dtype, device=dev)
                    for name, t in (("x", x), ("y", y))}
            return StepProgram(lambda: run(bufs["x"], bufs["y"]), bufs, dev,
                               pool=pool, grad=True)

        return cached_program(cache, key, build, _TRAIN_CACHE_MAX)

    def step(x, y, rng=None):
        if rng is not None:
            raise NotImplementedError(
                f"rng (dropout in training) comes with {_LATER}")
        if grad_accum > 1 and x.shape[0] % grad_accum:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"grad_accum {grad_accum}")
        if not jit:
            return run(x.to(dev), y.to(dev))
        prog = program(x, y)
        prog.load(x=x, y=y)
        return prog.replay().clone()

    step._cache = cache
    return step
