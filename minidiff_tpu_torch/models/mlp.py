"""The train step: forward, backward, optimizer update.

Port of ``make_train_step`` from ``minidiff_tpu/models/mlp.py``.  The
gradients come from PyTorch's autograd, through the kernels' own backward
``torch.autograd.Function``s; the update is one of ``models/optim.py``'s
optimizers, in place on the model's parameters.
"""

from __future__ import annotations

from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import check_device
from minidiff_tpu_torch.models.optim import SGD

_LATER = "a later slice of the port"


def make_train_step(model, optimizer=None, loss_fn=F.cross_entropy,
                    grad_accum: int = 1, device="cuda", *, apply_fn=None,
                    trainable=None, donate: bool = False):
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
    without a GPU).  The returned loss is detached.
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

    def step(x, y, rng=None):
        if rng is not None:
            raise NotImplementedError(
                f"rng (dropout in training) comes with {_LATER}")
        x, y = x.to(dev), y.to(dev)
        for p in params:
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(apply(x), y)
            loss.backward()
        else:
            if x.shape[0] % grad_accum:
                raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                                 f"grad_accum {grad_accum}")
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

    return step
