"""Optimizers over a model's parameters.

Port of ``SGD``, ``Adam`` and ``AdamW`` from ``minidiff_tpu/models/optim.py``
with the JAX package's update rules exactly, which differ from
``torch.optim``'s: Adam folds the bias correction into the step size,
``lr * sqrt(1 - b2^t) / (1 - b1^t)``, and adds ``eps`` to ``sqrt(v)``;
AdamW decays the parameters before the Adam step.  ``step(params)`` updates
each parameter in place from its ``.grad`` under ``torch.no_grad()`` (one
in-place subtraction or scaling, rounded once as the JAX package's
out-of-place update is).

The state lives where a CUDA graph can replay it: the momentum and the
moments are tensors made once, at a parameter's first step, in its dtype
(as the JAX state is), and written in place from then on; Adam's step count
``t`` is a float64 scalar on the parameters' device, as the JAX package's
``state["t"]``, and the bias-corrected step size is computed from it there.
A 0-dim device tensor takes the dtype of the tensor it scales, so the
update of a bf16 or f16 parameter is computed in f32 (the step size kept
at f32, as a Python float is inside a kernel) and rounded once, by the
in-place subtraction.  So a
captured train step reads and writes the same storage at every replay, and
the eager step runs the same operations.
"""

from __future__ import annotations

import torch


class Optimizer:
    def __init__(self):
        self.state: dict = {}

    def step(self, params) -> None:
        """Update every parameter of ``params`` that has a gradient."""
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, lr: float, momentum: float = 0.0):
        super().__init__()
        self.lr = lr
        self.momentum = momentum

    @torch.no_grad()
    def step(self, params) -> None:
        for p in params:
            if p.grad is None:
                continue
            g = p.grad
            if self.momentum != 0.0:
                v = self.state.get(p)
                if v is None:
                    v = self.state[p] = torch.zeros_like(p)
                g = v.mul_(self.momentum).add_(g)
            p.sub_(self.lr * g)


class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__()
        self.lr = lr
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.t = None  # the step count: a float64 scalar on the device

    @torch.no_grad()
    def step(self, params) -> None:
        params = [p for p in params if p.grad is not None]
        if not params:
            return
        if self.t is None:
            self.t = torch.zeros((), dtype=torch.float64, device=params[0].device)
        t = self.t.add_(1.0)
        # bias-corrected step size folded into one scalar, cast once a step
        # to each parameter dtype's compute type (at least f32)
        step = self.lr * torch.sqrt(1 - self.b2 ** t) / (1 - self.b1 ** t)
        steps: dict = {}
        for p in params:
            g = p.grad
            state = self.state.get(p)
            if state is None:
                state = self.state[p] = (torch.zeros_like(p), torch.zeros_like(p))
            m, v = state
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            wide = torch.promote_types(p.dtype, torch.float32)
            if wide not in steps:
                steps[wide] = step.to(wide)
            p.sub_(steps[wide] * m.to(wide) / (torch.sqrt(v.to(wide)) + self.eps))


class AdamW(Adam):
    """Adam with decoupled weight decay (applied to params, not grads)."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(lr, b1, b2, eps)
        self.weight_decay = weight_decay

    @torch.no_grad()
    def step(self, params) -> None:
        params = list(params)
        for p in params:
            if p.grad is not None:
                p.mul_(1.0 - self.lr * self.weight_decay)
        super().step(params)
