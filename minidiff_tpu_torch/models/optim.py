"""Optimizers over a model's parameters.

Port of ``SGD``, ``Adam`` and ``AdamW`` from ``minidiff_tpu/models/optim.py``
with the JAX package's update rules exactly, which differ from
``torch.optim``'s: Adam folds the bias correction into the step size,
``lr * sqrt(1 - b2^t) / (1 - b1^t)``, and adds ``eps`` to ``sqrt(v)``;
AdamW decays the parameters before the Adam step.  ``step(params)`` updates
each parameter in place from its ``.grad`` under ``torch.no_grad()`` (one
in-place subtraction or scaling, rounded once as the JAX package's
out-of-place update is); the state (momentum, moments) is kept per
parameter, in the parameter's dtype, as the JAX state is, and Adam's step
count once per optimizer.
"""

from __future__ import annotations

import math

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
                g = g.clone() if v is None else self.momentum * v + g
                self.state[p] = g
            p.sub_(self.lr * g)


class Adam(Optimizer):
    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__()
        self.lr = lr
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.t = 0

    @torch.no_grad()
    def step(self, params) -> None:
        self.t += 1
        # bias-corrected step size folded into one scalar
        step = self.lr * math.sqrt(1 - self.b2 ** self.t) / (1 - self.b1 ** self.t)
        for p in params:
            if p.grad is None:
                continue
            g = p.grad
            m, v = self.state.get(p, (torch.zeros_like(p), torch.zeros_like(p)))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            self.state[p] = (m, v)
            p.sub_(step * m / (torch.sqrt(v) + self.eps))


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
