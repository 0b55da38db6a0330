"""Softmax cross-entropy over integer labels, forward and backward.

Port of ``minidiff_tpu/kernels/xent.py`` (``softmax_xent``, ``xent_grad``).
Semantics, shared by the CUDA kernels and the plain versions here (acc = f32
for sub-f32 logits, else the logits' dtype):

    loss = logsumexp(z) - z[label]                    (per row, in acc)
    dz   = (softmax(z) - onehot(label)) * g           (cast to z.dtype)

The kernels write the loss in f32, which is acc for the two dtypes they take.
``softmax_xent`` is differentiable through ``SoftmaxXentFn``.  A CUDA tensor
goes to the hand-written kernels of ``csrc/xent.cu`` (``xent_fwd``,
``xent_bwd``); a CPU tensor goes to the plain versions.  A CUDA tensor the
kernels do not take raises: nothing falls back.  The kernels take any row
width V.  The tape's ``softmax_xent`` enters through ``loss`` and
``loss_grad``, which send f32 and bf16 logits to the kernels (their plain
versions on the CPU) and other dtypes to the plain versions.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels.layernorm import _acc_dtype

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"xent_fwd": 0, "xent_bwd": 0}


def _plain_xent(z, lab):
    """Per-row loss in acc: the port of ``_jnp_xent``."""
    za = z.to(_acc_dtype(z.dtype))
    m = za.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(za - m).sum(dim=-1, keepdim=True)) + m
    zlab = torch.gather(za, -1, lab.to(torch.int64).unsqueeze(-1))
    return (lse - zlab)[..., 0]


def _plain_xent_grad(z, lab, g):
    """dz: the port of ``_jnp_xent_grad``."""
    acc = _acc_dtype(z.dtype)
    za = z.to(acc)
    m = za.max(dim=-1, keepdim=True).values
    e = torch.exp(za - m)
    p = e / e.sum(dim=-1, keepdim=True)
    onehot = (torch.arange(z.shape[-1], device=z.device)
              == lab.to(torch.int64).unsqueeze(-1)).to(acc)
    return ((p - onehot) * g.to(acc).unsqueeze(-1)).to(z.dtype)


def _check_cuda(name: str, z, lab, *others):
    if z.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {z.dtype}")
    if z.dim() != 2 or lab.shape != z.shape[:1]:
        raise ValueError(f"{name}: takes (rows, V) logits and (rows,) labels, "
                         f"got {tuple(z.shape)} and {tuple(lab.shape)}")
    if lab.dtype.is_floating_point or lab.dtype.is_complex:
        raise TypeError(f"{name}: labels must be integers, got {lab.dtype}")
    for t in (lab, *others):
        if t.device != z.device:
            raise TypeError(f"{name}: every operand must be on {z.device}")


def xent_fwd(z, lab):
    """z (rows, V), lab (rows,) int -> per-row loss (rows,)."""
    if z.device.type == "cpu":
        return _plain_xent(z, lab)
    _check_cuda("xent_fwd", z, lab)
    rows, v = z.shape
    zc = z.contiguous()
    labc = lab.to(torch.int32).contiguous()
    loss = torch.empty((rows,), dtype=torch.float32, device=z.device)
    if rows == 0:
        return loss
    with torch.cuda.device(z.device):
        err = _build.function("xent_fwd")(
            *_build.ptrs(zc, labc, loss), rows, v, _build.DTYPE_CODES[z.dtype],
            _build.stream())
    _build.check(err, "xent_fwd")
    LAUNCHES["xent_fwd"] += 1
    return loss


def xent_grad(z, lab, g):
    """dz of the per-row loss for the per-row cotangent g: (rows, V)."""
    if z.device.type == "cpu":
        return _plain_xent_grad(z, lab, g)
    _check_cuda("xent_bwd", z, lab, g)
    if g.shape != lab.shape:
        raise ValueError(f"xent_bwd: g {tuple(g.shape)} must match the labels "
                         f"{tuple(lab.shape)}")
    rows, v = z.shape
    zc = z.contiguous()
    labc = lab.to(torch.int32).contiguous()
    gc = g.to(torch.float32).contiguous()
    dz = torch.empty_like(zc)
    if rows == 0:
        return dz
    with torch.cuda.device(z.device):
        err = _build.function("xent_bwd")(
            *_build.ptrs(zc, labc, gc, dz), rows, v, _build.DTYPE_CODES[z.dtype],
            _build.stream())
    _build.check(err, "xent_bwd")
    LAUNCHES["xent_bwd"] += 1
    return dz


class SoftmaxXentFn(torch.autograd.Function):
    """Per-row loss of (rows, V) logits; the backward is ``xent_grad``."""

    @staticmethod
    def forward(ctx, z, lab):
        ctx.save_for_backward(z, lab)
        return xent_fwd(z, lab)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, lab = ctx.saved_tensors
        return xent_grad(z, lab, g), None


def softmax_xent(z, lab):
    """Per-row loss (labels' shape) of ``z`` (..., V) logits and ``lab`` (...)
    int class ids: f32 for bf16/f32 logits, f64 for f64."""
    v = z.shape[-1]
    loss = SoftmaxXentFn.apply(z.reshape(-1, v), lab.reshape(-1))
    return loss.reshape(lab.shape)


def loss(z, lab):
    """Per-row loss (labels' shape) of ``z`` (..., V) logits and ``lab``
    (...) class ids, with no autograd: the kernel for f32 and bf16 logits,
    the plain version for other dtypes."""
    v = z.shape[-1]
    fn = xent_fwd if z.dtype in _build.DTYPE_CODES else _plain_xent
    return fn(z.reshape(-1, v), lab.reshape(-1)).reshape(lab.shape)


def loss_grad(z, lab, g):
    """dz (z's shape) of ``loss`` for the cotangent ``g`` (labels' shape),
    chosen as ``loss`` chooses."""
    v = z.shape[-1]
    fn = xent_grad if z.dtype in _build.DTYPE_CODES else _plain_xent_grad
    return fn(z.reshape(-1, v), lab.reshape(-1), g.reshape(-1)).reshape(z.shape)
