"""LayerNorm forward and fused residual-add + LayerNorm forward.

Port of ``minidiff_tpu/kernels/layernorm.py`` (``layernorm`` and
``add_layernorm``).  Semantics, shared by the CUDA kernels and the plain
versions here:

    acc = f32 if x is sub-f32 (bf16/f16) else x.dtype
    mu  = mean(x, -1);  var = mean((x-mu)^2, -1)      # biased, in acc
    y   = (x-mu) * rsqrt(var+eps) * g + b             # cast back to x.dtype

``add_layernorm`` returns the stacked pair ``(x + a, LN(x + a))`` with
``x + a`` rounded to the model dtype before the statistics.

A CUDA tensor goes to the hand-written kernels of ``csrc/layernorm.cu``
(``ln_fwd``, ``addln_fwd``); a CPU tensor goes to the plain versions.  A CUDA
tensor the kernels do not take raises: nothing falls back.
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"ln_fwd": 0, "addln_fwd": 0}


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt in (torch.float64, torch.float32) else torch.float32


def _plain_layernorm(x, g, b, eps: float = 1e-5):
    acc = _acc_dtype(x.dtype)
    xa = x.to(acc)
    mu = xa.mean(dim=-1, keepdim=True)
    xc = xa - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * g.to(acc) + b.to(acc)).to(x.dtype)


def _plain_add_layernorm(x, a, g, b, eps: float = 1e-5):
    t = x + a
    return torch.stack([t, _plain_layernorm(t, g, b, eps)])


def _check_cuda(name: str, x, *others):
    """Validate what the kernels take; raise on anything else."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    for t in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: every operand must be {x.dtype} on "
                            f"{x.device}, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    vec = 8 if x.dtype == torch.bfloat16 else 4
    width = _build.function("max_row_width")(_DTYPE_CODES[x.dtype])
    if d % vec or d > width:
        raise ValueError(f"{name}: last dim {d} must be a multiple of {vec} "
                         f"and at most {width} for {x.dtype}")


def _ptr(t: torch.Tensor) -> int:
    p = t.data_ptr()
    if p % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return p


def layernorm(x, g, b, eps: float = 1e-5):
    """Last-axis LayerNorm of ``x`` with gain ``g`` and bias ``b``."""
    if x.device.type == "cpu":
        return _plain_layernorm(x, g, b, eps)
    _check_cuda("ln_fwd", x, g, b)
    d = x.shape[-1]
    xc, gc, bc = x.contiguous(), g.contiguous(), b.contiguous()
    y = torch.empty_like(xc)
    rows = xc.numel() // d
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        err = _build.function("ln_fwd")(
            _ptr(xc), _ptr(gc), _ptr(bc), _ptr(y), rows, d, float(eps),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ln_fwd")
    LAUNCHES["ln_fwd"] += 1
    return y


def add_layernorm(x, a, g, b, eps: float = 1e-5):
    """Stacked ``(2, *x.shape)``: ``[0] = x + a``, ``[1] = LN(x + a)``."""
    if x.device.type == "cpu":
        return _plain_add_layernorm(x, a, g, b, eps)
    _check_cuda("addln_fwd", x, a, g, b)
    if a.shape != x.shape:
        raise ValueError(f"addln_fwd: shapes differ, {x.shape} vs {a.shape}")
    d = x.shape[-1]
    xc, ac, gc, bc = x.contiguous(), a.contiguous(), g.contiguous(), b.contiguous()
    out = torch.empty((2,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    rows = xc.numel() // d
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = _build.function("addln_fwd")(
            _ptr(xc), _ptr(ac), _ptr(gc), _ptr(bc), _ptr(out), rows, d,
            float(eps), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "addln_fwd")
    LAUNCHES["addln_fwd"] += 1
    return out
