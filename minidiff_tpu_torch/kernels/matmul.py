"""Matrix products for the tape: x @ y, x @ yᵀ and xᵀ @ y.

Port of ``minidiff_tpu/kernels/matmul.py`` (``matmul``, ``matmul_nt``,
``matmul_tn``).  The nt and tn forms exist so that the tape's matmul VJPs
(``dx = g @ yᵀ``, ``dy = xᵀ @ g``) read the "transposed" operand in its
stored layout and never make a transposed copy.

Dispatch (``uses_kernel``, a pure function of shapes and dtypes): a product
goes to the hand-written CUDA kernels of ``csrc/matmul.cu`` (``matmul_nn``,
``matmul_nt``, ``matmul_tn``) when it is 2-D, both operands have one dtype,
float32 or bfloat16, and it costs at least ``_MIN_FLOPS`` (2·m·n·k ≥ 2³¹,
the JAX package's threshold, below which launch overhead dominates).
Anything else goes to ``torch.matmul``, as the JAX package leaves it to
``jnp.matmul``.  There is no tile-alignment rule (the kernels guard their own
edges) and no race against cuBLAS.

A product that meets the rule launches its kernel when its operands lie on a
CUDA device, or raises; on the CPU it runs the plain version,
``(x.float() @ y.float()).to(dtype)``: an f32 accumulator and one cast, as
the kernels compute.  Nothing falls back.  No autograd here: the tape
supplies the VJPs, which re-enter these functions.
"""

from __future__ import annotations

import torch

from minidiff_tpu_torch.kernels import _build

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"matmul_nn": 0, "matmul_nt": 0, "matmul_tn": 0}
_MIN_FLOPS = 2 * 1024 * 1024 * 1024
# the C entry's `variant` argument
_VARIANTS = {"nn": 0, "nt": 1, "tn": 2}


def _mnk(variant: str, xs: tuple, ys: tuple) -> tuple:
    """(m, n, k) of a 2-D product, (0, 0, 0) if the inner sizes differ."""
    if variant == "nn":
        (m, k), (k2, n) = xs, ys
    elif variant == "nt":
        (m, k), (n, k2) = xs, ys
    else:  # tn
        (k, m), (k2, n) = xs, ys
    return (m, n, k) if k == k2 else (0, 0, 0)


def uses_kernel(variant: str, x_shape, y_shape, x_dtype, y_dtype) -> bool:
    """True when a product goes to the hand-written kernel."""
    if len(x_shape) != 2 or len(y_shape) != 2:
        return False
    if x_dtype != y_dtype or x_dtype not in _build.DTYPE_CODES:
        return False
    m, n, k = _mnk(variant, tuple(x_shape), tuple(y_shape))
    return 2 * m * n * k >= _MIN_FLOPS


def _oriented(variant: str, x, y):
    """The operands of the plain product x' @ y'."""
    if variant == "nt":
        return x, y.transpose(-1, -2)
    if variant == "tn":
        return x.transpose(-1, -2), y
    return x, y


def _plain(variant: str, x, y):
    """The kernels' arithmetic: an f32 accumulator, one cast at the end."""
    a, b = _oriented(variant, x, y)
    return (a.float() @ b.float()).to(x.dtype)


def _library(variant: str, x, y):
    """torch.matmul, with numpy's dtype promotion (torch refuses mixed
    dtypes)."""
    if variant != "nn" and (x.ndim < 2 or y.ndim < 2):
        raise ValueError(f"matmul_{variant} requires operands with ndim >= 2")
    dt = torch.promote_types(x.dtype, y.dtype)
    a, b = _oriented(variant, x.to(dt), y.to(dt))
    return torch.matmul(a, b)


def _operand(t):
    """Contiguous and 16-byte aligned, as the kernels load it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(variant: str, x, y):
    if y.device != x.device:
        raise TypeError(f"matmul_{variant}: operands on {x.device} and {y.device}")
    m, n, k = _mnk(variant, tuple(x.shape), tuple(y.shape))
    xc, yc = _operand(x), _operand(y)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.function("matmul")(
            *_build.ptrs(xc, yc, out), m, n, k, _VARIANTS[variant],
            _build.DTYPE_CODES[x.dtype], _build.stream())
    _build.check(err, f"matmul_{variant}")
    LAUNCHES[f"matmul_{variant}"] += 1
    return out


def _dispatch(variant: str, x, y):
    if not uses_kernel(variant, x.shape, y.shape, x.dtype, y.dtype):
        return _library(variant, x, y)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return _plain(variant, x, y)
    return _launch(variant, x, y)


def matmul(x, y):
    """x @ y."""
    return _dispatch("nn", x, y)


def matmul_nt(x, y):
    """x @ yᵀ over the last two axes, y read in its stored layout."""
    return _dispatch("nt", x, y)


def matmul_tn(x, y):
    """xᵀ @ y over the last two axes, x read in its stored layout."""
    return _dispatch("tn", x, y)
