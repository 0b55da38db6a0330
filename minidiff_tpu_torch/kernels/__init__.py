"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  A wrapper given a CPU tensor runs the plain version; given
a CUDA tensor it launches its kernel or raises.  Each op the models
differentiate with torch's autograd is a ``torch.autograd.Function`` whose
backward is a kernel too, with the same wiring on both devices; the matmul
kernels serve the tape engine, which supplies their VJPs.  The kernels are
built from ``csrc/`` with nvcc at first launch (see ``_build``)."""

from __future__ import annotations

from minidiff_tpu_torch.kernels import attention, layernorm, matmul, xent

__all__ = ["attention", "launch_counts", "layernorm", "matmul",
           "reset_launch_counts", "xent"]

_COUNTERS = (layernorm.LAUNCHES, attention.LAUNCHES, xent.LAUNCHES,
             matmul.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
