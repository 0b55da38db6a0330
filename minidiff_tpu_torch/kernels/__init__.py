"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  A wrapper given a CPU tensor runs the plain version; given
a CUDA tensor it launches its kernel or raises.  Each op the models
differentiate with torch's autograd is a ``torch.autograd.Function`` whose
backward is a kernel too, with the same wiring on both devices; the matmul
kernels serve the tape engine, which supplies their VJPs.  The kernels are
built from ``csrc/`` with nvcc at first launch (see ``_build``).

The launch counts are host counters that a wrapper bumps where it launches
its kernel.  A CUDA graph replays kernels without calling their wrappers,
so a captured program (``models/capture.py``) records the launches its
capture made and credits them once per replay: a replayed kernel counts as
a launch."""

from __future__ import annotations

from minidiff_tpu_torch.kernels import (attention, layernorm, matmul, paged,
                                        quant, scan, xent)

__all__ = ["attention", "credit_launches", "launch_counts", "layernorm", "matmul", "paged",
           "quant", "reset_launch_counts", "scan", "xent"]

_COUNTERS = (layernorm.LAUNCHES, attention.LAUNCHES, xent.LAUNCHES,
             matmul.LAUNCHES, quant.LAUNCHES, paged.LAUNCHES, scan.LAUNCHES)


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


def credit_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` ({kernel name: launches}) to the counters;
    a negative ``times`` takes them back."""
    for name, n in counts.items():
        for c in _COUNTERS:
            if name in c:
                c[name] += n * times
                break
        else:
            raise KeyError(f"no launch counter named {name!r}")
