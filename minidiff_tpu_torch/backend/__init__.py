"""The port's array backends and their runtime selector.

Two backends implement one interface (``torch_backend.TorchBackend``), each
bound to a ``torch.device``: ``"cuda"``, the default, and ``"cpu"``.  Every
other layer calls this module's attributes (``backend.add(a, b)``), which
resolve against the *active* backend, as in the JAX package's
``minidiff_tpu/backend/__init__.py``.

* ``set_backend(name)`` / ``use_backend(name)`` (a context manager) select one.
* Asking for ``"cuda"`` on a machine without a GPU raises at first use, not at
  import: the package imports anywhere.
"""

from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from typing import Any, Iterator

_NAMES = ("cpu", "cuda")
_backends: dict = {}
_active = ["cuda"]
# bumped on every switch; ops.wrapping.backend_fn caches its lookup per epoch
_epoch = [0]


def available_backends() -> list:
    return list(_NAMES)


def set_backend(name: str) -> None:
    """Select the active backend: ``"cuda"`` or ``"cpu"``."""
    if name not in _NAMES:
        raise ValueError(f"unknown backend {name!r}; available: {list(_NAMES)}")
    _active[0] = name
    _epoch[0] += 1


def epoch() -> int:
    return _epoch[0]


def backend_name() -> str:
    return _active[0]


def get_backend() -> Any:
    name = _active[0]
    b = _backends.get(name)
    if b is None:
        if name == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                'minidiff_tpu_torch: the default backend is "cuda" and this '
                'machine has no CUDA device; call md.use_backend("cpu") (or '
                'md.set_backend("cpu")) to run the tape on the CPU')
        from minidiff_tpu_torch.backend.torch_backend import TorchBackend

        b = _backends[name] = TorchBackend(torch.device(name))
    return b


@contextlib.contextmanager
def use_backend(name: str) -> Iterator[None]:
    """Switch the active backend inside the context."""
    prev = _active[0]
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


def __getattr__(name: str) -> Any:
    if name.startswith("__") or name == "torch_backend":
        raise AttributeError(name)
    return getattr(get_backend(), name)
