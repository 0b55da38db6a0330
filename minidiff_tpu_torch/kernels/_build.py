"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source rebuilds and a stale library is never
loaded.  ``build_all()`` starts one nvcc per source at once and waits for
all of them.  The compiler's output (with
ptxas's register and shared-memory report) is kept beside each library as
``<name>-<hash>.log``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("layernorm", "flash_fwd", "flash_bwd", "xent", "matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the dtypes the kernels take, as their C entries' `dtype` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# C signatures: name -> (source, argtypes).  Every entry returns the
# cudaError_t of its launch as an int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "ln_fwd": ("layernorm", (_P, _P, _P, _P, _I, _I, _F, _I, _P)),
    "addln_fwd": ("layernorm", (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P)),
    "max_row_width": ("layernorm", (_I,)),
    "ln_bwd_blocks": ("layernorm", (_I, _I)),
    "ln_bwd": ("layernorm", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    "addln_bwd": ("layernorm",
                  (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    "flash_fwd": ("flash_fwd",
                  (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P)),
    "flash_bwd_dkv": ("flash_bwd", (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _F, _I, _I, _I, _P)),
    "flash_bwd_dq": ("flash_bwd", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _P)),
    "xent_fwd": ("xent", (_P, _P, _P, _I, _I, _I, _P)),
    "xent_bwd": ("xent", (_P, _P, _P, _P, _I, _I, _I, _P)),
    "matmul": ("matmul", (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
}

_libs: dict = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise KernelBuildError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; returns {name: path}."""
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            log = open(p.with_suffix(".log"), "w")
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for n, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, paths[n])  # atomic: readers never see half a file
            else:
                failed.append(n)
        if failed:
            logs = "\n".join(paths[n].with_suffix(".log").read_text()
                             for n in failed)
            raise KernelBuildError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas -v report) for the current build of ``name``."""
    return _lib_path(name).with_suffix(".log").read_text()


def _lib(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((source,))[source]))
        for fn, (src, argtypes) in SIGNATURES.items():
            if src == source:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[source] = lib
    return lib


def function(name: str):
    """The C entry ``name``, building and loading its library if needed."""
    return getattr(_lib(SIGNATURES[name][0]), name)


def ptrs(*tensors) -> list:
    """Each tensor's data pointer; the kernels take 16-byte aligned
    operands and raise on anything else."""
    out = []
    for t in tensors:
        p = t.data_ptr()
        if p % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
        out.append(p)
    return out


def stream() -> int:
    """The current CUDA stream, as the kernels' launch argument."""
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")
