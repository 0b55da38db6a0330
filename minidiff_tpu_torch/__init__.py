"""minidiff_tpu_torch: the PyTorch and CUDA port of minidiff_tpu for the H100.

This slice ports the TransformerLM serving path: ``TransformerLM``,
``generate_compiled`` and the continuous-batching ``DecodeServer``, with
hand-written sm_90a CUDA kernels for LayerNorm, fused add+LayerNorm and the
flash-attention forward (``minidiff_tpu_torch.kernels``).  Entry points run
on ``device="cuda"`` unless the caller asks for the CPU, where every kernel
runs its plain PyTorch version.  The package imports neither JAX nor
``minidiff_tpu``.
"""

from minidiff_tpu_torch.models import (
    DecodeServer,
    TransformerLM,
    generate_compiled,
    params_from_jax,
)

__all__ = ["DecodeServer", "TransformerLM", "generate_compiled",
           "params_from_jax"]
