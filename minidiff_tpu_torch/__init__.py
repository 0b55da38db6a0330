"""minidiff_tpu_torch: the PyTorch and CUDA port of minidiff_tpu for the H100.

Two slices are ported.  Serving: ``TransformerLM``, ``generate_compiled``
and the continuous-batching ``DecodeServer``.  Training: ``make_train_step``
with the ``SGD``, ``Adam`` and ``AdamW`` update rules, ``lm_loss`` and
``cross_entropy``, differentiated by PyTorch's autograd.  Hand-written
sm_90a CUDA kernels (``minidiff_tpu_torch.kernels``) carry LayerNorm, fused
add+LayerNorm, flash attention and softmax cross-entropy, forward and
backward.  Entry points run on ``device="cuda"`` unless the caller asks for
the CPU, where every kernel runs its plain PyTorch version.  The package
imports neither JAX nor ``minidiff_tpu``.
"""

from minidiff_tpu_torch.models import (
    SGD,
    Adam,
    AdamW,
    DecodeServer,
    TransformerLM,
    cross_entropy,
    generate_compiled,
    lm_loss,
    make_train_step,
    params_from_jax,
)

__all__ = ["SGD", "Adam", "AdamW", "DecodeServer", "TransformerLM",
           "cross_entropy", "generate_compiled", "lm_loss", "make_train_step",
           "params_from_jax"]
