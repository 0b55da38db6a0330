"""minidiff_tpu_torch: the PyTorch and CUDA port of minidiff_tpu for the H100.

Seven slices are ported.  The tape engine: ``Tensor`` / ``backward()`` with
its three cleanup modes, higher-order sweeps and ``reuse_graph``, the op
registry and its VJPs, ``value_and_grad`` / ``grad`` / ``vjp`` / ``jvp`` /
``hvp`` / ``hessian``, ``jit`` (a tape program captured as a CUDA graph)
and the gradcheck oracle (``minidiff_tpu_torch.utils``),
over two array backends, ``"cuda"`` (the default) and ``"cpu"``
(``md.use_backend("cpu")``).  Serving: ``TransformerLM``,
``generate_compiled`` (with an int8 KV cache, ``kv_quant=True``), the
continuous-batching ``DecodeServer`` and the paged ``PagedDecodeServer``, and
int8 / int4 weight-only serving (``quantize_for_serving``), for the
flagship options and the LLaMA-style ones (RMSNorm, RoPE, grouped-query
attention, gated MLPs, parallel blocks, biases, tied embeddings).  The
Mamba family: ``MambaLM``, ``generate_compiled_ssm`` and
``SSMDecodeServer``, and the tape's ``linear_scan``.  Mixture-of-Experts:
``MoETransformerLM`` (one-hot or grouped top-k routing) serving over bf16 or
int8 expert banks through the same decode paths, its train step
(``make_moe_loss``, ``make_train_step(..., apply_fn=...)``), and the tape's
``dequant_matmul_bmm``.
Training: ``make_train_step`` with ``SGD``, ``Adam`` and ``AdamW``,
``lm_loss`` and ``cross_entropy``, differentiated by PyTorch's autograd,
each step one CUDA graph replay (``jit=True``, the default), and packed
pretraining (``models.pack``: ``pack_documents``,
``make_packed_train_step``).  Sliding-window attention with attention
sinks (``TransformerLM(window=, sinks=)``) trains and serves on every
path, and the tape's ``sdpa`` takes the JAX op's masks.
Hand-written sm_90a CUDA kernels (``minidiff_tpu_torch.kernels``) carry the
tape's large 2-D matrix products, LayerNorm, RMSNorm and their fused
residual-add forms, flash attention, softmax cross-entropy, the int8 and int4 dequant-matmuls,
the batched int8 dequant-matmul of an expert bank, attention over an int8 KV
cache, paged decode attention and the linear scan.  Entry points
run on the GPU unless the caller asks for the CPU, where every kernel runs
its plain PyTorch version.
The package imports neither JAX nor ``minidiff_tpu``.

    import minidiff_tpu_torch as md

    x = md.Tensor([[0, 2, -2, 1], [-1, -1, -2, -2]], allow_grad=True)
    y = md.Tensor([[2, 3, 4, 5], [0, -1, -3, 2]], allow_grad=True)
    f = 2 * y * md.sin(x) - x ** 2
    f.backward(allow_higher_order=True)
    x.grad.backward()          # second order
"""

from __future__ import annotations

from minidiff_tpu_torch import backend  # noqa: F401  (before ops and tensor)
from minidiff_tpu_torch.ops.definitions import *  # noqa: F401,F403
from minidiff_tpu_torch.tensor import *  # noqa: F401,F403
from minidiff_tpu_torch.tape import OpNode  # noqa: F401
from minidiff_tpu_torch.caching import (  # noqa: F401
    backward_indices_for_root,
    currently_caching,
    reuse_graph,
)
from minidiff_tpu_torch.func import (  # noqa: F401
    grad,
    hessian,
    hvp,
    jit,
    jvp,
    value_and_grad,
    vjp,
)
from minidiff_tpu_torch.backend import (  # noqa: F401
    available_backends,
    backend_name,
    set_backend,
    use_backend,
)
from minidiff_tpu_torch.models import (  # noqa: F401
    SGD,
    Adam,
    AdamW,
    DecodeServer,
    MambaLM,
    MoETransformerLM,
    PagedDecodeServer,
    SSMDecodeServer,
    TransformerLM,
    cross_entropy,
    generate_compiled,
    generate_compiled_ssm,
    lm_loss,
    make_moe_loss,
    make_train_step,
    params_from_jax,
    quantize_for_serving,
    quantized_bytes,
)
