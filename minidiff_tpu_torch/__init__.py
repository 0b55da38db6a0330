"""minidiff_tpu_torch: the PyTorch and CUDA port of minidiff_tpu for the H100.

Three slices are ported.  The tape engine: ``Tensor`` / ``backward()`` with
its three cleanup modes, higher-order sweeps and ``reuse_graph``, the op
registry and its VJPs, ``value_and_grad`` / ``grad`` / ``vjp`` / ``jvp`` /
``hvp`` / ``hessian`` and the gradcheck oracle (``minidiff_tpu_torch.utils``),
over two array backends, ``"cuda"`` (the default) and ``"cpu"``
(``md.use_backend("cpu")``).  Serving: ``TransformerLM``,
``generate_compiled`` and the continuous-batching ``DecodeServer``.
Training: ``make_train_step`` with ``SGD``, ``Adam`` and ``AdamW``,
``lm_loss`` and ``cross_entropy``, differentiated by PyTorch's autograd.
Hand-written sm_90a CUDA kernels (``minidiff_tpu_torch.kernels``) carry the
tape's large 2-D matrix products, LayerNorm, fused add+LayerNorm, flash
attention and softmax cross-entropy.  Entry points run on the GPU unless the
caller asks for the CPU, where every kernel runs its plain PyTorch version.
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
    TransformerLM,
    cross_entropy,
    generate_compiled,
    lm_loss,
    make_train_step,
    params_from_jax,
)
