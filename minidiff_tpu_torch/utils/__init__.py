from minidiff_tpu_torch.utils.gradcheck import (  # noqa: F401
    calculate_finite_differences,
    compute_grads,
)
