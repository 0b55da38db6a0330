from minidiff_tpu_torch.ops.definitions import *  # noqa: F401,F403
from minidiff_tpu_torch.ops.wrapping import *  # noqa: F401,F403
