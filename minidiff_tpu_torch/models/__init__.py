"""The serving path's models: TransformerLM, compiled decode and the
continuous-batching decode server."""

from minidiff_tpu_torch.models.convert import params_from_jax
from minidiff_tpu_torch.models.decode import generate_compiled
from minidiff_tpu_torch.models.server import DecodeServer
from minidiff_tpu_torch.models.transformer import TransformerLM

__all__ = ["DecodeServer", "TransformerLM", "generate_compiled",
           "params_from_jax"]
