"""The port's models: TransformerLM with its serving path (compiled decode,
the continuous-batching decode server) and its training path (the train
step, optimizers and losses)."""

from minidiff_tpu_torch.models.convert import params_from_jax
from minidiff_tpu_torch.models.decode import generate_compiled
from minidiff_tpu_torch.models.functional import cross_entropy
from minidiff_tpu_torch.models.mlp import make_train_step
from minidiff_tpu_torch.models.optim import SGD, Adam, AdamW
from minidiff_tpu_torch.models.server import DecodeServer
from minidiff_tpu_torch.models.transformer import TransformerLM, lm_loss

__all__ = ["SGD", "Adam", "AdamW", "DecodeServer", "TransformerLM",
           "cross_entropy", "generate_compiled", "lm_loss", "make_train_step",
           "params_from_jax"]
