"""The port's models: TransformerLM (the flagship and the LLaMA-style
options) with its serving path (compiled decode,
the continuous-batching decode server, the paged server, int8 / int4
weight-only quantization and the int8 KV cache) and its training path (the
train step, optimizers and losses), the Mamba family (MambaLM, its
compiled decode and the SSM decode server), and the Mixture-of-Experts
family (MoETransformerLM over float or int8 expert banks, make_moe_loss),
and packed pretraining (pack_documents, segment_positions,
make_packed_train_step)."""

from minidiff_tpu_torch.models.convert import params_from_jax
from minidiff_tpu_torch.models.decode import generate_compiled
from minidiff_tpu_torch.models.functional import cross_entropy
from minidiff_tpu_torch.models.mlp import make_train_step
from minidiff_tpu_torch.models.moe import (
    MoEFeedForward,
    MoETransformerBlock,
    MoETransformerLM,
    make_moe_loss,
)
from minidiff_tpu_torch.models.optim import SGD, Adam, AdamW
from minidiff_tpu_torch.models.pack import (
    make_packed_train_step,
    pack_documents,
    segment_positions,
)
from minidiff_tpu_torch.models.paged import PagedDecodeServer
from minidiff_tpu_torch.models.quant import quantize_for_serving, quantized_bytes
from minidiff_tpu_torch.models.server import DecodeServer, SSMDecodeServer
from minidiff_tpu_torch.models.ssm import MambaBlock, MambaLM, generate_compiled_ssm
from minidiff_tpu_torch.models.transformer import TransformerLM, lm_loss

__all__ = ["SGD", "Adam", "AdamW", "DecodeServer", "MambaBlock", "MambaLM",
           "MoEFeedForward", "MoETransformerBlock", "MoETransformerLM",
           "PagedDecodeServer", "SSMDecodeServer", "TransformerLM",
           "cross_entropy", "generate_compiled", "generate_compiled_ssm",
           "lm_loss", "make_moe_loss", "make_packed_train_step", "make_train_step",
           "pack_documents", "params_from_jax", "quantize_for_serving",
           "quantized_bytes", "segment_positions"]
