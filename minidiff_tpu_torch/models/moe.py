"""Mixture-of-Experts transformer LM on PyTorch.

Port of ``minidiff_tpu/models/moe.py``: ``MoEFeedForward`` (top-k routing
into per-expert capacity slots, the Switch load-balancing aux loss, the
stacked expert FFNs), ``MoETransformerBlock``, ``MoETransformerLM`` and
``make_moe_loss``.  Module attribute names follow the JAX parameter tree
(``blocks.0.moe.router.w``, ``blocks.0.moe.experts.w1``, ...), so
``params_from_jax(model.init())`` loads into the port, float or quantized.

Routing is the JAX package's static-shape arithmetic.  The top-k choice is
an iterated argmax (``torch.argmax`` takes the first maximal index, as
``jnp.argmax`` does, where ``torch.topk`` leaves the order of ties
unspecified), and every queue position, capacity test and slot id runs in
f32 whatever the model's dtype.  Capacity is per call: ``capacity(T)`` of
the tokens routed together.  Two dispatch routes give the same values:

* one-hot (``compute_routing``): (T, E, C) dispatch and combine masks
  contracted with the tokens and the expert outputs (the oracle);
* grouped (``dispatch_grouped`` / ``combine_grouped``): a token-for-slot
  table and row gathers, no dispatch FLOPs.  Kept slots are unique, so the
  table is one scatter of the kept tokens into a table filled with T (the
  appended zero row); the dropped tokens all land on the dump slot E*C,
  which is sliced off.

The experts are one batched product pair over the (E, C, d) slots:
``torch.matmul`` over a float bank (a 3-D product the JAX package leaves to
XLA), or ``dequant_matmul_bmm`` over an int8 bank (``models/quant.py``),
the ``dq_bmm`` kernel on the card.  The blocks keep the dense block's
serving contract (``ln1``, ``attn``, ``ln2``, ``parallel``,
``apply_mlp_normed``), so ``generate_compiled``, the decode servers and the
int8 KV cache run them with no MoE-specific code.  Sliding windows with
sinks are ported; packed sequences (which the JAX MoE model does not take)
raise ``NotImplementedError``, as does a train
step's ``rng`` (dropout).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from minidiff_tpu_torch.kernels.quant import dequant_matmul_bmm
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.layers import Linear, resolve_device, uniform
from minidiff_tpu_torch.models.transformer import (
    _LATER,
    MultiHeadAttention,
    _check_window,
    _make_norm,
    lm_loss,
)

__all__ = ["MoEFeedForward", "MoETransformerBlock", "MoETransformerLM",
           "make_moe_loss"]


def _later(option: str):
    return NotImplementedError(
        f"MoETransformerLM option {option!r} is not ported yet: it comes with "
        f"{_LATER}")


def _one_hot(idx, n: int):
    """(...,) -> (..., n) f32; an index outside [0, n) gives a zero row, as
    the JAX ``F.one_hot`` (an equality against ``arange``) does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


class Router(nn.Module):
    """The router's (d, E) weight.  Not a ``Linear``: it stays full
    precision under ``quantize_for_serving`` (int8 rounding there flips
    top-k choices)."""

    def __init__(self, dim: int, num_experts: int, *, dtype, device, generator):
        super().__init__()
        self.w = nn.Parameter(uniform((dim, num_experts), 1.0 / math.sqrt(dim),
                                      generator, dtype, device))


class Experts(nn.Module):
    """The stacked expert FFNs: w1 (E, d, w1_cols), w2 (E, ff, d), and the
    biases b1 (E, w1_cols), b2 (E, d) unless ``bias=False``.  A bank
    quantized for serving holds ``w1_q`` / ``w1_s`` / ``w2_q`` / ``w2_s``
    in place of ``w1`` / ``w2``."""

    def __init__(self, dim: int, num_experts: int, ff: int, w1_cols: int,
                 bias: bool, *, dtype, device, generator):
        super().__init__()
        e = num_experts
        self.w1 = nn.Parameter(uniform((e, dim, w1_cols), 1.0 / math.sqrt(dim),
                                       generator, dtype, device))
        self.w2 = nn.Parameter(uniform((e, ff, dim), 1.0 / math.sqrt(ff),
                                       generator, dtype, device))
        # zeros, as the JAX init
        self.b1 = (nn.Parameter(torch.zeros((e, w1_cols), dtype=dtype, device=device))
                   if bias else None)
        self.b2 = (nn.Parameter(torch.zeros((e, dim), dtype=dtype, device=device))
                   if bias else None)
        for name in ("w1_q", "w1_s", "w2_q", "w2_s"):
            self.register_buffer(name, None)

    def product(self, which: str, x):
        """x (E, C, K) through bank ``which`` ("w1" or "w2"), float or int8."""
        q = getattr(self, which + "_q")
        if q is not None:
            return dequant_matmul_bmm(x, q, getattr(self, which + "_s"))
        return torch.matmul(x, getattr(self, which))


class MoEFeedForward(nn.Module):
    """Top-k routed expert FFNs in place of a block's dense MLP.

    ``forward_with_aux`` returns ``(y, aux)``, aux the Switch load-balancing
    loss ``E * sum_e f_e * P_e`` (f_e the fraction of tokens whose first
    choice is e, P_e the mean router probability); ``forward`` drops aux.
    ``grouped=None`` takes the grouped route once E >= 8.
    """

    def __init__(self, dim: int, num_experts: int, mlp_ratio: int = 4,
                 k: int = 1, capacity_factor: float = 1.25, *, dtype,
                 device, generator, grouped=None, mlp: str = "gelu",
                 mlp_hidden=None, bias: bool = True,
                 renorm_gates: bool = False):
        super().__init__()
        if not 1 <= k <= num_experts:
            raise ValueError(f"k {k} must be in [1, num_experts {num_experts}]")
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(
                f"unknown expert mlp kind {mlp!r} (expected 'gelu'/'swiglu')")
        self.dim = dim
        self.num_experts = num_experts
        self.ff = mlp_hidden if mlp_hidden is not None else mlp_ratio * dim
        self.k = k
        self.capacity_factor = capacity_factor
        # swiglu: w1's columns are PAIR-major (ff, 2) gate/value pairs
        self.mlp = mlp
        self.renorm_gates = bool(renorm_gates)
        self.grouped = bool(num_experts >= 8) if grouped is None else bool(grouped)
        kw = dict(dtype=dtype, device=device, generator=generator)
        w1_cols = 2 * self.ff if mlp == "swiglu" else self.ff
        self.router = Router(dim, num_experts, **kw)
        self.experts = Experts(dim, num_experts, self.ff, w1_cols, bias, **kw)

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(self.capacity_factor * self.k * tokens
                                / self.num_experts))

    def _routing_choices(self, xt, c: int):
        """``(choices, aux)``: per top-k choice ``(idx (T,), oh (T, E) f32,
        gate (T, 1), pos_tok (T,) f32, keep (T,) f32)``, and the aux loss.
        The queue arithmetic runs in f32 (a bf16 cumsum stops counting
        exactly past 256)."""
        e = self.num_experts
        probs = F.softmax(xt @ self.router.w, dim=-1)  # (T, E)
        f32 = torch.float32
        remaining = probs
        counts = torch.zeros((1, e), dtype=f32, device=xt.device)
        choices = []
        first_choice = None
        for _ in range(self.k):
            idx = torch.argmax(remaining, dim=-1)
            oh = _one_hot(idx, e)
            if first_choice is None:
                first_choice = oh
            gate = (probs * oh.to(probs.dtype)).sum(dim=-1, keepdim=True)
            # each token's place in its expert's queue: the earlier tokens
            # routed there, plus the earlier choices' load
            pos = torch.cumsum(oh, dim=0) - oh + counts
            counts = counts + oh.sum(dim=0, keepdim=True)
            pos_tok = (pos * oh).sum(dim=-1)
            keep = (pos_tok < float(c)).to(f32)
            choices.append((idx, oh, gate, pos_tok, keep))
            remaining = remaining * (1 - oh.to(probs.dtype))
        if self.renorm_gates:
            # Mixtral: the k gates sum to 1, divided before the keep mask
            total = choices[0][2]
            for ch in choices[1:]:
                total = total + ch[2]
            choices = [(idx, oh, gate / total, pos_tok, keep)
                       for idx, oh, gate, pos_tok, keep in choices]
        frac = first_choice.mean(dim=0).to(probs.dtype)  # f_e
        mean_prob = probs.mean(dim=0)                      # P_e
        aux = (frac * mean_prob).sum() * float(e)
        return choices, aux

    def compute_routing(self, xt, c: int):
        """``(dispatch, combine, aux)``: the (T, E, C) one-hot dispatch mask
        (f32, no gradient), the gate-weighted combine weights (differentiable
        through the router softmax) and the aux loss."""
        t = xt.shape[0]
        choices, aux = self._routing_choices(xt, c)
        dispatch = combine = None
        for _, oh, gate, pos_tok, keep in choices:
            poh = _one_hot(pos_tok, c)  # (T, C); a dropped token's row is 0
            disp = oh[:, :, None] * poh[:, None, :] * keep.reshape(t, 1, 1)
            dispatch = disp if dispatch is None else dispatch + disp
            comb = disp.to(gate.dtype) * gate.reshape(t, 1, 1)
            combine = comb if combine is None else combine + comb
        return dispatch, combine, aux

    def compute_routing_sparse(self, xt, c: int):
        """``(choices, aux)`` with one ``(slot (T,) int64, gatekeep (T, 1))``
        pair per choice: slot = expert * C + queue position for a kept token,
        the dump slot E * C for a dropped one; gatekeep is the gate, zeroed
        for drops."""
        choices, aux = self._routing_choices(xt, c)
        dump = float(self.num_experts * c)
        out = []
        for idx, _, gate, pos_tok, keep in choices:
            slot = idx.to(torch.float32) * float(c) + pos_tok
            slot = torch.where(keep > 0.5, slot, torch.full_like(slot, dump))
            out.append((slot.to(torch.int64),
                        gate * keep.reshape(gate.shape).to(gate.dtype)))
        return out, aux

    def _experts_forward(self, expert_in):
        """(E, C, d) -> (E, C, d) through the stacked experts."""
        ex = self.experts
        h = ex.product("w1", expert_in)
        if ex.b1 is not None:
            h = h + ex.b1[:, None, :]
        if self.mlp == "swiglu":
            hp = h.reshape(h.shape[:-1] + (self.ff, 2))
            h = F.silu(hp[..., 0]) * hp[..., 1]
        else:
            h = F.gelu(h)
        out = ex.product("w2", h)
        if ex.b2 is not None:
            out = out + ex.b2[:, None, :]
        return out

    def dispatch_grouped(self, xt, c: int):
        """``(expert_in (E, C, d), choices, aux)`` by one row gather through
        the token-for-slot table (T: the appended zero row of an empty
        slot)."""
        t, d = xt.shape
        e = self.num_experts
        choices, aux = self.compute_routing_sparse(xt, c)
        tfs = torch.full((e * c + 1,), t, dtype=torch.int64, device=xt.device)
        tok_ids = torch.arange(t, device=xt.device)
        for slot, _ in choices:
            # kept slots are unique; only the dump slot sees repeats
            tfs[slot] = tok_ids
        xz = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
        return xz[tfs[:e * c]].reshape(e, c, d), choices, aux

    @staticmethod
    def combine_grouped(choices, out):
        """One gather of the expert outputs per choice, weighted by its gate."""
        e, c, d = out.shape
        out_flat = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))], dim=0)
        y = None
        for slot, gatekeep in choices:
            contrib = out_flat[slot] * gatekeep.to(out.dtype)
            y = contrib if y is None else y + contrib
        return y

    def forward_with_aux(self, x):
        b, s, d = x.shape
        t = b * s
        c = self.capacity(t)
        xt = x.reshape(t, d)
        if self.grouped:
            expert_in, choices, aux = self.dispatch_grouped(xt, c)
            y = self.combine_grouped(choices, self._experts_forward(expert_in))
            return y.reshape(b, s, d), aux
        dispatch, combine, aux = self.compute_routing(xt, c)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xt)
        out = self._experts_forward(expert_in)
        y = torch.einsum("tec,ecd->td", combine, out)
        return y.reshape(b, s, d), aux

    def forward(self, x):
        return self.forward_with_aux(x)[0]


class MoETransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(ln1(x)); x + MoE(ln2(x)), with the dense
    block's serving contract (``ln1``, ``attn``, ``ln2``, ``parallel``,
    ``apply_mlp_normed``)."""

    def __init__(self, dim: int, num_heads: int, num_experts: int,
                 mlp_ratio: int = 4, k: int = 1, capacity_factor: float = 1.25,
                 *, dtype, device, generator, grouped=None, norm: str = "layer",
                 norm_eps=None, num_kv_heads=None, rope: bool = False,
                 rope_base: float = 10000.0, attn_bias: bool = False,
                 mlp: str = "gelu", mlp_hidden=None, mlp_bias: bool = True,
                 renorm_gates: bool = False, window=None, sinks: int = 0):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = _make_norm(norm, dim, norm_eps, **kw)
        self.attn = MultiHeadAttention(
            dim, num_heads, generator=generator, num_kv_heads=num_kv_heads,
            rope=rope, rope_base=rope_base, bias=attn_bias, window=window,
            sinks=sinks, **kw)
        self.ln2 = _make_norm(norm, dim, norm_eps, **kw)
        self.parallel = False
        self.moe = MoEFeedForward(
            dim, num_experts, mlp_ratio, k, capacity_factor, generator=generator,
            grouped=grouped, mlp=mlp, mlp_hidden=mlp_hidden, bias=mlp_bias,
            renorm_gates=renorm_gates, **kw)

    def apply_mlp_normed(self, z):
        """The MoE branch on an already-normed input (aux dropped): the
        ``block_finish`` entry of the serving paths."""
        return self.moe(z)

    def forward_with_aux(self, x):
        a = self.attn(self.ln1(x))
        t, z = F.residual_norm(self.ln2, x, a)
        y, aux = self.moe.forward_with_aux(z)
        return t + y, aux

    def forward(self, x):
        return self.forward_with_aux(x)[0]


class MoETransformerLM(nn.Module):
    """Decoder-only LM with MoE feed-forward blocks.

    ``forward`` returns logits (the decode paths' contract);
    ``forward_with_aux`` returns (logits, the blocks' summed aux) for
    training with ``make_moe_loss``: ``make_train_step(model, opt,
    loss_fn=make_moe_loss(0.01), apply_fn=model.forward_with_aux)``.
    Weights are drawn from a CPU ``torch.Generator`` seeded with ``seed``,
    as ``TransformerLM`` draws them, then placed on ``device``.
    """

    def __init__(self, vocab_size: int = 256, dim: int = 128,
                 num_heads: int = 4, num_layers: int = 2, num_experts: int = 4,
                 max_seq_len: int = 256, mlp_ratio: int = 4, k: int = 1,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0, grouped=None, norm: str = "layer",
                 norm_eps=None, num_kv_heads=None, rope: bool = False,
                 rope_base: float = 10000.0, window=None, sinks: int = 0,
                 attn_bias: bool = False, mlp: str = "gelu", mlp_hidden=None,
                 mlp_bias: bool = True, renorm_gates: bool = False):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.num_experts = num_experts
        self.dtype = dtype
        # the serving paths read these off the model, as for TransformerLM
        self.rope = rope
        self.window, self.sinks = _check_window(window, sinks)
        self.tie_embeddings = False
        scale = 1.0 / math.sqrt(dim)

        def normal(shape):
            w = torch.randn(shape, generator=gen, dtype=torch.float64).mul_(scale)
            return nn.Parameter(w.to(device=dev, dtype=dtype))

        self.tok_emb = normal((vocab_size, dim))
        self.blocks = nn.ModuleList(
            MoETransformerBlock(
                dim, num_heads, num_experts, mlp_ratio, k, capacity_factor,
                dtype=dtype, device=dev, generator=gen, grouped=grouped,
                norm=norm, norm_eps=norm_eps, num_kv_heads=num_kv_heads,
                rope=rope, rope_base=rope_base, attn_bias=attn_bias, mlp=mlp,
                mlp_hidden=mlp_hidden, mlp_bias=mlp_bias,
                renorm_gates=renorm_gates, window=window, sinks=sinks)
            for _ in range(num_layers))
        self.ln_f = _make_norm(norm, dim, norm_eps, dtype=dtype, device=dev)
        self.head = Linear(dim, vocab_size, bias=False, dtype=dtype, device=dev,
                           generator=gen)
        if not rope:
            self.pos_emb = normal((max_seq_len, dim))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def lm_head(self, x):
        """Hidden states (..., d) -> vocab logits (..., V)."""
        return self.head(x)

    def forward_with_aux(self, tokens, segment_ids=None, positions=None):
        """tokens (B, S) int -> (logits (B, S, V), aux summed over blocks)."""
        if segment_ids is not None or positions is not None:
            raise _later("segment_ids / positions (packed sequences; the JAX "
                         "MoE model takes neither)")
        _, s = tokens.shape
        x = self.tok_emb[tokens]
        if not self.rope:
            x = x + self.pos_emb[:s]
        aux_total = None
        for blk in self.blocks:
            x, aux = blk.forward_with_aux(x)
            aux_total = aux if aux_total is None else aux_total + aux
        return self.lm_head(self.ln_f(x)), aux_total

    def forward(self, tokens, segment_ids=None, positions=None):
        return self.forward_with_aux(tokens, segment_ids, positions)[0]


def make_moe_loss(aux_coef: float = 0.01):
    """``loss(output, targets)`` for ``forward_with_aux``'s (logits, aux):
    ``lm_loss(logits, targets) + aux_coef * aux``."""

    def loss(output, targets):
        logits, aux = output
        return lm_loss(logits, targets) + aux.to(logits.dtype) * aux_coef

    return loss
