"""Selective state-space models (Mamba-style) on PyTorch.

Port of ``minidiff_tpu/models/ssm.py``: ``softplus``, ``MambaBlock``,
``MambaLM``, ``ssm_decode_program`` and ``generate_compiled_ssm``.  The sequence mixer is a
per-channel linear recurrence ``h_t = Abar_t * h_{t-1} + Bbar_t x_t`` whose
decay and input maps are functions of the input; the whole prompt or
training sequence runs it as one ``linear_scan`` (the ``scan`` kernel on the
card, ``kernels/scan.py``), whose backward is the same kernel run in
reverse.  Decoding carries an O(1) state per block: the hidden ``h`` (B,
d_inner, n) and the last K-1 conv inputs (B, K-1, d_inner).

Module attribute names follow the JAX parameter tree (``in_proj.w``,
``conv_w``, ``conv_b``, ``x_proj.w``, ``dt_proj.w`` / ``.b``, ``A_log``,
``D``, ``out_proj.w``; ``tok_emb``, ``norms.i.g``, ``ln_f.g``), so
``params_from_jax(model.init())`` loads into the port unchanged.  The norms
are the port's ``RMSNorm`` (the RMSNorm kernels), and the loss of a train
step the cross-entropy kernels.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels.scan import linear_scan
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.capture import DecodeLoop, cached_program, weights_key
from minidiff_tpu_torch.models.layers import Linear, check_device, resolve_device
from minidiff_tpu_torch.models.transformer import RMSNorm

__all__ = ["MambaBlock", "MambaLM", "generate_compiled_ssm", "softplus",
           "ssm_decode_program"]


def softplus(x):
    """log(1 + exp(x)), overflow-safe: max(x, 0) + log(1 + exp(-|x|)), the
    JAX package's formula (``F.softplus`` switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log(1.0 + torch.exp(-torch.abs(x)))


class MambaBlock(nn.Module):
    """One selective-SSM mixer: in-proj -> causal depthwise conv -> SSM scan
    -> gate -> out-proj.  d_inner = expand * dim, state size n = d_state per
    channel, dt bottleneck dt_rank (ceil(dim / 16) by default)."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank=None, *, dtype, device,
                 generator: torch.Generator):
        super().__init__()
        self.dim = dim
        self.d_state = d_state
        self.d_conv = d_conv
        self.d_inner = di = expand * dim
        self.dt_rank = dt_rank if dt_rank is not None else max(1, math.ceil(dim / 16))
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_proj = Linear(dim, 2 * di, bias=False, **kw)
        self.x_proj = Linear(di, self.dt_rank + 2 * d_state, bias=False, **kw)
        self.dt_proj = Linear(self.dt_rank, di, bias=True, **kw)
        self.out_proj = Linear(di, dim, bias=False, **kw)

        def param(w):
            return nn.Parameter(w.to(device=device, dtype=dtype))

        # A = -(1..n) per channel (the S4D-real spectrum)
        self.A_log = param(torch.log(torch.arange(1, d_state + 1, dtype=torch.float64)
                                     ).repeat(di, 1))
        self.conv_w = param((torch.rand((d_conv, di), generator=generator,
                                        dtype=torch.float64) * 2 - 1)
                            / math.sqrt(d_conv))
        self.conv_b = param(torch.zeros(di, dtype=torch.float64))
        self.D = param(torch.ones(di, dtype=torch.float64))
        # dt bias: softplus(b) log-uniform over [1e-3, 1e-1] (Mamba's dt_init)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(torch.rand(di, generator=generator, dtype=torch.float64)
                       * (hi - lo) + lo)
        self.dt_proj.b = param(dt + torch.log(-torch.expm1(-dt)))

    def _causal_conv(self, x):
        """Depthwise causal conv over the sequence, y_t = sum_j w_j
        x_{t-(K-1)+j}: K shifted adds, as the JAX block writes it."""
        s = x.shape[1]
        k = self.d_conv
        out = x * self.conv_w[k - 1]
        for j in range(k - 1):
            shift = k - 1 - j  # how far back this tap reaches
            if shift >= s:
                continue
            shifted = torch.cat([torch.zeros_like(x[:, :shift]), x[:, :s - shift]], dim=1)
            out = out + shifted * self.conv_w[j]
        return out + self.conv_b

    def _dtbc(self, x):
        """Input-dependent dt (..., di) and B, C (..., n), shared by the
        parallel forward and the recurrent step."""
        dtr, n = self.dt_rank, self.d_state
        proj = self.x_proj(x)
        dt = softplus(self.dt_proj(proj[..., :dtr]))
        return dt, proj[..., dtr:dtr + n], proj[..., dtr + n:]

    def forward(self, u):
        """(b, s, dim) -> (b, s, dim)."""
        return self._forward(u, collect_state=False)[0]

    def apply_with_state(self, u, lengths=None):
        """The parallel forward and the decode state after the last position
        (the prefill).  ``lengths`` (b,) makes the batch ragged: each row's
        state reflects exactly its first ``lengths[b]`` positions (pad steps
        are identities in the scan, and the conv window gathers the row's
        own last K-1 inputs)."""
        return self._forward(u, collect_state=True, lengths=lengths)

    def _forward(self, u, collect_state: bool, lengths=None):
        b, s, _ = u.shape
        di, n, k = self.d_inner, self.d_state, self.d_conv
        # in_proj columns are pair-major (x_j, z_j), as the JAX tree stores them
        xz = self.in_proj(u).reshape(b, s, di, 2)
        x_raw, z = xz[..., 0], xz[..., 1]
        x = F.silu(self._causal_conv(x_raw))
        dt, B, C = self._dtbc(x)
        if lengths is not None:
            # pad steps: dt = 0, so abar = 1 and the input term vanishes
            valid = (torch.arange(s, device=u.device)[None, :]
                     < lengths.reshape(b, 1)).to(dt.dtype)
            dt = dt * valid[..., None]
        A = -torch.exp(self.A_log)                              # (di, n)
        abar = torch.exp(dt[..., None] * A)                     # (b, s, di, n)
        bx = (dt * x)[..., None] * B[:, :, None, :]
        h = linear_scan(abar, bx, axis=1)
        y = (h * C[:, :, None, :]).sum(dim=-1) + x * self.D
        out = self.out_proj(y * F.silu(z))
        if not collect_state:
            return out, None
        state = {"h": h[:, -1]}
        if lengths is not None:
            # each row's window: positions lengths - (K-1) + j, zero where
            # they fall before the prompt (as init_state)
            pos = lengths.reshape(b, 1) - (k - 1) + torch.arange(k - 1, device=u.device)
            rows = x_raw[torch.arange(b, device=u.device)[:, None], pos.clamp(min=0)]
            state["conv"] = rows * (pos >= 0).to(x_raw.dtype)[..., None]
            return out, state
        take = min(k - 1, s)
        state["conv"] = torch.cat([torch.zeros_like(x_raw[:, :1]).expand(b, k - 1 - take, di),
                                   x_raw[:, s - take:]], dim=1)
        return out, state

    def init_state(self, batch: int):
        """Zero decode state: h (batch, d_inner, n) and the conv window
        (batch, K-1, d_inner), in the block's dtype and device."""
        w = self.conv_w
        return {"h": w.new_zeros((batch, self.d_inner, self.d_state)),
                "conv": w.new_zeros((batch, self.d_conv - 1, self.d_inner))}

    def step(self, state, u_t):
        """One token: u_t (b, dim) and the state -> (y_t (b, dim), the new
        state).  The ``forward`` math at one position: the conv window comes
        from the state and the scan is one update h = abar * h + bx."""
        b = u_t.shape[0]
        di, k = self.d_inner, self.d_conv
        xz = self.in_proj(u_t).reshape(b, di, 2)
        x_raw, z = xz[..., 0], xz[..., 1]
        conv = x_raw * self.conv_w[k - 1]
        for j in range(k - 1):
            conv = conv + state["conv"][:, j] * self.conv_w[j]
        x = F.silu(conv + self.conv_b)
        dt, B, C = self._dtbc(x)
        A = -torch.exp(self.A_log)
        abar = torch.exp(dt[..., None] * A)
        h = abar * state["h"] + (dt * x)[..., None] * B[:, None, :]
        y = (h * C[:, None, :]).sum(dim=-1) + x * self.D
        new_conv = (torch.cat([state["conv"][:, 1:], x_raw[:, None]], dim=1)
                    if k > 1 else state["conv"])  # K = 1: no history
        return self.out_proj(y * F.silu(z)), {"h": h, "conv": new_conv}


class MambaLM(nn.Module):
    """Decoder-only SSM LM: token embedding, pre-RMSNorm Mamba blocks with
    residuals, a final RMSNorm and the (tied) vocabulary head.  The same
    contract as ``TransformerLM``: ``forward(tokens)`` gives logits for
    ``lm_loss`` and ``make_train_step``.

    Weights are drawn one tensor at a time from a CPU ``torch.Generator``
    seeded with ``seed`` (the same weights on every device), then placed on
    ``device``.  Load a JAX checkpoint with
    ``model.load_state_dict(params_from_jax(tree))``.
    """

    def __init__(self, vocab_size: int = 256, dim: int = 128,
                 num_layers: int = 2, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, tie_embeddings: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.dim = dim
        self.dtype = dtype
        self.tie_embeddings = tie_embeddings
        tok = torch.randn((vocab_size, dim), generator=gen, dtype=torch.float64)
        self.tok_emb = nn.Parameter(tok.mul_(1.0 / math.sqrt(dim)).to(device=dev, dtype=dtype))
        self.blocks = nn.ModuleList(
            MambaBlock(dim, d_state=d_state, d_conv=d_conv, expand=expand,
                       dtype=dtype, device=dev, generator=gen)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(RMSNorm(dim, dtype=dtype, device=dev)
                                   for _ in range(num_layers))
        self.ln_f = RMSNorm(dim, dtype=dtype, device=dev)
        if not tie_embeddings:
            self.head = Linear(dim, vocab_size, bias=False, dtype=dtype,
                               device=dev, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def lm_head(self, x):
        """Hidden states (..., d) -> vocab logits (..., V)."""
        if self.tie_embeddings:
            return x @ self.tok_emb.T
        return self.head(x)

    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, V)."""
        x = self.tok_emb[tokens]
        for blk, nm in zip(self.blocks, self.norms):
            x = x + blk(nm(x))
        return self.lm_head(self.ln_f(x))

    def init_state(self, batch: int):
        return [blk.init_state(batch) for blk in self.blocks]

    def step(self, state, tokens_t):
        """One decode step: tokens_t (B,) int -> (logits (B, V), state)."""
        x = self.tok_emb[tokens_t]
        new_states = []
        for blk, nm, st in zip(self.blocks, self.norms, state):
            y, st2 = blk.step(st, nm(x))
            x = x + y
            new_states.append(st2)
        return self.lm_head(self.ln_f(x)), new_states

    def prefill(self, tokens, lengths=None):
        """The whole prompt in one parallel pass: tokens (B, S) -> (logits
        (B, V) at the last position, decode states).  ``lengths`` (B,) serves
        a ragged batch right-padded to S: each row's logits come from its
        position ``lengths[b] - 1`` and its state from its own positions."""
        b = tokens.shape[0]
        x = self.tok_emb[tokens]
        states = []
        for blk, nm in zip(self.blocks, self.norms):
            y, st = blk.apply_with_state(nm(x), lengths=lengths)
            x = x + y
            states.append(st)
        if lengths is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(b, device=x.device), lengths.to(torch.long) - 1]
        return self.lm_head(self.ln_f(last)), states

    def generate(self, prompt, new_tokens: int):
        """Greedy decode through ``step`` alone (the prompt token by token):
        prompt (B, S) int -> (B, S + new_tokens)."""
        with torch.inference_mode():
            prompt = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
            b, s = prompt.shape
            state = self.init_state(b)
            logits = None
            for t in range(s):
                logits, state = self.step(state, prompt[:, t])
            out = [prompt]
            for _ in range(new_tokens):
                tok = torch.argmax(logits, dim=-1)
                out.append(tok[:, None])
                logits, state = self.step(state, tok)
            return torch.cat(out, dim=1)


# program key -> DecodeLoop, LRU-bounded as the JAX package's cache
_SSM_DECODE_CACHE_MAX = 32
_ssm_decode_cache: "OrderedDict" = OrderedDict()


def ssm_decode_program(model, prompt, max_new_tokens: int, greedy: bool = True,
                       temperature: float = 1.0, top_k=None, device="cuda"):
    """The captured ``(prompt, seed) -> (B, S0 + max_new_tokens)`` program
    behind ``generate_compiled_ssm`` for ``prompt``'s shape, cached per
    (model, batch, prompt length, new tokens, sampling config, prompt dtype)
    as the JAX package keys it, and per device, library epoch and weight
    storage.  Its static state is ``model.init_state(B)``: the prefill
    copies its states in, and the captured ``MambaLM.step`` updates them in
    place."""
    dev = check_device(model, device)
    prompt = torch.as_tensor(prompt)
    b, s0 = prompt.shape
    if s0 < 1 or max_new_tokens < 1:
        raise ValueError("generate_compiled_ssm needs a non-empty prompt and "
                         "max_new_tokens >= 1")
    key = (id(model), b, s0, max_new_tokens, greedy, float(temperature), top_k,
           str(prompt.dtype), str(dev), _build.epoch(), weights_key(model))

    def build():
        states = model.init_state(b)
        rows = torch.arange(b, device=dev)

        def keep(new_states):
            for st, nw in zip(states, new_states):
                for name, t in nw.items():
                    st[name].copy_(t)

        def prefill(toks):
            logits, st = model.prefill(toks)
            keep(st)
            return logits

        def forward(tok, pos):
            logits, st = model.step(states, tok)
            keep(st)
            return logits

        def select(logits, seed, pos):
            noise = (None if greedy
                     else F.gumbel_noise(seed, pos, rows, logits.shape[-1]))
            return F.select_next(logits, greedy, temperature, top_k, None, None,
                                 noise)

        return DecodeLoop(b, s0, max_new_tokens, dev, prefill, forward, select)

    return cached_program(_ssm_decode_cache, key, build, _SSM_DECODE_CACHE_MAX)


def generate_compiled_ssm(model, prompt, max_new_tokens: int, greedy: bool = True,
                          temperature: float = 1.0, top_k=None, seed: int = 0,
                          device="cuda"):
    """prompt (B, S0) int -> (B, S0 + max_new_tokens) int64 on the model's
    device, through ``ssm_decode_program``: one parallel prefill (the scan
    kernel) hands its O(1) state to ``MambaLM.step``, on the card one CUDA
    graph replay per token after the first.

    Greedy mode takes the argmax and gives ``model.generate``'s tokens.
    ``greedy=False`` draws a Gumbel-max sample at ``temperature`` (top-k
    truncated with ``top_k``) with noise keyed by (seed, position, row),
    drawn on the model's device: deterministic per seed.  ``device`` must
    be where the model lives.
    """
    prompt = torch.as_tensor(prompt)
    return ssm_decode_program(model, prompt, max_new_tokens, greedy, temperature,
                              top_k, device)(prompt, seed)
