"""The port's captured train steps, on the CPU.

``make_train_step(..., jit=True)`` (the default) runs each step as a
``StepProgram`` with ``grad=True`` (``models/capture.py``): on the card a
CUDA graph captured after the first real step and replayed once per call,
here the same program object running its step function on the same static
buffers.  Held here, in float64 from the JAX model's ``init()`` weights
(``params_from_jax``):

* three steps of the dense LM, the LLaMA-style options (RMSNorm, RoPE,
  SwiGLU, grouped-query attention), MoE (``forward_with_aux`` and
  ``make_moe_loss``) and MambaLM, under SGD with momentum, Adam and AdamW
  and at ``grad_accum=2``, against JAX ``make_train_step`` (its numpy
  backend, ``jit=False``; ``tests/test_models.py`` holds JAX's jit equal to
  its eager step) at 1e-9, and against the port's ``jit=False`` step bit
  for bit;
* what a graph needs of the step: from step 2 on every parameter and every
  optimizer state tensor keeps its storage, Adam's step count is a tensor
  on the parameters' device, and the step function makes no host sync and
  no host copy (checked on the dispatcher);
* the losses a caller keeps stay distinct, and the program cache: a new
  batch shape makes a second program, the same shape none, and rebound
  parameters one more.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import minidiff_tpu as md
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import Adam as JaxAdam
from minidiff_tpu.models import AdamW as JaxAdamW
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models import make_train_step as jax_make_train_step
from minidiff_tpu.models.moe import MoETransformerLM as JaxMoELM
from minidiff_tpu.models.moe import make_moe_loss as jax_make_moe_loss
from minidiff_tpu.models.ssm import MambaLM as JaxMamba
from minidiff_tpu_torch import (SGD, Adam, AdamW, MambaLM, MoETransformerLM,
                                TransformerLM, lm_loss, make_moe_loss,
                                make_train_step, params_from_jax)
from minidiff_tpu_torch.models import capture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {
    "dense": (JaxLM, TransformerLM,
              dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq_len=32)),
    "options": (JaxLM, TransformerLM,
                dict(vocab_size=64, dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
                     max_seq_len=32, norm="rms", rope=True, mlp="swiglu",
                     mlp_hidden=96, mlp_bias=False)),
    "moe": (JaxMoELM, MoETransformerLM,
            dict(vocab_size=64, dim=64, num_heads=4, num_layers=2, num_experts=4,
                 max_seq_len=32, k=2, capacity_factor=1.0, grouped=True)),
    "mamba": (JaxMamba, MambaLM, dict(vocab_size=64, dim=32, num_layers=2, d_state=4)),
}
_OPTS = {
    "sgd": (lambda: JaxSGD(0.1), lambda: SGD(0.1)),
    "sgd_momentum": (lambda: JaxSGD(0.1, momentum=0.9), lambda: SGD(0.1, momentum=0.9)),
    "adam": (lambda: JaxAdam(1e-2), lambda: Adam(1e-2)),
    "adamw": (lambda: JaxAdamW(1e-2, weight_decay=0.1),
              lambda: AdamW(1e-2, weight_decay=0.1)),
}


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t._data), tree,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(name, seed=0):
    """The JAX model and params (numpy backend) and the port model with the
    same weights, in float64."""
    jax_cls, torch_cls, cfg = MODELS[name]
    np.random.seed(seed)
    jm = jax_cls(dtype=md.float64, **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = torch_cls(dtype=torch.float64, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b=4, s=16, seed=1):
    return np.random.RandomState(seed).randint(0, 64, size=(b, s))


def _port_step(name, tm, opt, **kw):
    moe = name == "moe"
    return make_train_step(tm, opt, loss_fn=make_moe_loss(0.01) if moe else lm_loss,
                           apply_fn=tm.forward_with_aux if moe else None,
                           device="cpu", **kw)


# f64 on both sides, so the steps differ only in summation order (and in
# Adam's step size, computed on the device here from a float64 step count
# as the JAX package computes it from its own): ~1e-14 relative; 1e-9
# holds it with margin
@pytest.mark.parametrize("name,opt,grad_accum", [
    ("dense", "sgd", 1), ("dense", "sgd_momentum", 1), ("dense", "adam", 1),
    ("dense", "adamw", 1), ("dense", "adam", 2), ("options", "sgd_momentum", 1),
    ("options", "adamw", 1), ("moe", "sgd_momentum", 1), ("moe", "adam", 2),
    ("mamba", "sgd_momentum", 1), ("mamba", "adamw", 1)])
def test_captured_steps_match_jax_and_the_eager_step(name, opt, grad_accum):
    jax_opt, torch_opt = _OPTS[opt]
    toks = _tokens()
    moe = name == "moe"
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(name)
        jopt = jax_opt()
        jstep = jax_make_train_step(
            jm, jopt, loss_fn=jax_make_moe_loss(0.01) if moe else jax_lm_loss,
            jit=False, grad_accum=grad_accum, apply_fn=jm.apply_with_aux if moe else None)
        state = jopt.init(jp)
        jl = []
        for _ in range(3):
            jp, state, loss = jstep(jp, state, md.Tensor(toks), md.Tensor(toks))
            jl.append(float(np.asarray(loss._data)))
    _, _, eager_model = _pair(name)
    tt = torch.from_numpy(toks)
    runs = {}
    for jit, model in ((True, tm), (False, eager_model)):
        step = _port_step(name, model, torch_opt(), grad_accum=grad_accum, jit=jit)
        runs[jit] = [step(tt, tt).item() for _ in range(3)]
    assert len(step._cache) == 0  # jit=False keeps no program
    assert runs[True] == runs[False]
    np.testing.assert_allclose(runs[True], jl, rtol=1e-9)
    ref = params_from_jax(_np_tree(jp))
    eager = eager_model.state_dict()
    for pname, p in tm.state_dict().items():
        assert torch.equal(p, eager[pname]), pname
        np.testing.assert_allclose(p.numpy(), ref[pname].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=pname)


def _state_tensors(opt) -> list:
    out = []
    for v in opt.state.values():
        out += list(v) if isinstance(v, tuple) else [v]
    return out + ([opt.t] if isinstance(opt, Adam) else [])


@pytest.mark.parametrize("opt", ["sgd_momentum", "adam", "adamw"])
def test_state_and_parameters_keep_their_storage(opt):
    _, _, tm = _pair("dense")
    optimizer = _OPTS[opt][1]()
    step = _port_step("dense", tm, optimizer)
    tt = torch.from_numpy(_tokens())
    step(tt, tt)  # step 1 makes the state
    (program,) = step._cache.values()

    def storage():
        return [t.data_ptr() for t in (*tm.parameters(), *_state_tensors(optimizer),
                                       *program.buffers.values())]

    n = len(list(tm.parameters()))
    per_param = 1 if opt == "sgd_momentum" else 2
    assert len(_state_tensors(optimizer)) == per_param * n + (opt != "sgd_momentum")
    ptrs = storage()
    for _ in range(3):
        step(tt, tt)
        assert storage() == ptrs
    if opt != "sgd_momentum":
        t = optimizer.t  # the step count: a float64 tensor on the device
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
        assert t.device == next(tm.parameters()).device and t.item() == 4.0


_SYNCS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
          "aten::unique", "aten::_unique2", "aten::unique_consecutive",
          "aten::is_nonzero", "aten::equal"}
# a host array made a tensor (a host-to-device copy on the card)
_HOST_COPIES = {"aten::lift_fresh"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,opt,grad_accum", [
    ("dense", "adamw", 1), ("options", "adam", 2), ("moe", "sgd_momentum", 1),
    ("mamba", "sgd", 1)])
def test_step_function_makes_no_host_sync_or_copy(name, opt, grad_accum):
    _, _, tm = _pair(name)
    step = _port_step(name, tm, _OPTS[opt][1](), grad_accum=grad_accum)
    tt = torch.from_numpy(_tokens())
    step(tt, tt)  # the first step: what the card runs eagerly before capture
    (program,) = step._cache.values()
    with _Ops() as ops:
        program.fn()
    bad = ops.names & (_SYNCS | _HOST_COPIES)
    assert not bad, bad
    assert "aten::addmm" in ops.names or "aten::mm" in ops.names  # it saw the step


def test_the_dispatch_check_sees_a_host_read_in_the_loss():
    _, _, tm = _pair("dense")

    def loss_fn(logits, y):
        loss = lm_loss(logits, y)
        return loss if loss.item() >= 0 else -loss

    step = make_train_step(tm, SGD(0.1), loss_fn=loss_fn, device="cpu")
    tt = torch.from_numpy(_tokens())
    step(tt, tt)
    (program,) = step._cache.values()
    with _Ops() as ops:
        program.fn()
    assert "aten::_local_scalar_dense" in ops.names


def test_kept_losses_stay_distinct_and_calls_replay():
    _, _, tm = _pair("dense")
    step = _port_step("dense", tm, SGD(0.1))
    tt = torch.from_numpy(_tokens())
    capture.reset_stats()
    losses = [step(tt, tt) for _ in range(4)]
    assert capture.STATS["replays"] == 4  # one step call each on the CPU
    values = [float(v) for v in losses]
    assert len(set(values)) == 4 and values[-1] < values[0]
    assert len({v.data_ptr() for v in losses}) == 4
    step(tt, tt)
    assert [float(v) for v in losses] == values  # no later step overwrote them


def test_program_cache_keys_shapes_and_parameter_storage():
    _, _, tm = _pair("dense")
    step = _port_step("dense", tm, SGD(0.1))
    a, b = torch.from_numpy(_tokens(4, 16)), torch.from_numpy(_tokens(2, 16))
    step(a, a)
    step(a, a)
    assert len(step._cache) == 1          # the same shape: no new program
    step(b, b)
    assert len(step._cache) == 2          # another batch shape: one more
    step(a, a)
    assert len(step._cache) == 2
    for p in tm.parameters():             # parameters rebound to new storage
        p.data = p.data.clone()
    step(a, a)
    assert len(step._cache) == 3
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        _port_step("dense", tm, SGD(0.1), grad_accum=3)(a, a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_adam_updates_half_precision_parameters_at_f32(dtype):
    """Adam's step size is a device scalar, which a bf16 or f16 operand
    would round to its own dtype: held against the f64 update of the same
    moments, within half a unit in the last place of the parameter's dtype
    and 2^-20 of the operands for the f32 arithmetic (the update is computed
    in f32 and rounded once)."""
    rng = np.random.default_rng(3)
    p = torch.nn.Parameter(torch.zeros(4096, dtype=dtype))
    opt = Adam(lr=0.1)
    for t in range(1, 4):
        p.grad = torch.from_numpy(rng.standard_normal(4096)).to(dtype)
        before = p.detach().double()
        opt.step([p])
        m, v = (s.double() for s in opt.state[p])
        step = 0.1 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        exact = before - step * m / (v.sqrt() + 1e-8)
        top = exact.abs().to(dtype)  # the spacing above |exact|'s rounding
        ulp = (torch.nextafter(top, torch.full_like(top, np.inf)) - top).double()
        err = (p.detach().double() - exact).abs()
        slack = (before.abs() + exact.abs()) * 2.0 ** -20  # f32, both operands
        assert bool((err <= 0.5 * ulp + slack).all()), t
    assert opt.t.dtype == torch.float64 and float(opt.t) == 3.0


def test_program_cache_keeps_the_32_latest_keys():
    _, _, tm = _pair("dense")
    step = _port_step("dense", tm, SGD(0.1))
    batches = [torch.from_numpy(_tokens(b, 8)) for b in range(1, 34)]
    for b in batches:
        step(b, b)
    assert len(step._cache) == 32          # the first key went
    assert (tuple(batches[0].shape), torch.int64) not in {k[:2] for k in step._cache}
    step(batches[-1], batches[-1])
    assert len(step._cache) == 32
