"""The port's captured decode programs, on the CPU.

``generate_compiled`` and ``generate_compiled_ssm`` run through
``decode_program`` / ``ssm_decode_program`` and the three servers through
their ``StepProgram`` (``models/capture.py``); on the card each step is a
CUDA graph replay, here the same program objects run their step functions
on the same static buffers.  Held here:

* greedy tokens through the programs against the JAX package's greedy
  tokens (its model's forward, argmax per position, on the numpy backend;
  the int8 KV cache against its XLA ``generate_compiled``) in float64, on
  the flagship at a small width, over float, int8 and int4 weights, the int8
  cache, MoE and Mamba, and the dense, paged and SSM servers; one replay per
  token after the first, and one per server step;
* the program caches' rules: another seed reuses the program, another
  sampling config adds one, the 33rd key evicts the oldest, a bumped
  library epoch re-keys (the servers' steps too);
* the launch-credit bookkeeping: a capture's launches are taken back and
  added once per replay;
* the captured steps make no host sync: no ``.item()``, no ``nonzero`` or
  other data-dependent shape (the MoE routing and the dequant products
  among them), checked on the dispatcher.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import minidiff_tpu as md
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu.models import quantize_for_serving as jax_quantize
from minidiff_tpu.models.moe import MoETransformerLM as JaxMoELM
from minidiff_tpu.models.ssm import MambaLM as JaxMamba
from minidiff_tpu_torch import (DecodeServer, MambaLM, MoETransformerLM,
                                PagedDecodeServer, SSMDecodeServer, TransformerLM,
                                generate_compiled, generate_compiled_ssm,
                                params_from_jax, quantize_for_serving)
from minidiff_tpu_torch import kernels as K
from minidiff_tpu_torch.kernels import _build
from minidiff_tpu_torch.kernels import layernorm as KL
from minidiff_tpu_torch.kernels import paged as KP
from minidiff_tpu_torch.models import capture, decode, ssm
from minidiff_tpu_torch.models.capture import StepProgram, record_launches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_programs():
    """Take the JAX package's compiled decode programs that this file adds
    back out of its caches (LRUs of 32): the reference's own tests count
    their entries (``tests/test_decode.py``) in the same worker.  The other
    port files that run the reference's compiled decode import it, and it
    applies to each as its own module fixture."""
    from minidiff_tpu.models import decode as ref_decode
    from minidiff_tpu.models import ssm as ref_ssm

    caches = (ref_decode._decode_cache, ref_ssm._SSM_DECODE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, keys in zip(caches, before):
        for key in [k for k in cache if k not in keys]:
            del cache[key]


DENSE = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq_len=256)
MOE = dict(vocab_size=64, dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
           num_experts=4, max_seq_len=256, k=2, capacity_factor=2.0, norm="rms",
           rope=True, mlp="swiglu", mlp_hidden=96, mlp_bias=False, renorm_gates=True)
MAMBA = dict(vocab_size=64, dim=32, num_layers=2, d_state=4)


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t._data), tree,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(jax_cls, torch_cls, cfg, seed=0):
    """The JAX model and params (numpy backend) and the port model with
    the same weights, in float64."""
    np.random.seed(seed)
    jm = jax_cls(dtype=md.float64, **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = torch_cls(dtype=torch.float64, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _jax_greedy(jm, jp, prompt, n):
    """The JAX package's greedy tokens: its forward over the sequence so
    far, argmax at the last position, n times (numpy backend)."""
    toks = np.asarray(prompt)
    with md.use_backend("numpy"), md.no_grad():
        for _ in range(n):
            logits = np.asarray(jm.apply(jp, md.Tensor(toks))._data)
            toks = np.concatenate([toks, logits[:, -1].argmax(-1)[:, None]], axis=1)
    return toks


@pytest.fixture(scope="module")
def dense():
    return _pair(JaxLM, TransformerLM, DENSE)


def _quantized(pair, bits):
    jm, jp, tm = pair
    with md.use_backend("numpy"):
        jq = jax_quantize(jp, bits=bits)
    tq = quantize_for_serving(tm, bits=bits)
    tq.load_state_dict(params_from_jax(_np_tree(jq)))
    return jm, jq, tq


@pytest.mark.parametrize("case", ["dense", "int8", "int4", "moe"])
def test_generate_through_its_program_matches_jax(dense, case):
    if case == "moe":
        # capacity E / k: no token is dropped, so the forward routes as
        # the cached steps do
        jm, jp, tm = _pair(JaxMoELM, MoETransformerLM, MOE, seed=2)
    else:
        jm, jp, tm = dense if case == "dense" else _quantized(dense, int(case[3:]))
    prompt = np.random.RandomState(3).randint(0, 64, size=(2, 9))
    capture.reset_stats()
    out = generate_compiled(tm, prompt, 8, device="cpu")
    assert capture.STATS["replays"] == 7  # one per token after the first
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(jm, jp, prompt, 8))
    program = decode.decode_program(tm, torch.as_tensor(prompt), 8, device="cpu")
    assert next(reversed(decode._decode_cache.values())) is program


def test_int8_cache_generate_through_its_program_matches_jax(dense):
    jm, jq, tq = _quantized(dense, 8)
    prompt = np.random.RandomState(4).randint(0, 64, size=(2, 9))
    with md.use_backend("xla"):
        jq_xla = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jq,
                              is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jq_xla, md.Tensor(prompt), 8,
                                      kv_quant=True)._data)
    out = generate_compiled(tq, prompt, 8, device="cpu", kv_quant=True)
    np.testing.assert_array_equal(out.numpy(), ref)
    # a second call reuses the program and its cache, reset by the prefill
    np.testing.assert_array_equal(
        generate_compiled(tq, prompt, 8, device="cpu", kv_quant=True).numpy(), ref)


def test_ssm_generate_through_its_program_matches_jax():
    jm, jp, tm = _pair(JaxMamba, MambaLM, MAMBA)
    prompt = np.random.RandomState(5).randint(0, 64, size=(2, 5))
    capture.reset_stats()
    out = generate_compiled_ssm(tm, prompt, 10, device="cpu")
    assert capture.STATS["replays"] == 9
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(jm, jp, prompt, 10))
    # the program's state is reset by each prefill: a second call agrees
    assert torch.equal(generate_compiled_ssm(tm, prompt, 10, device="cpu"), out)


def _schedule(srv, requests):
    """Staggered submits over more requests than slots (slot reuse); the
    steps that had a live slot."""
    pending, slot_of, results, steps = list(enumerate(requests)), {}, {}, 0
    while pending or srv.active():
        if pending and len(slot_of) - len(results) < srv.max_batch and (
                steps % 3 == 0 or not srv.active()):
            i, (p, n) = pending.pop(0)
            slot_of[i] = srv.submit(p, n, seed=i)
        steps += bool(srv.step())
        for i, s in slot_of.items():
            if i not in results and srv.done(s):
                results[i] = srv.collect(s)
    return [results[i] for i in range(len(requests))], steps


@pytest.mark.parametrize("server", ["dense", "paged", "ssm", "moe"])
def test_servers_through_their_programs_match_jax(dense, server):
    rng = np.random.RandomState(6)
    # prompts over one and two 128-token buckets; the paged server's
    # requests cross from their first page into a second
    requests = [([int(t) for t in rng.randint(0, 64, n)], new)
                for n, new in ((4, 6), (120, 12), (130, 5), (7, 9))]
    if server == "ssm":
        jm, jp, tm = _pair(JaxMamba, MambaLM, MAMBA)
        srv = SSMDecodeServer(tm, max_batch=2, device="cpu")
    elif server == "moe":
        jm, jp, tm = _pair(JaxMoELM, MoETransformerLM, MOE, seed=2)
        srv = DecodeServer(tm, max_batch=2, window=256, device="cpu")
    else:
        jm, jp, tm = dense
        cls = PagedDecodeServer if server == "paged" else DecodeServer
        srv = cls(tm, max_batch=2, window=256, device="cpu")
    capture.reset_stats()
    got, steps = _schedule(srv, requests)
    assert capture.STATS["replays"] == steps  # one replay per step
    for (p, n), g in zip(requests, got):
        ref = _jax_greedy(jm, jp, [p], n)[0, len(p):]
        assert g == ref.tolist()
    if server == "paged":
        # one captured step per table width: 1 page, then 2
        assert sorted(k[0] for k in srv._programs) == [1, 2]
    else:
        assert len(srv._programs) == 1


@pytest.mark.parametrize("which", ["decode", "ssm"])
def test_program_cache_rules(dense, which):
    if which == "decode":
        tm, cache, entry = dense[2], decode._decode_cache, generate_compiled
    else:
        tm = MambaLM(dtype=torch.float32, device="cpu", **MAMBA)
        cache, entry = ssm._ssm_decode_cache, generate_compiled_ssm
    cache.clear()
    prompt = np.random.RandomState(7).randint(0, 64, size=(1, 3))
    sampled = dict(greedy=False, temperature=0.7, top_k=5)
    a = entry(tm, prompt, 4, seed=1, device="cpu", **sampled)
    assert len(cache) == 1
    b = entry(tm, prompt, 4, seed=2, device="cpu", **sampled)
    assert len(cache) == 1                     # another seed: no new program
    assert torch.equal(a, entry(tm, prompt, 4, seed=1, device="cpu", **sampled))
    assert not torch.equal(a, b)
    entry(tm, prompt, 4, seed=1, device="cpu", **dict(sampled, temperature=0.9))
    assert len(cache) == 2                     # another sampling config: one more
    first = next(iter(cache))
    for n in range(5, 36):                     # 33 keys in all
        entry(tm, prompt, n, device="cpu")
    assert len(cache) == 32 and first not in cache
    keys = set(cache)
    _build._epoch += 1                         # what a library swap does
    try:
        entry(tm, prompt, 35, device="cpu")
        assert set(cache) - keys and len(cache) == 32
    finally:
        _build._epoch -= 1
    cache.clear()


def test_library_swap_bumps_the_epoch_and_recaptures_server_steps(dense):
    srv = DecodeServer(dense[2], max_batch=1, window=256, device="cpu")
    srv.submit([1, 2, 3], 4)
    srv.step()
    before, own = _build.epoch(), _build._libs.get("rmsnorm")
    _build.use_library("rmsnorm", own)
    try:
        assert _build.epoch() == before + 1
        srv.step()
        assert len(srv._programs) == 2
    finally:
        if own is None:
            _build._libs.pop("rmsnorm", None)


def test_launch_credit_bookkeeping():
    K.reset_launch_counts()

    def fake_step():  # what a capture's wrappers count
        KL.LAUNCHES["ln_fwd"] += 2
        KP.LAUNCHES["paged_attn"] += 1
        return "outputs"

    out, made = record_launches(fake_step)
    assert out == "outputs" and made == {"ln_fwd": 2, "paged_attn": 1}
    assert not any(K.launch_counts().values())  # a capture launches nothing
    for _ in range(3):                          # three replays
        K.credit_launches(made)
    counts = {k: n for k, n in K.launch_counts().items() if n}
    assert counts == {"ln_fwd": 6, "paged_attn": 3}
    with pytest.raises(KeyError):
        K.credit_launches({"no_such_kernel": 1})
    K.reset_launch_counts()


def test_step_program_loads_host_values_into_static_buffers():
    buffers = {"a": torch.zeros(3, dtype=torch.long), "t": torch.zeros((2, 2), dtype=torch.int32)}
    prog = StepProgram(lambda: buffers["a"].sum() + buffers["t"].sum(), buffers, "cpu")
    capture.reset_stats()
    assert int(prog.run(a=np.array([1, 2, 3]), t=[[1, 1], [1, 1]])) == 10
    assert int(prog.run(a=torch.tensor([0, 0, 5]))) == 9  # a CPU tensor too
    assert buffers["t"].dtype == torch.int32 and capture.STATS["replays"] == 2
    assert prog.graph is None and prog.launches == {}  # no graph on the CPU


_SYNCS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
          "aten::unique", "aten::_unique2", "aten::unique_consecutive",
          "aten::is_nonzero", "aten::equal"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["dense", "int8", "int4", "kv_quant", "moe",
                                  "moe_int8", "ssm", "sampled"])
def test_captured_decode_steps_make_no_host_sync(dense, case):
    prompt = torch.randint(0, 64, (2, 5), generator=torch.Generator().manual_seed(0))
    kw = {}
    if case == "ssm":
        tm = MambaLM(dtype=torch.float32, device="cpu", **MAMBA)
        program = ssm.ssm_decode_program(tm, prompt, 3, device="cpu")
    else:
        if case.startswith("moe"):
            tm = MoETransformerLM(dtype=torch.float32, device="cpu", **MOE)
            if case == "moe_int8":
                tm = quantize_for_serving(tm, min_elements=64)
        elif case in ("int8", "int4", "kv_quant"):
            tm = quantize_for_serving(dense[2], bits=4 if case == "int4" else 8)
        else:
            tm = dense[2]
        kw = dict(kv_quant=case == "kv_quant")
        if case == "sampled":
            kw = dict(greedy=False, top_k=8, top_p=0.9, min_p=0.01)
        program = decode.decode_program(tm, prompt, 3, device="cpu", **kw)
    program(prompt, 0)
    program.col.fill_(1)  # the state after the first token
    program.pos.fill_(prompt.shape[1])
    with _Ops() as ops, torch.inference_mode():
        program.step.fn()
    assert not ops.names & _SYNCS, ops.names & _SYNCS


@pytest.mark.parametrize("server", [DecodeServer, PagedDecodeServer, SSMDecodeServer])
def test_captured_server_steps_make_no_host_sync(dense, server):
    tm = (MambaLM(dtype=torch.float32, device="cpu", **MAMBA)
          if server is SSMDecodeServer else dense[2])
    srv = server(tm, max_batch=2, window=None if server is SSMDecodeServer else 256,
                 greedy=False, temperature=0.8, device="cpu")
    srv.submit([1, 2, 3], 4, seed=3)
    srv.step()
    (program,) = srv._programs.values()
    with _Ops() as ops, torch.inference_mode():
        program.fn()
    assert not ops.names & _SYNCS, ops.names & _SYNCS
