"""The port's Mixture-of-Experts family against the JAX package's, on the CPU.

``MoETransformerLM`` with one-hot and grouped routing: the slot tables and
gates of the routing, the logits and aux loss, the loss and every gradient
(the router's included), a train step with ``apply_fn``, the int8 expert
banks of ``quantize_for_serving`` and greedy decoding.  The JAX model's
``init()`` weights cross into the port through ``params_from_jax``.  The JAX
side runs on its numpy backend with x64, except ``generate_compiled`` (a
jitted scan), which runs on XLA.

Tolerances: slot tables and dispatch masks exactly equal; float64 1e-10
(the same arithmetic in another summation order); float32 1e-4 through two
layers (~1e-6 seen).  The float32 cases first assert that the routes are
the same: a router probability within f32 rounding of the next one would
flip a route and move that token's output by O(1).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu.models import make_train_step as jax_make_train_step
from minidiff_tpu.models import quantize_for_serving as jax_quantize
from minidiff_tpu.models import quantized_bytes as jax_quantized_bytes
from minidiff_tpu.models.moe import MoEFeedForward as JaxMoE
from minidiff_tpu.models.moe import MoETransformerLM as JaxMoELM
from minidiff_tpu.models.moe import make_moe_loss as jax_make_moe_loss
from minidiff_tpu_torch import (SGD, DecodeServer, MoETransformerLM,
                                PagedDecodeServer, generate_compiled,
                                make_moe_loss, make_train_step, params_from_jax,
                                quantize_for_serving, quantized_bytes)
from minidiff_tpu_torch.models.moe import MoEFeedForward
from test_torch_capture import _drop_reference_programs  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# LayerNorm, learned positions, gelu experts with bias, top-2 at a capacity
# that drops tokens; and the serving configuration's options (RMSNorm, RoPE,
# 4 heads over 2 KV heads, SwiGLU experts without bias, renormalised gates)
# at a capacity of E / k, which drops none
GELU = dict(vocab_size=64, dim=64, num_heads=4, num_layers=2, num_experts=4,
            max_seq_len=64, k=2, capacity_factor=1.0)
SWIGLU = dict(vocab_size=64, dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
              num_experts=4, max_seq_len=256, k=2, capacity_factor=2.0,
              norm="rms", rope=True, mlp="swiglu", mlp_hidden=96, mlp_bias=False,
              renorm_gates=True)
CONFIGS = {"gelu": GELU, "swiglu": SWIGLU}
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(cfg, dtype, grouped, seed=0):
    """The JAX model and its params (numpy backend), and the port model with
    the same weights.  The JAX init zeroes the expert biases; they are drawn
    here so that the bias terms show."""
    np.random.seed(seed)
    jm = JaxMoELM(dtype=_JAX_DT[dtype], grouped=grouped, **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
        rng = np.random.RandomState(seed + 100)
        for blk in jp["blocks"]:
            ex = blk["moe"]["experts"]
            for name in ("b1", "b2"):
                if name in ex:
                    ex[name] = md.Tensor(0.1 * rng.standard_normal(ex[name].shape),
                                         allow_grad=True, dtype=_JAX_DT[dtype])
    tm = MoETransformerLM(dtype=dtype, device="cpu", grouped=grouped, **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b, s, seed=1, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


# ---------------------------------------------------------------------------
# routing: slot tables, gates, dispatch masks, aux
# ---------------------------------------------------------------------------


def _ffn_pair(k, cf, renorm, zero_router=False):
    d, e = 16, 4
    np.random.seed(3)
    jf = JaxMoE(d, e, mlp_ratio=2, k=k, capacity_factor=cf, dtype=md.float64,
                renorm_gates=renorm)
    with md.use_backend("numpy"):
        jp = jf.init()
        if zero_router:  # every probability 1/E: the top-k choice is all ties
            jp["router"]["w"] = md.Tensor(np.zeros((d, e)), dtype=md.float64)
    tf = MoEFeedForward(d, e, 2, k, cf, dtype=torch.float64, device="cpu",
                        generator=torch.Generator(), renorm_gates=renorm)
    tf.load_state_dict(params_from_jax(_np_tree(jp)))
    return jf, jp, tf


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 2.0), (2, 0.75)])
def test_routing_matches_jax(k, cf, renorm, zero_router):
    # cf 0.75 at k 2 drops tokens: their slots go to the dump slot E * C
    jf, jp, tf = _ffn_pair(k, cf, renorm, zero_router)
    t = 24
    x = np.random.RandomState(4).standard_normal((t, 16))
    c = jf.capacity(t)
    assert tf.capacity(t) == c
    with md.use_backend("numpy"), md.no_grad():
        jx = md.Tensor(x)
        jchoices, jaux = jf.compute_routing_sparse(jp, jx, c)
        jdisp, jcomb, jaux1 = jf.compute_routing(jp, jx, c)
        jin, _, _ = jf.dispatch_grouped(jp, jx, c)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        choices, aux = tf.compute_routing_sparse(tx, c)
        disp, comb, aux1 = tf.compute_routing(tx, c)
        tin, _, _ = tf.dispatch_grouped(tx, c)
    assert len(choices) == len(jchoices) == k
    for (slot, gk), (jslot, jgk) in zip(choices, jchoices):
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot._data))
        np.testing.assert_allclose(gk.numpy(), np.asarray(jgk._data),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp._data))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb._data),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin._data))
    for a, ja in ((aux, jaux), (aux1, jaux1)):
        np.testing.assert_allclose(a.item(), float(np.asarray(ja._data)),
                                   rtol=1e-10)
    dropped = sum(int((s == 4 * c).sum()) for s, _ in choices)
    if c >= t:
        assert dropped == 0
    elif cf < 1:
        assert dropped >= k * t - 4 * c > 0
    if zero_router:
        # ties go to the first maximal index, choice after choice
        for i, (slot, _) in enumerate(choices):
            assert set((slot.numpy() // c).tolist()) <= {i, 4}


def test_bf16_routing_positions_stay_exact():
    # 600 tokens all routed to expert 0: a bf16 cumsum would stop counting
    # at 256; the queue arithmetic runs in f32 (tests/test_moe.py:199)
    tf = MoEFeedForward(8, 4, 2, 1, 4.0, dtype=torch.bfloat16, device="cpu",
                        generator=torch.Generator())
    with torch.no_grad():
        tf.router.w.zero_()
        tf.router.w[:, 0] = 4.0
        x = torch.ones((600, 8), dtype=torch.bfloat16)
        (slot, gk), = tf.compute_routing_sparse(x, 600)[0]
    np.testing.assert_array_equal(slot.numpy(), np.arange(600))
    assert bool((gk > 0).all())


# ---------------------------------------------------------------------------
# the model: logits and aux, loss and gradients, a train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_and_aux_match_jax(name, grouped, dtype, tol):
    cfg = CONFIGS[name]
    toks = _tokens(2, 24)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(cfg, dtype, grouped)
        with md.no_grad():
            ref, jaux = jm.apply_with_aux(jp, md.Tensor(toks))
            # the first layer's routes, for the f32 flip check below
            jx = jp["tok_emb"][md.Tensor(toks)]
            if not cfg.get("rope"):
                jx = jx + jp["pos_emb"][:24]
            blk = jm.blocks[0]
            z = blk.ln2.apply(jp["blocks"][0]["ln2"], jx + blk.attn.apply(
                jp["blocks"][0]["attn"], blk.ln1.apply(jp["blocks"][0]["ln1"], jx)))
            c = blk.moe.capacity(48)
            jslots, _ = blk.moe.compute_routing_sparse(
                jp["blocks"][0]["moe"], z.reshape((48, cfg["dim"])), c)
    assert set(tm.state_dict()) == set(params_from_jax(_np_tree(jp)))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        x = tm.tok_emb[tt] + (0 if cfg.get("rope") else tm.pos_emb[:24])
        blk = tm.blocks[0]
        z = blk.ln2(x + blk.attn(blk.ln1(x)))
        slots, _ = blk.moe.compute_routing_sparse(z.reshape(48, -1), c)
        out, aux = tm.forward_with_aux(tt)
    for (s, _), (js, _) in zip(slots, jslots):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js._data))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(aux.item(), float(np.asarray(jaux._data)),
                               rtol=tol)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_loss_and_grads_match_jax_value_and_grad(name, grouped):
    toks = _tokens(2, 16, seed=6)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(CONFIGS[name], torch.float64, grouped)
        t = md.Tensor(toks)
        jloss = jax_make_moe_loss(0.01)
        loss_ref, grads = md.value_and_grad(
            lambda p: jloss(jm.apply_with_aux(p, t), t))(jp)
        ref = params_from_jax(_np_tree(grads))
    tt = torch.from_numpy(toks)
    loss = make_moe_loss(0.01)(tm.forward_with_aux(tt), tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(loss_ref._data)),
                               rtol=1e-10, atol=1e-10)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    assert "blocks.0.moe.router.w" in named
    for name_, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name_].numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=name_)


def test_train_step_with_apply_fn_matches_jax():
    # f64 on both sides: the steps differ only in summation order, 1e-9
    toks = _tokens(2, 16, seed=7)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(SWIGLU, torch.float64, grouped=True)
        jopt = JaxSGD(0.1)
        jstep = jax_make_train_step(jm, jopt, loss_fn=jax_make_moe_loss(0.01),
                                    jit=False, apply_fn=jm.apply_with_aux)
        jp, _, jloss = jstep(jp, jopt.init(jp), md.Tensor(toks), md.Tensor(toks))
    step = make_train_step(tm, SGD(0.1), loss_fn=make_moe_loss(0.01),
                           device="cpu", apply_fn=tm.forward_with_aux)
    tloss = step(torch.from_numpy(toks), torch.from_numpy(toks))
    np.testing.assert_allclose(tloss.item(), float(np.asarray(jloss._data)),
                               rtol=1e-9)
    ref = params_from_jax(_np_tree(jp))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# int8 expert banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_banks_match_jax(bits):
    toks = _tokens(2, 24, seed=8)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(SWIGLU, torch.float64, grouped=True)
        # min_elements 128: the router's d * E = 256 entries pass the size
        # rule and still stay full precision; the banks take int8 at bits 4
        jq = jax_quantize(jp, min_elements=128, bits=bits)
        with md.no_grad():
            ref = np.asarray(jm.apply(jq, md.Tensor(toks))._data)
    tq = quantize_for_serving(tm, min_elements=128, bits=bits)
    want = params_from_jax(_np_tree(jq))
    got = tq.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    ex = tq.blocks[0].moe.experts
    assert ex.w1 is None and ex.w1_q.dtype == torch.int8
    assert tuple(ex.w1_s.shape) == (4, 2 * 96) and tuple(ex.w2_q.shape) == (4, 96, 64)
    assert tq.blocks[0].moe.router.w.dtype == torch.float64
    assert torch.equal(tq.blocks[0].moe.router.w, tm.blocks[0].moe.router.w)
    assert tm.blocks[0].moe.experts.w1 is not None  # the input is untouched
    assert quantized_bytes(tq) == jax_quantized_bytes(jq)
    # a quantized JAX tree loads through params_from_jax as it stands
    tq.load_state_dict(want)
    with torch.no_grad():
        out = tq(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def swiglu64():
    return _pair(SWIGLU, torch.float64, grouped=True, seed=2)


def test_greedy_generate_matches_jax(swiglu64):
    jm, jp, tm = swiglu64
    prompt = _tokens(2, 9, seed=3)
    with md.use_backend("xla"):
        jpx = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jp,
                           is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jpx, md.Tensor(prompt), 10)._data)
    out = generate_compiled(tm, prompt, 10, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("server", [DecodeServer, PagedDecodeServer])
def test_f32_server_matches_solo_decode(server):
    # capacity E / k drops no token, so each request's tokens route as they
    # would alone, whatever its neighbours in the batch
    _, _, tm = _pair(SWIGLU, torch.float32, grouped=True, seed=5)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (4, 6, 130)]
    srv = server(tm, max_batch=2, window=256, device="cpu")
    s1 = srv.submit(prompts[0], max_new_tokens=3)
    s2 = srv.submit(prompts[1], max_new_tokens=9)
    while not srv.done(s1):
        srv.step()
    out = [srv.collect(s1)]
    s3 = srv.submit(prompts[2], max_new_tokens=5)
    assert s3 == s1
    while srv.active():
        srv.step()
    out += [srv.collect(s2), srv.collect(s3)]
    solo = [generate_compiled(tm, [p], n, device="cpu")[0, len(p):].tolist()
            for p, n in zip(prompts, (3, 9, 5))]
    assert out == solo


# ---------------------------------------------------------------------------
# what stays for later slices
# ---------------------------------------------------------------------------


# window and sinks are ported (tests/test_torch_window.py); out of range
# they raise, as the JAX layer's asserts do
@pytest.mark.parametrize("kw", [dict(window=0), dict(window=64, sinks=-1)])
def test_later_options_raise(kw):
    with pytest.raises(ValueError, match="must be >= "):
        MoETransformerLM(device="cpu", **GELU, **kw)


def test_packing_and_dropout_raise():
    tm = MoETransformerLM(device="cpu", **GELU)
    toks = torch.zeros((1, 8), dtype=torch.long)
    for kw in (dict(segment_ids=toks), dict(positions=toks)):
        with pytest.raises(NotImplementedError, match="later slice"):
            tm.forward_with_aux(toks, **kw)
    step = make_train_step(tm, SGD(0.1), loss_fn=make_moe_loss(), device="cpu",
                           apply_fn=tm.forward_with_aux)
    with pytest.raises(NotImplementedError, match="dropout"):
        step(toks, toks, rng=0)
