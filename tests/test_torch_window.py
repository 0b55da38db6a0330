"""Sliding-window attention with attention sinks in the port's models,
against the JAX package's, on the CPU.

``TransformerLM(window=, sinks=)`` and ``MoETransformerLM(window=,
sinks=)`` at a tiny Mistral-style size (RMSNorm, RoPE, grouped-query
attention, SwiGLU) with sequences longer than the window: the JAX model's
``init()`` weights cross into the port through ``params_from_jax``, and
logits, the loss and every gradient are held to the JAX package on its
numpy backend; greedy ``generate_compiled`` tokens to the JAX program (XLA);
the cached chunk step past the window to the JAX ``_chunk_step``; the dense
and paged servers to solo decodes; and the options that raise in the JAX
package raise here.

Tolerances: float64 runs the same algebra in another order on both sides,
1e-10; float32 (head dim 128, where the port takes the flash kernels' plain
version and the JAX numpy backend its composed attention) 1e-4, as
``tests/test_torch_options.py``.  The cached step takes its scores and
softmax in f32 whatever the model dtype, as the JAX step does: 1e-6 on
logits of order 1.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models.moe import MoETransformerLM as JaxMoELM
from minidiff_tpu_torch import (DecodeServer, MoETransformerLM, PagedDecodeServer,
                                TransformerLM, generate_compiled, lm_loss, params_from_jax)
from minidiff_tpu_torch.kernels import attention as TA
from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill
from test_torch_capture import _drop_reference_programs  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Mistral-7B-v0.1's options at a tiny size: a window of 24 with 4 sinks
# (head dim 128: 2 heads over 1 KV head)
WINDOWED = dict(vocab_size=64, dim=256, num_heads=2, num_kv_heads=1, num_layers=2,
                max_seq_len=256, norm="rms", norm_eps=1e-5, rope=True, mlp="swiglu",
                mlp_hidden=448, mlp_bias=False, window=24, sinks=4)
# learned positions, a window not a multiple of anything, no sinks
LEARNED = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq_len=128,
               window=13)
MOE = dict(vocab_size=64, dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
           num_experts=4, max_seq_len=256, k=2, capacity_factor=2.0, norm="rms",
           rope=True, mlp="swiglu", mlp_hidden=96, mlp_bias=False, window=16, sinks=2)
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(cfg, dtype, seed=0, jax_cls=JaxLM, cls=TransformerLM):
    np.random.seed(seed)
    jm = jax_cls(dtype=_JAX_DT[dtype], **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = cls(dtype=dtype, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b, s, seed=1, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", ["windowed", "learned"])
def test_logits_match_jax_apply(name, dtype, tol):
    cfg = {"windowed": WINDOWED, "learned": LEARNED}[name]
    toks = _tokens(2, 60)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(cfg, dtype)
        with md.no_grad():
            ref = np.asarray(jm.apply(jp, md.Tensor(toks))._data)
    assert (tm.window, tm.sinks) == (cfg["window"], cfg.get("sinks", 0))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks)).numpy()
        full = TransformerLM(dtype=dtype, device="cpu", **dict(cfg, window=None, sinks=0))
        full.load_state_dict(tm.state_dict())
        unwindowed = full(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    # the band bites: past the window the logits differ from full attention
    assert np.abs(out[:, 40:] - unwindowed[:, 40:]).max() > 1e-3
    np.testing.assert_allclose(out[:, :cfg["window"]], unwindowed[:, :cfg["window"]],
                               rtol=tol, atol=tol)


def test_moe_logits_match_jax_apply():
    toks = _tokens(2, 40, seed=2)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(MOE, torch.float64, jax_cls=JaxMoELM, cls=MoETransformerLM)
        with md.no_grad():
            ref, jaux = jm.apply_with_aux(jp, md.Tensor(toks))
    with torch.no_grad():
        out, aux = tm.forward_with_aux(torch.from_numpy(toks))
    assert (tm.window, tm.sinks) == (16, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(aux.item(), float(np.asarray(jaux._data)), rtol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_loss_and_grads_match_jax_value_and_grad(dtype, tol):
    # float32 runs the port's attention through SdpaFn (the flash kernels'
    # plain versions, forward and backward)
    toks = _tokens(2, 48, seed=6)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(WINDOWED, dtype)
        t = md.Tensor(toks)
        loss_ref, grads = md.value_and_grad(lambda p: jax_lm_loss(jm.apply(p, t), t))(jp)
        ref = params_from_jax(_np_tree(grads))
    tt = torch.from_numpy(toks)
    loss = lm_loss(tm(tt), tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(loss_ref._data)), rtol=tol,
                               atol=tol)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# serving past the window
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def windowed64():
    return _pair(WINDOWED, torch.float64, seed=2)


def test_greedy_generate_matches_jax(windowed64):
    # a prompt past the window, and new tokens further past it
    jm, jp, tm = windowed64
    prompt = _tokens(2, 30, seed=3)
    with md.use_backend("xla"):
        jpx = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jp,
                           is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jpx, md.Tensor(prompt), 12)._data)
    out = generate_compiled(tm, prompt, 12, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cached_chunk_step_matches_jax_past_the_window(windowed64):
    from minidiff_tpu.models.speculative import _chunk_step as jax_chunk_step
    from minidiff_tpu.models.speculative import _prefill as jax_prefill

    jm, jp, tm = windowed64
    toks = _tokens(2, 64, seed=5)
    tt = torch.from_numpy(toks)
    with md.use_backend("numpy"), md.no_grad():
        jcaches, jlast = jax_prefill(jm, jp, md.Tensor(toks[:, :30]), 128, md.float64)
    with torch.no_grad():
        full = tm(tt)
        caches, last = _prefill(tm, tt[:, :30], 128)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast._data), rtol=1e-10,
                                   atol=1e-10)
        # row 1 one token behind row 0's three-token chunks, both past the
        # window of 24 with its sinks
        for p0 in (30, 33, 36):
            pos = np.array([p0, p0 - 1])
            chunk = np.stack([toks[0, p0:p0 + 3], toks[1, p0 - 1:p0 + 2]])
            got = _chunk_step(tm, caches, torch.from_numpy(chunk), torch.from_numpy(pos), 128)
            with md.use_backend("numpy"), md.no_grad():
                jcaches, ref = jax_chunk_step(jm, jp, jcaches, md.Tensor(chunk),
                                              md.Tensor(pos), 128)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref._data), rtol=0, atol=1e-6)
            want = torch.stack([full[0, p0:p0 + 3], full[1, p0 - 1:p0 + 2]])
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("server", [DecodeServer, PagedDecodeServer])
def test_servers_match_solo_decode_past_the_window(windowed64, server):
    _, _, tm = windowed64
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (5, 40, 131)]
    srv = server(tm, max_batch=2, window=256, device="cpu")
    s1 = srv.submit(prompts[0], max_new_tokens=30)
    s2 = srv.submit(prompts[1], max_new_tokens=9)
    while not srv.done(s2):
        srv.step()
    out = {s2: srv.collect(s2)}
    s3 = srv.submit(prompts[2], max_new_tokens=5)
    while srv.active():
        srv.step()
    got = [srv.collect(s1), out[s2], srv.collect(s3)]
    solo = [generate_compiled(tm, [p], n, device="cpu")[0, len(p):].tolist()
            for p, n in zip(prompts, (30, 9, 5))]
    assert got == solo


# ---------------------------------------------------------------------------
# what raises, as in the JAX package
# ---------------------------------------------------------------------------


def test_kv_quant_with_a_window_raises(windowed64):
    with pytest.raises(NotImplementedError, match="sliding-window"):
        generate_compiled(windowed64[2], _tokens(1, 8), 4, device="cpu", kv_quant=True)


def test_window_needs_causal_and_canonicalises():
    q = torch.randn(1, 2, 16, 128)
    with pytest.raises(ValueError, match="causal"):
        TA.sdpa(q, q, q, window=4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        TA.sdpa(q, q, q, causal=True, window=0)
    # a window covering every causal position (and its sinks) is no window
    full = TA.sdpa(q, q, q, causal=True)
    assert torch.equal(TA.sdpa(q, q, q, causal=True, window=16, sinks=3), full)
    assert TA._normalize_window(16, 3, 16, 16, True) == (None, 0)
    assert TA._normalize_window(8, 3, 16, 16, True) == (8, 3)
