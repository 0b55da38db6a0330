"""The LLaMA-style options of the port's TransformerLM against the JAX
package's, on the CPU.

RMSNorm, RoPE, grouped-query attention, the gated MLPs, parallel blocks,
biases and tied embeddings: the JAX model's ``init()`` weights cross into
the port through ``params_from_jax`` unchanged, and logits, greedy tokens,
the loss, every gradient and optimizer steps are held to the JAX package.
The JAX side runs on its numpy backend (the same model code over numpy
arrays), except ``generate_compiled``, a jitted scan, which runs on XLA.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import AdamW as JaxAdamW
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models import make_train_step as jax_make_train_step
from minidiff_tpu_torch import (SGD, AdamW, DecodeServer, TransformerLM,
                                generate_compiled, lm_loss, make_train_step,
                                params_from_jax)
from minidiff_tpu_torch.models import functional as F
from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill
from test_torch_capture import _drop_reference_programs  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them (a
    float64 gradcheck took 450 s that way instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Mistral-7B-v0.3's options at a tiny size: RMSNorm (eps 1e-5), RoPE at
# base 1e6, 8 heads over 2 KV heads (4:1), SwiGLU at 3.5 x dim, no biases,
# an untied head; head dim 64
MISTRAL = dict(vocab_size=64, dim=512, num_heads=8, num_kv_heads=2,
               num_layers=2, max_seq_len=256, norm="rms", norm_eps=1e-5,
               rope=True, rope_base=1e6, mlp="swiglu", mlp_hidden=1792,
               mlp_bias=False)
SMALL = dict(vocab_size=64, dim=256, num_heads=4, num_layers=2, max_seq_len=128)
OPTION_SETS = {
    "mistral": MISTRAL,
    "tied": dict(SMALL, norm="rms", rope=True, tie_embeddings=True),
    "geglu": dict(SMALL, mlp="geglu", mlp_hidden=320, num_kv_heads=2),
    "geglu_erf": dict(SMALL, mlp="geglu_erf", norm="rms", rope=True),
    "gelu_erf": dict(SMALL, mlp="gelu_erf", norm_eps=1e-6),
    "parallel_partial_rope": dict(SMALL, parallel_block=True, rope=True,
                                  rope_dim=32, norm="rms"),
    "attn_and_head_bias": dict(SMALL, attn_bias=True, head_bias=True,
                               num_kv_heads=2, rope=True),
    "mqa": dict(SMALL, num_kv_heads=1, rope=True, norm="rms", mlp="swiglu"),
}
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(cfg, dtype, seed=0):
    """The JAX model and its params (numpy backend), and the port model
    with the same weights."""
    np.random.seed(seed)
    jm = JaxLM(dtype=_JAX_DT[dtype], **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = TransformerLM(dtype=dtype, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b, s, seed=1, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


# float32: the same algebra in another summation order through 2 layers
# leaves ~1e-6 relative; 1e-4 holds it with margin.  float64: the same at
# double precision.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_logits_match_jax_apply(name, dtype, tol):
    cfg = OPTION_SETS[name]
    toks = _tokens(2, 24)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(cfg, dtype)
        with md.no_grad():
            ref = np.asarray(jm.apply(jp, md.Tensor(toks))._data)
    assert set(tm.state_dict()) == set(params_from_jax(_np_tree(jp)))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks)).numpy()
    assert out.shape == ref.shape == (2, 24, cfg["vocab_size"])
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_layouts_follow_the_jax_tree():
    _, jp, tm = _pair(MISTRAL, torch.float32)
    tree = _np_tree(jp)
    attn = tm.blocks[0].attn
    assert tuple(attn.wq.w.shape) == (512, 512)
    # wkv columns (kv, 2, hd), fc1 columns (hidden, 2): carried unchanged
    assert tuple(attn.wkv.w.shape) == (512, 2 * 2 * 64)
    np.testing.assert_array_equal(attn.wkv.w.detach().numpy(),
                                  tree["blocks"][0]["attn"]["wkv"]["w"])
    assert tuple(tm.blocks[0].fc1.w.shape) == (512, 2 * 1792)
    assert not hasattr(tm, "pos_emb") and tm.blocks[0].fc1.b is None
    assert tm.blocks[0].ln1.eps == 1e-5 and not hasattr(tm.blocks[0].ln1, "b")


def _rope_ref(x, positions, base, rot_dim=None):
    with md.use_backend("numpy"):
        from minidiff_tpu.models import functional as JF

        return np.asarray(JF.apply_rope(md.Tensor(x), md.Tensor(positions), base,
                                        rot_dim=rot_dim)._data)


@pytest.mark.parametrize("positions,rot_dim", [
    (np.arange(6), None), (np.array(37), None),
    (np.array([[3, 4, 5, 6, 7, 8], [90, 91, 92, 93, 94, 95]]), None),
    (np.arange(6) + 200, 16)])
def test_apply_rope_matches_jax(positions, rot_dim):
    s = 1 if np.ndim(positions) == 0 else 6
    x = np.random.RandomState(4).standard_normal((2, 3, s, 64))
    got = F.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), 1e6,
                       rot_dim=rot_dim).numpy()
    np.testing.assert_allclose(got, _rope_ref(x, positions, 1e6, rot_dim),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mistral64():
    return _pair(MISTRAL, torch.float64, seed=2)


def test_greedy_generate_matches_jax(mistral64):
    jm, jp, tm = mistral64
    prompt = _tokens(2, 9, seed=3)
    with md.use_backend("xla"):
        jpx = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jp,
                           is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jpx, md.Tensor(prompt), 10)._data)
    out = generate_compiled(tm, prompt, 10, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cached_logits_match_jax_and_the_full_forward(mistral64):
    # prefill, then cached chunk steps at per-row positions (the rows sit
    # at different lengths): the logits themselves, since tokens alone
    # would hide near-ties.  The prefill's logits are f64 throughout:
    # 1e-10.  The cached step takes its scores and softmax in f32 whatever
    # the model dtype, as the JAX step does, so against the JAX step and
    # the f64 full forward it keeps f32 rounding of the probabilities
    # (~1e-7 of logits of order 1): 1e-6.
    from minidiff_tpu.models.speculative import _chunk_step as jax_chunk_step
    from minidiff_tpu.models.speculative import _prefill as jax_prefill

    jm, jp, tm = mistral64
    toks = _tokens(2, 20, seed=5)
    tt = torch.from_numpy(toks)
    with md.use_backend("numpy"), md.no_grad():
        jcaches, jlast = jax_prefill(jm, jp, md.Tensor(toks[:, :12]), 128,
                                     md.float64)
    with torch.no_grad():
        full = tm(tt)
        caches, last = _prefill(tm, tt[:, :12], 128)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast._data),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(),
                                   rtol=1e-10, atol=1e-10)
        # row 1 advances one token behind row 0's two-token chunks
        for p0 in (12, 14, 16):
            pos = np.array([p0, p0 - 1])
            chunk = np.stack([toks[0, p0:p0 + 2], toks[1, p0 - 1:p0 + 1]])
            got = _chunk_step(tm, caches, torch.from_numpy(chunk),
                              torch.from_numpy(pos), 128)
            with md.use_backend("numpy"), md.no_grad():
                jcaches, ref = jax_chunk_step(jm, jp, jcaches, md.Tensor(chunk),
                                              md.Tensor(pos), 128)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref._data),
                                       rtol=0, atol=1e-6)
            want = torch.stack([full[0, p0:p0 + 2], full[1, p0 - 1:p0 + 1]])
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)
    assert caches[0]["k"].shape == (2, 2, 128, 64)  # kv heads, not h


def test_server_matches_solo_decode(mistral64):
    _, _, tm = mistral64
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (4, 6, 130)]
    srv = DecodeServer(tm, max_batch=2, window=256, device="cpu")
    assert srv._caches[0]["k"].shape == (2, 2, 256, 64)
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
    # no pos_emb under RoPE; the window rule is still the JAX server's
    with pytest.raises(ValueError, match=r"max_seq_len 256$"):
        DecodeServer(tm, max_batch=1, window=384, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = dict(MISTRAL, dim=256, num_heads=4, num_kv_heads=1, mlp_hidden=448,
             max_seq_len=32)


def test_loss_and_grads_match_jax_value_and_grad():
    toks = _tokens(2, 16, seed=6)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(TRAIN, torch.float64)
        t = md.Tensor(toks)
        loss_ref, grads = md.value_and_grad(
            lambda p: jax_lm_loss(jm.apply(p, t), t))(jp)
        ref = params_from_jax(_np_tree(grads))
    tt = torch.from_numpy(toks)
    loss = lm_loss(tm(tt), tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(loss_ref._data)),
                               rtol=1e-10, atol=1e-10)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


# f64 on both sides, so the steps differ only in summation order: 1e-9
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_optimizer_step_matches_jax(opt):
    jax_opt, torch_opt = {
        "sgd": (JaxSGD(0.1), SGD(0.1)),
        "adamw": (JaxAdamW(1e-2, weight_decay=0.1), AdamW(1e-2, weight_decay=0.1)),
    }[opt]
    toks = _tokens(2, 16, seed=7)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(TRAIN, torch.float64)
        jstep = jax_make_train_step(jm, jax_opt, loss_fn=jax_lm_loss, jit=False)
        jp, _, jloss = jstep(jp, jax_opt.init(jp), md.Tensor(toks), md.Tensor(toks))
    tloss = make_train_step(tm, torch_opt, loss_fn=lm_loss, device="cpu")(
        torch.from_numpy(toks), torch.from_numpy(toks))
    np.testing.assert_allclose(tloss.item(), float(np.asarray(jloss._data)),
                               rtol=1e-9)
    ref = params_from_jax(_np_tree(jp))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# what stays for later slices
# ---------------------------------------------------------------------------


# window and sinks are ported (tests/test_torch_window.py); a window or
# sinks out of range raise as the JAX layer's asserts do
@pytest.mark.parametrize("kw,err", [(dict(window=0), ValueError),
                                    (dict(window=64, sinks=-1), ValueError),
                                    (dict(dropout=0.1), NotImplementedError),
                                    (dict(remat_blocks=True), NotImplementedError)])
def test_later_options_raise(kw, err):
    with pytest.raises(err, match="later slice|must be >= "):
        TransformerLM(device="cpu", **SMALL, **kw)


def test_packing_raises():
    # packing is ported for TransformerLM (tests/test_torch_pack.py); its
    # tables must match the tokens' shape, and packed ids need S_q == S_k
    tm = TransformerLM(device="cpu", **dict(SMALL, rope=True, norm="rms"))
    toks = torch.zeros((1, 8), dtype=torch.long)
    assert tm(toks, segment_ids=toks, positions=toks).shape == (1, 8, 64)
    with pytest.raises((RuntimeError, ValueError, IndexError)):
        tm(toks, segment_ids=torch.zeros((1, 7), dtype=torch.long))
