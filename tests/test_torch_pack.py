"""Sequence packing in the port (``models/pack.py``) against the JAX
package's, on the CPU.

``pack_documents`` and ``segment_positions`` against the JAX package's on
the same documents, equal; ``TransformerLM.forward(tokens, segment_ids=,
positions=)`` (learned positions, and RoPE with a window and sinks) against
the JAX ``apply``; the packed loss and every gradient against
``md.value_and_grad``; two steps of ``make_packed_train_step`` against the
JAX ``make_packed_train_step`` (its numpy backend, ``jit=False``); and the
captured step (``jit=True``) against the eager one, bit for bit, with one
program for two batches of a shape.  Tolerances: float64 on both sides,
1e-10 (steps: 1e-9); float32 at head dim 128 (the flash kernels' plain
versions with segment ids) 1e-4.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models import pack as jax_pack
from minidiff_tpu_torch import SGD, TransformerLM, params_from_jax
from minidiff_tpu_torch.models import (lm_loss, make_packed_train_step, pack_documents,
                                       segment_positions)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEARNED = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq_len=64)
ROPE = dict(vocab_size=64, dim=256, num_heads=2, num_kv_heads=1, num_layers=2,
            max_seq_len=64, norm="rms", norm_eps=1e-5, rope=True, mlp="swiglu",
            mlp_hidden=448, mlp_bias=False, window=12, sinks=2)
CONFIGS = {"learned": LEARNED, "rope_window": ROPE}
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(cfg, dtype, seed=0):
    np.random.seed(seed)
    jm = JaxLM(dtype=_JAX_DT[dtype], **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = TransformerLM(dtype=dtype, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _docs(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 64, size=rng.randint(lo, hi + 1))) for _ in range(n)]


def _batch(seq_len=32, seed=3, n=7):
    return pack_documents(_docs(n, 1, 45, seed), seq_len)


@pytest.mark.parametrize("seq_len,seed", [(32, 3), (16, 4), (48, 5)])
def test_pack_documents_equals_jax(seq_len, seed):
    docs = _docs(9, 0, 60, seed)  # empty documents and ones longer than a row
    got, ref = pack_documents(docs, seq_len), jax_pack.pack_documents(docs, seq_len)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(segment_positions(got["segment_ids"]),
                                  jax_pack.segment_positions(ref["segment_ids"]))
    one = got["segment_ids"][0]
    np.testing.assert_array_equal(segment_positions(one), jax_pack.segment_positions(one))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_logits_match_jax_apply(name, dtype, tol):
    bt = _batch()
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(CONFIGS[name], dtype)
        with md.no_grad():
            ref = np.asarray(jm.apply(jp, md.Tensor(bt["tokens"]),
                                      segment_ids=md.Tensor(bt["segment_ids"]),
                                      positions=md.Tensor(bt["positions"]))._data)
    with torch.no_grad():
        out = tm(torch.from_numpy(bt["tokens"]),
                 segment_ids=torch.from_numpy(bt["segment_ids"]),
                 positions=torch.from_numpy(bt["positions"]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    # each document alone gives its own logits: no cross-talk
    seg, toks = bt["segment_ids"][0], bt["tokens"][0]
    d = int(seg.max())
    at = np.flatnonzero(seg == d)
    with torch.no_grad():
        alone = tm(torch.from_numpy(toks[at][None]))[0]
    np.testing.assert_allclose(out[0, at].numpy(), alone.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_packed_loss_and_grads_match_jax(dtype, tol):
    bt = _batch(seed=8)
    tabs = {k: torch.from_numpy(v) for k, v in bt.items()}
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(ROPE, dtype)
        jt = {k: md.Tensor(v) for k, v in bt.items()}
        loss_ref, grads = md.value_and_grad(lambda p: jax_lm_loss(
            jm.apply(p, jt["tokens"], segment_ids=jt["segment_ids"],
                     positions=jt["positions"]), jt["targets"], mask=jt["loss_mask"]))(jp)
        ref = params_from_jax(_np_tree(grads))
    loss = lm_loss(tm(tabs["tokens"], segment_ids=tabs["segment_ids"],
                      positions=tabs["positions"]), tabs["targets"], mask=tabs["loss_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(loss_ref._data)), rtol=tol,
                               atol=tol)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_packed_train_steps_match_jax(name):
    batches = [_batch(seed=10), _batch(seed=11)]
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(CONFIGS[name], torch.float64)
        jopt = JaxSGD(0.1)
        jstep = jax_pack.make_packed_train_step(jm, jopt, jit=False)
        state = jopt.init(jp)
        jlosses = []
        for bt in batches:
            jp, state, jl = jstep(jp, state, bt)
            jlosses.append(float(np.asarray(jl._data)))
    step = make_packed_train_step(tm, SGD(0.1), device="cpu")
    losses = [step(bt).item() for bt in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9)
    ref = params_from_jax(_np_tree(jp))
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[k].numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def test_captured_step_equals_eager_with_one_program():
    batches = [{k: v[:3] for k, v in _batch(seed=seed).items()} for seed in (20, 21)]
    assert batches[0]["tokens"].shape == batches[1]["tokens"].shape
    models = [TransformerLM(device="cpu", seed=4, **ROPE) for _ in range(2)]
    jit_step = make_packed_train_step(models[0], SGD(0.1), jit=True, device="cpu")
    eager_step = make_packed_train_step(models[1], SGD(0.1), jit=False, device="cpu")
    for bt in batches:
        a, b = jit_step(bt), eager_step({k: torch.from_numpy(v) for k, v in bt.items()})
        assert torch.equal(a, b)
    assert len(jit_step._cache) == 1
    for pa, pb in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(pa, pb)
    with pytest.raises(ValueError, match="table"):
        jit_step(dict(batches[0], loss_mask=batches[0]["loss_mask"][:, :-1]))
    with pytest.raises(NotImplementedError):
        make_packed_train_step(models[0], donate=True, device="cpu")
