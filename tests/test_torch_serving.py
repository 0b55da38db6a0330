"""The port's serving path against the JAX package's, on the CPU.

Greedy decoding is held to token identity: the port's ``generate_compiled``
against the JAX ``generate_compiled``, and the port's ``DecodeServer``
against the port's solo decode and the JAX server, for staggered arrivals,
prompts over two 128-token buckets and slot reuse (the contract of
``tests/test_server.py``).  These run in float64, so that no argmax near-tie
can separate two correct implementations.  Sampled decoding draws its
Gumbel noise from a torch.Generator, which cannot reproduce JAX's threefry
bits: it is held to determinism per seed and to the truncation rules.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import DecodeServer as JaxServer
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import functional as JF
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu_torch import (
    DecodeServer,
    TransformerLM,
    generate_compiled,
    params_from_jax,
)
from minidiff_tpu_torch.models import functional as F
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


CFG = dict(vocab_size=64, dim=256, num_heads=2, num_layers=2, max_seq_len=256)


@pytest.fixture(scope="module")
def models():
    md.set_backend("xla")
    np.random.seed(0)
    jm = JaxLM(dtype=md.float64, **CFG)
    jp = jm.init()
    tree = jax.tree.map(lambda t: np.asarray(t._data), jp,
                        is_leaf=lambda t: isinstance(t, md.Tensor))
    tm = TransformerLM(dtype=torch.float64, device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(tree))
    return jm, jp, tm


def _solo(tm, prompt, n, **kw):
    out = generate_compiled(tm, [prompt], n, device="cpu", **kw)
    return out[0, len(prompt):].tolist()


def _drain(srv):
    while srv.active():
        srv.step()


def test_greedy_generate_matches_jax(models):
    jm, jp, tm = models
    prompt = np.random.RandomState(3).randint(0, 64, size=(2, 16))
    ref = np.asarray(jax_generate(jm, jp, md.Tensor(prompt), 12)._data)
    out = generate_compiled(tm, prompt, 12, device="cpu")
    assert out.shape == (2, 28) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)


def _staggered(srv, prompts):
    """Mirror of test_server's staggered-arrival, slot-reuse schedule."""
    p1, p2, p3 = prompts
    s1 = srv.submit(p1, max_new_tokens=3)   # finishes first
    s2 = srv.submit(p2, max_new_tokens=10)
    while not srv.done(s1):
        srv.step()
    out1 = srv.collect(s1)
    s3 = srv.submit(p3, max_new_tokens=5)   # takes s1's slot mid-decode of s2
    assert s3 == s1
    _drain(srv)
    return [out1, srv.collect(s2), srv.collect(s3)]


def test_server_matches_solo_decode_and_jax_server(models):
    jm, jp, tm = models
    rng = np.random.default_rng(1)
    # the third prompt spans two 128-token prefill buckets
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (4, 6, 130)]
    port = _staggered(DecodeServer(tm, max_batch=2, window=256, device="cpu"),
                      prompts)
    jax_srv = _staggered(JaxServer(jm, jp, max_batch=2, window=256), prompts)
    solo = [_solo(tm, p, n) for p, n in zip(prompts, (3, 10, 5))]
    assert port == solo
    assert port == [[int(t) for t in o] for o in jax_srv]


def test_sampled_decode_is_deterministic_per_seed(models):
    _, _, tm = models
    prompt = [5, 9, 2, 7]
    kw = dict(greedy=False, temperature=1.3)
    a = _solo(tm, prompt, 16, seed=11, **kw)
    assert a == _solo(tm, prompt, 16, seed=11, **kw)
    assert a != _solo(tm, prompt, 16, seed=12, **kw)
    srv = DecodeServer(tm, max_batch=3, window=256, greedy=False,
                       temperature=1.3, device="cpu")
    s1, s2, s3 = (srv.submit(prompt, 16, seed=s) for s in (11, 11, 12))
    _drain(srv)
    assert srv.collect(s1) == srv.collect(s2) != srv.collect(s3)


@pytest.mark.parametrize("trunc", [dict(top_k=1), dict(top_p=1e-6),
                                   dict(min_p=1.0)])
def test_sampling_truncated_to_one_token_is_greedy(models, trunc):
    _, _, tm = models
    prompt = [1, 2, 3]
    greedy = _solo(tm, prompt, 8)
    assert _solo(tm, prompt, 8, greedy=False, seed=5, **trunc) == greedy
    srv = DecodeServer(tm, max_batch=1, window=256, greedy=False,
                       device="cpu", **trunc)
    slot = srv.submit(prompt, 8, seed=5)
    _drain(srv)
    assert srv.collect(slot) == greedy


@pytest.mark.parametrize("trunc", [dict(top_k=5), dict(top_p=0.8),
                                   dict(min_p=0.3),
                                   dict(top_k=20, top_p=0.9, min_p=0.05)])
def test_truncate_logits_matches_jax(trunc):
    logits = np.random.RandomState(7).standard_normal((4, 64)) * 2
    ref = np.asarray(JF.truncate_logits(md.Tensor(logits), **trunc)._data)
    out = F.truncate_logits(torch.from_numpy(logits), **trunc).numpy()
    np.testing.assert_array_equal(out, ref)


def test_server_host_contract(models):
    _, _, tm = models
    srv = DecodeServer(tm, max_batch=1, window=256, device="cpu")
    s1 = srv.submit([1, 2], max_new_tokens=1)  # finishes immediately
    assert srv.done(s1) and not srv.active()
    with pytest.raises(RuntimeError, match="collect"):
        srv.submit([3], max_new_tokens=1)
    srv.collect(s1)
    assert srv.submit([3], max_new_tokens=1) == s1
    with pytest.raises(ValueError, match="max_seq_len"):
        DecodeServer(tm, max_batch=1, window=384, device="cpu")


def test_entry_points_raise_on_cuda_without_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, _, tm = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_compiled(tm, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(tm)
