"""The port's paged serving against the JAX package's, on the CPU.

The plain ``paged_attention`` (the gathered-view reference, what the CUDA
kernel is held to on the card) is compared with the JAX
``paged_attention_reference`` and with the Pallas page-walk kernel in
interpret mode, over GQA grouping, a window with sinks, head dim 64 and a
single-page slot.  ``PagedDecodeServer`` is held token for token to solo
decoding and to the JAX ``PagedDecodeServer`` on a staggered schedule that
reuses a slot and crosses page boundaries (float64, so that no argmax
near-tie can separate two correct implementations), and to the paging
contract of ``tests/test_paged.py``: oversubscribed pools, loud exhaustion
at submit and mid-decode, neighbour isolation, pages released on collect,
and the JAX server's ``kv_bytes``.

Tolerances: against the reference, the same algebra in another summation
order: float32 1e-5 relative plus 1e-6 of the largest value, bfloat16 one
ulp (2^-7 relative).  Against the interpret-mode kernel, which rounds the
unnormalised probabilities to bfloat16 against a running max where the
reference rounds the normalised ones: 2^-6 in bfloat16 (as
``chip_smoke.TOL["attn"]``), 1e-5 in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.kernels import paged as JP
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models.paged import PagedDecodeServer as JaxPaged
from minidiff_tpu_torch import (
    PagedDecodeServer,
    TransformerLM,
    generate_compiled,
    params_from_jax,
)
from minidiff_tpu_torch.kernels import paged as TP
from test_torch_capture import _drop_reference_programs  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAGE = TP.PAGE
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, ref, rtol, atol):
    got = np.asarray(got.to(torch.float64) if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


# (b, kv, g, hd, maxp, pages used per slot, dtype, window, sinks)
KERNEL_CASES = {
    "f32": (2, 2, 1, 128, 4, [2, 4], "float32", None, 0),
    "bf16_gqa": (3, 2, 4, 128, 3, [1, 3, 2], "bfloat16", None, 0),
    "window_sinks": (2, 1, 2, 128, 4, [4, 3], "float32", 192, 2),
    "hd64": (2, 2, 2, 64, 3, [2, 3], "float32", None, 0),
    "single_page": (2, 2, 2, 128, 4, [1, 1], "float32", None, 0),
    # head dim 256 (Gemma's), the third instantiation of the kernel
    "hd256": (2, 1, 2, 256, 3, [2, 3], "float32", None, 0),
    "hd256_bf16": (2, 2, 1, 256, 2, [1, 2], "bfloat16", None, 0),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_plain_paged_attention_matches_jax(case):
    b, kv, g, hd, maxp, used, dtype, window, sinks = KERNEL_CASES[case]
    rng = np.random.default_rng(list(KERNEL_CASES).index(case))
    npages = 1 + sum(used)
    pk = rng.standard_normal((npages, kv, PAGE, hd)).astype(np.float32)
    pv = rng.standard_normal((npages, kv, PAGE, hd)).astype(np.float32)
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    table = np.zeros((b, maxp), np.int32)
    nxt = 1
    for i, u in enumerate(used):
        table[i, :u] = np.arange(nxt, nxt + u)
        nxt += u
    # each slot's position lands inside its last used page
    pos = np.array([(u - 1) * PAGE + int(rng.integers(0, PAGE)) for u in used],
                   np.int32)
    scale = hd ** -0.5
    jargs = [jnp.asarray(a, _JNP[dtype]) for a in (q, pk, pv)]
    targs = [torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, pk, pv)]
    got = TP.paged_attention(*targs, torch.from_numpy(table), torch.from_numpy(pos),
                             window=window, sinks=sinks)
    assert got.dtype == _TORCH[dtype] and got.shape == (b, kv, g, hd)
    ref = JP.paged_attention_reference(*jargs, jnp.asarray(table), jnp.asarray(pos),
                                       scale, window, sinks)
    kern = JP._pallas_paged_attention(*jargs, jnp.asarray(table), jnp.asarray(pos),
                                      scale, window, sinks, interpret=True)
    if dtype == "float32":
        _close(got, ref, 1e-5, 1e-6)
        _close(got, kern, 1e-5, 1e-6)
    else:
        _close(got, ref, 2 ** -7, 1e-6)
        _close(got, kern, 2 ** -6, 2 ** -7)


def test_append_kv_matches_jax():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((5, 2, PAGE, 64)).astype(np.float32)
    rows = rng.standard_normal((3, 2, 64))
    pids, offs = np.array([3, 1, 4], np.int32), np.array([0, 127, 5], np.int32)
    ref = JP.append_kv(jnp.asarray(pool), jnp.asarray(rows, jnp.float32),
                       jnp.asarray(pids), jnp.asarray(offs))
    tpool = torch.from_numpy(pool.copy())
    out = TP.append_kv(tpool, torch.from_numpy(rows), torch.from_numpy(pids),
                       torch.from_numpy(offs))
    assert out is tpool  # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=48, dim=128, num_heads=2, num_layers=2, max_seq_len=512)


@pytest.fixture(scope="module")
def models():
    np.random.seed(0)
    jm = JaxLM(dtype=md.float64, **CFG)
    with md.use_backend("numpy"):
        jp = jm.init()
    tree = jax.tree.map(lambda t: np.asarray(t._data), jp,
                        is_leaf=lambda t: isinstance(t, md.Tensor))
    tm = TransformerLM(dtype=torch.float64, device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(tree))
    return jm, tree, tm


def _solo(tm, prompt, n):
    return generate_compiled(tm, [prompt], n, device="cpu")[0, len(prompt):].tolist()


def _drain(srv):
    while srv.active():
        srv.step()


def _staggered(srv, prompts):
    """Slot 0's first request finishes early and its slot (and pages) go to
    the third; the second crosses from its first page into a second one
    while the third runs; the third's 130-token prompt takes two pages at
    submit."""
    p1, p2, p3 = prompts
    s1 = srv.submit(p1, max_new_tokens=3)
    s2 = srv.submit(p2, max_new_tokens=10)
    while not srv.done(s1):
        srv.step()
    out1 = srv.collect(s1)
    s3 = srv.submit(p3, max_new_tokens=5)
    assert s3 == s1
    _drain(srv)
    return [out1, srv.collect(s2), srv.collect(s3)]


def test_paged_server_matches_solo_decode_and_jax(models):
    jm, tree, tm = models
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 48, n)] for n in (4, 124, 130)]
    srv = PagedDecodeServer(tm, max_batch=2, window=256, device="cpu")
    port = _staggered(srv, prompts)
    assert srv.pages_in_use() == 0
    solo = [_solo(tm, p, n) for p, n in zip(prompts, (3, 10, 5))]
    assert port == solo
    with md.use_backend("xla"):
        jp = jax.tree.map(md.Tensor, tree)
        ref = _staggered(JaxPaged(jm, jp, max_batch=2, window=256), prompts)
    assert port == [[int(t) for t in o] for o in ref]


# Mistral-7B-v0.3's options at a tiny size: the pool holds the 2 KV heads,
# and each step's 8 query heads attend through them in groups of 4
MISTRAL_CFG = dict(vocab_size=48, dim=256, num_heads=8, num_kv_heads=2,
                   num_layers=2, max_seq_len=512, norm="rms", norm_eps=1e-5,
                   rope=True, rope_base=1e6, mlp="swiglu", mlp_hidden=448,
                   mlp_bias=False)


def test_paged_mistral_server_matches_solo_decode_and_jax():
    np.random.seed(3)
    jm = JaxLM(dtype=md.float64, **MISTRAL_CFG)
    with md.use_backend("numpy"):
        jp = jm.init()
    tree = jax.tree.map(lambda t: np.asarray(t._data), jp,
                        is_leaf=lambda t: isinstance(t, md.Tensor))
    tm = TransformerLM(dtype=torch.float64, device="cpu", **MISTRAL_CFG)
    tm.load_state_dict(params_from_jax(tree))
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 48, n)] for n in (4, 124, 130)]
    srv = PagedDecodeServer(tm, max_batch=2, window=256, device="cpu")
    assert srv._caches[0]["k"].shape[1:] == (2, 128, 32)
    port = _staggered(srv, prompts)
    assert srv.pages_in_use() == 0
    assert port == [_solo(tm, p, n) for p, n in zip(prompts, (3, 10, 5))]
    with md.use_backend("xla"):
        ref = _staggered(JaxPaged(jm, jax.tree.map(md.Tensor, tree), max_batch=2,
                                  window=256), prompts)
    assert port == [[int(t) for t in o] for o in ref]


def test_paged_page_accounting_and_boundary_crossing(models):
    _, _, tm = models
    srv = PagedDecodeServer(tm, max_batch=2, window=512, device="cpu")
    p = [int(t) for t in np.random.default_rng(2).integers(0, 48, 126)]
    s = srv.submit(p, max_new_tokens=6)
    assert srv.pages_in_use() == 1 and srv.free_page_count() == 7
    _drain(srv)
    assert srv.pages_in_use() == 2  # crossed into a second page
    assert srv.collect(s) == _solo(tm, p, 6)
    assert srv.pages_in_use() == 0 and srv.free_page_count() == 8


def test_paged_oversubscribed_pool_reuses_pages(models):
    _, _, tm = models
    # dense capacity would be 4 slots * 512/128 = 16 pages; give it 4
    srv = PagedDecodeServer(tm, max_batch=4, window=512, num_pages=4, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        prompts = [[int(t) for t in rng.integers(0, 48, n)] for n in (4, 9)]
        slots = [srv.submit(p, max_new_tokens=4) for p in prompts]
        _drain(srv)
        for p, s in zip(prompts, slots):
            assert srv.collect(s) == _solo(tm, p, 4)
    assert srv.pages_in_use() == 0


def test_paged_exhaustion_is_loud(models):
    _, _, tm = models
    rng = np.random.default_rng(4)
    srv = PagedDecodeServer(tm, max_batch=4, window=512, num_pages=2, device="cpu")
    srv.submit([int(t) for t in rng.integers(0, 48, 130)], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        srv.submit([1, 2, 3], max_new_tokens=2)
    srv = PagedDecodeServer(tm, max_batch=2, window=512, num_pages=1, device="cpu")
    srv.submit([int(t) for t in rng.integers(0, 48, 126)], max_new_tokens=8)
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        _drain(srv)  # crosses 128 at the third step


def test_paged_slot_reuse_does_not_perturb_neighbor(models):
    _, _, tm = models
    srv = PagedDecodeServer(tm, max_batch=3, window=256, device="cpu")
    rng = np.random.default_rng(5)
    p1, p2, p3 = ([int(t) for t in rng.integers(0, 48, n)] for n in (4, 6, 9))
    s1 = srv.submit(p1, max_new_tokens=2)
    s2 = srv.submit(p2, max_new_tokens=8)
    _ = [srv.step() for _ in range(2)]
    assert srv.collect(s1) == _solo(tm, p1, 2)
    # the released slot keeps stepping into the garbage page; its pages are
    # reused by the next request, and the neighbour decodes on untouched
    s3 = srv.submit(p3, max_new_tokens=3)
    _drain(srv)
    assert srv.collect(s2) == _solo(tm, p2, 8)
    assert srv.collect(s3) == _solo(tm, p3, 3)


def test_paged_kv_bytes_equal_jax(models):
    jm, tree, tm = models
    with md.use_backend("xla"):
        jp = jax.tree.map(md.Tensor, tree)
        for pages in (None, 5):
            ref = JaxPaged(jm, jp, max_batch=2, window=512, num_pages=pages)
            srv = PagedDecodeServer(tm, max_batch=2, window=512, num_pages=pages,
                                    device="cpu")
            assert srv.kv_bytes() == ref.kv_bytes()


def test_paged_later_paths_and_devices_raise(models):
    _, _, tm = models
    srv = PagedDecodeServer(tm, max_batch=1, window=256, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        srv.submit([1, 2], 2, prefix=0)
    with pytest.raises(NotImplementedError, match="later slice"):
        PagedDecodeServer(tm, window=256, prefill_chunk=64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedDecodeServer(tm, window=256)
