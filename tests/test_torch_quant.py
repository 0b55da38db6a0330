"""The port's quantized serving against the JAX package's, on the CPU.

The quantizers must give bit-identical codes and scales.  The plain
versions of the dequant-matmuls and of the int8-cache attention (what the
CUDA kernels are held to on the card) are compared with the JAX ``_jnp_*``
functions and with the Pallas kernels in interpret mode.  The quantized
TransformerLM's logits (a JAX quantized tree carried by ``params_from_jax``)
are held to ``TransformerLM.apply`` on the JAX numpy backend in float64, and
greedy ``generate_compiled`` with int8 weights and an int8 KV cache, and
with int4 weights, to the JAX ``generate_compiled`` token for token.

Tolerances (``_close``): float64 1e-10 (the same arithmetic in another
order); float32 1e-5 relative plus 1e-6 of the output's largest magnitude
(f32 sums of up to 512 terms in another order; an output that cancels to
near zero keeps the absolute error of its terms); bfloat16 one ulp of the
output, 2^-7 relative (both sides sum in f32 and round once; the sums differ
only in order, which can move a rounding by one ulp).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.kernels import quant as JQ
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import generate_compiled as jax_generate
from minidiff_tpu.models import quantize_for_serving as jax_quantize
from minidiff_tpu.models import quantized_bytes as jax_quantized_bytes
from minidiff_tpu_torch import (
    TransformerLM,
    generate_compiled,
    params_from_jax,
    quantize_for_serving,
    quantized_bytes,
)
from minidiff_tpu_torch.kernels import quant as TQ
from test_torch_capture import _drop_reference_programs  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (rtol, atol); atol is a share of the reference's largest magnitude but
# for float64
TOL = {"float64": (1e-10, 1e-10), "float32": (1e-5, 1e-6),
       "bfloat16": (2 ** -7, 1e-6)}
_JNP = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _np(a):
    return np.asarray(a, dtype=np.float64) if not isinstance(a, torch.Tensor) \
        else a.to(torch.float64).numpy()


def _close(got, ref, dtype: str):
    got, ref = _np(got), _np(ref)
    rtol, atol = TOL[dtype]
    if dtype != "float64":
        atol *= np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _both(a, dtype: str):
    """A numpy array as (jnp array, torch tensor) of ``dtype``; sub-f64
    dtypes round from the same f32 values on both sides."""
    a = np.asarray(a, np.float64 if dtype == "float64" else np.float32)
    return jnp.asarray(a, _JNP[dtype]), torch.from_numpy(a).to(_TORCH[dtype])


def _weight(k, n, seed=0):
    w = np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero column takes the s = 1 guard
    return w


# ---------------------------------------------------------------------------
# quantizers: bit-identical codes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "int8_rows", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_are_bit_identical_to_jax(name, dtype):
    w = _weight(256, 48) * 3
    if name == "int8_rows":
        w = w.reshape(4, 3, 16, 64)  # (B, h, s, hd); one zero row per head
        w[0, 1, 2] = 0.0
    wj, wt = _both(w, dtype)
    jfn, tfn = {"int8": (JQ.quantize_int8, TQ.quantize_int8),
                "int8_rows": (JQ.quantize_int8_rows, TQ.quantize_int8_rows),
                "int4": (JQ.quantize_int4, TQ.quantize_int4)}[name]
    (qj, sj), (qt, st) = jfn(wj), tfn(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if name == "int4":
        np.testing.assert_array_equal(TQ.unpack_int4(qt).numpy(),
                                      np.asarray(JQ.unpack_int4(qj)))


# ---------------------------------------------------------------------------
# plain versions against the _jnp_* functions and the interpret-mode kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def _interpret_pallas(monkeypatch):
    """Run every pallas_call in interpret mode (tests/test_quant.py:160)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_plain_dequant_matmul_matches_jax(dtype, _interpret_pallas):
    x = np.random.RandomState(1).standard_normal((16, 256))
    q, s = JQ.quantize_int8(jnp.asarray(_weight(256, 512)))
    xj, xt = _both(x, dtype)
    got = TQ._plain_dequant_matmul(xt, torch.from_numpy(np.array(q)),
                                   torch.from_numpy(np.array(s)))
    assert got.dtype == _TORCH[dtype] and got.shape == (16, 512)
    refs = [JQ._jnp_dequant_matmul(xj, q, s)]
    if dtype != "float64":  # the kernel takes f32 and bf16
        refs.append(JQ._pallas_dequant_matmul(xj, q, s))
    for ref in refs:
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_plain_dequant_matmul4_matches_jax(dtype):
    x = np.random.RandomState(2).standard_normal((16, 512))
    p, s = JQ.quantize_int4(jnp.asarray(_weight(512, 256, seed=3)))
    xj, xt = _both(x, dtype)
    got = TQ._plain_dequant_matmul4(xt, torch.from_numpy(np.array(p)),
                                    torch.from_numpy(np.array(s)))
    refs = [JQ._jnp_dequant_matmul4(xj, p, s)]
    if dtype != "float64":
        refs.append(JQ._pallas_dequant_matmul4(xj, p, s, interpret=True))
    for ref in refs:
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_quantizer_is_bit_identical_to_jax(dtype):
    w = np.stack([_weight(64, 48, seed=e) * (e + 1) for e in range(3)])
    w[2] = 0.0  # an all-zero expert takes the s = 1 guard in every column
    wj, wt = _both(w, dtype)
    (qj, sj), (qt, st) = JQ.quantize_int8_stacked(wj), TQ.quantize_int8_stacked(wt)
    assert qt.dtype == torch.int8 and tuple(st.shape) == (3, 48)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    with pytest.raises(ValueError, match="3-D"):
        TQ.quantize_int8_stacked(wt[0])


# (E, C, K, N): the interpret-mode kernel's N-tile is 256; a C that is no
# multiple of 8 (the CUDA kernel's rows per CTA) and one of 16
@pytest.mark.parametrize("c", [5, 16])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_plain_dequant_bmm_matches_jax(dtype, c, _interpret_pallas):
    e, k, n = 3, 128, 512
    x = np.random.RandomState(8).standard_normal((e, c, k))
    wb = np.stack([_weight(k, n, seed=10 + i) for i in range(e)])
    q, s = JQ.quantize_int8_stacked(jnp.asarray(wb))
    xj, xt = _both(x, dtype)
    qt, st = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    got = TQ._plain_dequant_bmm(xt, qt, st)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == (e, c, n)
    refs = [JQ._jnp_dequant_bmm(xj, q, s)]
    if dtype != "float64":  # the kernel takes f32 and bf16
        refs.append(JQ._pallas_dequant_bmm(xj, q, s))
    for ref in refs:
        _close(got, ref, dtype)
    # the entry point (the plain version on the CPU) and each expert's 2-D
    # product agree with it exactly
    assert torch.equal(TQ.dequant_matmul_bmm(xt, qt, st), got)
    for i in range(e):
        _close(got[i], JQ._jnp_dequant_matmul(xj[i], q[i], s[i]), dtype)


def test_dequant_bmm_shape_errors_and_route_rule():
    q, s = TQ.quantize_int8_stacked(torch.randn(2, 16, 8))
    for bad_x, bad_q in ((torch.randn(2, 16), q), (torch.randn(2, 3, 16), q[0]),
                         (torch.randn(3, 3, 16), q), (torch.randn(2, 3, 12), q)):
        with pytest.raises(ValueError, match="dequant_matmul_bmm"):
            TQ.dequant_matmul_bmm(bad_x, bad_q, s)
    # the rule of dq_mm on C, the rows per expert (quant.py:111): a server
    # prefill of a 384-token bucket routes 384 rows per expert at capacity
    # E / k, which take the plain product on the dequantized bank
    assert TQ.uses_kernel(256) and not TQ.uses_kernel(384)
    x = torch.randn(2, 384, 16, dtype=torch.float64)
    assert torch.equal(TQ.dequant_matmul_bmm(x, q, s),
                       TQ._plain_dequant_bmm(x, q, s))
    # the tape's entry: f64 (the oracle) always takes the plain version
    entry = TQ.for_tape("dequant_matmul_bmm")
    assert torch.equal(entry(x, q, s), TQ._plain_dequant_bmm(x, q, s))


def _cache(b, kv, L, hd, seed):
    rng = np.random.RandomState(seed)
    k8, ks = JQ.quantize_int8_rows(jnp.asarray(rng.standard_normal((b, kv, L, hd))))
    v8, vs = JQ.quantize_int8_rows(jnp.asarray(rng.standard_normal((b, kv, L, hd))))
    return (k8, ks, v8, vs), tuple(torch.from_numpy(np.array(t)) for t in (k8, ks, v8, vs))


# (batch, kv heads, group, chunk): decode (g = c = 1), and GQA with a chunk
@pytest.mark.parametrize("b,kv,g,c", [(2, 2, 1, 1), (2, 1, 2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sdpa_int8_matches_jax(b, kv, g, c, dtype):
    L, hd = 256, 128
    (jk8, jks, jv8, jvs), (tk8, tks, tv8, tvs) = _cache(b, kv, L, hd, seed=4)
    q = np.random.RandomState(5).standard_normal((b, kv, g * c, hd))
    qj, qt = _both(q, dtype)
    pos = np.array([7, 200])[:b]
    got = TQ._plain_sdpa_int8(qt, tk8, tks, tv8, tvs, torch.from_numpy(pos), c,
                              hd ** -0.5)
    assert got.dtype == _TORCH[dtype]
    for ref in (JQ._jnp_sdpa_int8(qj, jk8, jks, jv8, jvs, jnp.asarray(pos), c,
                                  hd ** -0.5),
                JQ._pallas_sdpa_int8(qj, jk8, jks, jv8, jvs, jnp.asarray(pos), c,
                                     hd ** -0.5, interpret=True)):
        _close(got, ref, dtype)
    # the (B, h, c, hd) entry point regroups the heads as the JAX one does
    qh = qt.reshape(b, kv * g, c, hd)
    want = JQ.sdpa_int8_cache(qj.reshape(b, kv * g, c, hd), jk8, jks, jv8, jvs,
                              jnp.asarray(pos))
    _close(TQ.sdpa_int8_cache(qh, tk8, tks, tv8, tvs, torch.from_numpy(pos)),
           want, dtype)


# head dim 256 (Gemma's), the kernel's third instantiation; the JAX
# kernel takes any multiple of 128
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sdpa_int8_at_head_dim_256_matches_jax(dtype):
    b, kv, g, c, L, hd = 2, 1, 2, 1, 128, 256
    (jk8, jks, jv8, jvs), (tk8, tks, tv8, tvs) = _cache(b, kv, L, hd, seed=6)
    q = np.random.RandomState(7).standard_normal((b, kv * g, c, hd))
    qj, qt = _both(q, dtype)
    pos = np.array([40, 127])
    got = TQ.sdpa_int8_cache(qt, tk8, tks, tv8, tvs, torch.from_numpy(pos))
    assert got.dtype == _TORCH[dtype] and got.shape == (b, kv * g, c, hd)
    qg = qj.reshape(b, kv, g * c, hd)
    for ref in (JQ._jnp_sdpa_int8(qg, jk8, jks, jv8, jvs, jnp.asarray(pos), c,
                                  hd ** -0.5),
                JQ._pallas_sdpa_int8(qg, jk8, jks, jv8, jvs, jnp.asarray(pos), c,
                                     hd ** -0.5, interpret=True)):
        _close(got.reshape(b, kv, g * c, hd), ref, dtype)


def test_prefill_sized_products_take_the_matmul_route():
    # quant.py:111: more than 256 activation rows is no weight stream
    assert TQ.uses_kernel(8) and TQ.uses_kernel(256)
    assert not TQ.uses_kernel(257)
    x = torch.randn(3, 100, 256, dtype=torch.float64)
    q, s = TQ.quantize_int8(torch.randn(256, 32))
    np.testing.assert_allclose(TQ.dequant_matmul(x, q, s).numpy(),
                               TQ._plain_dequant_matmul(x, q, s).numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the quantized model
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=64, dim=256, num_heads=2, num_layers=2, max_seq_len=256)


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _jax_pair(cfg, dtype, seed=0):
    """The JAX model and its params (numpy backend) and the port model with
    the same weights."""
    np.random.seed(seed)
    jm = JaxLM(dtype={torch.float64: md.float64, torch.float32: md.float32}[dtype],
               **cfg)
    with md.use_backend("numpy"):
        jp = jm.init()
    tm = TransformerLM(dtype=dtype, device="cpu", **cfg)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_lm_logits_match_jax(bits):
    with md.use_backend("numpy"):
        jm, jp, tm = _jax_pair(CFG, torch.float64)
        jq = jax_quantize(jp, bits=bits)
        toks = np.random.RandomState(1).randint(0, CFG["vocab_size"], size=(2, 24))
        with md.no_grad():
            ref = np.asarray(jm.apply(jq, md.Tensor(toks))._data)
    # the JAX quantized tree loads into the port's quantized structure ...
    tq = quantize_for_serving(tm, bits=bits)
    tq.load_state_dict(params_from_jax(_np_tree(jq)))
    # ... and the port quantizes the float weights to the same codes
    for key, val in quantize_for_serving(tm, bits=bits).state_dict().items():
        assert torch.equal(val, tq.state_dict()[key]), key
    with torch.no_grad():
        out = tq(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-10)


def test_quantize_for_serving_selectivity_and_bytes():
    # dim 192: the projections' K = 192 is no multiple of the int4 group
    # of 128 and falls back to int8; fc2's K = 768 takes int4
    cfg = dict(CFG, dim=192, num_heads=3)
    _, jp, tm = _jax_pair(cfg, torch.float32)
    for bits, kw in ((8, {}), (4, {}), (8, dict(min_elements=10 ** 9))):
        with md.use_backend("numpy"):
            jq = jax_quantize(jp, bits=bits, **kw)
        tq = quantize_for_serving(tm, bits=bits, **kw)
        want = params_from_jax(_np_tree(jq))
        got = tq.state_dict()
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
        assert quantized_bytes(tq) == jax_quantized_bytes(jq)
    assert not any(k.endswith(("w_q", "w_q4")) for k in got)  # min_elements
    tq4 = quantize_for_serving(tm, bits=4)
    names = set(tq4.state_dict())
    assert {"blocks.0.attn.qkv.w_q", "blocks.0.fc2.w_q4", "head.w"} <= names
    assert {"tok_emb", "pos_emb", "blocks.0.ln1.g", "blocks.0.fc1.b"} <= names
    # the input model is untouched and shares no storage with the copy
    assert tm.blocks[0].fc2.w is not None and tm.blocks[0].fc2.w_q4 is None
    assert tq4.tok_emb.data_ptr() != tm.tok_emb.data_ptr()
    with pytest.raises(ValueError):
        quantize_for_serving(tm, bits=3)


def test_int8_buffers_survive_to():
    _, _, tm = _jax_pair(CFG, torch.float32)
    tq = quantize_for_serving(tm).to("cpu")
    assert tq.blocks[0].attn.qkv.w_q.dtype == torch.int8
    assert tq.blocks[0].attn.qkv.w_s.dtype == torch.float32


# greedy decode: XLA on the JAX side (generate_compiled is a jitted scan),
# the port's plain versions on the CPU, both in float64
GEN_CFG = dict(vocab_size=64, dim=128, num_heads=2, num_layers=2, max_seq_len=256)


@pytest.mark.parametrize("bits,kv_quant", [(8, True), (4, False)])
def test_quantized_generate_matches_jax(bits, kv_quant):
    jm, jp, tm = _jax_pair(GEN_CFG, torch.float64, seed=1)
    with md.use_backend("numpy"):
        jq = jax_quantize(jp, bits=bits)
    tq = quantize_for_serving(tm, bits=bits)
    tq.load_state_dict(params_from_jax(_np_tree(jq)))
    prompt = np.random.RandomState(2).randint(0, 64, size=(2, 9))
    with md.use_backend("xla"):
        jq_xla = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jq,
                              is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jq_xla, md.Tensor(prompt), 10,
                                      kv_quant=kv_quant)._data)
    out = generate_compiled(tq, prompt, 10, device="cpu", kv_quant=kv_quant)
    np.testing.assert_array_equal(out.numpy(), ref)


# Mistral-7B-v0.3's options at a tiny size (RMSNorm, RoPE at base 1e6,
# 8 heads over 2 KV heads, SwiGLU, no biases): wq and wkv quantize like
# any Linear, and the int8 cache holds the KV heads only
MISTRAL_CFG = dict(vocab_size=64, dim=256, num_heads=8, num_kv_heads=2,
                   num_layers=2, max_seq_len=256, norm="rms", norm_eps=1e-5,
                   rope=True, rope_base=1e6, mlp="swiglu", mlp_hidden=448,
                   mlp_bias=False)


def test_quantized_mistral_generate_matches_jax():
    jm, jp, tm = _jax_pair(MISTRAL_CFG, torch.float64, seed=4)
    with md.use_backend("numpy"):
        jq = jax_quantize(jp)
    tq = quantize_for_serving(tm)
    assert set(tq.state_dict()) == set(params_from_jax(_np_tree(jq)))
    assert {"blocks.0.attn.wq.w_q", "blocks.0.attn.wkv.w_q"} <= set(tq.state_dict())
    tq.load_state_dict(params_from_jax(_np_tree(jq)))
    prompt = np.random.RandomState(5).randint(0, 64, size=(2, 9))
    with md.use_backend("xla"):
        jq_xla = jax.tree.map(lambda t: md.Tensor(np.asarray(t._data)), jq,
                              is_leaf=lambda t: isinstance(t, md.Tensor))
        ref = np.asarray(jax_generate(jm, jq_xla, md.Tensor(prompt), 10,
                                      kv_quant=True)._data)
    out = generate_compiled(tq, prompt, 10, device="cpu", kv_quant=True)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_quant_cache_layout_and_determinism():
    _, _, tm = _jax_pair(GEN_CFG, torch.float32, seed=1)
    from minidiff_tpu_torch.models.speculative import _prefill

    prompt = torch.from_numpy(np.random.RandomState(3).randint(0, 64, (2, 5)))
    with torch.no_grad():
        caches, _ = _prefill(tm, prompt, 128, kv_quant=True)
    c = caches[0]
    assert set(c) == {"k8", "ks", "v8", "vs"} and c["k8"].dtype == torch.int8
    assert c["k8"].shape == (2, 2, 128, 64) and c["ks"].shape == (2, 2, 128)
    # unwritten rows: zero codes, unit scales
    assert not c["k8"][:, :, 5:].any() and bool((c["ks"][:, :, 5:] == 1).all())
    a = generate_compiled(tm, prompt, 6, device="cpu", kv_quant=True)
    assert torch.equal(a, generate_compiled(tm, prompt, 6, device="cpu",
                                            kv_quant=True))
