"""The Mamba family of the port against the JAX package's, on the CPU.

The scan kernel's plain version against the interpret-mode Pallas kernel
and ``_jnp_scan``; ``ScanFn``'s gradients and the tape's ``linear_scan``
against the JAX VJPs; ``softplus``; and a tiny ``MambaLM`` loaded through
``params_from_jax``: logits, the loss and every gradient, an SGD step, the
recurrent step, the ragged prefill, greedy decoding and the decode server.
The JAX side runs on its numpy backend (the same model code over numpy
arrays) unless a test says otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minidiff_tpu as jmd
import minidiff_tpu_torch as md
from minidiff_tpu.kernels import scan as JK
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models import make_train_step as jax_make_train_step
from minidiff_tpu.models.ssm import MambaLM as JaxMamba
from minidiff_tpu.models.ssm import softplus as jax_softplus
from minidiff_tpu.ops import definitions as jdefs
from minidiff_tpu_torch import (SGD, MambaLM, SSMDecodeServer,
                                generate_compiled_ssm, lm_loss, make_train_step,
                                params_from_jax)
from minidiff_tpu_torch import kernels
from minidiff_tpu_torch.kernels import scan as S
from minidiff_tpu_torch.models.ssm import softplus
from minidiff_tpu_torch.utils import compute_grads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL64 = dict(rtol=1e-10, atol=1e-10)
CFG = dict(vocab_size=64, dim=32, num_layers=2, d_state=4)
_JAX_DT = {torch.float32: jmd.float32, torch.float64: jmd.float64}


def _np(t):
    return np.asarray(t, dtype=np.float64)


def _scan_inputs(shape, seed, lo=-1.05, hi=1.05):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape), rng.standard_normal(shape)


def _sequential(a, b):
    """The numpy backend's oracle over axis 1, in f64."""
    out = np.zeros_like(b)
    acc = np.zeros((b.shape[0], b.shape[2]))
    for t in range(b.shape[1]):
        acc = a[:, t] * acc + b[:, t]
        out[:, t] = acc
    return out


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


# f32: the Pallas tile scan (Hillis-Steele within a tile, a carried prefix
# across tiles) and the sequential loop sum in other orders: 1e-5
@pytest.mark.parametrize("b,t,c", [(2, 17, 200), (3, 300, 128)])
def test_plain_scan_matches_pallas_kernel_and_associative(b, t, c):
    a, bb = _scan_inputs((b, t, c), 20)
    a32, b32 = a.astype(np.float32), bb.astype(np.float32)
    bt, cb, t_pad, c_pad = JK._tiles(t, c)
    pallas = np.asarray(JK._run_padded(jnp.asarray(a32), jnp.asarray(b32), t, c,
                                       bt, cb, t_pad, c_pad, interpret=True))
    assoc = np.asarray(JK._jnp_scan(jnp.asarray(a32), jnp.asarray(b32), 1))
    got = S._plain_scan(torch.from_numpy(a32), torch.from_numpy(b32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), assoc, rtol=1e-5, atol=1e-5)
    # f64: the numpy backend's loop exactly
    got64 = S._plain_scan(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    np.testing.assert_allclose(got64, _sequential(a, bb), **TOL64)


def test_plain_scan_bf16_accumulates_in_f32():
    # slow decay over 512 steps: a bf16 carry would drift far from the
    # exact scan of the bf16-rounded inputs; an f32 carry rounded once per
    # output stays within one bf16 ulp (2^-8 relative) of it, and of the
    # Pallas kernel, which carries in f32 too
    rng = np.random.default_rng(21)
    t, c = 512, 256
    a = torch.from_numpy(rng.uniform(0.9, 0.999, (1, t, c))).to(torch.bfloat16)
    bb = torch.from_numpy(rng.standard_normal((1, t, c))).to(torch.bfloat16)
    got = S._plain_scan(a, bb)
    assert got.dtype == torch.bfloat16
    exact = _sequential(a.double().numpy(), bb.double().numpy())
    got64 = got.double().numpy()
    np.testing.assert_allclose(got64, exact, rtol=2 ** -8, atol=1e-2)
    bt, cb, t_pad, c_pad = JK._tiles(t, c)
    ja = jnp.asarray(a.float().numpy(), jnp.bfloat16)
    jb = jnp.asarray(bb.float().numpy(), jnp.bfloat16)
    pallas = np.asarray(JK._run_padded(ja, jb, t, c, bt, cb, t_pad, c_pad,
                                       interpret=True)).astype(np.float64)
    np.testing.assert_allclose(got64, pallas, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((3, 9), 1), ((2, 5, 4), 1),
                                        ((2, 3, 8), -1), ((4, 6, 2, 3), 2)])
def test_linear_scan_canonicalises_any_axis(shape, axis):
    a, bb = _scan_inputs(shape, 1)
    got = S.linear_scan(torch.from_numpy(a), torch.from_numpy(bb), axis=axis)
    moved = [np.moveaxis(x, axis, 0) for x in (a, bb)]
    ref = _sequential(*(x.reshape(1, x.shape[0], -1) for x in moved))
    ref = np.moveaxis(ref.reshape(moved[0].shape), 0, axis)
    np.testing.assert_allclose(got.numpy(), ref, **TOL64)


def test_scan_fn_grads_match_jax_vjps():
    a, bb = _scan_inputs((2, 9, 5), 3)
    g = np.random.default_rng(4).standard_normal(a.shape)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(bb).requires_grad_()
    y = S.linear_scan(ta, tb, axis=1)
    y.backward(torch.from_numpy(g))
    with jmd.use_backend("numpy"):
        ja, jb, jg = (jmd.Tensor(x) for x in (a, bb, g))
        ref_a = jdefs.linear_scan_grad_a(ja, jb, jg, axis=1)
        ref_b = jdefs.linear_scan_grad_b(ja, jb, jg, axis=1)
    np.testing.assert_allclose(ta.grad.numpy(), _np(ref_a._data), **TOL64)
    np.testing.assert_allclose(tb.grad.numpy(), _np(ref_b._data), **TOL64)


def test_scan_takes_the_plain_version_on_the_cpu():
    a, bb = (torch.from_numpy(x).float() for x in _scan_inputs((2, 8, 6), 5))
    kernels.reset_launch_counts()
    y = S.scan(a, bb)
    assert kernels.launch_counts()["scan"] == 0
    torch.testing.assert_close(y, S._plain_scan(a, bb), rtol=0, atol=0)
    with pytest.raises(ValueError, match="matching shapes"):
        S.linear_scan(a, bb[:, :4])


# ---------------------------------------------------------------------------
# the tape's linear_scan
# ---------------------------------------------------------------------------


@pytest.fixture
def _tape_backends():
    with jmd.use_backend("numpy"), md.use_backend("cpu"):
        yield


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_tape_linear_scan_matches_jax(axis, _tape_backends):
    a, bb = _scan_inputs((3, 6, 4), 6)
    ct = np.random.default_rng(7).standard_normal(a.shape)
    out = []
    for m in (jmd, md):
        ta, tb = m.Tensor(a, allow_grad=True), m.Tensor(bb, allow_grad=True)
        y = m.linear_scan(ta, tb, axis=axis)
        m.sum(y * m.Tensor(ct)).backward()
        out.append((_np(y), _np(ta.grad), _np(tb.grad)))
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got, ref, **TOL64)


def test_tape_backward_runs_one_reverse_scan(monkeypatch, _tape_backends):
    calls = []
    plain = S.scan
    monkeypatch.setattr(S, "scan", lambda a, b: calls.append(a.shape) or plain(a, b))
    a, bb = _scan_inputs((2, 7, 3), 8)
    ta, tb = md.Tensor(a, allow_grad=True), md.Tensor(bb, allow_grad=True)
    md.sum(md.linear_scan(ta, tb, axis=1) ** 2).backward()
    # the forward, then one reverse scan shared by both VJPs
    assert len(calls) == 2
    assert ta.grad is not None and tb.grad is not None


def test_tape_linear_scan_second_order_matches_jax(_tape_backends):
    a, bb = _scan_inputs((2, 5, 3), 9, lo=-0.9, hi=0.9)
    ct = np.random.default_rng(10).standard_normal(a.shape)
    out = []
    for m in (jmd, md):
        ta, tb = m.Tensor(a, allow_grad=True), m.Tensor(bb, allow_grad=True)
        y = m.linear_scan(ta, tb, axis=1)
        m.sum(y * y * m.Tensor(ct)).backward(allow_higher_order=True)
        ga, gb = ta.grad, tb.grad
        m.sum(ga * ga + gb * ga).backward()
        out.append((_np(ta.grad), _np(tb.grad)))
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got, ref, **TOL64)


def test_tape_linear_scan_gradcheck(_tape_backends):
    a, bb = _scan_inputs((2, 6, 3), 11, lo=-0.9, hi=0.9)
    ts = [md.Tensor(a), md.Tensor(bb)]
    for t in ts:
        t.allow_grad = True
    numeric, analytic = compute_grads(
        *ts, func=lambda x, y: md.sum(md.tanh(md.linear_scan(x, y, axis=1))))
    for n, g in zip(numeric, analytic):
        np.testing.assert_allclose(_np(g), _np(n), rtol=1e-5, atol=1e-6)


def test_tape_linear_scan_rejects_mismatched_shapes(_tape_backends):
    with pytest.raises(ValueError, match="matching shapes"):
        md.linear_scan(md.Tensor(np.ones((2, 3))), md.Tensor(np.ones((2, 4))))


def test_softplus_matches_jax_beyond_twenty():
    x = np.concatenate([np.linspace(-40, 40, 33), [-25.5, 20.5, 35.0, 1e-3]])
    with jmd.use_backend("numpy"):
        ref = _np(jax_softplus(jmd.Tensor(x))._data)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(), ref, **TOL64)


# ---------------------------------------------------------------------------
# MambaLM
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t._data), tree,
                        is_leaf=lambda t: isinstance(t, jmd.Tensor))


def _pair(dtype, seed=0):
    """The JAX model and its params (numpy backend), and the port model
    with the same weights."""
    np.random.seed(seed)
    jm = JaxMamba(dtype=_JAX_DT[dtype], **CFG)
    with jmd.use_backend("numpy"):
        jp = jm.init()
    tm = MambaLM(dtype=dtype, device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b, s, seed=1):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], size=(b, s))


# float32: the same algebra in another summation order through 2 layers
# leaves ~1e-6 relative; 1e-4 holds it with margin.  float64: the same at
# double precision.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_logits_match_jax_apply(dtype, tol):
    toks = _tokens(2, 12)
    jm, jp, tm = _pair(dtype)
    with jmd.use_backend("numpy"), jmd.no_grad():
        ref = _np(jm.apply(jp, jmd.Tensor(toks))._data)
    assert set(tm.state_dict()) == set(params_from_jax(_np_tree(jp)))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    assert out.dtype == dtype and out.shape == (2, 12, CFG["vocab_size"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_loss_and_grads_match_jax_value_and_grad(dtype, tol):
    toks = _tokens(2, 10)
    jm, jp, tm = _pair(dtype)
    with jmd.use_backend("numpy"):
        t = jmd.Tensor(toks)
        loss_ref, grads = jmd.value_and_grad(
            lambda p: jax_lm_loss(jm.apply(p, t), t))(jp)
        ref = params_from_jax(_np_tree(grads))
    tt = torch.from_numpy(toks)
    loss = lm_loss(tm(tt), tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(_np(loss_ref._data)),
                               rtol=tol, atol=tol)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        scale = max(1.0, float(ref[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=tol, atol=tol * scale, err_msg=name)


def test_sgd_step_matches_jax_make_train_step():
    # f64 on both sides: the steps differ only in summation order
    toks = _tokens(2, 8)
    jm, jp, tm = _pair(torch.float64)
    with jmd.use_backend("numpy"):
        opt = JaxSGD(0.1)
        jstep = jax_make_train_step(jm, opt, loss_fn=jax_lm_loss, jit=False)
        jp, _, jloss = jstep(jp, opt.init(jp), jmd.Tensor(toks), jmd.Tensor(toks))
    tstep = make_train_step(tm, SGD(0.1), loss_fn=lm_loss, device="cpu")
    tt = torch.from_numpy(toks)
    np.testing.assert_allclose(tstep(tt, tt).item(), float(_np(jloss._data)), rtol=1e-9)
    ref = params_from_jax(_np_tree(jp))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_step_matches_the_parallel_forward():
    toks = torch.from_numpy(_tokens(2, 9))
    _, _, tm = _pair(torch.float64)
    with torch.no_grad():
        full = tm(toks)
        state = tm.init_state(2)
        steps = []
        for t in range(toks.shape[1]):
            logits, state = tm.step(state, toks[:, t])
            steps.append(logits)
        lg, pstate = tm.prefill(toks)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), **TOL64)
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), **TOL64)
    for got, ref in zip(pstate, state):
        for key in ("h", "conv"):
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), **TOL64)


def test_ragged_prefill_matches_jax():
    toks = _tokens(3, 11)
    lengths = np.array([11, 2, 6])
    jm, jp, tm = _pair(torch.float64)
    with jmd.use_backend("numpy"), jmd.no_grad():
        jl, jst = jm.prefill(jp, jmd.Tensor(toks), lengths=jmd.Tensor(lengths))
        ref_logits = _np(jl._data)
        ref_states = _np_tree(jst)
    with torch.no_grad():
        lg, st = tm.prefill(torch.from_numpy(toks), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(lg.numpy(), ref_logits, **TOL64)
    for got, ref in zip(st, ref_states):
        for key in ("h", "conv"):
            np.testing.assert_allclose(got[key].numpy(), ref[key], **TOL64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_greedy_tokens_match_jax_generate(dtype):
    prompt = _tokens(2, 5, seed=3)
    jm, jp, tm = _pair(dtype)
    with jmd.use_backend("numpy"):
        ref = np.asarray(jm.generate(jp, jmd.Tensor(prompt), 12)._data)
    got = generate_compiled_ssm(tm, prompt, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tm.generate(prompt, 12).numpy(), ref)


def _schedule(srv, requests):
    """Staggered submits over more requests than slots (slot reuse)."""
    pending, slot_of, results, steps = list(enumerate(requests)), {}, {}, 0
    while pending or srv.active():
        if pending and len(slot_of) - len(results) < srv.max_batch and steps % 3 == 0:
            i, (p, n) = pending.pop(0)
            slot_of[i] = srv.submit(p, n, seed=i)
        srv.step()
        steps += 1
        for i, s in slot_of.items():
            if i not in results and srv.done(s):
                results[i] = srv.collect(s)
    return [results[i] for i in range(len(requests))], len(set(slot_of.values()))


def test_ssm_server_matches_solo_decode():
    rng = np.random.RandomState(5)
    requests = [(list(rng.randint(0, 64, n)), new)
                for n, new in [(5, 9), (140, 6), (3, 12), (20, 4), (9, 7)]]
    _, _, tm = _pair(torch.float32)
    srv = SSMDecodeServer(tm, max_batch=2, device="cpu")
    assert srv.window is None
    got, slots = _schedule(srv, requests)
    assert slots < len(requests)
    for (p, n), g in zip(requests, got):
        solo = generate_compiled_ssm(tm, [p], n, device="cpu")[0, len(p):]
        assert g == solo.tolist()


def test_sampling_is_deterministic_per_seed():
    _, _, tm = _pair(torch.float32)
    prompt = _tokens(2, 4, seed=6)
    a = generate_compiled_ssm(tm, prompt, 10, greedy=False, temperature=0.8,
                              top_k=20, seed=7, device="cpu")
    b = generate_compiled_ssm(tm, prompt, 10, greedy=False, temperature=0.8,
                              top_k=20, seed=7, device="cpu")
    c = generate_compiled_ssm(tm, prompt, 10, greedy=False, temperature=0.8,
                              top_k=20, seed=8, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :4], torch.from_numpy(prompt))


def test_cpu_paths_launch_no_kernel():
    _, _, tm = _pair(torch.float32)
    toks = torch.from_numpy(_tokens(2, 8))
    kernels.reset_launch_counts()
    make_train_step(tm, SGD(1e-3), lm_loss, device="cpu")(toks, toks)
    generate_compiled_ssm(tm, toks, 3, device="cpu")
    assert set(kernels.launch_counts().values()) == {0}


def test_entry_points_on_cuda_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaLM(**CFG)
    _, _, tm = _pair(torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_compiled_ssm(tm, _tokens(1, 3), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SSMDecodeServer(tm)
