"""The port's training path against the JAX package's, on the CPU.

A tiny TransformerLM gets the JAX model's ``init()`` weights through
``params_from_jax``.  Loss and gradients are held to JAX
``md.value_and_grad`` of the same ``lm_loss``, and a few optimizer steps to
the trajectory of JAX ``make_train_step``.  The reference runs on the JAX
package's numpy backend (the same tape engine and model code over numpy
arrays, the package's own oracle): an XLA run compiles every operation anew
and costs ~8 s per model on the CPU.  On the CPU every kernel runs its plain
version inside the same ``torch.autograd.Function`` that launches the
kernels on the card, so this is the wiring the card runs.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import AdamW as JaxAdamW
from minidiff_tpu.models import Adam as JaxAdam
from minidiff_tpu.models import SGD as JaxSGD
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu.models import lm_loss as jax_lm_loss
from minidiff_tpu.models import make_train_step as jax_make_train_step
from minidiff_tpu_torch import (SGD, Adam, AdamW, TransformerLM, cross_entropy,
                                lm_loss, make_train_step, params_from_jax)
from minidiff_tpu_torch import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them (a
    float64 gradcheck took 450 s that way instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(vocab_size=128, dim=64, num_heads=2, num_layers=2, max_seq_len=32)
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t._data), tree,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(dtype, seed=0):
    np.random.seed(seed)
    jm = JaxLM(dtype=_JAX_DT[dtype], **CFG)
    jp = jm.init()
    tm = TransformerLM(dtype=dtype, device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _tokens(b=2, s=32, seed=1):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], size=(b, s))


# float32: the same algebra in another summation order through 2 layers,
# forward and backward, leaves ~1e-6 relative; 1e-4 holds it with margin.
# float64: the same at double precision.  masked: the masked mean, whose
# unscored positions get no gradient.
@pytest.mark.parametrize("dtype,tol,masked", [
    (torch.float32, 1e-4, False), (torch.float64, 1e-10, False),
    (torch.float64, 1e-10, True)])
def test_loss_and_grads_match_jax_value_and_grad(dtype, tol, masked):
    toks = _tokens()
    mask = ((np.random.RandomState(2).rand(*toks.shape) > 0.3).astype(np.int64)
            if masked else None)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(dtype)
        t = md.Tensor(toks)
        jmask = None if mask is None else md.Tensor(mask)
        loss_ref, grads = md.value_and_grad(
            lambda p: jax_lm_loss(jm.apply(p, t), t, jmask))(jp)
        ref = params_from_jax(_np_tree(grads))

    tt = torch.from_numpy(toks)
    loss = lm_loss(tm(tt), tt, None if mask is None else torch.from_numpy(mask))
    loss.backward()
    assert loss.dtype == dtype
    np.testing.assert_allclose(loss.item(), float(np.asarray(loss_ref._data)),
                               rtol=tol, atol=tol)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def test_masked_lm_loss_matches_jax():
    jm, jp, tm = _pair(torch.float64)
    toks = _tokens()
    mask = (np.random.RandomState(2).rand(*toks.shape) > 0.3).astype(np.int64)
    with md.use_backend("numpy"), md.no_grad():
        logits = jm.apply(jp, md.Tensor(toks))
        ref = jax_lm_loss(logits, md.Tensor(toks), md.Tensor(mask))
    out = lm_loss(torch.from_numpy(np.array(logits._data)),
                  torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(out.item(), float(np.asarray(ref._data)),
                               rtol=1e-12)


def test_cross_entropy_soft_labels_match_integer_labels():
    rng = np.random.RandomState(3)
    z = torch.from_numpy(rng.standard_normal((6, 10)))
    lab = torch.from_numpy(rng.randint(0, 10, 6))
    onehot = torch.nn.functional.one_hot(lab, 10).to(torch.float64)
    # one composed log-softmax path, one fused loss path: the same f64 value
    np.testing.assert_allclose(cross_entropy(z, onehot).item(),
                               cross_entropy(z, lab).item(), rtol=1e-12)
    per = cross_entropy(z, lab, reduce=False)
    assert per.shape == (6,) and per.dtype == torch.float64


_OPTS = {
    "sgd": (lambda: JaxSGD(0.1), lambda: SGD(0.1)),
    "sgd_momentum": (lambda: JaxSGD(0.1, momentum=0.9),
                     lambda: SGD(0.1, momentum=0.9)),
    "adam": (lambda: JaxAdam(1e-2), lambda: Adam(1e-2)),
    "adamw": (lambda: JaxAdamW(1e-2, weight_decay=0.1),
              lambda: AdamW(1e-2, weight_decay=0.1)),
}


def _trajectories(opt_name, grad_accum=1, steps=3):
    jax_opt, torch_opt = (f() for f in _OPTS[opt_name])
    toks = _tokens(b=4, s=16)
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(torch.float64)
        jstep = jax_make_train_step(jm, jax_opt, loss_fn=jax_lm_loss,
                                    jit=False, grad_accum=grad_accum)
        tstep = make_train_step(tm, torch_opt, loss_fn=lm_loss,
                                grad_accum=grad_accum, device="cpu")
        state = jax_opt.init(jp)
        jl, tl = [], []
        for _ in range(steps):
            jp, state, loss = jstep(jp, state, md.Tensor(toks),
                                    md.Tensor(toks))
            jl.append(float(np.asarray(loss._data)))
            tl.append(tstep(torch.from_numpy(toks),
                            torch.from_numpy(toks)).item())
        return jl, tl, params_from_jax(_np_tree(jp)), tm.state_dict()


# f64 on both sides, so the steps differ only in summation order (and in
# Adam's step size, a scalar tensor there and a Python float here, both
# f64): ~1e-14 relative; 1e-9 holds it with margin.
@pytest.mark.parametrize("opt_name", sorted(_OPTS))
def test_optimizer_steps_stay_on_jax_trajectory(opt_name):
    jl, tl, ref, got = _trajectories(opt_name)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert tl[-1] < tl[0]
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_grad_accum_matches_jax():
    jl, tl, ref, got = _trajectories("sgd", grad_accum=2, steps=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_cpu_train_step_launches_no_kernel():
    _, _, tm = _pair(torch.float32)
    toks = torch.from_numpy(_tokens(s=16))
    kernels.reset_launch_counts()
    make_train_step(tm, SGD(1e-3), lm_loss, device="cpu")(toks, toks)
    assert set(kernels.launch_counts().values()) == {0}


def test_train_step_options_of_later_slices_raise():
    tm = TransformerLM(device="cpu", **CFG)
    with pytest.raises(NotImplementedError, match="later slice"):
        make_train_step(tm, trainable=lambda path: True, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        make_train_step(tm, donate=True, device="cpu")
    step = make_train_step(tm, device="cpu")
    toks = torch.from_numpy(_tokens(s=8))
    with pytest.raises(NotImplementedError, match="later slice"):
        step(toks, toks, rng=0)


@pytest.mark.parametrize("opt_name", ["sgd_momentum", "adamw"])
def test_jit_true_and_false_give_the_same_steps(opt_name):
    """The captured program's step function (jit=True, the default) and the
    eager step (jit=False) run the same operations: equal losses and
    parameters, bit for bit, on the CPU."""
    toks = torch.from_numpy(_tokens(b=4, s=16))
    runs = []
    for jit in (True, False):
        _, _, tm = _pair(torch.float64)
        step = make_train_step(tm, _OPTS[opt_name][1](), loss_fn=lm_loss,
                               jit=jit, device="cpu")
        runs.append(([step(toks, toks).item() for _ in range(3)], tm.state_dict()))
    (jl, jp), (el, ep) = runs
    assert jl == el
    for name, p in jp.items():
        assert torch.equal(p, ep[name]), name


def test_train_step_on_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tm = TransformerLM(device="cpu", **CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(tm, SGD(1e-3), lm_loss)


def test_double_backward_raises():
    tm = TransformerLM(device="cpu", dtype=torch.float64, **CFG)
    toks = torch.from_numpy(_tokens(s=8))
    loss = lm_loss(tm(toks), toks)
    (g,) = torch.autograd.grad(loss, tm.blocks[0].ln1.g, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()
