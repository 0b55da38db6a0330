"""The port's TransformerLM against the JAX package's, on the CPU.

The JAX model's ``init()`` makes the weights (numpy-seeded); they cross into
the port as numpy arrays through ``params_from_jax``, and both models run
the same tokens.  Both sides get an explicit dtype (the test harness turns on
JAX's x64, so an unspecified dtype would not be float32).
"""

from __future__ import annotations

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import minidiff_tpu as md
from minidiff_tpu.models import TransformerLM as JaxLM
from minidiff_tpu_torch import TransformerLM, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them (a
    float64 gradcheck took 450 s that way instead of 2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# small sizes with the flagship's head dim (d 256, 2 heads -> hd 128)
CFG = dict(vocab_size=64, dim=256, num_heads=2, num_layers=2, max_seq_len=256)
_JAX_DT = {torch.float32: md.float32, torch.float64: md.float64}


def _np_tree(params):
    return jax.tree.map(lambda t: np.asarray(t._data), params,
                        is_leaf=lambda t: isinstance(t, md.Tensor))


def _pair(dtype, seed=0):
    np.random.seed(seed)
    jm = JaxLM(dtype=_JAX_DT[dtype], **CFG)
    with md.use_backend("numpy"):  # numpy-seeded init, no XLA compiles
        jp = jm.init()
    tm = TransformerLM(dtype=dtype, device="cpu", **CFG)
    tm.load_state_dict(params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _logits_pair(dtype, s):
    # the reference runs on the JAX package's numpy backend: the same model
    # code over numpy arrays, without an XLA compile of every operation
    with md.use_backend("numpy"):
        jm, jp, tm = _pair(dtype)
        toks = np.random.RandomState(1).randint(0, CFG["vocab_size"], size=(2, s))
        with md.no_grad():
            ref = np.asarray(jm.apply(jp, md.Tensor(toks))._data)
    with torch.no_grad():
        out = tm(torch.from_numpy(toks)).numpy()
    return out, ref


# float32: the same algebra in another summation order across 2 layers of
# d=256 matmuls and 64-way softmaxes leaves ~1e-6 relative; 1e-4 holds it
# with margin.  float64: the same, at double precision.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("s", [16, 200])
def test_logits_match_jax_apply(dtype, tol, s):
    out, ref = _logits_pair(dtype, s)
    assert out.shape == ref.shape == (2, s, CFG["vocab_size"])
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_params_from_jax_carries_layouts_unchanged():
    _, jp, tm = _pair(torch.float32)
    tree = _np_tree(jp)
    state = params_from_jax(tree)
    assert set(state) == set(tm.state_dict())
    # (in, out) weights and the head-major fused QKV columns, untouched
    np.testing.assert_array_equal(state["blocks.0.attn.qkv.w"].numpy(),
                                  tree["blocks"][0]["attn"]["qkv"]["w"])
    assert tuple(tm.blocks[0].attn.qkv.w.shape) == (256, 3 * 256)
    assert tuple(tm.head.w.shape) == (256, CFG["vocab_size"])
    np.testing.assert_array_equal(tm.blocks[1].fc2.b.detach().numpy(),
                                  tree["blocks"][1]["fc2"]["b"])


def test_params_from_jax_bfloat16_leaves():
    tree = {"w": np.asarray(jax.numpy.asarray([[1.5, -2.25]], md.bfloat16))}
    t = params_from_jax(tree)["w"]
    assert t.dtype == torch.bfloat16 and t.tolist() == [[1.5, -2.25]]


def test_unported_options_raise():
    # the LLaMA-style options are ported (tests/test_torch_options.py), and
    # so are window and sinks (tests/test_torch_window.py)
    for kw in (dict(dropout=0.1), dict(remat_blocks=True)):
        with pytest.raises(NotImplementedError, match="later slice"):
            TransformerLM(device="cpu", **CFG, **kw)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(**CFG)


def test_seeded_init_is_deterministic():
    a = TransformerLM(device="cpu", seed=3, **CFG)
    b = TransformerLM(device="cpu", seed=3, **CFG)
    c = TransformerLM(device="cpu", seed=4, **CFG)
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.tok_emb, c.tok_emb)


_ROOT = Path(__file__).resolve().parent.parent


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((_ROOT / "minidiff_tpu_torch").rglob("*.py"))
    files.append(_ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            # exact names: minidiff_tpu_torch shares minidiff_tpu's prefix
            assert root not in ("jax", "jaxlib", "minidiff_tpu"), (f, mod)
