"""The port's sampling noise, drawn on the model's device.

``functional.gumbel_noise`` is a counter-based hash of (seed, step, row,
vocab index) in integer tensor ops, so that a captured decode step can draw
it inside its CUDA graph from device-tensor seeds and steps.  These tests
hold it to its contract on the CPU: the hash is MurmurHash3's finaliser bit
for bit (a numpy uint32 restatement), the draw is a pure function of its
key that differs across rows, steps and seeds, u stays strictly inside
(0, 1), and 10^5 draws are Gumbel(0, 1) by their mean and variance (within
3 standard errors) and by a Kolmogorov-Smirnov test.  Its bits differ from
the JAX package's threefry bits, an accepted divergence: determinism per
seed is what both packages promise.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from scipy import stats

from minidiff_tpu_torch.models import functional as F


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed, step, row):
    return tuple(torch.as_tensor(v, dtype=torch.int64) for v in (seed, step, row))


def _np_fmix32(h):
    h = np.asarray(h, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def _np_uniform(seed, step, row, vocab):
    """gumbel_uniform restated in numpy's wrapping uint32 arithmetic."""
    k = _np_fmix32(np.uint32(seed & 0xFFFFFFFF) ^ np.uint32(0x3C6EF372))
    k = _np_fmix32(k ^ np.uint32(step & 0xFFFFFFFF))
    k = _np_fmix32(k ^ np.uint32(row & 0xFFFFFFFF))
    v = _np_fmix32(np.arange(vocab, dtype=np.uint32) ^ np.uint32(0x9E3779B9))
    bits = _np_fmix32(k ^ v)
    return ((bits >> np.uint32(8)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -24)


@pytest.mark.parametrize("seed,step,row", [(0, 0, 0), (7, 130, 3), (0xFFFFFFFF, 2 ** 31, 1),
                                           (2 ** 40 + 5, 12, 0)])
def test_hash_is_murmur_finaliser_bit_for_bit(seed, step, row):
    u = F.gumbel_uniform(*(t.reshape(1) for t in _key(seed, step, row)), 333)
    np.testing.assert_array_equal(u[0].numpy(), _np_uniform(seed, step, row, 333))


def test_mul32_matches_wrapping_product():
    h = torch.tensor([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x12345678, 0xDEADBEEF])
    for c in (0x85EBCA6B, 0xC2B2AE35, 1, 0xFFFFFFFF):
        want = (h.numpy().astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(F._mul32(h, c).numpy(), want.astype(np.int64))


def test_noise_is_a_pure_function_of_its_key():
    key = _key([3, 3, 9], [17, 17, 17], [0, 1, 0])
    a = F.gumbel_noise(*key, 500)
    b = F.gumbel_noise(*key, 500)
    assert a.dtype == torch.float32 and a.shape == (3, 500)
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()
    # rows, seeds and steps each give another draw
    assert not torch.equal(a[0], a[1])          # row
    assert not torch.equal(a[0], a[2])          # seed
    c = F.gumbel_noise(*_key([3], [18], [0]), 500)
    assert not torch.equal(a[0], c[0])          # step
    # a row's draw does not depend on the rows beside it
    d = F.gumbel_noise(*_key([9], [17], [0]), 500)
    assert torch.equal(a[2], d[0])


def test_uniform_stays_strictly_inside_the_unit_interval():
    u = F.gumbel_uniform(*_key(np.arange(8), np.arange(8) * 1000, np.arange(8)), 4096)
    assert float(u.min()) >= 2.0 ** -25 and float(u.max()) <= 1 - 2.0 ** -25
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert torch.isfinite(F.gumbel_noise(*_key(np.arange(8), np.arange(8), np.arange(8)),
                                         4096)).all()


def test_draws_are_gumbel_by_moments_and_kolmogorov_smirnov():
    rows = 4
    g = F.gumbel_noise(*_key([1234] * rows, [56] * rows, np.arange(rows)), 25_000)
    x = g.double().flatten().numpy()
    n = x.size
    assert n == 10 ** 5
    mean, var = 0.5772156649015329, math.pi ** 2 / 6
    # the sample variance's standard error from the Gumbel's fourth moment
    # (excess kurtosis 12/5)
    se_mean, se_var = math.sqrt(var / n), math.sqrt((5.4 - 1.0) * var ** 2 / n)
    assert abs(x.mean() - mean) < 3 * se_mean
    assert abs(x.var(ddof=1) - var) < 3 * se_var
    assert stats.kstest(x, "gumbel_r").pvalue > 1e-3


def test_noise_is_drawn_where_its_key_lives():
    key = _key([1], [2], [0])
    assert F.gumbel_noise(*key, 16).device == key[0].device
