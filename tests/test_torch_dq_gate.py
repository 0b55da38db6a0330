"""The f32 dequant gate of ``chip_smoke.py``, on the CPU.

``chip_smoke.dq_hold`` holds every f32 ``dq_mm`` / ``dq4_mm`` / ``dq_bmm``
output of the kernel and of its plain version to the exact (f64) product,
within ``chip_smoke.dq_f32_bound``:

    |out - ref| <= DQ_F32_C * 2^-24 * sqrt(K) * (||t||_2 + |ref|)

for an output of K products t_k = x_k w_kj.  The kernels cannot run here;
these tests hold the bound itself, at the card's dequant shapes (cut in
rows) and K 1,024, 2,048 and 4,096, at three seeds:

- loose enough: the plain f32 version, and a fully serial f32 sum (the
  order whose rounding grows most with K), use at most half of it;
- tight enough: an output with its largest product dropped, and a product
  with one k16 step of K skipped, are rejected, and ``dq_hold`` raises on
  them;
- near the old gate: its mean per-output bound is within 4x of the old
  tolerance, 1e-5 |ref| + 1e-6 max |ref|.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import chip_smoke
from minidiff_tpu_torch.kernels import quant as Q


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the card's f32 dequant shapes (chip_smoke.py's quant_cases, dq_bmm_cases),
# cut in rows and experts: dq_mm / dq4_mm [M, K, N], dq_bmm [E, C, K, N]
SHAPES = [("dq_mm", [8, 1024, 3072]), ("dq_mm", [16, 4096, 1024]),
          ("dq_bmm", [2, 8, 2048, 1024]), ("dq_bmm", [2, 4, 1024, 4096]),
          ("dq4_mm", [8, 1024, 3072]), ("dq4_mm", [8, 4096, 1024])]
SEEDS = (0, 1, 2)


def _case(name, shape, seed):
    """x, the quantized weight, the plain f32 product, the exact weight (f64)
    and product, and the bound, drawn with numpy from ``seed`` as the card's
    cases draw theirs (x normal, w normal / sqrt(K), then quantized)."""
    rng = np.random.RandomState(seed)
    k, n = shape[-2:]
    x = torch.from_numpy(rng.standard_normal(shape[:-1]).astype(np.float32))
    w = rng.standard_normal(shape[:1] + shape[2:] if name == "dq_bmm" else shape[1:])
    w = torch.from_numpy((w * k ** -0.5).astype(np.float32))
    if name == "dq_mm":
        q, s = Q.quantize_int8(w)
        plain, exact = Q._plain_dequant_matmul(x, q, s), q.double() * s.double()
    elif name == "dq_bmm":
        q, s = Q.quantize_int8_stacked(w)
        plain, exact = Q._plain_dequant_bmm(x, q, s), q.double() * s.double()[:, None, :]
    else:
        q, s = Q.quantize_int4(w)
        plain = Q._plain_dequant_matmul4(x, q, s)
        exact = Q._dequantized4(q, s, torch.float32).double()
    ref = torch.matmul(x.double(), exact)
    return x, plain, exact, ref, chip_smoke.dq_f32_bound(torch, x, exact, ref)


def _serial(x, w):
    """x @ w summed in f32 one product at a time, in K's order (each
    product and each addition rounded to f32)."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros(*x.shape[:-1], w.shape[-1])
    for k in range(x.shape[-1]):
        acc = acc + xf[..., k:k + 1] * wf[..., k:k + 1, :]
    return acc


def _share(out, ref, lim):
    return ((out.double() - ref).abs() / lim)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,shape", SHAPES)
def test_plain_and_serial_sums_pass_with_margin(name, shape, seed):
    x, plain, exact, ref, lim = _case(name, shape, seed)
    assert _share(plain, ref, lim).max().item() <= 0.5
    assert _share(_serial(x, exact), ref, lim).max().item() <= 0.5
    # dq_hold passes the plain version as the kernel's output
    err, shares = chip_smoke.dq_hold(torch, plain, plain, x, exact, "float32")
    assert shares["kernel"] == shares["plain"] <= 0.5
    assert err == (plain.double() - ref).abs().max().item()


def _largest_products(x, w):
    """For each output, its product of the largest magnitude."""
    rows = x.reshape(-1, x.shape[-1]).double()
    ws = w.double().expand(*x.shape[:-2], *w.shape[-2:]).reshape(-1, *w.shape[-2:]) \
        if w.dim() == 3 else w.double()[None]
    per = rows.shape[0] // ws.shape[0]
    out = torch.empty(rows.shape[0], w.shape[-1], dtype=torch.float64)
    for i in range(rows.shape[0]):
        t = rows[i, :, None] * ws[i // per]
        out[i] = t.gather(0, t.abs().argmax(0, keepdim=True))[0]
    return out.reshape(*x.shape[:-1], w.shape[-1])


@pytest.mark.parametrize("name,shape", SHAPES)
def test_bound_rejects_a_dropped_product(name, shape):
    x, plain, exact, ref, lim = _case(name, shape, 0)
    dropped = plain.double() - _largest_products(x, exact)
    # every output with its largest product dropped is beyond its bound
    assert (_share(dropped, ref, lim) > 1).all()
    # and dq_hold fails a kernel that drops one output's largest product
    out = plain.clone()
    out.view(-1)[7] = dropped.view(-1)[7].float()
    with pytest.raises(chip_smoke.SmokeFailure, match="kernel"):
        chip_smoke.dq_hold(torch, out, plain, x, exact, "float32")


@pytest.mark.parametrize("name,shape", SHAPES)
def test_bound_rejects_a_skipped_k16_step(name, shape):
    x, plain, exact, ref, lim = _case(name, shape, 1)
    k = shape[-2]
    for step in (0, k // 32, k // 16 - 1):
        keep = torch.ones(k, dtype=torch.float64)
        keep[16 * step:16 * step + 16] = 0
        skipped = torch.matmul(x.double() * keep, exact)
        over = _share(skipped, ref, lim) > 1
        # nearly every output: only one whose 16 skipped products cancel to
        # within its bound escapes
        assert over.double().mean().item() > 0.99
        with pytest.raises(chip_smoke.SmokeFailure, match="kernel"):
            chip_smoke.dq_hold(torch, skipped.float(), plain, x, exact, "float32")


@pytest.mark.parametrize("name,shape", SHAPES)
def test_mean_bound_is_within_4x_of_the_old_tolerance(name, shape):
    _, _, _, ref, lim = _case(name, shape, 2)
    old = 1e-5 * ref.abs() + 1e-6 * ref.abs().max()
    ratio = lim.mean().item() / old.mean().item()
    assert 0.25 <= ratio <= 4.0, ratio


def test_bound_grows_with_k_as_stated():
    # the bound of one output whose products are all 1/sqrt(K): ||t||_2 = 1,
    # ref = sqrt(K)
    for k in (1024, 2048, 4096):
        x = torch.full((1, k), k ** -0.25)
        w = torch.full((k, 1), k ** -0.25, dtype=torch.float64)
        ref = torch.matmul(x.double(), w)
        lim = chip_smoke.dq_f32_bound(torch, x, w, ref).item()
        want = chip_smoke.DQ_F32_C * 2.0 ** -24 * math.sqrt(k) * (1 + math.sqrt(k))
        assert lim == pytest.approx(want, rel=1e-6)


def test_bf16_keeps_its_check():
    # one output ulp plus 1e-6 of the largest value, against the plain version
    assert chip_smoke.TOL[("dq", "bfloat16")] == (2 ** -7, 1e-6)
    assert ("dq", "float32") not in chip_smoke.TOL
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    q, s = Q.quantize_int8(torch.randn(64, 32, generator=torch.Generator().manual_seed(1)))
    plain = Q._plain_dequant_matmul(x, q, s)
    err, shares = chip_smoke.dq_hold(torch, plain, plain, x, q.double() * s.double(),
                                     "bfloat16")
    assert err == 0.0 and shares == {}
    bad = plain.clone()
    bad[0, 0] = bad[0, 0] * 1.1 + 1
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.dq_hold(torch, bad, plain, x, q.double() * s.double(), "bfloat16")
