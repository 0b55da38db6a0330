"""How far the large tensor-core tile of the port's dequant-matmuls
accumulates, on the CPU.

The large tile of ``csrc/quant.cu`` (``dq_mm``, ``dq_bmm`` and ``dq4_mm``
at 17-256 rows) sums each split's products in wgmma's f32 accumulator,
whose sums do not round as f32 additions do.  On the card, chip_smoke.py's
``dq_split_ab`` found an output of ``dq4_mm`` at (128, 4096, 1024) that
cancels to 6.70e-6 come out 4.9e-6 away from its f64 value at one split
(256 k16 steps in one accumulator), beyond ``TOL["dq"]``'s 1e-6 of the
largest output (4.47e-6 there), and 2.0e-6 away at two splits (128 steps).
So ``kernels.quant.dq_plan`` never gives a large-tile split more than
``LARGE_STEPS`` (128) k16 steps, and the C entry refuses one that would
(``tc_args_ok``); a K that 16 splits cannot bring under the bound takes
the SIMT tile, whose FFMA sums round as the plain version's do.  The
kernels cannot run here: these tests hold the plan to that bound.
"""

from __future__ import annotations

import pytest
import torch

from minidiff_tpu_torch.kernels import quant as TQ

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs several workers
    on a few cores, and torch's thread pool would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans():
    for bits in (8, 4):
        for rows in (17, 128, 256):
            for k in (512, 1024, 2048, 4096, 8192, 14336, 16384, 32768, 65536):
                for n in (1024, 4096):
                    for experts in ((1, 8) if bits == 8 else (1,)):
                        plan = TQ.dq_plan(bits, rows, n, k, BF16,
                                          group=128 if bits == 4 else None, experts=experts)
                        yield bits, rows, n, k, experts, plan


def test_large_tile_splits_keep_at_most_large_steps():
    seen = set()
    for bits, rows, n, k, experts, plan in _plans():
        if plan.tile == "large":
            assert k // 16 <= TQ.LARGE_STEPS * plan.splits, (bits, rows, n, k, plan)
            assert plan.splits >= TQ.min_splits(k, "large")
        seen.add(plan.tile)
    assert seen == {"large", "simt"}  # a K 16 splits cannot bound takes the SIMT tile


@pytest.mark.parametrize("bits,rows,n,k,splits", [
    (4, 128, 1024, 4096, 8),    # the shape whose one-split route strayed: its plan
    (8, 128, 1024, 4096, 16),   # dq_mm's prefill fc2
    (8, 128, 1024, 2048, 2),    # 128 steps in one split are within the bound
])
def test_plans_at_the_measured_shapes(bits, rows, n, k, splits):
    plan = TQ.dq_plan(bits, rows, n, k, BF16, group=128 if bits == 4 else None,
                      experts=8 if (bits, k) == (8, 2048) else 1)
    assert plan.tile == "large" and plan.splits == splits


def test_min_splits():
    assert TQ.LARGE_STEPS == 128
    assert [TQ.min_splits(k, "large") for k in (1024, 2048, 2064, 4096, 8192, 32768)] == \
        [1, 1, 2, 2, 4, 16]
    # the small tiles and the SIMT tile take any K at one split
    assert TQ.min_splits(65536, "small8") == TQ.min_splits(65536, "simt") == 1
    # a K past 16 splits of 128 steps leaves the large tile
    assert TQ.dq_plan(8, 128, 1024, 65536, BF16).tile == "simt"
