#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, tape, quantized and paged
serving paths, the LLaMA-style options, the Mamba family and the
Mixture-of-Experts family on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json PATH]
    python3 chip_smoke.py --refusal CASE   (one child case of phase 5)

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
kernels build from ``minidiff_tpu_torch/kernels/csrc`` into
``minidiff_tpu_torch/_build/`` on first use.  Phases:

1. device: the card's name and power limit; TF32 off for f32 products;
2. kernels: each hand-written kernel against its plain PyTorch version at
   the serving, train and tape paths' shapes, in bf16 and f32, with times for
   the kernel, the plain version and the library call, and the card's lower
   bound; the flash kernels at head dim 256, the scan at the SSM train step's,
   backward's and server prefill's shapes, an RMSNorm at d 16,384 (wider
   than the kernels: composed, no launch), the flash rule at head dims
   32, 64, 128 and 256 (the route each takes, counted by launches),
   ``dq_bmm`` at the MoE model's decode and prefill banks (a C of 384
   launches nothing), ``dq4_mm`` at int4 groups 64 and 256, a ragged N
   (520) and one row, each case with the tile and K splits it launched
   with, and the A/B of ``dq_mm`` / ``dq_bmm`` / ``dq4_mm`` in bf16 at the
   main path's shapes: the tensor-core tiles against a ``-DDQ_SIMT_BF16``
   build of ``quant.cu`` (the SIMT tile) in turns, with the library call,
   and cold times beside the warm ones (weights rotated over 100 MB); the
   A/B of the bf16 flash forward at every bf16 shape of its cases: the
   ``wgmma`` tile at 64 and 128 query rows per CTA against a
   ``-DFLASH_WMMA_BF16`` build of ``flash_fwd.cu`` (the WMMA tile), in
   turns; the A/B of the bf16 flash backward at every bf16 shape of its
   cases: ``flash_bwd_dkv`` and ``flash_bwd_dq`` on their ``wgmma`` tiles
   at one and two warpgroups per CTA against a ``-DFLASH_BWD_WMMA_BF16``
   build of ``flash_bwd.cu`` (the WMMA tile), in turns, with SDPA's
   backward beside them; every bf16 backward case run twice and held bit
   for bit (the kernels are deterministic); the bf16 matmuls at 1032^3 and
   at one K-tile and part of one (8192 x 8192 x 64 and x 16) beside the
   main path's shapes, each run twice and held bit for bit, and their A/Bs
   at those shapes: the ``wgmma`` tile against a ``-DMM_WMMA_BF16`` build
   of ``matmul.cu`` (the WMMA tile), in turns, with the library call, and
   the ``wgmma`` tile at 128 x 256 and 128 x 128, in bands of 8 tile-rows
   and of 1; ``sdpa_int8`` (SDPA_CASES, Mistral-7B's grouping at L 16,384
   among them) and ``paged_attn`` (PAGED_CASES, g 4 among them) on their
   split plans, each bf16 case run twice and held bit for bit, their A/B
   against the one-CTA kernels of a ``-DDECODE_ATTN_ONE_CTA`` build of
   ``quant.cu`` and ``paged.cu`` in turns, and each case at 1, 2, 4, 8 and
   16 splits with the clusters the card holds at once; the four forward
   norms (``rms_fwd``, ``ln_fwd``, ``addrms_fwd``, ``addln_fwd``) on the
   launch plan's route against the earlier forward (a ``-DNORM_FWD_V1``
   build of ``rmsnorm.cu`` and ``layernorm.cu``) in turns at decode and
   train rows, beside the empty kernel ``norm_null``'s time at each
   route's grid and block (the launch floor) and the library call (after
   ``x + a`` for the fused ones), the fused ones at decode rows the same
   bits twice and their y bit-equal to the plain forward of their t, the
   one-wave kernel against the old route at 1-8,192 rows, and every norm
   at every width at 8 rows and past the plan's crossover, the forwards
   the same bits twice; ``xent_bwd`` on the launch plan's route and
   on every row-kernel shape it tried against a ``-DXENT_BWD_V1`` build of
   ``xent.cu`` (the warp kernel) in turns at 8,192 rows of V 512 to 65,536,
   and ``rms_bwd`` on the plan's ring and every ring depth and CTAs per SM
   it tried against a ``-DNORM_BWD_V1`` build of ``rmsnorm.cu`` (the
   block-per-row kernel) at (8192, 1024), (8192, 4096) and (1024, 4096),
   ``ln_bwd`` and ``addln_bwd`` likewise against a ``-DNORM_BWD_V1`` build
   of ``layernorm.cu`` (the warp-per-row and block-per-row kernels) at
   (8192, 1024), (4096, 512) and (8192, 4096),
   each new route the same bits twice, ``xent_fwd`` and ``addrms_bwd`` the
   same bits as those builds and within 3% of their times; ``xent_fwd`` on
   the launch plan's route and the route it did not pick against a
   ``-DXENT_FWD_V1`` build of ``xent.cu`` (the warp kernel) in turns at
   8,192 rows of V 128 to 65,536 and at the MoE train step's (4096, 512),
   labels outside [0, V) among the rows; the scan on the plan's ring and
   the other ring tiles and depths against a ``-DSCAN_V1`` build of
   ``scan.cu`` (the thread kernel) in turns at every lead 1-8 of the SSM
   train step's width, the server's one-row prefills and the decode and
   tape shapes, every route the old build's bits, and the reverse scan
   against the old composition flip(scan(shift(flip(a)), flip(g))) bit for
   bit; the f32
   ``dq_mm`` / ``dq4_mm`` / ``dq_bmm`` cases at three seeds, the kernel and
   the plain version each held to the f64 product within a bound that
   grows with K (``dq_f32_bound``);
   ``flash_bwd.cu``, ``matmul.cu``, ``quant.cu``, ``paged.cu``,
   ``layernorm.cu``, ``rmsnorm.cu``, ``xent.cu`` and ``scan.cu`` built with
   no spill, no ptxas C75xx note and no ignored setmaxnreg;
3. ``generate_compiled`` at full width (V512 d1024 h8 L4, max_seq_len 512,
   bf16, batch 8, prompt 16, 128 new tokens), profiled once, and once more
   on the ``-DNORM_FWD_V1`` norms (each profile reports the forward norms'
   device time, and per call for the plain and the fused instantiations
   apart);
4. ``DecodeServer`` (8 slots, window 512, staggered requests over 1-3
   prompt buckets, slot reuse): in f32 every request must equal its solo
   ``generate_compiled`` decode token for token, and the f32 logits of the
   kernel path must match the plain path run on the CPU; then bf16
   throughput and agreement;
5. the train step at full width (V512 d1024 h8 L4, S 1024, batch 8, bf16,
   ``make_train_step(model, SGD(1e-3), lm_loss)`` on the identity task, as
   the JAX repo's ``bench.py`` headline): finite losses, ms/step, tokens/s,
   model TFLOP/s, the launches per step of every kernel, one profiled step,
   and one on the ``-DXENT_BWD_V1`` and ``-DNORM_BWD_V1`` builds (each
   reports ``xent_bwd``'s, ``ln_bwd``'s and ``addln_bwd``'s device time per
   step); then the f32 gradient gate: loss and every parameter's gradient of the
   kernel path on the card against the plain path on the CPU (batch 1 x
   256 tokens); then the capture refusals: in a child process each, a
   train step whose loss reads ``.item()``, an ``md.jit`` program with
   ``.item()`` and one that makes a numpy array a Tensor must raise at
   their capture;
6. the tape engine under ``md.use_backend("cuda")``: the JAX repo's
   ``bench.py`` matmul step (``md.value_and_grad`` of ``sum(tanh(x @ w))``
   at 4096² bf16 and an SGD update, through ``md.jit``; ms/step, TFLOP/s,
   exactly one launch of each matmul kernel per step), the device-bound
   MLP of ``benchmarks/mlp_bench.py`` (batch 8192, 784 -> 4096 -> 10, f32,
   SGD 0.1, through ``md.jit``: the loss must fall, exact launches per
   step), a draw from ``md.randn`` inside ``md.jit`` (fresh at each replay,
   the eager draws of the same seed), an f32 gate (the value,
   gradients and an hvp of ``sum(tanh(x @ w))`` at 2048² on the card against
   the same tape on the CPU), and the README demo and the 64-dim Rosenbrock
   ``md.hessian`` against their closed forms;
7. quantized decode (``bench.py:350-443``): ``generate_compiled`` at full
   width over int8 weights, int4 weights and int8 weights with an int8 KV
   cache (bf16, batch 8, prompt 16, 128 new tokens), and the int8 KV cache
   at long context (max_seq_len 4096, batch 4, prompt 3,968, 64 new
   tokens): tok/s, ms/step, exact launches per decode step, the weight
   bytes; an f32 gate of the quantized model's logits on the card against
   the same codes' plain path on the CPU; one profiled run;
8. ``PagedDecodeServer`` (``benchmarks/serving_bench.py:76-145``): in f32
   the staggered requests of phase 4 must each equal their solo decode
   token for token (slot reuse, page-boundary crossings; the smallest top-2
   logit gap is reported); then bf16 paged against dense tok/s at equal
   batch (8 slots, window 1024), the dense-equivalent and the oversubscribed
   pools' ``kv_bytes``, pages in use, and pool exhaustion raising;
9. the LLaMA-style options at Mistral-7B-v0.3's widths (RMSNorm, RoPE,
   32 heads over 8 KV heads, SwiGLU 14336, vocabulary 32768; bf16, 4 of
   32 layers, max_seq_len 1024): ``generate_compiled`` (batch 8, prompt
   16, 128 new tokens) with exact launches, ``DecodeServer`` (the
   staggered requests of phase 4 on 8 slots, window 1024) with its KV
   bytes against the multi-head equivalent, one profiled decode (again on
   the ``-DNORM_FWD_V1`` norms), and the train step (batch 8 x 1024,
   ``make_train_step(model, SGD(1e-3), lm_loss)``) with the exact RMSNorm,
   flash and cross-entropy launches per step derived from the model, and
   one profiled step, and again on the ``-DXENT_BWD_V1`` and
   ``-DNORM_BWD_V1`` builds (each profile reports ``xent_bwd``'s and
   ``rms_bwd``'s device time per step, which must be below the old
   builds') and on the ``-DXENT_FWD_V1`` build (``xent_fwd``'s device time
   per step on both); then f32 gates
   at full width and one layer against the plain path on the CPU: the
   logits of a prefill and 8 cached decode steps, the loss and every
   parameter's gradient;
10. the Mamba family at ``bench.py:602-632``'s and
   ``benchmarks/ssm_bench.py``'s configuration (``MambaLM`` V512 d1024 L4,
   d_state 16, d_conv 4, expand 2, bf16): ``generate_compiled_ssm`` (batch
   8, prompt 16, 128 new tokens, and after a 1,024-token prompt with the
   prefill timed), ``SSMDecodeServer`` over phase 4's requests (in f32
   every request token-identical to its solo decode, then bf16 tok/s and
   the state bytes beside the flagship's KV cache), the train step (batch
   8 x 1024, ``make_train_step(model, SGD(1e-4), lm_loss)``: ms/step,
   tokens/s, model TFLOP/s, peak memory, one profiled step, and one on
   the ``-DXENT_BWD_V1`` and ``-DNORM_BWD_V1`` builds, and one on the old
   scan: the ``-DSCAN_V1`` build with the backward's cotangent as
   flips around a forward scan, each profile reporting the flip, cat and
   scan kernels' device time per step; the new one must hold no flip
   kernel), exact scan,
   RMSNorm and cross-entropy launches on each, f32 gates at full width and
   one layer against the plain path on the CPU (prefill + 8 steps' logits,
   a ragged prefill's states, the loss and every gradient), and the tape's
   ``md.value_and_grad`` of a ``linear_scan`` loss (an f32 gate against the
   CPU tape, then bf16 timed at the train step's scan shape);
11. head dims: ``TransformerLM()`` at its own defaults (head dim 32: the
   composed attention, no flash launch) and a head-dim-256 model (dim 512,
   2 heads, 2 layers, the flash kernels' 256 instantiation), each through
   ``generate_compiled`` and a train step with exact flash launches, and
   the head-dim-256 model's f32 loss and gradients against the CPU;
12. the Mixture-of-Experts family at ``bench.py:502-530``'s
   ``decode_moe_int8`` configuration (``MoETransformerLM`` V512 d1024, 8
   heads over 4 KV heads, L4, 8 experts top-2 at capacity 4.0, grouped,
   RMSNorm, RoPE, SwiGLU 2048 without bias, renormalised gates, bf16):
   ``generate_compiled`` over bf16 and int8 expert banks (batch 8, prompt
   16, 64 new tokens; exact ``dq_bmm`` and ``dq_mm`` launches), one
   profiled int8 decode, ``DecodeServer`` and ``PagedDecodeServer`` (8
   slots, window 256, 10 staggered requests) in bf16 and in f32, where
   every request equals its solo decode; f32 gates at full width and one
   layer against the CPU (identical slot tables with the smallest top-k
   gap, prefill + 8 cached steps over float and int8 banks, the loss with
   aux and every gradient); and ``benchmarks/moe_bench.py``'s train step
   (V512 d512 h4 L2, E8 top-1 at capacity 1.0, batch 8 x 512, bf16) grouped
   and one-hot beside the equal-FLOPs dense step, with exact launches and
   one profiled step, and one on the old backwards' builds (as phase 5);
13. sliding windows with attention sinks, and packed sequences, at
   Mistral-7B-v0.1's widths (V32000 d4096, 32 heads over 8 KV heads,
   SwiGLU 14336, RMSNorm 1e-5, RoPE 1e4, window 4096 with 4 sinks, bf16,
   2 of its 32 layers, max_seq_len 8192): three packed train steps through
   the captured ``make_packed_train_step`` (2 rows of 8,192 tokens packed
   from documents of 64-6,144 tokens) with exact launches, their losses
   bit-equal to the eager step's; ``generate_compiled`` of a 4,608-token
   prompt and 32 new tokens, equal to the eager loop; ``PagedDecodeServer``
   with 4 requests whose prompts pass 4,096 positions, each equal to its
   solo decode; an f32 gate at one layer (S 256, window 96, 4 sinks, segment
   ids) of the loss and every gradient against the CPU; and the tape's
   ``md.sdpa`` with a key-padding mask (B 4, H 32, S 2,048, head dim 128,
   non-causal) forward and backward against the plain versions.  Phase 2
   holds the flash kernels under each mask (window 4,096 with 4 sinks at
   (64, 8192, 128), ids at (32, 8192, 128), a key row at (128, 2048, 128),
   and an f32 case of each) to their plain versions, with times, bounds
   over the visible pairs and SDPA with the dense boolean mask beside them;
14. the kernels line: every kernel must have launched on its paths (counts
   are reset just before phases 3, 4, 5, each timed part of 6, each run of
   7, phase 8 and each run of 9-13, and read just after each).

The train steps of phases 5 and 9-12 (``make_train_step``'s default
``jit=True``) and the tape steps of phase 6 (``md.jit``) run captured: the
first call of a program is a real step, run eagerly, after which the step
is captured; every later call replays one CUDA graph.  Each path is timed
against its eager step (``jit=False``, or the function itself for the tape)
in turns in the same call (``train_ab``: the flagship, options, MoE
grouped and MambaLM steps and the tape's matmul and MLP steps; ms per step
of every run, each arm's busy share and device calls from one profiled
step, the capture's seconds, the device memory each arm's first two
steps take and hold), each arm from a copy of the same weights, with
their losses bit-equal step for step (or within the spread of two eager
runs, reported).

The decode entry points of phases 3, 4 and 7-12 (``generate_compiled``,
``generate_compiled_ssm`` and the three servers) run captured: one CUDA
graph replay per token or step (``models/capture.py``), their launches
credited per replay, each capture's warm-up step counted too.  Each path
is timed against its eager step loop in turns in the same call
(``decode_ab``: ms per step and tok/s of every run, each arm's busy share
and device calls per step from a profile of a shorter decode, exactly one
replay per step, two captured runs the same tokens, the agreement of the
two arms reported); the f32 paths' solo decodes must equal the eager
loop's token for token.  The captured programs are dropped between
phases (``clear_programs``).

Prints progress lines, a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
that line; without a CUDA device, or without the package beside this file,
it exits 2 and prints no result.  ``--json PATH`` also writes every
measurement (all kernel cases, the profile) to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# The card's published peaks (H100 SXM data sheet, dense): HBM rate, bf16
# tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# full-width serving model: the JAX repo's decode configuration
# (benchmarks/decode_twin.py: V512 d1024 h8 L4, cache 512, batch 8,
# prompt 16, 128 new tokens)
MODEL = dict(vocab_size=512, dim=1024, num_heads=8, num_layers=4,
             max_seq_len=512)
BATCH, PROMPT, NEW = 8, 16, 128
# (prompt length, new tokens): 10 requests over 8 slots, 1-3 buckets of 128
REQUESTS = [(16, 64), (130, 48), (300, 32), (16, 96), (200, 40), (40, 80),
            (260, 24), (90, 56), (5, 30), (310, 60)]

# Tolerances of kernel against plain version, as (rtol, atol) on
# |kernel - plain| <= atol + rtol * |plain|.
#  f32: the same f32 arithmetic in another order (~1e-6 seen): 1e-5.
#  bf16 LN: outputs round to bf16 once from f32 statistics summed in
#   another order: one bf16 ulp (2^-7 relative).
#  bf16 attention: the kernel rounds the unnormalised probabilities to bf16
#   against the running max, the plain version the normalised ones against
#   the global max, then both round o: up to ~2 ulp (2^-6 relative).
#  lse is f32 on both sides: 1e-4 absolute on values of order 1-10.
#  LN dg/db: f32 sums over up to 8192 rows in another order (~1e-5 relative
#   of values up to ~100), then one rounding to bf16.
#  add+LN dx rounds twice in bf16: a one-ulp difference of dx_ln before g0
#   is added stays absolute: 2^-6 on values of order 1.
#  xent: f32 row statistics in another order; the loss (order 1-10) is f32,
#   dz (order 1/V) rounds once to the logits' dtype.  dz = (p - onehot) * g:
#   where p is near 1, p - 1 is exact and keeps p's absolute error, a few
#   f32 ulps of 1 (2^-23 each), which g then scales: 4 ulps of 1 times
#   max |g| (atol is scaled by max |g|, see G_SCALED), and the bf16
#   rounding of dz is relative.
#  flash backward: P and dS round to bf16 at the same points on both sides;
#   a score summed in another order can flip one of those roundings, and
#   the products then sum up to S of them: 2^-6 of the output's largest
#   value (atol is scaled by max |plain|), 2^-6 relative.  f32: 1e-4
#   relative, 1e-5 of the largest value.
TOL = {("ln", "float32"): (1e-5, 1e-5), ("ln", "bfloat16"): (2 ** -7, 1e-3),
       ("lnsum", "float32"): (1e-4, 1e-3), ("lnsum", "bfloat16"): (2 ** -7, 1e-2),
       ("addln_dx", "float32"): (1e-5, 1e-5),
       ("addln_dx", "bfloat16"): (2 ** -7, 2 ** -6),
       ("attn", "float32"): (1e-5, 1e-5), ("attn", "bfloat16"): (2 ** -6, 2 ** -7),
       ("lse", "float32"): (0.0, 1e-4), ("lse", "bfloat16"): (0.0, 1e-4),
       ("xent_loss", "float32"): (1e-5, 1e-4), ("xent_loss", "bfloat16"): (1e-5, 1e-4),
       ("xent_dz", "float32"): (1e-5, 2 ** -21), ("xent_dz", "bfloat16"): (2 ** -7, 2 ** -21),
       ("attn_bwd", "float32"): (1e-4, 1e-5), ("attn_bwd", "bfloat16"): (2 ** -6, 2 ** -6),
       ("matmul", "float32"): (0.0, 1e-5), ("matmul", "bfloat16"): (0.0, 1e-2),
       ("dq", "bfloat16"): (2 ** -7, 1e-6),
       ("scan", "float32"): (1e-6, 1e-6), ("scan", "bfloat16"): (2 ** -7, 2 ** -7)}
# the kinds whose atol is a share of the plain output's largest magnitude.
#  matmul: both sides accumulate in f32; bf16 rounds the output once (one
#   bf16 ulp, under 2^-8 of the largest value), f32 sums up to K = 8192
#   products in another order: 1e-2 and 1e-5 of the largest value.
#  dq (dq_mm, dq4_mm, dq_bmm) in bf16: products of int8 codes and bf16
#   values are exact in f32 and both sides sum them in f32 in another order
#   (int4's weights round to bf16 at the same point on both sides), then
#   round the output once: one ulp of the output (2^-7 relative) and 1e-6
#   of the largest value.  f32 has no entry here: dq_hold holds the kernel
#   and the plain version alike to the exact (f64) product, output by
#   output, within dq_f32_bound.  Its bound, for an output of K products
#   t_k = x_k w_kj summed in f32 in any order:
#     |out - ref| <= DQ_F32_C * 2^-24 * sqrt(K) * (||t||_2 + |ref|).
#   Each f32 addition errs by at most 2^-24 of the partial sum it forms,
#   and the errors of K additions add up like a random walk (sqrt(K) of
#   them).  A partial sum of terms of both signs is the sum's drift towards
#   ref plus a random walk of the terms, whose size is ||t||_2; a rounded
#   product, the scale's multiply and the output's own rounding each add at
#   most 2^-24 of |t_k| or |ref|, which the same bound covers.  A fully
#   serial f32 sum of K = 1,024-4,096 such products (the worst order) used
#   up to 0.37 of the bound on the CPU, the plain version up to 0.24, at
#   three seeds (tests/test_torch_dq_gate.py).  The old f32 gate (1e-5
#   relative, 1e-6 of the largest output) held the kernel to the plain
#   version and grew with nothing: an output that cancels keeps its terms'
#   rounding, which grows with K, and a new draw failed it (9.78e-6 against
#   5.39e-6 at K 1,024-2,048).
#  sdpa_int8 and paged_attn take the "attn" tolerances: sdpa_int8 rounds
#   p * vs to bf16 at the same point as its plain version, and a p that
#   differs in its last f32 bit can move that rounding; paged_attn rounds
#   the unnormalised p against the running max where the plain version
#   rounds the normalised one, as flash_fwd does.
#  scan: the kernel and its plain version run the same two f32 operations
#   per step (a rounded multiply, then a rounded add) in the same order, so
#   they agree bit for bit; 1e-6 (f32) or one bf16 ulp, relative and of the
#   largest value, holds that with margin, and a wrong carry is off by O(1).
SCALED = {"attn_bwd", "matmul", "dq", "scan"}
# the kinds whose atol is a share of the largest cotangent the caller passes
G_SCALED = {"xent_dz"}
# dq_f32_bound's constant, and the seeds of the f32 dequant cases, each
# drawn from a generator of its own (dq_f32_cases)
DQ_F32_C = 4.0
DQ_F32_SEEDS = (2024, 2025, 2026)

# the full-width train step: the JAX repo's headline (bench.py:636-661,
# TransformerLM V512 d1024 h8 L4, S 1024, batch 8, bf16, SGD(1e-3), lm_loss
# on the identity task); the f32 gradient gate runs one 256-token sequence
TRAIN_MODEL = dict(vocab_size=512, dim=1024, num_heads=8, num_layers=4,
                   max_seq_len=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 8, 1024, 2, 10
GATE_SEQ = 256
# launches per train step: ln1 x4 + ln_f, ln2 (add+LN) x4, attention x4, the
# loss once; each backward once per forward
TRAIN_LAUNCHES = {"ln_fwd": 5, "addln_fwd": 4, "flash_fwd": 4, "xent_fwd": 1,
                  "ln_bwd": 5, "addln_bwd": 4, "flash_bwd_dkv": 4,
                  "flash_bwd_dq": 4, "xent_bwd": 1}
# the device symbols of the port's kernels, as the profiler names them
PORTED_SYMBOLS = ("ln_rows_kernel", "ln_bwd_kernel", "norm_fwd_kernel",
                  "norm_bwd_kernel", "flash_fwd_kernel",
                  "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                  "xent_fwd_kernel", "xent_bwd_kernel", "mm_bf16_kernel",
                  "mm_f32_kernel", "dq_mm_kernel", "dq4_mm_kernel",
                  "sdpa_int8_kernel", "paged_attn_kernel", "scan_kernel",
                  "dq_bmm_kernel", "dq_bmm_tc_kernel", "dq4_mm_tc_kernel",
                  "dq_mm_tc_kernel", "flash_fwd_wgmma_kernel",
                  "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                  "mm_wgmma_kernel", "sdpa_int8_split_kernel",
                  "paged_attn_split_kernel", "norm_wave_kernel",
                  "xent_row_kernel", "norm_ring_bwd_kernel", "ring_sum_kernel",
                  "scan_ring_kernel")
# the forward norms' kernels, whose device time per call each profile reports
# for the plain and the fused (ADD) instantiations apart
NORM_FWD_SYMBOLS = ("norm_wave_kernel", "ln_rows_kernel", "norm_fwd_kernel")
# the redesigned backwards whose device time per step the train profiles
# report on their new and old kernels: xent_bwd's (the row kernel and the
# warp kernel), and rms_bwd's, ln_bwd's and addln_bwd's (the ring and its
# partial rows' sum; the block-per-row kernel, and LayerNorm's warp-per-row
# kernel, whose partial rows the caller sums with PyTorch kernels not
# counted here)
BWD_REDESIGNED = ("xent_bwd", "rms_bwd", "ln_bwd", "addln_bwd")
# the kernels that the train path runs and the serving path does not
TRAIN_ONLY = {"ln_bwd", "addln_bwd", "flash_bwd_dkv", "flash_bwd_dq",
              "xent_fwd", "xent_bwd"}
# the kernels that only the tape path runs
TAPE_ONLY = {"matmul_nn", "matmul_nt", "matmul_tn"}
# the kernels that only quantized decoding runs, and only the paged server
QUANT_ONLY = {"dq_mm", "dq4_mm", "sdpa_int8"}
PAGED_ONLY = {"paged_attn"}
SSM_ONLY = {"scan"}
MOE_ONLY = {"dq_bmm"}
PATHS = ("generate", "server", "train", "tape", "quant", "paged", "options",
         "ssm", "head_dims", "moe", "window")
# the kernels phase 13 (sliding windows, sinks, packing) must launch too
WINDOW_PATH = {"flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "paged_attn"}

# quantized decode (bench.py:350-443): the serving model above at its bench
# size, and the int8 KV cache at long context (bench.py:413-443)
LC_SEQ, LC_BATCH, LC_PROMPT, LC_NEW = 4096, 4, 3968, 64
# per decode step: 16 projections and the head, and with kv_quant the
# attention of each of the 4 layers
DQ_PER_STEP = 4 * MODEL["num_layers"] + 1
SDPA8_PER_STEP = MODEL["num_layers"]
# the paged server against the dense one (serving_bench.paged_vs_dense):
# 8 slots, window 1024, bf16, prompts of 16 tokens, timed in turns
PAGED_SEQ, PAGED_SLOTS, PAGED_PROMPT, PAGED_STEPS, PAGED_ROUNDS = 1024, 8, 16, 32, 3
# decode attention over a cache in phase 2 (decode_attn_cases and its A/Bs).
# sdpa_int8 at [B, heads, kv heads, hd, L, pos]: the bench decode's last
# step, the long-context one, head dim 256 (2 heads) at the bench decode's,
# and Mistral-7B's grouping (32 heads over 8 KV heads) at L 16,384, which
# the one-CTA kernel refused (its scores overflowed the block).
# paged_attn at [kv heads, g, hd, pages used] of PAGED_SLOTS slots of
# PAGED_SEQ // 128 pages: the paged server's step at 1 and 8 pages, head
# dim 256 (2 heads), and the Mistral-7B grouping
SDPA_CASES = ([BATCH, MODEL["num_heads"], MODEL["num_heads"], 128, 256, PROMPT + NEW - 1],
              [LC_BATCH, MODEL["num_heads"], MODEL["num_heads"], 128, LC_SEQ,
               LC_PROMPT + LC_NEW - 1],
              [BATCH, 2, 2, 256, 256, PROMPT + NEW - 1],
              [1, 32, 8, 128, 16384, 16000])
PAGED_CASES = ([MODEL["num_heads"], 1, 128, 1], [MODEL["num_heads"], 1, 128, 8],
               [2, 1, 256, 8], [8, 4, 128, 8])
# launches per server step: ln1 of each block and ln_f, add+LN of each
# block; the paged step adds one paged_attn per layer
DENSE_STEP_LAUNCHES = {"ln_fwd": 5, "addln_fwd": 4}
PAGED_STEP_LAUNCHES = {**DENSE_STEP_LAUNCHES, "paged_attn": MODEL["num_layers"]}

# the LLaMA-style options at Mistral-7B-v0.3's widths
# (https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/config.json:
# hidden 4096, 32 heads over 8 KV heads, intermediate 14336 with SwiGLU,
# vocabulary 32768, rope_theta 1e6, rms_norm_eps 1e-5, untied head, no
# biases), bf16, random weights from --seed.  Cut: 4 of its 32 identical
# layers, and 1,024 positions (the train length and the server window;
# under RoPE nothing reads more)
OPT_MODEL = dict(vocab_size=32768, dim=4096, num_heads=32, num_kv_heads=8,
                 num_layers=4, max_seq_len=1024, norm="rms", norm_eps=1e-5,
                 rope=True, rope_base=1e6, mlp="swiglu", mlp_hidden=14336,
                 mlp_bias=False)
# train at bench.py:636-661's shape; the f32 gates take one layer, a prompt
# of 16 and 8 cached steps, and one sequence of 128 tokens for the gradients
OPT_TRAIN_BATCH, OPT_TRAIN_SEQ, OPT_TRAIN_STEPS = 8, 1024, 10
OPT_GATE_LAYERS, OPT_GATE_PROMPT, OPT_GATE_STEPS, OPT_GATE_SEQ = 1, 16, 8, 128

# sliding windows with attention sinks, and packed sequences, at
# Mistral-7B-v0.1's widths
# (https://huggingface.co/mistralai/Mistral-7B-v0.1/blob/main/config.json:
# hidden 4096, 32 heads over 8 KV heads, intermediate 14336 with SwiGLU,
# vocabulary 32000, rope_theta 1e4, rms_norm_eps 1e-5, sliding_window 4096,
# untied head, no biases) with 4 attention sinks (StreamingLLM's count),
# bf16, random weights from --seed.  Cut: 2 of its 32 identical layers, and
# 8,192 positions (past the window, so the band is live)
WIN_MODEL = dict(vocab_size=32000, dim=4096, num_heads=32, num_kv_heads=8,
                 num_layers=2, max_seq_len=8192, norm="rms", norm_eps=1e-5,
                 rope=True, rope_base=1e4, mlp="swiglu", mlp_hidden=14336,
                 mlp_bias=False, window=4096, sinks=4)
# three packed train steps of 2 rows x 8,192 tokens, documents of 64-6,144
# tokens; a 4,608-token prompt and 32 new tokens; the paged server's 4
# requests (prompt, new tokens), every prompt past the window; the f32
# gate's sequence, window and sinks; the tape gate's (B, H, S, head dim)
WIN_TRAIN_BATCH, WIN_TRAIN_SEQ, WIN_TRAIN_STEPS = 2, 8192, 3
WIN_DOCS = (64, 6144)
WIN_PROMPT, WIN_NEW = 4608, 32
WIN_REQUESTS = [(4160, 24), (4500, 16), (4800, 12), (5100, 20)]
WIN_GATE_SEQ, WIN_GATE_WINDOW, WIN_GATE_SINKS = 256, 96, 4
WIN_SDPA = (4, 32, 2048, 128)
OPTIONS_ONLY = {"rms_fwd", "addrms_fwd", "rms_bwd", "addrms_bwd"}

# the head-dim-256 flash cases: 8 sequences x 2 heads of 1,024 tokens, the
# train shape of phase 11's head-dim-256 model (d 512 over 2 heads)
HD256_BH, HD256_SEQ = 16, 1024
HD256_MODEL = dict(vocab_size=512, dim=512, num_heads=2, num_layers=2,
                   max_seq_len=1024)

# the Mamba family at bench.py:602-632's decode_ssm row and
# benchmarks/ssm_bench.py's configuration: the flagship's vocabulary, width
# and depth, d_state 16 (d_conv 4, expand 2, tied head), bf16.  Nothing is
# cut.  ssm_bench.decode_bench decodes after a 1,024-token prompt;
# ssm_bench.train_race trains at batch 8 x 1024 with SGD(1e-4) and lm_loss
SSM_MODEL = dict(vocab_size=512, dim=1024, num_layers=4, d_state=16, d_conv=4,
                 expand=2)
SSM_LONG_PROMPT = 1024
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS, SSM_LR = 8, 1024, 10, 1e-4
# the scan's (lead, T, C) at the train step: (batch, seq, d_inner * d_state)
SSM_SCAN = (SSM_TRAIN_BATCH, SSM_TRAIN_SEQ,
            SSM_MODEL["expand"] * SSM_MODEL["dim"] * SSM_MODEL["d_state"])
# the f32 gates at full width and one layer: a prompt of 16 and 8 steps, a
# ragged prefill of three rows, one sequence of 128 tokens for the gradients;
# the tape's f32 gate at (2, 256, 4096)
SSM_GATE_PROMPT, SSM_GATE_STEPS, SSM_GATE_SEQ = 16, 8, 128
SSM_TAPE_GATE = (2, 256, 4096)
# per tape step: the forward scan and one reverse scan for both VJPs
SSM_TAPE_LAUNCHES = {"scan": 2}

# the MoE family at bench.py:502-530's decode_moe_int8 row: nothing is cut.
# Its decode: batch 8, prompt 16, 64 new tokens; at capacity 4.0 x top-2
# over 8 experts each expert has C = T slots, so no token is ever dropped
# and a server request routes as it would alone
MOE_MODEL = dict(vocab_size=512, dim=1024, num_heads=8, num_kv_heads=4,
                 num_layers=4, num_experts=8, k=2, capacity_factor=4.0,
                 grouped=True, max_seq_len=256, norm="rms", rope=True,
                 mlp="swiglu", mlp_hidden=2048, mlp_bias=False, renorm_gates=True)
MOE_NEW = 64
# 10 staggered requests whose prompt and new tokens fit the 256 window
MOE_REQUESTS = [(16, 64), (130, 48), (200, 40), (16, 96), (100, 40), (40, 80),
                (160, 24), (90, 56), (5, 30), (180, 60)]
# benchmarks/moe_bench.py: V512 d512 h4 L2, S 512, batch 8, E 8, top-1 at
# capacity 1.0, LayerNorm, gelu experts with bias, bf16, SGD(1e-3),
# make_moe_loss(0.01); the dense TransformerLM of equal FLOPs beside it
MOE_TRAIN = dict(vocab_size=512, dim=512, num_heads=4, num_layers=2,
                 num_experts=8, max_seq_len=512, k=1, capacity_factor=1.0)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS, MOE_TRAIN_ROUNDS = 8, 512, 5, 2
# the f32 gates: one layer, a prompt of 16 and 8 cached steps, one
# sequence of 128 tokens for the loss and gradients
MOE_GATE_PROMPT, MOE_GATE_STEPS, MOE_GATE_SEQ = 16, 8, 128
# the idle host time on each side of a profiled run (profile_run), far
# beyond the profiler's error in placing kernels on the host's clock
PROFILE_PAD_S = 0.02

# the tape path.  bench.py:196-234's matmul step: 4096^2 bf16, lr 1e-6, 2
# warm-up and 10 timed steps; each step's forward is one nn product and its
# backward one nt (dx) and one tn (dw)
MM_N, MM_LR, MM_WARMUP, MM_STEPS = 4096, 1e-6, 2, 10
# the dequant kernels' A/B of phase 2 (dq_route_ab): the tensor-core tiles
# against the SIMT tile of a -DDQ_SIMT_BF16 build, at the main path's shapes
# ([E, C, K, N] for dq_bmm, [M, K, N] for dq4_mm); a cold time rotates over
# copies of the weight that together exceed COLD_BYTES (twice the 50 MB L2)
DQ_BMM_AB = ([8, 128, 1024, 4096], [8, 128, 2048, 1024], [8, 8, 1024, 4096],
             [8, 8, 2048, 1024], [8, 5, 1024, 4096])
DQ4_AB = ([128, 1024, 3072], [128, 1024, 4096], [128, 4096, 1024], [8, 1024, 3072],
          [8, 1024, 1024], [8, 1024, 4096], [8, 1024, 512], [8, 4096, 1024])
# dq_mm ([M, K, N]): the int8 model's decode (8 rows) and bench prefill (128
# rows) projections, QKV, out, fc1, fc2 and the head; the MoE model's
# attention projections (8 heads over 4 KV heads) are [1024, 1024] like out
DQ_MM_AB = [[m, k, n] for m in (BATCH, 128)
            for k, n in ((MODEL["dim"], 3 * MODEL["dim"]), (MODEL["dim"], MODEL["dim"]),
                         (MODEL["dim"], 4 * MODEL["dim"]), (4 * MODEL["dim"], MODEL["dim"]),
                         (MODEL["dim"], MODEL["vocab_size"]))]
COLD_BYTES = 100e6
# the split A/B of phase 2 (dq_split_ab): each shape on its plan's tile at
# 1, 2, 4, 8 and 16 K splits (as many as its units allow), the evidence for
# dq_plan's split rule; the 128-row shapes on the large tile, the decode
# shapes on the small one ((bits, shape) as DQ_BMM_AB / DQ_MM_AB / DQ4_AB)
DQ_SPLIT_AB = ((8, [8, 128, 2048, 1024]), (8, [8, 128, 1024, 4096]),
               (4, [128, 1024, 3072]), (4, [128, 1024, 4096]), (4, [128, 4096, 1024]),
               (8, [8, 8, 2048, 1024]), (4, [8, 4096, 1024]), (4, [8, 1024, 3072]),
               (8, [128, 1024, 3072]), (8, [128, 4096, 1024]), (8, [128, 1024, 4096]),
               (8, [8, 4096, 1024]), (8, [8, 1024, 3072]))
# the tile A/B at 9-16 rows (dq_tile_ab): a 16-token bucket's products on
# each tensor-core tile, with the split rule's splits for that tile
DQ_TILE_AB = ((8, [8, 16, 1024, 4096]), (8, [8, 16, 2048, 1024]),
              (4, [16, 1024, 3072]), (4, [16, 4096, 1024]), (8, [16, 1024, 3072]))
MM_STEP_LAUNCHES = {"matmul_nn": 1, "matmul_nt": 1, "matmul_tn": 1}
# the bf16 matmuls' edges in phase 2 ([m, n, k], each layout): no dimension
# a multiple of a tile, one K-tile and part of one (2^31 flops or more)
MM_EDGES = ([1032, 1032, 1032], [8192, 8192, 64], [8192, 8192, 16])
# benchmarks/mlp_bench.py's device-bound config mlp_784x4096x10_b8192:
# batch 8192, 784 -> 4096 (relu) -> 10, f32, SGD 0.1.  Per step: layer 1's
# forward (nn) and dW1 (tn) are 52.6 GFLOP each and launch the kernels; x
# takes no gradient (no nt); layer 2's three products are 0.67 GFLOP each,
# under the 2^31-flop rule, and go to torch.matmul; the loss launches
# xent_fwd and its first-order VJP xent_bwd
MLP_BATCH, MLP_IN, MLP_HIDDEN, MLP_OUT, MLP_LR, MLP_STEPS = 8192, 784, 4096, 10, 0.1, 10
MLP_STEP_LAUNCHES = {"matmul_nn": 1, "matmul_tn": 1, "xent_fwd": 1, "xent_bwd": 1}
# the matmul A/Bs of phase 2 (matmul_route_ab, matmul_tile_ab): [variant,
# m, n, k] at the tape's matmul step, the MLP's bf16 layer-1 forward and
# dW1, and MM_EDGES
MM_AB = ([[v, MM_N, MM_N, MM_N] for v in ("nn", "nt", "tn")]
         + [["nn", MLP_BATCH, MLP_HIDDEN, MLP_IN], ["tn", MLP_IN, MLP_HIDDEN, MLP_BATCH]]
         + [[v, *e] for e in MM_EDGES for v in ("nn", "nt", "tn")])
# the f32 gate's size (the CPU runs it too) and the Hessian's dimension
# (benchmarks/hessian_bench.py)
TAPE_GATE_N, HESS_N = 2048, 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, default=None,
                    help="write every measurement to this file")
    ap.add_argument("--refusal", choices=REFUSALS, default=None,
                    help="run one capture-refusal case (a child process of the run)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port "
              "and has nothing to run here", file=sys.stderr)
        return 2
    if not (ROOT / "minidiff_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no minidiff_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.refusal is not None:
        return refusal_case(torch, args.refusal)

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    report = {"device": smi, "seed": args.seed, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["phase_seconds"] = {}

    def timed(name, phase, *a):
        t0 = time.perf_counter()
        out = phase(torch, *a, report)
        report["phase_seconds"][name] = time.perf_counter() - t0
        return out

    kernels = timed("kernels", phase_kernels)
    for name, phase in (("generate", phase_generate), ("server", phase_server),
                        ("train", phase_train), ("tape", phase_tape),
                        ("quant", phase_quant), ("paged", phase_paged),
                        ("options", phase_options), ("ssm", phase_ssm),
                        ("head_dims", phase_head_dims), ("moe", phase_moe),
                        ("window", phase_window)):
        timed(name, phase, args.seed)
        clear_programs()

    from minidiff_tpu_torch import kernels as K

    for k in kernels:
        counts = {path: report[f"launches_{path}"][k["name"]] for path in PATHS}
        k["launches"] = sum(counts.values())
        for path, n in counts.items():
            k[f"launches_{path}"] = n
        required = required_paths(k["name"])
        check(all(counts[p] > 0 for p in required),
              f"kernel {k['name']} did not launch on its paths {required}: "
              f"{counts}")
    check(set(K.launch_counts()) == {k["name"] for k in kernels},
          "the kernels line must list every ported kernel")
    report["kernels"] = kernels
    log("[train_ab] captured against eager (best run's ms per step; busy share, device "
        "calls a step, peak MiB from one profiled step and the first two steps):")
    for label, r in report["train_ab"].items():
        c, e = r["captured"], r["eager"]
        log(f"[train_ab]   {label}: {min(c['ms_per_step']):.3f} / {min(e['ms_per_step']):.3f} "
            f"ms, busy {c['busy_share']:.1%} / {e['busy_share']:.1%}, calls "
            f"{c['device_calls_per_step']} / {e['device_calls_per_step']}, peak "
            f"{c['peak_mib']:.0f} / {e['peak_mib']:.0f} MiB, capture "
            f"{c['capture_seconds']:.2f} s, losses {r['held']}")
    report["seconds"] = time.perf_counter() - t_start
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in report["phase_seconds"].items()))
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
        *(f"launches_{path}" for path in PATHS))}
        for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def required_paths(name: str) -> tuple:
    """The paths on which kernel ``name`` must launch: the serving kernels
    (the forward norms and flash) on every path that runs the model forward,
    the others on the paths that only they serve; the flash kernels and
    paged attention on the window path too."""
    extra = ("window",) if name in WINDOW_PATH else ()
    for only, paths in ((TAPE_ONLY, ("tape",)), (QUANT_ONLY, ("quant",)),
                        (PAGED_ONLY, ("paged",)), (TRAIN_ONLY, ("train",)),
                        (OPTIONS_ONLY, ("options",)), (SSM_ONLY, ("ssm",)),
                        (MOE_ONLY, ("moe",))):
        if name in only:
            return paths + extra
    return ("generate", "server", "train", "quant", "paged") + extra


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device milliseconds per call of ``fn``, back to back.

    A spin kernel holds the stream while the host enqueues all ``iters``
    calls, so the events time the device's work and not the host's Python
    and launch overhead (which the end-to-end phases include).  ``iters``
    stays small enough that a plain version's ~15 launches per call do not
    fill the device's launch queue, which would make the host wait on it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~25 ms at 2 GHz, or ~100 us a call past 250 calls: longer than the enqueue
    torch.cuda._sleep(max(50_000_000, 200_000 * iters))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the readings of each name in one turn of a gated pair in the route A/Bs,
# whose median is the turn's: a lone reading of the old kernel's own code
# has read 6% slower than the turn beside it, past the 3% gate
GATE_READS = 3
# the least device ms of a reading in the route A/Bs of short calls
# (xent_fwd's narrow rows, 7-14 us; the scan's (8, 16, 32768), 5 us): 50
# calls made readings short enough for the card's drift between two turns
# to move them by 3%
GATE_READ_MS = 2.0


def _pair_turns(torch, run, pair, iters: int = 50) -> dict:
    """Device us of ``run(name)`` for the pair a route A/B gates (the old
    build first) in two turns, ``pair`` then reversed.  A turn reads the
    two alternately, GATE_READS times each, and a name's turn is the median
    of its readings, so that both names' turns span the same stretch of
    the card's drift."""
    us = {n: [] for n in pair}
    for order in (pair, pair[::-1]):
        reads = {n: [] for n in pair}
        for _ in range(GATE_READS):
            for n in order:
                reads[n].append(device_ms(torch, lambda: run(n), iters) * 1e3)
        for n in pair:
            us[n].append(statistics.median(reads[n]))
    return us


def max_err(torch, out, ref, kind, dtype_name, g=None):
    rtol, atol = TOL[(kind, dtype_name)]
    out, ref = out.float(), ref.float()
    if kind in SCALED:
        atol *= ref.abs().max().item()
    if kind in G_SCALED:
        atol *= g.abs().max().item()
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{kind}: non-finite output")
    over = err - (atol + rtol * ref.abs())
    if bool((over > 0).any()):
        i = int(torch.argmax(over))
        check(False, f"{kind} {dtype_name}: max |err| {err.max().item():.3g} beyond "
              f"rtol {rtol} atol {atol}; {int((over > 0).sum())} of {err.numel()} beyond, "
              f"the worst at flat index {i}: {out.flatten()[i].item()!r} against "
              f"{ref.flatten()[i].item()!r}")
    return err.max().item()


def dq_f32_bound(torch, x, w, ref):
    """The f32 dequant gate's bound on each output's |out - ref| (see TOL):
    x (..., K) the activations, w (..., K, N) the dequantized weight in f64,
    ref = x @ w in f64.  ||t||_2 of an output's products is the square root
    of (x^2) @ (w^2)."""
    import math

    x = x.double()
    norm = torch.sqrt(torch.matmul(x * x, w * w))
    return DQ_F32_C * 2.0 ** -24 * math.sqrt(x.shape[-1]) * (norm + ref.abs())


def dq_hold(torch, out, plain, x, w, dn):
    """A dequant product ``out`` of the kernel and ``plain`` of its plain
    version, for activations x and the dequantized weight w (f64): in bf16
    out within TOL["dq"] of plain; in f32 both within dq_f32_bound of the
    exact product x @ w.  Returns the largest |out - plain| (bf16) or |out -
    ref| (f32), and in f32 the largest share of the bound the kernel and
    the plain version used ({} in bf16)."""
    if dn == "bfloat16":
        return max_err(torch, out, plain, "dq", dn), {}
    ref = torch.matmul(x.double(), w)
    lim = dq_f32_bound(torch, x, w, ref)
    shares = {}
    for side, got in (("kernel", out), ("plain", plain)):
        check(bool(torch.isfinite(got).all()), f"dq f32 {side}: non-finite output")
        share = (got.double() - ref).abs() / lim
        i = int(torch.argmax(share))
        check(share.flatten()[i].item() <= 1.0,
              f"dq f32 {side} {tuple(x.shape)} x {tuple(w.shape)}: |err| "
              f"{(got.double() - ref).abs().max().item():.3g} beyond dq_f32_bound; "
              f"{int((share > 1).sum())} of {share.numel()} beyond, the worst at flat index "
              f"{i}: {got.flatten()[i].item()!r} against {ref.flatten()[i].item()!r}, "
              f"{share.flatten()[i].item():.3g} of its bound {lim.flatten()[i].item():.3g}")
        shares[side] = share.max().item()
    return (out.double() - ref).abs().max().item(), shares


def ptxas_report(text: str) -> list:
    """One line for each kernel in nvcc's ``-Xptxas -v`` output: its name
    (demangled where c++filt exists), registers, and spills if any."""
    try:
        text = subprocess.run(["c++filt"], input=text, capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        pass  # the mangled names name the instantiations too
    lines, name, spills = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            name, spills = name.removeprefix("void "), ""
        elif "spill" in line and not line.strip().startswith("0 bytes"):
            spills = "; " + line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}{spills}")
            name = None
        elif re.search(r"\(C75\d\d\)|setmaxnreg", line):
            lines.append(line.strip())  # serialised MMAs, an ignored setmaxnreg
    return lines


def phase_kernels(torch, report):
    from minidiff_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    # layernorm.cu with every row on the block-per-row route, built beside
    # the libraries
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    block_lib = _build.BUILD_DIR / "layernorm-block-per-row.so"
    block_build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DNORM_BLOCK_PER_ROW", "-o",
         str(block_lib), str(_build._CSRC / "layernorm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # quant.cu with every bf16 dq_mm / dq_bmm / dq4_mm on the SIMT tile
    # (dq_route_ab), flash_fwd.cu with bf16 on the WMMA tile (flash_route_ab)
    simt_lib = _build.BUILD_DIR / "quant-simt.so"
    simt_build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDQ_SIMT_BF16", "-o",
         str(simt_lib), str(_build._CSRC / "quant.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wmma_lib = _build.BUILD_DIR / "flash_fwd-wmma.so"
    wmma_build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_WMMA_BF16", "-o",
         str(wmma_lib), str(_build._CSRC / "flash_fwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # flash_bwd.cu with bf16 on the WMMA tile (flash_bwd_route_ab)
    bwd_wmma_lib = _build.BUILD_DIR / "flash_bwd-wmma.so"
    bwd_wmma_build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_BWD_WMMA_BF16", "-o",
         str(bwd_wmma_lib), str(_build._CSRC / "flash_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # matmul.cu with every bf16 product on the WMMA tile (matmul_route_ab)
    mm_wmma_lib = _build.BUILD_DIR / "matmul-wmma.so"
    mm_wmma_build = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DMM_WMMA_BF16", "-o",
         str(mm_wmma_lib), str(_build._CSRC / "matmul.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # quant.cu's sdpa_int8 and paged.cu on their one-CTA kernels
    # (decode_attn_route_ab)
    one_cta_libs = {src: _build.BUILD_DIR / f"{src}-one-cta.so" for src in ("quant", "paged")}
    one_cta_builds = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDECODE_ATTN_ONE_CTA", "-o", str(lib),
         str(_build._CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, lib in one_cta_libs.items()}
    # layernorm.cu's and rmsnorm.cu's forwards on their earlier routes at
    # every row count (norm_fwd_route_ab)
    v1_libs = {src: _build.BUILD_DIR / f"{src}-fwd-v1.so" for src in ("layernorm", "rmsnorm")}
    v1_builds = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DNORM_FWD_V1", "-o", str(lib),
         str(_build._CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, lib in v1_libs.items()}
    # xent.cu's backward on the warp kernel, rmsnorm.cu's rms_bwd and
    # layernorm.cu's ln_bwd and addln_bwd on their kernels before the ring,
    # at every row (xent_bwd_route_ab, norm_bwd_route_ab, the train profiles)
    bwd_v1_libs = {"xent": _build.BUILD_DIR / "xent-bwd-v1.so",
                   "rmsnorm": _build.BUILD_DIR / "rmsnorm-bwd-v1.so",
                   "layernorm": _build.BUILD_DIR / "layernorm-bwd-v1.so"}
    bwd_v1_builds = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(bwd_v1_libs[src]),
         str(_build._CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, flag in (("xent", "-DXENT_BWD_V1"), ("rmsnorm", "-DNORM_BWD_V1"),
                          ("layernorm", "-DNORM_BWD_V1"))}
    # xent.cu's forward on the warp kernel and scan.cu on the thread kernel,
    # at every shape (xent_fwd_route_ab, scan_route_ab, the train profiles)
    v1_fwd_libs = {"xent": _build.BUILD_DIR / "xent-fwd-v1.so",
                   "scan": _build.BUILD_DIR / "scan-v1.so"}
    v1_fwd_builds = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(v1_fwd_libs[src]),
         str(_build._CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, flag in (("xent", "-DXENT_FWD_V1"), ("scan", "-DSCAN_V1"))}
    _build.build_all()
    for flag, proc in (("-DNORM_BLOCK_PER_ROW", block_build), ("-DDQ_SIMT_BF16", simt_build),
                       ("-DFLASH_WMMA_BF16", wmma_build),
                       ("-DFLASH_BWD_WMMA_BF16", bwd_wmma_build),
                       ("-DMM_WMMA_BF16", mm_wmma_build),
                       *((f"-DDECODE_ATTN_ONE_CTA {src}.cu", proc)
                         for src, proc in one_cta_builds.items()),
                       *((f"-DNORM_FWD_V1 {src}.cu", proc)
                         for src, proc in v1_builds.items()),
                       *((f"{src}.cu V1 backward", proc)
                         for src, proc in bwd_v1_builds.items()),
                       *((f"{src}.cu V1 forward", proc)
                         for src, proc in v1_fwd_builds.items())):
        out = proc.communicate()[0]
        check(proc.returncode == 0, f"nvcc {flag}:\n{out}")
    log(f"[build] {len(_build.SOURCES) + 14} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    report["build"] = []
    for name in _build.SOURCES:
        for line in ptxas_report(_build.build_log(name)):
            report["build"].append(f"{name}: {line}")
            log(f"[build] {name}: {line}")
    # the flash kernels', the matmuls', the quantized kernels', the paged
    # kernel's, the norms', the cross-entropy's and the scan's: no spill, no
    # serialised MMAs, no ignored setmaxnreg
    for name in ("flash_fwd", "flash_bwd", "matmul", "quant", "paged", "layernorm", "rmsnorm",
                 "xent", "scan"):
        bad = [line for line in ptxas_report(_build.build_log(name))
               if re.search(r"\b[1-9]\d* bytes spill|C75\d\d|setmaxnreg", line)]
        check(not bad, f"{name}.cu: ptxas reports " + "; ".join(bad))

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the MoE and SSM train shapes' cases and the backwards' A/Bs draw from a
    # generator of their own, so that adding them left the inputs of every
    # other case and A/B as they were
    gen_bwd = torch.Generator(device="cuda").manual_seed(1235)

    def randn_bwd(*shape, dtype):
        return torch.randn(shape, generator=gen_bwd, device="cuda").to(dtype)

    cases = (norm_cases(torch, randn)
             + norm_cases(torch, randn, OPT_MODEL["dim"],
                          (OPT_TRAIN_BATCH * OPT_TRAIN_SEQ,))
             + rms_cases(torch, randn) + flash_cases(torch, randn)
             + xent_cases(torch, gen, randn) + matmul_cases(torch, randn)
             + quant_cases(torch, gen, randn, (torch.bfloat16,))
             + decode_attn_cases(torch, gen, randn) + scan_cases(torch, gen)
             + dq_bmm_cases(torch, randn, (torch.bfloat16,))
             + dq_edge_cases(torch, randn, (torch.bfloat16,))
             + norm_cases(torch, randn_bwd, MOE_TRAIN["dim"],
                          (MOE_TRAIN_BATCH * MOE_TRAIN_SEQ,))
             + rms_cases(torch, randn_bwd, ((SSM_TRAIN_BATCH * SSM_TRAIN_SEQ,
                                              SSM_MODEL["dim"]),))
             + xent_cases(torch, gen_bwd, randn_bwd, ((MOE_TRAIN_BATCH * MOE_TRAIN_SEQ,
                                                       MOE_TRAIN["vocab_size"]),)))
    # the flash kernels under sinks, key rows and ids, from a generator of
    # their own (the other cases' inputs stay as they were)
    cases += flash_mask_cases(torch)
    # the f32 dequant cases at three seeds; the first seed's are timed
    report["dq_f32_seeds"] = dq_f32_cases(torch)
    cases += [c for c in report["dq_f32_seeds"] if "ms" in c]
    torch.cuda.synchronize()
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms'] * 1e3:8.2f}"
        tile = (f" {c['tile']}" + (f"x{c['splits']}" if "splits" in c else "")
                if c.get("tile") else "")
        log(f"[kernel] {c['name']:13s} {c['dtype']:8s} {str(c['shape']):18s}{tile}"
            f"{' g' + str(c['group']) if c.get('group') else ''}"
            f"{' causal' if c.get('causal') else '':7s}"
            f"{' w' + str(c['window']) if c.get('window') else '':5s}"
            f"{' ' + c['masks'] if c.get('masks') else ''}"
            f"{' g' + str(c['groups']) if c.get('groups', 1) > 1 else '':4s} "
            f"err {c['max_abs_err']:.3g} "
            f"| kernel {c['ms'] * 1e3:9.2f} us | plain {c['plain_ms'] * 1e3:9.2f} us "
            f"| library {lib} us | bound {c['bound_ms'] * 1e3:7.2f} us "
            f"({c['bound_by']})")
    report["kernel_cases"] = cases
    report["flash_route"] = flash_route_cases(torch, randn)
    report["flash_route_ab"] = flash_route_ab(torch, randn, wmma_lib)
    report["flash_bwd_route_ab"] = flash_bwd_route_ab(torch, randn, bwd_wmma_lib)
    report["matmul_route_ab"] = matmul_route_ab(torch, randn, mm_wmma_lib)
    report["matmul_tile_ab"] = matmul_tile_ab(torch, randn)
    report["wide_norm"] = wide_norm_case(torch, randn)
    report["norm_width_sweep"] = norm_width_sweep(torch, randn)
    report["norm_route_ab"] = norm_route_ab(torch, randn, block_lib)
    report["norm_fwd_route_ab"] = norm_fwd_route_ab(torch, randn, v1_libs)
    report["norm_rows_ab"] = norm_rows_ab(torch, randn)
    report["dq_route_ab"] = dq_route_ab(torch, randn, simt_lib)
    report["dq_split_ab"] = dq_split_ab(torch, randn)
    report["dq_tile_ab"] = dq_tile_ab(torch, randn)
    report["decode_attn_route_ab"] = decode_attn_route_ab(torch, gen, randn, one_cta_libs)
    report["decode_split_ab"] = decode_split_ab(torch, gen, randn)
    report["xent_width_sweep"] = xent_width_sweep(torch, gen_bwd, randn_bwd)
    report["xent_bwd_route_ab"] = xent_bwd_route_ab(torch, gen_bwd, randn_bwd,
                                                    bwd_v1_libs["xent"])
    report["norm_bwd_route_ab"] = norm_bwd_route_ab(
        torch, randn_bwd, {src: bwd_v1_libs[src] for src in ("rmsnorm", "layernorm")})
    # the forward cross-entropy's and the scan's A/Bs draw from a generator of
    # their own, as the backwards' did
    gen_fwd = torch.Generator(device="cuda").manual_seed(1236)

    def randn_fwd(*shape, dtype):
        return torch.randn(shape, generator=gen_fwd, device="cuda").to(dtype)

    report["xent_fwd_route_ab"] = xent_fwd_route_ab(torch, gen_fwd, randn_fwd,
                                                    v1_fwd_libs["xent"])
    report["scan_route_ab"] = scan_route_ab(torch, gen_fwd, v1_fwd_libs["scan"])
    report["simt_quant_lib"] = str(simt_lib)  # phases 7 and 12 profile it too
    # phases 3 and 9 profile their decodes on the earlier forward norms too
    report["norm_fwd_v1_libs"] = {src: str(path) for src, path in v1_libs.items()}
    # phases 9 and 10 profile their train steps on the old backwards too, and
    # on the old forward cross-entropy and scan
    report["bwd_v1_libs"] = {src: str(path) for src, path in bwd_v1_libs.items()}
    report["fwd_v1_libs"] = {src: str(path) for src, path in v1_fwd_libs.items()}

    # the kernels line reports the serving kernels at the shape the bf16
    # serving path gives them most often (the norms at a decode step's 8
    # rows, flash at generate_compiled's prefill of 8 sequences x 8 heads of
    # 16 tokens), the train path's kernels at the train step's shapes, the
    # matmul kernels at the tape's matmul step ([m, n, k]), the dequant
    # kernels at a decode step's QKV projection ([m, K, N]), sdpa_int8 at
    # the bench decode's last step ([B, kv, g*c, hd, L]), paged_attn at the
    # paged server's steps ([B, kv, g, hd, pages per slot]), the RMSNorm
    # forwards at the options model's decode step and their backwards at its
    # train step, the scan at the SSM train step's (lead, T, C), and dq_bmm
    # at the MoE model's decode step's w1 bank ([E, C, K, N])
    d, rows = TRAIN_MODEL["dim"], TRAIN_BATCH * TRAIN_SEQ
    bhs = [TRAIN_BATCH * TRAIN_MODEL["num_heads"], TRAIN_SEQ, 128]
    ln_src = "minidiff_tpu_torch/kernels/csrc/layernorm.cu"
    rms_src = "minidiff_tpu_torch/kernels/csrc/rmsnorm.cu"
    od, orows = OPT_MODEL["dim"], OPT_TRAIN_BATCH * OPT_TRAIN_SEQ
    mm_src = "minidiff_tpu_torch/kernels/csrc/matmul.cu"
    q_src = "minidiff_tpu_torch/kernels/csrc/quant.cu"
    meta = {
        "ln_fwd": (ln_src, "minidiff_tpu/kernels/layernorm.py:84", [8, d]),
        "addln_fwd": (ln_src, "minidiff_tpu/kernels/layernorm.py:123", [8, d]),
        "flash_fwd": ("minidiff_tpu_torch/kernels/csrc/flash_fwd.cu",
                      "minidiff_tpu/kernels/attention.py:171", [64, 16, 128]),
        "ln_bwd": (ln_src, "minidiff_tpu/kernels/layernorm.py:181", [rows, d]),
        "addln_bwd": (ln_src, "minidiff_tpu/kernels/layernorm.py:149", [rows, d]),
        "flash_bwd_dkv": ("minidiff_tpu_torch/kernels/csrc/flash_bwd.cu",
                          "minidiff_tpu/kernels/attention.py:339", bhs),
        "flash_bwd_dq": ("minidiff_tpu_torch/kernels/csrc/flash_bwd.cu",
                         "minidiff_tpu/kernels/attention.py:390", bhs),
        "xent_fwd": ("minidiff_tpu_torch/kernels/csrc/xent.cu",
                     "minidiff_tpu/kernels/xent.py:64",
                     [rows, TRAIN_MODEL["vocab_size"]]),
        "xent_bwd": ("minidiff_tpu_torch/kernels/csrc/xent.cu",
                     "minidiff_tpu/kernels/xent.py:74",
                     [rows, TRAIN_MODEL["vocab_size"]]),
        "matmul_nn": (mm_src, "minidiff_tpu/kernels/matmul.py:106", [MM_N] * 3),
        "matmul_nt": (mm_src, "minidiff_tpu/kernels/matmul.py:190", [MM_N] * 3),
        "matmul_tn": (mm_src, "minidiff_tpu/kernels/matmul.py:207", [MM_N] * 3),
        "dq_mm": (q_src, "minidiff_tpu/kernels/quant.py:58", [BATCH, d, 3 * d]),
        "dq4_mm": (q_src, "minidiff_tpu/kernels/quant.py:412", [BATCH, d, 3 * d]),
        "sdpa_int8": (q_src, "minidiff_tpu/kernels/quant.py:138",
                      [BATCH, MODEL["num_heads"], 1, 128, 256]),
        "paged_attn": ("minidiff_tpu_torch/kernels/csrc/paged.cu",
                       "minidiff_tpu/kernels/paged.py:64",
                       [PAGED_SLOTS, MODEL["num_heads"], 1, 128, 1]),
        "rms_fwd": (rms_src, "minidiff_tpu/kernels/layernorm.py:91", [8, od]),
        "addrms_fwd": (rms_src, "minidiff_tpu/kernels/layernorm.py:141", [8, od]),
        "rms_bwd": (rms_src, "minidiff_tpu/kernels/layernorm.py:112", [orows, od]),
        "addrms_bwd": (rms_src, "minidiff_tpu/kernels/layernorm.py:168",
                       [orows, od]),
        "scan": ("minidiff_tpu_torch/kernels/csrc/scan.cu",
                 "minidiff_tpu/kernels/scan.py:67", list(SSM_SCAN)),
        "dq_bmm": (q_src, "minidiff_tpu/kernels/quant.py:274",
                   [MOE_MODEL["num_experts"], BATCH, MOE_MODEL["dim"],
                    2 * MOE_MODEL["mlp_hidden"]]),
    }
    line = []
    for name, (src, replaces, shape) in meta.items():
        c = next(c for c in cases if c["name"] == name and c["dtype"] == "bfloat16"
                 and c["shape"] == shape and not c.get("window") and not c.get("masks")
                 and c.get("causal", True) and not c.get("backward"))
        line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         shape=shape, **{key: c[key] for key in (
                             "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}))
    return line


def norm_cases(torch, randn, d=None, row_counts=None):
    """ln_fwd / addln_fwd and ln_bwd / addln_bwd at the decode step's 8 rows,
    prefill-sized rows and the train step's 8192 rows of d = 1024 (or at
    ``row_counts`` rows of ``d``: 8192 rows of 4096, wider than one warp's
    registers, take the block-per-row kernels)."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import layernorm as L

    cases = []
    d = d or MODEL["dim"]
    row_counts = row_counts or (8, 128, 1024, TRAIN_BATCH * TRAIN_SEQ)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows in row_counts:
            x = randn(rows, d, dtype=dtype) * 3 + 1
            a = randn(rows, d, dtype=dtype)
            g = 1 + 0.1 * randn(d, dtype=dtype)
            b = 0.1 * randn(d, dtype=dtype)
            bytes_ln = (2 * rows * d + 2 * d) * size
            flops_ln = 8 * rows * d
            err = max_err(torch, L.layernorm(x, g, b), L._plain_layernorm(x, g, b),
                          "ln", dn)
            cases.append(dict(
                name="ln_fwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.layernorm(x, g, b)),
                plain_ms=device_ms(torch, lambda: L._plain_layernorm(x, g, b)),
                library_ms=device_ms(torch, lambda: TF.layer_norm(x, (d,), g, b, 1e-5)),
                **bound(bytes_ln, flops_ln, dn)))
            pair = L.add_layernorm(x, a, g, b)
            plain = L._plain_add_layernorm(x, a, g, b)
            check(torch.equal(pair[0], plain[0]), "addln: t = x + a must be exact")
            err = max_err(torch, pair, plain, "ln", dn)
            cases.append(dict(
                name="addln_fwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.add_layernorm(x, a, g, b)),
                plain_ms=device_ms(torch, lambda: L._plain_add_layernorm(x, a, g, b)),
                library_ms=None,
                **bound((4 * rows * d + 2 * d) * size, flops_ln + rows * d, dn)))
            if rows == 128:
                continue  # the backward runs at the train step's and two others
            dy = randn(rows, d, dtype=dtype)
            g0 = randn(rows, d, dtype=dtype)
            # about 12 operations per element: statistics, xhat, w, the two
            # row sums, dx, and the dg/db sums
            flops_bwd = 12 * rows * d
            got, ref = L.ln_grads(x, g, dy), L._plain_ln_grads(x, g, dy)
            err = max(max_err(torch, got[0], ref[0], "ln", dn),
                      max_err(torch, got[1], ref[1], "lnsum", dn),
                      max_err(torch, got[2], ref[2], "lnsum", dn))
            mean, rstd = (t for t in torch.ops.aten.native_layer_norm(
                x, (d,), g, b, 1e-5)[1:])
            cases.append(dict(
                name="ln_bwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.ln_grads(x, g, dy)),
                plain_ms=device_ms(torch, lambda: L._plain_ln_grads(x, g, dy)),
                library_ms=device_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, (d,), mean, rstd, g, b, [True, True, True])),
                **bound((3 * rows * d + 3 * d) * size, flops_bwd, dn)))
            # against dx_ln + g0 with the same two roundings
            got = L.addln_grads(x, g, dy, g0)
            ref = L._plain_addln_grads(x, g, dy, g0)
            err = max(max_err(torch, got[0], ref[0], "addln_dx", dn),
                      max_err(torch, got[1], ref[1], "lnsum", dn),
                      max_err(torch, got[2], ref[2], "lnsum", dn))
            cases.append(dict(
                name="addln_bwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.addln_grads(x, g, dy, g0)),
                plain_ms=device_ms(torch, lambda: L._plain_addln_grads(x, g, dy, g0)),
                library_ms=None,
                **bound((4 * rows * d + 3 * d) * size, flops_bwd + rows * d, dn)))
    return cases


def rms_cases(torch, randn, shapes=None):
    """rms_fwd / addrms_fwd at a decode step's 8 rows and at the options
    train step's 8192 rows of d = 4096, and rms_bwd / addrms_bwd at the
    latter, against their plain versions and F.rms_norm (forward, and its
    autograd backward); the forwards also at 8 rows of d = 1024, the SSM's
    and MoE's decode shape (or at ``shapes``' (rows, d): all four at more
    than 8 rows)."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import layernorm as L

    cases = []
    eps = OPT_MODEL["norm_eps"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows, d in shapes or ((8, SSM_MODEL["dim"]), (8, OPT_MODEL["dim"]),
                                  (OPT_TRAIN_BATCH * OPT_TRAIN_SEQ, OPT_MODEL["dim"])):
            x = randn(rows, d, dtype=dtype) * 3 + 1
            a = randn(rows, d, dtype=dtype)
            g = 1 + 0.1 * randn(d, dtype=dtype)
            # x*x, the row sum, x * rsig * g: about 4 operations per element
            flops = 4 * rows * d
            err = max_err(torch, L.rmsnorm(x, g, eps), L._plain_rmsnorm(x, g, eps),
                          "ln", dn)
            cases.append(dict(
                name="rms_fwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.rmsnorm(x, g, eps)),
                plain_ms=device_ms(torch, lambda: L._plain_rmsnorm(x, g, eps)),
                library_ms=device_ms(torch, lambda: TF.rms_norm(x, (d,), g, eps)),
                **bound((2 * rows * d + d) * size, flops, dn)))
            pair = L.add_rmsnorm(x, a, g, eps)
            plain = L._plain_add_rmsnorm(x, a, g, eps)
            check(torch.equal(pair[0], plain[0]), "addrms: t = x + a must be exact")
            cases.append(dict(
                name="addrms_fwd", dtype=dn, shape=[rows, d],
                max_abs_err=max_err(torch, pair, plain, "ln", dn),
                ms=device_ms(torch, lambda: L.add_rmsnorm(x, a, g, eps)),
                plain_ms=device_ms(torch, lambda: L._plain_add_rmsnorm(x, a, g, eps)),
                library_ms=None,
                **bound((4 * rows * d + d) * size, flops + rows * d, dn)))
            if rows == 8:
                continue  # the backward runs at the train step's rows
            dy = randn(rows, d, dtype=dtype)
            g0 = randn(rows, d, dtype=dtype)
            # rsig, xhat, w, the row sum of w * xhat, dx, and the dg sums
            flops_bwd = 9 * rows * d
            got, ref = L.rms_grads(x, g, dy, eps), L._plain_rms_grads(x, g, dy, eps)
            err = max(max_err(torch, got[0], ref[0], "ln", dn),
                      max_err(torch, got[1], ref[1], "lnsum", dn))
            xl, gl = (t.clone().requires_grad_() for t in (x, g))
            yl = TF.rms_norm(xl, (d,), gl, eps)
            cases.append(dict(
                name="rms_bwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.rms_grads(x, g, dy, eps)),
                plain_ms=device_ms(torch, lambda: L._plain_rms_grads(x, g, dy, eps)),
                library_ms=device_ms(torch, lambda: torch.autograd.grad(
                    yl, (xl, gl), dy, retain_graph=True)),
                **bound((3 * rows * d + 2 * d) * size, flops_bwd, dn)))
            # against dx_rms + g0 with the same two roundings
            got = L.addrms_grads(x, g, dy, g0, eps)
            ref = L._plain_addrms_grads(x, g, dy, g0, eps)
            err = max(max_err(torch, got[0], ref[0], "addln_dx", dn),
                      max_err(torch, got[1], ref[1], "lnsum", dn))
            cases.append(dict(
                name="addrms_bwd", dtype=dn, shape=[rows, d], max_abs_err=err,
                ms=device_ms(torch, lambda: L.addrms_grads(x, g, dy, g0, eps)),
                plain_ms=device_ms(torch, lambda: L._plain_addrms_grads(
                    x, g, dy, g0, eps)),
                library_ms=None,
                **bound((4 * rows * d + 2 * d) * size, flops_bwd + rows * d, dn)))
    # the tape's entries choose by x's dtype alone: a gain of another dtype
    # reaches the kernels' checks and raises, as the model's path does
    g16 = g.bfloat16()  # x, a, dy and g0 are f32 from the last round
    for name, args in (("rmsnorm", (g16,)), ("add_rmsnorm", (a, g16)),
                       ("rms_grads", (g16, dy)), ("addrms_grads", (g16, dy, g0))):
        try:
            L.for_tape(name)(x, *args, eps)
        except TypeError:
            continue
        check(False, f"tape {name}: an f32 x with a bf16 gain did not raise")
    return cases


def norm_width_sweep(torch, randn) -> dict:
    """Every norm kernel at every width d <= 8192 that is a multiple of 128,
    at a decode step's 8 rows and at 2 * WAVE_MAX_ROWS + 1 rows, past the
    forward plan's crossover, in bf16 and f32, against its plain version
    (correctness only: so the four forwards pass through both of their
    routes at every width; rms_bwd, ln_bwd and addln_bwd take the ring at
    every width, addrms_bwd the block-per-row kernel).  The forwards run
    twice and must give the same bits.  Returns the largest error of each
    kernel."""
    from minidiff_tpu_torch.kernels import layernorm as L

    worst: dict = {}

    def hold(name, got, ref, kind, dn):
        worst[name] = max(worst.get(name, 0.0), max_err(torch, got, ref, kind, dn))

    routes = set()
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for rows in (8, 2 * L.WAVE_MAX_ROWS + 1):
            for d in range(128, L.MAX_WIDTH + 1, 128):
                x, a, dy, g0 = (randn(rows, d, dtype=dtype) for _ in range(4))
                g, b = 1 + 0.1 * randn(d, dtype=dtype), 0.1 * randn(d, dtype=dtype)
                for name, run, ref in (
                        ("ln_fwd", lambda: L.layernorm(x, g, b), L._plain_layernorm(x, g, b)),
                        ("rms_fwd", lambda: L.rmsnorm(x, g), L._plain_rmsnorm(x, g)),
                        ("addln_fwd", lambda: L.add_layernorm(x, a, g, b),
                         L._plain_add_layernorm(x, a, g, b)),
                        ("addrms_fwd", lambda: L.add_rmsnorm(x, a, g),
                         L._plain_add_rmsnorm(x, a, g))):
                    got = run()
                    hold(name, got, ref, "ln", dn)
                    check(torch.equal(got, run()),
                          f"{name} {dn} {[rows, d]}: a second run gave other bits")
                    routes.add((name, L.norm_fwd_plan(rows, d, dtype, "rms" in name).route))
                for name, got, ref in (
                        ("ln_bwd", L.ln_grads(x, g, dy), L._plain_ln_grads(x, g, dy)),
                        ("addln_bwd", L.addln_grads(x, g, dy, g0),
                         L._plain_addln_grads(x, g, dy, g0)),
                        ("rms_bwd", L.rms_grads(x, g, dy), L._plain_rms_grads(x, g, dy)),
                        ("addrms_bwd", L.addrms_grads(x, g, dy, g0),
                         L._plain_addrms_grads(x, g, dy, g0))):
                    hold(name, got[0], ref[0], "addln_dx" if "add" in name else "ln", dn)
                    for i in range(1, len(got)):
                        hold(name, got[i], ref[i], "lnsum", dn)
    check(routes == {(name, route) for name in ("ln_fwd", "addln_fwd")
                     for route in ("wave", "warp", "block")}
          | {(name, route) for name in ("rms_fwd", "addrms_fwd") for route in ("wave", "block")},
          f"norm_width_sweep: routes {sorted(routes)}")
    log(f"[kernel] norms at every d in 128..{L.MAX_WIDTH} step 128, 8 and "
        f"{2 * L.WAVE_MAX_ROWS + 1} rows, bf16 and f32, within tolerance of their "
        "plain versions (the four forwards on both routes, the same bits twice; the "
        "backwards but addrms_bwd on the ring); largest errors " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def norm_route_ab(torch, randn, block_lib) -> list:
    """The LayerNorm forwards at the flagship's widths (d = 1024 at a decode
    step's 8 rows and the train step's 8192), bf16 and f32: device time of
    layernorm.cu's warp-per-row route against the block-per-row route of
    rowblock.cuh (``block_lib``, built with -DNORM_BLOCK_PER_ROW), each
    within tolerance of the plain version.  (The backwards left both for
    the ring: norm_bwd_route_ab times them against their old build.)"""
    from minidiff_tpu_torch.kernels import _build
    from minidiff_tpu_torch.kernels import layernorm as L

    block, warp = lib_at("layernorm", block_lib), _build._lib("layernorm")
    rows_out = []
    d = MODEL["dim"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for rows in (8, TRAIN_BATCH * TRAIN_SEQ):
            x, a = (randn(rows, d, dtype=dtype) for _ in range(2))
            g, b = 1 + 0.1 * randn(d, dtype=dtype), 0.1 * randn(d, dtype=dtype)
            # ln_fwd and addln_fwd on their route before the one-wave kernel
            # (the warp per row, or every row block-per-row in block_lib)
            warp_plan = L.norm_fwd_plan(rows, d, dtype, False, wave=False)
            runs = {
                "ln_fwd": (lambda: (_norm_fwd_run(L, "ln_fwd", x, g, b, a, warp_plan),),
                           (L._plain_layernorm(x, g, b),), ("ln",)),
                "addln_fwd": (lambda: (_norm_fwd_run(L, "addln_fwd", x, g, b, a,
                                                     warp_plan),),
                              (L._plain_add_layernorm(x, a, g, b),), ("ln",))}
            for name, (run, ref, kinds) in runs.items():
                us = {}
                for route, lib in (("warp", warp), ("block", block), ("warp2", warp)):
                    with built_as("layernorm", lib):
                        for got, want, kind in zip(run(), ref, kinds):
                            max_err(torch, got, want, kind, dn)
                        us[route] = device_ms(torch, run) * 1e3
                rows_out.append(dict(name=name, dtype=dn, shape=[rows, d],
                                     warp_us=[us["warp"], us["warp2"]],
                                     block_us=us["block"]))
                log(f"[route] {name:9s} {dn:8s} {str([rows, d]):12s} warp per row "
                    f"{us['warp']:8.2f} / {us['warp2']:8.2f} us | block per row "
                    f"{us['block']:8.2f} us")
    return rows_out


def _norm_fwd_run(L, name, x, g, b, a, plan=None):
    """One of the four forward norms on x (and the residual a) by ``plan``
    (the wrapper's rule when None)."""
    rms = "rms" in name
    operands = ((a,) if name.startswith("add") else ()) + ((g,) if rms else (g, b))
    eps = OPT_MODEL["norm_eps"] if rms else 1e-5
    out_shape = ((2,) if name.startswith("add") else ()) + tuple(x.shape)
    return L._fwd_kernel(name, x, operands, eps, out_shape, plan)


def _norm_fwd_plain(L, name, x, g, b, a):
    eps = OPT_MODEL["norm_eps"] if "rms" in name else 1e-5
    return {"rms_fwd": lambda: L._plain_rmsnorm(x, g, eps),
            "ln_fwd": lambda: L._plain_layernorm(x, g, b, eps),
            "addrms_fwd": lambda: L._plain_add_rmsnorm(x, a, g, eps),
            "addln_fwd": lambda: L._plain_add_layernorm(x, a, g, b, eps)}[name]()


def _norm_fwd_library(TF, name, x, g, b, a):
    """The library yardstick: F.rms_norm / F.layer_norm, after x + a for
    the fused forwards (two calls composed: no single call adds and norms)."""
    d = x.shape[-1]
    if "rms" in name:
        eps = OPT_MODEL["norm_eps"]
        norm = lambda t: TF.rms_norm(t, (d,), g, eps)  # noqa: E731
    else:
        norm = lambda t: TF.layer_norm(t, (d,), g, b, 1e-5)  # noqa: E731
    if name.startswith("add"):
        return lambda: norm(x + a)
    return lambda: norm(x)


def _floor_us(torch, plan) -> float:
    """The empty kernel norm_null at ``plan``'s grid and block: the least
    device time a launch of that shape takes."""
    from minidiff_tpu_torch.kernels import _build

    null = _build.function("norm_null")
    return device_ms(torch, lambda: _build.check(
        null(plan.ctas, plan.threads, _build.stream()), "norm_null")) * 1e3


# the forward norms' shapes of norm_fwd_route_ab: (name, rows, d) at the
# decode steps' 8 rows and the train steps' 8192
NORM_FWD_AB = (("rms_fwd", 8, 1024), ("rms_fwd", 8, 4096), ("rms_fwd", 8192, 4096),
               ("ln_fwd", 8, 1024), ("ln_fwd", 8192, 1024),
               ("addln_fwd", 8, 1024), ("addln_fwd", 8192, 1024),
               ("addrms_fwd", 8, 1024), ("addrms_fwd", 8, 4096),
               ("addrms_fwd", 8192, 4096))


def norm_fwd_route_ab(torch, randn, v1_libs) -> list:
    """The four forward norms at NORM_FWD_AB's shapes, bf16 and f32: the
    route the plan picks against the earlier forward of ``v1_libs``
    ({source: path}: layernorm.cu and rmsnorm.cu built with
    -DNORM_FWD_V1), each within TOL["ln"] of the plain version (t = x + a
    exact), timed in turns (old, new, new, old), with the empty kernel's
    time at each route's grid and block (its launch floor) and the library
    beside (F.rms_norm / F.layer_norm, after x + a for the fused forwards).
    At a decode shape in bf16 the new route must be faster than the old in
    both turns; at 8192 rows the plan's route within 3% of the old.  At
    decode rows a fused forward must give the same bits on a second run,
    and its y must equal the plain forward (rms_fwd / ln_fwd) of its t bit
    for bit."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import layernorm as L

    old = {src: lib_at(src, path) for src, path in v1_libs.items()}
    rows_out = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, rows, d in NORM_FWD_AB:
            x = randn(rows, d, dtype=dtype) * 3 + 1
            a = randn(rows, d, dtype=dtype)
            g, b = 1 + 0.1 * randn(d, dtype=dtype), 0.1 * randn(d, dtype=dtype)
            rms, add = "rms" in name, name.startswith("add")
            src = "rmsnorm" if rms else "layernorm"
            plan = L.norm_fwd_plan(rows, d, dtype, rms)
            run = lambda: _norm_fwd_run(L, name, x, g, b, a)  # noqa: E731
            ref = _norm_fwd_plain(L, name, x, g, b, a)

            def routed(route):
                with built_as(src, old[src]) if route == "old" else contextlib.nullcontext():
                    return run()

            err = {}
            for route in ("old", "new"):
                got = routed(route)
                if add:
                    check(torch.equal(got[0], ref[0]),
                          f"{name} {[rows, d]} {dn} ({route}): t = x + a must be exact")
                err[route] = max_err(torch, got, ref, "ln", dn)
            us = _pair_turns(torch, routed, ("old", "new"))
            old_plan = L.norm_fwd_plan(rows, d, dtype, rms, wave=False)
            row = dict(name=name, dtype=dn, shape=[rows, d], old_us=us["old"],
                       new_us=us["new"], max_abs_err=err, route=plan.route,
                       threads=plan.threads, vecs=plan.vecs,
                       floor_us=_floor_us(torch, plan),
                       old_floor_us=_floor_us(torch, old_plan),
                       library_us=device_ms(torch, _norm_fwd_library(
                           TF, name, x, g, b, a)) * 1e3)
            if rows <= L.WAVE_MAX_ROWS and dtype == torch.bfloat16:
                check(max(us["new"]) < min(us["old"]),
                      f"{name} {[rows, d]} bf16: the new route {us['new']} us is not "
                      f"faster than the old {us['old']} us")
            if rows > L.WAVE_MAX_ROWS:
                check(max(us["new"]) <= 1.03 * min(us["old"]),
                      f"{name} {[rows, d]} {dn}: the plan's route {us['new']} us is "
                      f"more than 3% slower than the old {us['old']} us")
            if add and rows <= L.WAVE_MAX_ROWS:
                pair = run()
                check(torch.equal(pair, run()),
                      f"{name} {[rows, d]} {dn}: a second run gave other bits")
                alone = _norm_fwd_run(L, name[3:], pair[0], g, b, None)
                check(torch.equal(pair[1], alone),
                      f"{name} {[rows, d]} {dn}: y is not {name[3:]} of t bit for bit")
            rows_out.append(row)
            log(f"[norm ab] {name:10s} {dn:8s} {str([rows, d]):12s} old "
                f"{us['old'][0]:7.2f} / {us['old'][1]:7.2f} us | new {us['new'][0]:7.2f} / "
                f"{us['new'][1]:7.2f} us | floor {row['floor_us']:6.2f} (old "
                f"{row['old_floor_us']:6.2f}) us | library {row['library_us']:7.2f} us | "
                f"{plan.route} {plan.threads}x{plan.vecs}")
    return rows_out


NORM_ROWS_AB = (1, 8, 32, 128, 512, 8192)


def norm_rows_ab(torch, randn) -> list:
    """The four forward norms in bf16 at NORM_ROWS_AB's rows of d 1024 and
    4096: the one-wave kernel against the route before it, both forced
    through norm_fwd_plan, in turns (old, wave, wave, old), each within
    TOL["ln"] of the plain version, with each route's launch floor: the
    readings behind kernels.layernorm.WAVE_MAX_ROWS."""
    from minidiff_tpu_torch.kernels import layernorm as L

    dtype, dn = torch.bfloat16, "bfloat16"
    out = []
    for d in (1024, 4096):
        for rows in NORM_ROWS_AB:
            x = randn(rows, d, dtype=dtype) * 3 + 1
            a = randn(rows, d, dtype=dtype)
            g, b = 1 + 0.1 * randn(d, dtype=dtype), 0.1 * randn(d, dtype=dtype)
            for name in ("rms_fwd", "ln_fwd", "addrms_fwd", "addln_fwd"):
                rms = "rms" in name
                plans = {wave: L.norm_fwd_plan(rows, d, dtype, rms, wave=wave)
                         for wave in (False, True)}
                ref = _norm_fwd_plain(L, name, x, g, b, a)
                us = {False: [], True: []}
                for wave in (False, True, True, False):
                    run = lambda: _norm_fwd_run(L, name, x, g, b, a, plans[wave])  # noqa: E731
                    if not us[wave]:
                        max_err(torch, run(), ref, "ln", dn)
                    us[wave].append(device_ms(torch, run) * 1e3)
                row = dict(name=name, shape=[rows, d], old_route=plans[False].route,
                           old_us=us[False], wave_us=us[True],
                           old_floor_us=_floor_us(torch, plans[False]),
                           wave_floor_us=_floor_us(torch, plans[True]),
                           plan=L.norm_fwd_plan(rows, d, dtype, rms).route)
                out.append(row)
                log(f"[norm rows] {name:10s} {str([rows, d]):12s} plan {row['plan']:5s} | "
                    f"{row['old_route']} {us[False][0]:7.2f} / {us[False][1]:7.2f} us "
                    f"(floor {row['old_floor_us']:5.2f}) | wave {us[True][0]:7.2f} / "
                    f"{us[True][1]:7.2f} us (floor {row['wave_floor_us']:5.2f})")
    return out


# xent_bwd_route_ab's row widths, at 8,192 rows: the flagship's and MoE's
# vocabulary, three between, the options model's, and the JAX kernels'
# widest (xent.py's _MAX_V), which the row kernel does not hold
XENT_AB_V = (512, 2048, 8192, 32768, 65536)
XENT_AB_ROWS = 8192
# xent_width_sweep's row widths: every multiple of 8 to 512, and ragged
# and round widths on both sides of the row kernel's limits and past them
XENT_SWEEP_V = (tuple(range(8, 513, 8)) + (10, 1000, 1024, 2040, 4104, 8200, 16376, 32760,
                                           32768, 32776, 50257, 65536))


def _turns(torch, names, run, first, min_ms: float = 0.0):
    """Device us of ``run(name)`` for each name in two turns,
    ``first(name, out)`` called once per name on a run's output before its
    first timing.  The first two names are the pair every caller gates
    (the old build and the plan): _pair_turns reads them first.  The
    others, which are only reported, follow forward and back, each turn one
    reading.  ``min_ms`` > 0 lengthens each reading of a short call from 50
    calls to as many as fill ``min_ms`` of device time (at most 400, which
    keeps a call of two launches inside the launch queue), from a first
    reading of 5 calls of the first name."""
    pair, rest = names[:2], names[2:]
    for n in pair:
        first(n, run(n))
    iters = 50
    if min_ms:
        est = device_ms(torch, lambda: run(names[0]), 5)
        iters = 400 if est * 400 <= min_ms else max(50, math.ceil(min_ms / est))
    us = _pair_turns(torch, run, pair, iters)
    for n in (*rest, *reversed(rest)):
        if n not in us:
            first(n, run(n))
            us[n] = []
        us[n].append(device_ms(torch, lambda: run(n), iters) * 1e3)
    return us


def xent_bwd_route_ab(torch, gen, randn, v1_lib) -> list:
    """xent_bwd at 8,192 rows of XENT_AB_V in bf16 and f32: the plan's
    route, and the row kernel at each of its shapes the plan did not pick
    (its default vectors a thread, and half as many on twice the threads),
    against the warp kernel of ``v1_lib`` (xent.cu built with
    -DXENT_BWD_V1), in turns (old, plan, back, then the others), each within
    TOL["xent_dz"] of the plain version and the new routes the same bits on
    a second run; and xent_fwd against the same build, the same bits and
    within 3% of its time.  The plan's route must be no more than 3% slower
    than the old in either turn at every V: the readings behind
    kernels.xent.ROW_MIN_V."""
    from minidiff_tpu_torch.kernels import xent as X

    old = lib_at("xent", v1_lib)
    rows, out = XENT_AB_ROWS, []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        w = 16 // (torch.finfo(dtype).bits // 8)
        for v in XENT_AB_V:
            z = randn(rows, v, dtype=dtype) * 3
            lab = torch.randint(0, v, (rows,), generator=gen, device=DEVICE)
            g = randn(rows, dtype=torch.float32)
            ref = X._plain_xent_grad(z, lab, g)
            plan = X.xent_bwd_plan(rows, v, dtype)
            plans = {"plan": plan}
            if v % w == 0 and v <= X.ROW_MAX_V:
                tried = [X.xent_bwd_plan(rows, v, dtype, route="row")]
                if tried[0].vecs > 1 and 2 * tried[0].threads <= X.ROW_MAX_THREADS:
                    tried.append(X.xent_bwd_plan(rows, v, dtype, route="row",
                                                 vecs=tried[0].vecs // 2))
                plans.update((f"row {p.threads}x{p.vecs}", p) for p in tried if p != plan)
            err = {}

            def run(name):
                if name == "old":
                    with built_as("xent", old):
                        return X.xent_grad(z, lab, g)
                if name == "plan":
                    return X.xent_grad(z, lab, g)
                return X._bwd_kernel(z, lab, g, plans[name])

            def first(name, got):
                err[name] = max_err(torch, got, ref, "xent_dz", dn, g=g)
                if name != "old":
                    check(_same_bits(torch, got, run(name)),
                          f"xent_bwd {name} {[rows, v]} {dn}: a second run gave other bits")

            us = _turns(torch, ("old", *plans), run, first)
            check(max(us["plan"]) <= 1.03 * min(us["old"]),
                  f"xent_bwd {[rows, v]} {dn}: the plan's {plan.route} route {us['plan']} us "
                  f"is more than 3% slower than the old {us['old']} us")
            del ref
            # the forward is untouched: the same bits and time as the old build
            with built_as("xent", old):
                fwd_old = X.xent_fwd(z, lab)
            check(torch.equal(X.xent_fwd(z, lab), fwd_old),
                  f"xent_fwd {[rows, v]} {dn}: other bits than the -DXENT_BWD_V1 build")
            fwd = _old_new_turns(torch, "xent", old, lambda: X.xent_fwd(z, lab))
            check(min(fwd["new"]) <= 1.03 * min(fwd["old"]),
                  f"xent_fwd {[rows, v]} {dn}: {fwd['new']} us against the old build's "
                  f"{fwd['old']} us")
            rec = dict(dtype=dn, shape=[rows, v], route=plan.route, threads=plan.threads,
                       vecs=plan.vecs, us=us, max_abs_err=err, fwd_us=fwd)
            out.append(rec)
            log(f"[xent ab] {dn:8s} {str([rows, v]):14s} plan {plan.route} "
                f"{plan.threads}x{plan.vecs} | " + " | ".join(
                    f"{n} {t[0]:8.2f} / {t[1]:8.2f}" for n, t in us.items())
                + f" us | xent_fwd new {fwd['new'][0]:.2f} / {fwd['new'][1]:.2f}, old "
                f"{fwd['old'][0]:.2f} / {fwd['old'][1]:.2f} us")
    return out


def _old_new_turns(torch, source, old_lib, run) -> dict:
    """Device us of ``run`` in turns (old, new, new, old), the old turns
    launching ``csrc/<source>.cu``'s kernels from ``old_lib``."""
    def turn(name):
        with built_as(source, old_lib) if name == "old" else contextlib.nullcontext():
            return run()

    return _turns(torch, ("old", "new"), turn, lambda name, out: None)


def xent_width_sweep(torch, gen, randn) -> dict:
    """xent_bwd at every width of XENT_SWEEP_V, 37 rows, bf16 and f32, by
    the plan and, where the row kernel holds the row, forced onto it, with
    labels outside [0, V) (-1 and V) among the rows, against the plain
    version, and the plan's routes the same bits on a second run
    (correctness only, so the row kernel meets every count of vectors a
    thread and of warps).  Returns the largest error of each route."""
    from minidiff_tpu_torch.kernels import xent as X

    worst: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        w = 16 // (torch.finfo(dtype).bits // 8)
        for v in XENT_SWEEP_V:
            z = randn(37, v, dtype=dtype) * 3
            lab = torch.randint(0, v, (37,), generator=gen, device=DEVICE)
            lab[3], lab[4] = -1, v
            g = randn(37, dtype=torch.float32)
            ref = X._plain_xent_grad(z, lab, g)
            plans = [X.xent_bwd_plan(37, v, dtype)]
            if v % w == 0 and v <= X.ROW_MAX_V:
                plans.append(X.xent_bwd_plan(37, v, dtype, route="row"))
            for plan in plans:
                got = X._bwd_kernel(z, lab, g, plan)
                err = max_err(torch, got, ref, "xent_dz", dn, g=g)
                worst[plan.route] = max(worst.get(plan.route, 0.0), err)
                check(_same_bits(torch, got, X._bwd_kernel(z, lab, g, plan)),
                      f"xent_bwd {plan.route} {[37, v]} {dn}: a second run gave other bits")
    log(f"[kernel] xent_bwd at {len(XENT_SWEEP_V)} widths 8..65,536, 37 rows, bf16 and "
        "f32, labels outside [0, V) included, within tolerance of the plain version on "
        "every route (the same bits twice); largest errors " + ", ".join(
            f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return worst


# xent_fwd_route_ab's shapes (rows, V): 8,192 rows at XENT_AB_V's widths,
# between them and below them, and the MoE train step's (4096, 512)
XENT_FWD_AB = (tuple((XENT_AB_ROWS, v) for v in (128, 256, 512, 1024, 2048, 4096, 8192,
                                                  32768, 65536))
               + ((MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, MOE_TRAIN["vocab_size"]),))


def xent_fwd_route_ab(torch, gen, randn, v1_lib) -> list:
    """xent_fwd at XENT_FWD_AB in bf16 and f32: the plan's route and, where
    the row kernel holds the row, the route it did not pick and the row
    kernel at every other count of vectors a thread, against the
    warp kernel of ``v1_lib`` (xent.cu built with -DXENT_FWD_V1), in turns
    (old, plan, back, then the others), each within TOL["xent_loss"] of the plain
    version with labels outside [0, V) (-1 and V) among the rows, and the
    new routes the same bits on a second run.  Where the plan's route is
    the row kernel it must be no more than 3% slower than the old in either
    turn: the readings behind kernels.xent.FWD_ROW_MIN_V, FWD_VECS and
    FWD_THREADS.  Where it is the warp kernel, both arms launch the same
    kernel from the same source, so a speed gate would read only the card's
    drift: there the plan's output must be the old build's, bit for bit,
    and both times are kept.  Each reading covers at least GATE_READ_MS of
    device time."""
    from minidiff_tpu_torch.kernels import xent as X

    old = lib_at("xent", v1_lib)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        w = 16 // (torch.finfo(dtype).bits // 8)
        for rows, v in XENT_FWD_AB:
            z = randn(rows, v, dtype=dtype) * 3
            lab = torch.randint(0, v, (rows,), generator=gen, device=DEVICE)
            lab[3], lab[4] = -1, v
            ref = X._plain_xent(z, lab)
            plan = X.xent_fwd_plan(rows, v, dtype)
            plans = {"plan": plan}
            if v % w == 0 and v <= X.ROW_MAX_V:
                other = X.xent_fwd_plan(rows, v, dtype,
                                        route="warp" if plan.route == "row" else "row")
                plans[other.route] = other
                # the row kernel at every other count of vectors a thread
                row = plan if plan.route == "row" else other
                for n in (1, 2, 4, 8):
                    if n != row.vecs and 32 * n <= -(-v // w) <= X.ROW_MAX_THREADS * n:
                        alt = X.xent_fwd_plan(rows, v, dtype, route="row", vecs=n)
                        plans[f"row {alt.threads}x{alt.vecs}"] = alt
            err = {}

            def run(name):
                if name == "old":
                    with built_as("xent", old):
                        return X.xent_fwd(z, lab)
                return X._fwd_kernel(z, lab, plans[name])

            def first(name, got):
                err[name] = max_err(torch, got, ref, "xent_loss", dn)
                if name != "old":
                    check(torch.equal(got.view(torch.int32), run(name).view(torch.int32)),
                          f"xent_fwd {name} {[rows, v]} {dn}: a second run gave other bits")

            us = _turns(torch, ("old", *plans), run, first, min_ms=GATE_READ_MS)
            if plan.route == "warp":
                check(torch.equal(run("plan").view(torch.int32), run("old").view(torch.int32)),
                      f"xent_fwd {[rows, v]} {dn}: the plan's warp route gave other bits "
                      "than the old build's warp kernel")
            else:
                check(max(us["plan"]) <= 1.03 * min(us["old"]),
                      f"xent_fwd {[rows, v]} {dn}: the plan's {plan.route} route "
                      f"{us['plan']} us is more than 3% slower than the old {us['old']} us")
            out.append(dict(dtype=dn, shape=[rows, v], route=plan.route, threads=plan.threads,
                            vecs=plan.vecs, us=us, max_abs_err=err))
            log(f"[xent_fwd ab] {dn:8s} {str([rows, v]):14s} plan {plan.route} "
                f"{plan.threads}x{plan.vecs} | " + " | ".join(
                    f"{n} {t[0]:8.2f} / {t[1]:8.2f}" for n, t in us.items()) + " us")
            del z, ref
    return out


# norm_bwd_route_ab's shapes (rows, d): rms_bwd at the SSM and the options
# train steps' and a tenth of the latter's rows; ln_bwd and addln_bwd at the
# flagship's and the MoE train step's and at the options model's width;
# the ring choices it times beside the plan's: (CTAs per SM, stages), each
# cut to what shared memory holds; and the shapes where the plan's ring
# must beat the old build in both turns (bf16; no more than 3% slower
# anywhere)
NORM_BWD_AB = ((8192, 1024), (8192, 4096), (1024, 4096))
LN_BWD_AB = ((8192, 1024), (4096, 512), (8192, 4096))
RING_AB = tuple((per_sm, stages) for per_sm in (1, 2, 4, 8) for stages in (2, 4, 8))
RING_FASTER = {"rms_bwd": ((8192, 1024), (8192, 4096)),
               "ln_bwd": ((8192, 1024), (4096, 512)),
               "addln_bwd": ((8192, 1024), (4096, 512))}


def _ring_ab(torch, name, old, x, g, dy, g0, eps) -> dict:
    """``name`` (rms_bwd, ln_bwd or addln_bwd) at x's shape: the plan's ring
    and every other ring of RING_AB against ``old`` (its source built with
    -DNORM_BWD_V1), in turns (old, plan, back, then the others), dx within
    TOL["ln"] (TOL["addln_dx"] for addln_bwd) and dg (and db) within
    TOL["lnsum"] of the plain version, the rings the same bits on a second
    run.  The plan must be faster than the old in both turns at
    RING_FASTER's bf16 shapes and no more than 3% slower anywhere."""
    from minidiff_tpu_torch.kernels import _build
    from minidiff_tpu_torch.kernels import layernorm as L

    rms, add = name == "rms_bwd", g0 is not None
    dn = str(x.dtype).split(".")[1]
    rows, d = x.shape
    grads, plain, kinds = {
        "rms_bwd": (L.rms_grads, L._plain_rms_grads, ("ln", "lnsum")),
        "ln_bwd": (L.ln_grads, L._plain_ln_grads, ("ln", "lnsum", "lnsum")),
        "addln_bwd": (L.addln_grads, L._plain_addln_grads,
                      ("addln_dx", "lnsum", "lnsum"))}[name]
    args = (x, g, dy) if g0 is None else (x, g, dy, g0)
    ref = plain(*args, eps)
    plan = L.norm_bwd_plan(rows, d, x.dtype, rms, add)
    plans = {"plan": plan}
    for per_sm, stages in RING_AB:
        p = L.norm_bwd_plan(rows, d, x.dtype, rms, add, stages=stages, per_sm=per_sm)
        key = f"ring {-(-p.ctas // _build.SMS)}x{p.stages}"
        if p not in plans.values() and key not in plans:
            plans[key] = p
    err = {}

    def run(n):
        if n == "old":
            with built_as("rmsnorm" if rms else "layernorm", old):
                return grads(*args, eps)
        if n == "plan":
            return grads(*args, eps)
        return L._bwd_kernel(name, x, g, dy, g0, eps, plans[n])

    def first(n, got):
        err[n] = max(max_err(torch, a, b, k, dn) for a, b, k in zip(got, ref, kinds))
        if n != "old":
            again = run(n)
            check(all(_same_bits(torch, a, b) for a, b in zip(got, again)),
                  f"{name} {n} {[rows, d]} {dn}: a second run gave other bits")

    us = _turns(torch, ("old", *plans), run, first)
    check(max(us["plan"]) <= 1.03 * min(us["old"]),
          f"{name} {[rows, d]} {dn}: the plan's ring {us['plan']} us is more than 3% "
          f"slower than the old {us['old']} us")
    if (rows, d) in RING_FASTER[name] and x.dtype == torch.bfloat16:
        check(max(us["plan"]) < min(us["old"]),
              f"{name} {[rows, d]} bf16: the plan's ring {us['plan']} us is not faster "
              f"than the old {us['old']} us")
    rec = dict(name=name, dtype=dn, shape=[rows, d], ctas=plan.ctas, threads=plan.threads,
               vecs=plan.vecs, stages=plan.stages, us=us, max_abs_err=err,
               rings={k: [p.ctas, p.stages] for k, p in plans.items()})
    log(f"[norm bwd ab] {name:9s} {dn:8s} {str([rows, d]):12s} plan {plan.ctas} CTAs x "
        f"{plan.threads} x{plan.vecs}, {plan.stages} stages | " + " | ".join(
            f"{n} {t[0]:7.2f} / {t[1]:7.2f}" for n, t in us.items()) + " us")
    return rec


def norm_bwd_route_ab(torch, randn, v1_libs) -> list:
    """rms_bwd at NORM_BWD_AB's shapes, then ln_bwd and addln_bwd at
    LN_BWD_AB's, in bf16 and f32, each by _ring_ab against the
    -DNORM_BWD_V1 build of its source (``v1_libs``: rmsnorm.cu's and
    layernorm.cu's).  addrms_bwd (which keeps the block-per-row kernel) at
    the options train step's shape against the same build of rmsnorm.cu:
    the same bits, and within 3% of its time.  The readings behind
    kernels.layernorm's RING_CTAS_BY_STAGE_BYTES and RING_BYTES."""
    from minidiff_tpu_torch.kernels import layernorm as L

    old = {src: lib_at(src, path) for src, path in v1_libs.items()}
    eps = OPT_MODEL["norm_eps"]
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for rows, d in NORM_BWD_AB:
            x = randn(rows, d, dtype=dtype) * 3 + 1
            g = 1 + 0.1 * randn(d, dtype=dtype)
            dy = randn(rows, d, dtype=dtype)
            rec = _ring_ab(torch, "rms_bwd", old["rmsnorm"], x, g, dy, None, eps)
            if rows == OPT_TRAIN_BATCH * OPT_TRAIN_SEQ and d == OPT_MODEL["dim"]:
                # addrms_bwd keeps its kernel: the same bits and time
                g0 = randn(rows, d, dtype=dtype)
                new = L.addrms_grads(x, g, dy, g0, eps)
                with built_as("rmsnorm", old["rmsnorm"]):
                    was = L.addrms_grads(x, g, dy, g0, eps)
                check(all(_same_bits(torch, a, b) for a, b in zip(new, was)),
                      f"addrms_bwd {[rows, d]} {dn}: other bits than the -DNORM_BWD_V1 build")
                rec["addrms_us"] = _old_new_turns(
                    torch, "rmsnorm", old["rmsnorm"], lambda: L.addrms_grads(x, g, dy, g0, eps))
                check(min(rec["addrms_us"]["new"]) <= 1.03 * min(rec["addrms_us"]["old"]),
                      f"addrms_bwd {[rows, d]} {dn}: {rec['addrms_us']} us, more than 3% "
                      "slower than the -DNORM_BWD_V1 build")
                log("[norm bwd ab] addrms_bwd {0} {1}: new {2[0]:.2f} / {2[1]:.2f}, old "
                    "{3[0]:.2f} / {3[1]:.2f} us".format(
                        dn, [rows, d], rec["addrms_us"]["new"], rec["addrms_us"]["old"]))
            out.append(rec)
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in LN_BWD_AB:
            x = randn(rows, d, dtype=dtype) * 3 + 1
            g = 1 + 0.1 * randn(d, dtype=dtype)
            dy, g0 = (randn(rows, d, dtype=dtype) for _ in range(2))
            for name in ("ln_bwd", "addln_bwd"):
                out.append(_ring_ab(torch, name, old["layernorm"], x, g, dy,
                                    g0 if name == "addln_bwd" else None, 1e-5))
    return out


def flash_shapes(torch) -> list:
    """flash_cases' cases as (kind, (dtype, bh, s, causal, window, groups,
    head dim)), kind "fwd" or "bwd": the serving prefill's shapes (64 x 16
    tokens, 8 x 128 and 8 x 384: full, causal and a window of 100), the
    train step's (64, 1024, 128), the options train step's (256, 1024,
    128), whose K and V come from ``expand_kv``, head dim 256 (16, 1024,
    256) and a ragged (4, 200, 256) with a window of 64; and lengths whose
    last 128-row CTA has an empty second warpgroup while its ring of key
    tiles wraps (64 x 576 full, causal and a window of 300, which also
    makes the second warpgroup skip a tile the first takes; 16 x 1088),
    forward and backward (where the same holds of the dK/dV CTA's 128
    keys and its ring of query tiles), and in the backward a ragged S of 130
    (an empty second warpgroup in the last tile of both kernels) and of 65
    at head dim 256."""
    bh_train = TRAIN_BATCH * TRAIN_MODEL["num_heads"]
    bh_opt = OPT_TRAIN_BATCH * OPT_MODEL["num_heads"]
    groups = OPT_MODEL["num_heads"] // OPT_MODEL["num_kv_heads"]
    # (dtype, bh, s, causal, window), head dim 128
    fwd = [(torch.bfloat16, 64, 16, True, None), (torch.bfloat16, 8, 128, True, None),
           (torch.bfloat16, 8, 128, False, None), (torch.bfloat16, 8, 128, True, 100),
           (torch.bfloat16, 8, 384, True, None), (torch.bfloat16, 8, 384, False, None),
           (torch.bfloat16, 8, 384, True, 100),
           (torch.bfloat16, bh_train, TRAIN_SEQ, True, None),
           (torch.bfloat16, 64, 576, True, None), (torch.bfloat16, 64, 576, False, None),
           (torch.bfloat16, 64, 576, True, 300), (torch.bfloat16, 16, 1088, True, None),
           (torch.float32, 64, 16, True, None), (torch.float32, 8, 384, True, None),
           (torch.float32, 8, 384, True, 100)]
    bwd = [(torch.bfloat16, bh_train, TRAIN_SEQ, True, None),
           (torch.bfloat16, 8, 384, True, None), (torch.bfloat16, 8, 384, False, None),
           (torch.bfloat16, 8, 384, True, 100), (torch.float32, 8, 256, True, None),
           (torch.bfloat16, 64, 576, True, None), (torch.bfloat16, 64, 576, False, None),
           (torch.bfloat16, 64, 576, True, 300), (torch.bfloat16, 16, 1088, True, None),
           (torch.bfloat16, 16, 130, True, None)]
    gqa = [(torch.bfloat16, bh_opt, OPT_TRAIN_SEQ, True, None, groups, 128)]
    hd256 = [(torch.bfloat16, HD256_BH, HD256_SEQ, True, None, 1, 256),
             (torch.float32, HD256_BH, HD256_SEQ, True, None, 1, 256),
             (torch.bfloat16, 4, 200, True, 64, 1, 256)]
    return ([("fwd", c + (1, 128)) for c in fwd] + [("fwd", c) for c in gqa + hd256]
            + [("bwd", c + (1, 128)) for c in bwd] + [("bwd", c) for c in gqa + hd256]
            + [("bwd", (torch.bfloat16, 8, 65, False, None, 1, 256))])


def flash_cases(torch, randn):
    """flash_fwd at ``flash_shapes``' forward shapes, flash_bwd_dkv /
    flash_bwd_dq at its backward shapes on the forward's o and lse, each
    against its plain version; bf16 and f32.  Every bf16 backward runs twice
    and must give the same bits (one owner per output tile, no atomics)."""
    import types

    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import attention as A
    from minidiff_tpu_torch.models.transformer import MultiHeadAttention

    cases = []
    todo = flash_shapes(torch)
    for kind, (dtype, bh, s, causal, window, g, hd) in todo:
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        scale = hd ** -0.5
        q, k, v = (randn(bh, s, hd, dtype=dtype) for _ in range(3))
        if g > 1:
            attn = types.SimpleNamespace(num_heads=bh, num_kv_heads=bh // g)
            k, v = (MultiHeadAttention.expand_kv(attn, t[None, ::g])[0]
                    for t in (k, v))
        q4, k4, v4 = (t.reshape(1, bh, s, hd) for t in (q, k, v))
        # visible (query, key) pairs: the work this run's mask leaves
        pairs = (int(A._keep_mask(s, s, window, "cpu").sum()) if causal
                 else s * s)
        shape = dict(dtype=dn, shape=[bh, s, hd], causal=causal, window=window,
                     groups=g, rows=A.flash_plan(bh, s, hd, dtype))
        o, lse = A.flash_fwd(q, k, v, scale, causal, window)
        if kind == "fwd":
            op, lp = A._plain_flash_fwd(q, k, v, scale, causal, window)
            err = max(max_err(torch, o, op, "attn", dn),
                      max_err(torch, lse, lp, "lse", dn))
            # SDPA, a windowed case with the equivalent dense boolean mask
            band = None if window is None else A._keep_mask(s, s, window, DEVICE)
            library = device_ms(torch, lambda: TF.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal and band is None, attn_mask=band))
            cases.append(dict(
                name="flash_fwd", max_abs_err=err, **shape,
                ms=device_ms(torch, lambda: A.flash_fwd(q, k, v, scale, causal,
                                                        window)),
                plain_ms=device_ms(torch, lambda: A._plain_flash_fwd(
                    q, k, v, scale, causal, window)),
                library_ms=library,
                **bound((4 * bh * s * hd) * size + bh * s * 4,
                        4 * bh * pairs * hd, dn)))
            continue
        do = randn(bh, s, hd, dtype=dtype)
        ops, dims, flags = A._bwd_operands(q, k, v, o, lse, do, window, causal)
        dk, dv = A.flash_bwd_dkv(ops, dims, scale, flags)
        dq = A.flash_bwd_dq(ops, dims, scale, flags)
        if dtype == torch.bfloat16:
            again = (*A.flash_bwd_dkv(ops, dims, scale, flags),
                     A.flash_bwd_dq(ops, dims, scale, flags))
            check(all(torch.equal(a, b) for a, b in zip((dk, dv, dq), again)),
                  f"flash backward {shape}: two runs differ")
        shape["plan"] = list(A.flash_bwd_plan(bh, s, s, hd, dtype))
        pq, pk, pv = A._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
        plain_ms = device_ms(torch, lambda: A._plain_flash_bwd(
            q, k, v, o, lse, do, scale, causal, window), iters=10)
        # autograd of SDPA, the backward only: dq, dk and dv in one call (a
        # windowed case with the equivalent dense boolean mask)
        band = None if window is None else A._keep_mask(s, s, window, DEVICE)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q4, k4, v4))
        ol = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal and band is None,
                                             attn_mask=band)
        do4 = do.reshape(1, bh, s, hd)
        library = device_ms(torch, lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do4, retain_graph=True), iters=10)
        io = bh * s * hd * size
        stats = 2 * bh * s * 4  # lse and delta, f32
        cases.append(dict(
            name="flash_bwd_dkv", **shape,
            max_abs_err=max(max_err(torch, dk, pk, "attn_bwd", dn),
                            max_err(torch, dv, pv, "attn_bwd", dn)),
            ms=device_ms(torch, lambda: A.flash_bwd_dkv(ops, dims, scale, flags)),
            plain_ms=plain_ms, library_ms=library,
            # S^T, dP^T, P^T dO, dS^T Q over the visible pairs
            **bound(6 * io + stats, 8 * bh * pairs * hd, dn)))
        cases.append(dict(
            name="flash_bwd_dq", **shape,
            max_abs_err=max_err(torch, dq, pq, "attn_bwd", dn),
            ms=device_ms(torch, lambda: A.flash_bwd_dq(ops, dims, scale, flags)),
            plain_ms=plain_ms, library_ms=library,
            # S, dP, dS K
            **bound(5 * io + stats, 6 * bh * pairs * hd, dn)))
    return cases


# flash_mask_cases' cases: (dtype, batch rows, heads, S, window, sinks, key
# row, ids), head dim 128: Mistral-7B-v0.1's window of 4,096 with 4 sinks
# at the window phase's train shape (2 rows x 32 heads of 8,192), packed ids
# at one row of 8,192, a key row at the tape gate's (4 x 32 heads of
# 2,048, non-causal), and an f32 case of each at a small size
FLASH_MASK_CASES = (("bfloat16", 2, 32, 8192, 4096, 4, False, False),
                    ("bfloat16", 1, 32, 8192, None, 0, False, True),
                    ("bfloat16", 4, 32, 2048, None, 0, True, False),
                    ("float32", 2, 4, 512, 200, 4, False, False),
                    ("float32", 2, 4, 512, None, 0, False, True),
                    ("float32", 2, 4, 512, None, 0, True, False))
# heads per call of the chunked plain versions (their (S, S) scores)
PLAIN_HEADS = 4


def _packed_ids(rng, s: int, lo: int, hi: int):
    """(1, S) segment ids and positions of documents with lengths drawn in
    [lo, hi] from ``rng``, packed into one row (the last cut by S)."""
    ids, pos, d = [], [], 0
    while len(ids) < s:
        n = int(rng.randint(lo, hi + 1))
        ids += [d] * n
        pos += list(range(n))
        d += 1
    return ids[:s], pos[:s]


def _chunked(torch, fn, h, outs, *ops, kvm=None, seg=None):
    """``fn`` (a plain flash version) over (BH, S, D) operands, PLAIN_HEADS
    heads of one batch row at a time (its (S, S) scores fit), concatenated
    into ``outs`` outputs."""
    bh = ops[0].shape[0]
    parts = []
    for r0 in range(0, bh, PLAIN_HEADS):
        r1, b = min(r0 + PLAIN_HEADS, (r0 // h + 1) * h), r0 // h
        sl = [t[r0:r1] for t in ops]
        parts.append(fn(*sl, kvm=None if kvm is None else kvm[b:b + 1],
                        seg=None if seg is None else seg[b:b + 1], h=r1 - r0))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(outs))


def flash_mask_cases(torch) -> list:
    """flash_fwd, flash_bwd_dkv and flash_bwd_dq under each mask of
    FLASH_MASK_CASES against their plain versions (run PLAIN_HEADS heads at
    a time), every bf16 backward twice with the same bits; times, the bound
    over this run's visible pairs, and as the library call SDPA (the
    memory-efficient backend) with the equivalent dense boolean mask,
    forward, and the backward of its autograd."""
    import numpy as np
    import torch.nn.functional as TF
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from minidiff_tpu_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1237)
    rng = np.random.RandomState(1237)
    cases = []
    for dn, b, h, s, window, sinks, key_row, ids in FLASH_MASK_CASES:
        dtype, hd = getattr(torch, dn), 128
        bh, scale, size = b * h, hd ** -0.5, torch.finfo(getattr(torch, dn)).bits // 8
        causal = not key_row
        q, k, v, do = (torch.randn((bh, s, hd), generator=gen, device=DEVICE).to(dtype)
                       for _ in range(4))
        kvm = seg = None
        keep = (A._keep_mask(s, s, window, DEVICE, sinks) if causal
                else torch.ones(s, s, dtype=torch.bool, device=DEVICE))[None].expand(b, s, s)
        if key_row:
            lens = rng.randint(s // 8, s + 1, size=b)
            kvm = torch.from_numpy((np.arange(s)[None] < lens[:, None]).astype(np.int32)
                                   ).to(DEVICE)
            keep = keep & (kvm[:, None, :] != 0)
        if ids:
            seg = torch.tensor([_packed_ids(rng, s, 64, 6144 if s > 1024 else 200)[0]
                                for _ in range(b)], dtype=torch.int32, device=DEVICE)
            keep = keep & (seg[:, :, None] == seg[:, None, :])
        pairs = int(keep.sum()) * h  # visible (query, key) pairs of every head
        masks = ("window %d sinks %d" % (window, sinks) if window else "") + (
            "key row" if key_row else "") + ("ids" if ids else "")
        shape = dict(dtype=dn, shape=[bh, s, hd], causal=causal, window=window, sinks=sinks,
                     masks=masks, rows=A.flash_plan(bh, s, hd, dtype))
        mk = dict(kvm=kvm, seg=seg, h=h)
        q4, k4, v4, do4 = (t.reshape(b, h, s, hd) for t in (q, k, v, do))
        dense = keep[:, None]  # (B, 1, S, S), True = attend

        def lib_fwd():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense,
                                                       scale=scale)

        o, lse = A.flash_fwd(q, k, v, scale, causal, window, sinks, **mk)
        op, lp = _chunked(torch, lambda *t, **m: A._plain_flash_fwd(
            *t, scale, causal, window, sinks, **m), h, 2, q, k, v, kvm=kvm, seg=seg)
        err = max(max_err(torch, o, op, "attn", dn), max_err(torch, lse, lp, "lse", dn))
        io = bh * s * hd * size
        mask_bytes = 4 * (0 if kvm is None else kvm.numel()) + 4 * (
            0 if seg is None else seg.numel())
        cases.append(dict(
            name="flash_fwd", max_abs_err=err, **shape,
            ms=device_ms(torch, lambda: A.flash_fwd(q, k, v, scale, causal, window, sinks,
                                                    **mk), iters=10),
            plain_ms=device_ms(torch, lambda: _chunked(torch, lambda *t, **m: (
                A._plain_flash_fwd(*t, scale, causal, window, sinks, **m)), h, 2, q, k, v,
                kvm=kvm, seg=seg), iters=2),
            library_ms=device_ms(torch, lib_fwd, iters=10),
            **bound(4 * io + bh * s * 4 + mask_bytes, 4 * pairs * hd, dn)))
        del op, lp
        ops, dims, flags = A._bwd_operands(q, k, v, o, lse, do, window, causal, sinks, **mk)
        dk, dv = A.flash_bwd_dkv(ops, dims, scale, flags)
        dq = A.flash_bwd_dq(ops, dims, scale, flags)
        if dtype == torch.bfloat16:
            again = (*A.flash_bwd_dkv(ops, dims, scale, flags),
                     A.flash_bwd_dq(ops, dims, scale, flags))
            check(all(torch.equal(a, b_) for a, b_ in zip((dk, dv, dq), again)),
                  f"flash backward {shape}: two runs differ")
            del again
        shape["plan"] = list(A.flash_bwd_plan(bh, s, s, hd, dtype))

        def plain_bwd():
            return _chunked(torch, lambda *t, **m: A._plain_flash_bwd(
                *t, scale, causal, window, sinks, **m), h, 3, q, k, v, o, lse, do, kvm=kvm, seg=seg)

        pq, pk, pv = plain_bwd()
        plain_ms = device_ms(torch, plain_bwd, iters=2)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q4, k4, v4))
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ol = TF.scaled_dot_product_attention(ql, kl, vl, attn_mask=dense, scale=scale)
        library = device_ms(torch, lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do4, retain_graph=True), iters=5)
        del ol, ql, kl, vl
        stats = 2 * bh * s * 4  # lse and delta, f32
        cases.append(dict(
            name="flash_bwd_dkv", **shape,
            max_abs_err=max(max_err(torch, dk, pk, "attn_bwd", dn),
                            max_err(torch, dv, pv, "attn_bwd", dn)),
            ms=device_ms(torch, lambda: A.flash_bwd_dkv(ops, dims, scale, flags), iters=10),
            plain_ms=plain_ms, library_ms=library,
            **bound(6 * io + stats + mask_bytes, 8 * pairs * hd, dn)))
        cases.append(dict(
            name="flash_bwd_dq", **shape,
            max_abs_err=max_err(torch, dq, pq, "attn_bwd", dn),
            ms=device_ms(torch, lambda: A.flash_bwd_dq(ops, dims, scale, flags), iters=10),
            plain_ms=plain_ms, library_ms=library,
            **bound(5 * io + stats + mask_bytes, 6 * pairs * hd, dn)))
        del q, k, v, do, o, lse, ops, dk, dv, dq, pq, pk, pv, keep, dense
        torch.cuda.empty_cache()
    return cases


def flash_route_cases(torch, randn) -> list:
    """The flash rule on the card: ``sdpa`` at head dims 32, 64, 128 and 256
    (bf16, causal, 2 x 4 heads of 200 tokens) launches the flash kernels
    exactly where ``flash_eligible`` (the JAX ``_flash_eligible``) says,
    and composes elsewhere; each result, forward and backward, against the
    plain version of its route (the plain flash forward and backward, or
    the composed path under autograd)."""
    from minidiff_tpu_torch import kernels as K
    from minidiff_tpu_torch.kernels import attention as A

    out = []
    for hd in (32, 64, 128, 256):
        q, k, v, do = (randn(2, 4, 200, hd, dtype=torch.bfloat16) for _ in range(4))
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        K.reset_launch_counts()
        o = A.sdpa(ql, kl, vl, causal=True)
        grads = torch.autograd.grad(o, (ql, kl, vl), do)
        torch.cuda.synchronize()
        counts = {n: c for n, c in K.launch_counts().items() if c}
        flash = hd in A.HEAD_DIMS
        want = ({"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
                if flash else {})
        check(counts == want, f"flash rule at head dim {hd}: launches {counts}, "
              f"expected {want}")
        check(A.flash_eligible(q, k, v) == flash, f"flash_eligible at head dim {hd}")
        if flash:
            q3, k3, v3, do3 = (t.reshape(8, 200, hd) for t in (q, k, v, do))
            oc, lse = A._plain_flash_fwd(q3, k3, v3, hd ** -0.5, True)
            ref = A._plain_flash_bwd(q3, k3, v3, oc, lse, do3, hd ** -0.5, True)
        else:
            qc, kc, vc = (t.clone().requires_grad_() for t in (q, k, v))
            oc = A._plain_flash_fwd(qc, kc, vc, hd ** -0.5, True)[0]
            ref = torch.autograd.grad(oc, (qc, kc, vc), do)
        err = max_err(torch, o, oc.reshape(o.shape), "attn", "bfloat16")
        err = max([err] + [max_err(torch, a, b.reshape(a.shape), "attn_bwd", "bfloat16")
                           for a, b in zip(grads, ref)])
        out.append(dict(head_dim=hd, route="flash" if flash else "composed",
                        launches=counts, max_abs_err=err))
        log(f"[kernel] flash rule head dim {hd:3d}: {out[-1]['route']:8s} "
            f"launches {counts} | err vs its plain route {err:.3g}")
    return out


def flash_route_ab(torch, randn, wmma_lib) -> list:
    """The bf16 flash forward at every bf16 forward shape of flash_shapes: the
    ``wgmma`` tile at 64 and 128 query rows per CTA against the WMMA tile of
    ``wmma_lib`` (flash_fwd.cu built with -DFLASH_WMMA_BF16), each within
    TOL["attn"] / TOL["lse"] of the plain version, timed in turns (WMMA, 64,
    128, then back): the readings behind flash_plan's rule.  The 128-row
    tile is built at head dim 128 only."""
    import types

    from minidiff_tpu_torch.kernels import attention as A
    from minidiff_tpu_torch.models.transformer import MultiHeadAttention

    wmma = lib_at("flash_fwd", wmma_lib)
    rows_out = []
    for kind, (dtype, bh, s, causal, window, g, hd) in flash_shapes(torch):
        if kind != "fwd" or dtype != torch.bfloat16:
            continue
        q, k, v = (randn(bh, s, hd, dtype=dtype) for _ in range(3))
        if g > 1:
            attn = types.SimpleNamespace(num_heads=bh, num_kv_heads=bh // g)
            k, v = (MultiHeadAttention.expand_kv(attn, t[None, ::g])[0] for t in (k, v))
        scale = hd ** -0.5
        op, lp = A._plain_flash_fwd(q, k, v, scale, causal, window)
        routes = {"wmma": (wmma, None), "wgmma64": (None, 64)}
        if hd == 128:
            routes["wgmma128"] = (None, 128)
        us, err = {r: [] for r in routes}, {}
        for order in (list(routes), list(routes)[::-1]):
            for r in order:
                lib, rows = routes[r]

                def run():
                    if rows is None:  # the WMMA build takes no tile plan
                        return A.flash_fwd(q, k, v, scale, causal, window)
                    return A._fwd_launch(q, k, v, scale, causal, window, rows)

                with contextlib.ExitStack() as stack:
                    if lib is not None:
                        stack.enter_context(built_as("flash_fwd", lib))
                    if r not in err:
                        o, lse = run()
                        err[r] = max(max_err(torch, o, op, "attn", "bfloat16"),
                                     max_err(torch, lse, lp, "lse", "bfloat16"))
                    us[r].append(device_ms(torch, run, iters=20) * 1e3)
        row = dict(shape=[bh, s, hd], causal=causal, window=window, groups=g,
                   plan_rows=A.flash_plan(bh, s, hd, dtype), us=us, max_abs_err=err)
        rows_out.append(row)
        log(f"[flash ab] {str([bh, s, hd]):16s}{' causal' if causal else '':7s}"
            f"{' w' + str(window) if window else '':5s} plan {row['plan_rows']:3d} | " + " | ".join(
                f"{r} {v[0]:8.2f} / {v[1]:8.2f}" for r, v in us.items()) + " us")
    return rows_out


def flash_bwd_route_ab(torch, randn, wmma_lib) -> list:
    """The bf16 flash backward at every bf16 backward shape of flash_shapes:
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` on their ``wgmma`` tiles (at head
    dim 128 with one and with two warpgroups per CTA, at 256 the one tile
    of each) against the WMMA tile of ``wmma_lib`` (flash_bwd.cu built with
    -DFLASH_BWD_WMMA_BF16), each within TOL["attn_bwd"] of the plain
    version, timed in turns (WMMA, each tile, then back), with SDPA's
    backward (dq, dk and dv in one autograd call) beside them where it takes
    the mask: the readings behind flash_bwd_plan's rule."""
    import types

    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import attention as A
    from minidiff_tpu_torch.models.transformer import MultiHeadAttention

    wmma = lib_at("flash_bwd", wmma_lib)
    rows_out = []
    for kind, (dtype, bh, s, causal, window, g, hd) in flash_shapes(torch):
        if kind != "bwd" or dtype != torch.bfloat16:
            continue
        q, k, v, do = (randn(bh, s, hd, dtype=dtype) for _ in range(4))
        if g > 1:
            attn = types.SimpleNamespace(num_heads=bh, num_kv_heads=bh // g)
            k, v = (MultiHeadAttention.expand_kv(attn, t[None, ::g])[0] for t in (k, v))
        scale = hd ** -0.5
        o, lse = A.flash_fwd(q, k, v, scale, causal, window)
        ops, dims, flags = A._bwd_operands(q, k, v, o, lse, do, window, causal)
        ref = A._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
        # (library, dK/dV warpgroups, dQ warpgroups); the WMMA build takes
        # no tile plan
        routes = {"wmma": (wmma, None, None)}
        if hd == 128:
            routes.update(wgmma1=(None, 1, 1), wgmma2=(None, 2, 2))
        else:
            routes["wgmma"] = (None, 2, 1)
        us = {r: {"dkv": [], "dq": []} for r in routes}
        err = {}
        for order in (list(routes), list(routes)[::-1]):
            for r in order:
                lib, wd, wq = routes[r]

                def dkv():
                    return A.flash_bwd_dkv(ops, dims, scale, flags, wd)

                def dqf():
                    return A.flash_bwd_dq(ops, dims, scale, flags, wq)

                with contextlib.ExitStack() as stack:
                    if lib is not None:
                        stack.enter_context(built_as("flash_bwd", lib))
                    if r not in err:
                        got = (dqf(), *dkv())
                        err[r] = max(max_err(torch, a, b, "attn_bwd", "bfloat16")
                                     for a, b in zip(got, ref))
                    us[r]["dkv"].append(device_ms(torch, dkv, iters=20) * 1e3)
                    us[r]["dq"].append(device_ms(torch, dqf, iters=20) * 1e3)
        library = None
        if window is None:
            q4, k4, v4 = (t.reshape(1, bh, s, hd).clone().requires_grad_() for t in (q, k, v))
            ol = TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            do4 = do.reshape(1, bh, s, hd)
            library = device_ms(torch, lambda: torch.autograd.grad(
                ol, (q4, k4, v4), do4, retain_graph=True), iters=10) * 1e3
        plan = A.flash_bwd_plan(bh, s, s, hd, dtype)
        row = dict(shape=[bh, s, hd], causal=causal, window=window, groups=g,
                   plan=list(plan), us=us, library_us=library, max_abs_err=err)
        rows_out.append(row)
        log(f"[flash bwd ab] {str([bh, s, hd]):16s}{' causal' if causal else '':7s}"
            f"{' w' + str(window) if window else '':5s} plan {plan.dkv_wgs}/{plan.dq_wgs} | "
            + " | ".join(f"{r} dkv {v['dkv'][0]:8.2f} / {v['dkv'][1]:8.2f} dq "
                         f"{v['dq'][0]:8.2f} / {v['dq'][1]:8.2f}" for r, v in us.items())
            + f" | SDPA bwd {'-' if library is None else f'{library:8.2f}'} us")
    return rows_out


def xent_cases(torch, gen, randn, shapes=None):
    """xent_fwd / xent_bwd at the train step's (8192, 512) and (1024, 512),
    at the options train step's (8192, 32768), and at the tape MLP's
    (8192, 10), whose rows are no whole number of 16-byte vectors (the
    kernels' one-element-per-lane route); or at ``shapes``' (rows, V)."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import xent as X

    cases = []
    shapes = shapes or [(TRAIN_BATCH * TRAIN_SEQ, TRAIN_MODEL["vocab_size"]),
                        (1024, TRAIN_MODEL["vocab_size"]),
                        (OPT_TRAIN_BATCH * OPT_TRAIN_SEQ, OPT_MODEL["vocab_size"]),
                        (MLP_BATCH, MLP_OUT)]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows, v in shapes:
            z = randn(rows, v, dtype=dtype) * 3
            lab = torch.randint(0, v, (rows,), generator=gen, device=DEVICE)
            g = randn(rows, dtype=torch.float32)
            zl = z.clone().requires_grad_()
            loss_lib = TF.cross_entropy(zl, lab, reduction="none")
            cases.append(dict(
                name="xent_fwd", dtype=dn, shape=[rows, v],
                max_abs_err=max_err(torch, X.xent_fwd(z, lab),
                                    X._plain_xent(z, lab), "xent_loss", dn),
                ms=device_ms(torch, lambda: X.xent_fwd(z, lab)),
                plain_ms=device_ms(torch, lambda: X._plain_xent(z, lab)),
                library_ms=device_ms(torch, lambda: TF.cross_entropy(
                    z, lab, reduction="none")),
                # max, subtract, exp, add per element
                **bound(rows * v * size + rows * (8 + 4), 4 * rows * v, dn)))
            cases.append(dict(
                name="xent_bwd", dtype=dn, shape=[rows, v],
                max_abs_err=max_err(torch, X.xent_grad(z, lab, g),
                                    X._plain_xent_grad(z, lab, g), "xent_dz", dn,
                                    g=g),
                ms=device_ms(torch, lambda: X.xent_grad(z, lab, g)),
                plain_ms=device_ms(torch, lambda: X._plain_xent_grad(z, lab, g)),
                library_ms=device_ms(torch, lambda: torch.autograd.grad(
                    loss_lib, zl, g.to(loss_lib.dtype), retain_graph=True)),
                # the statistics again, then p, the one-hot and the scale
                **bound(2 * rows * v * size + rows * (8 + 4), 8 * rows * v, dn)))
    return cases


def matmul_cases(torch, randn):
    """matmul_nn / _nt / _tn at the tape's matmul step (4096^3 bf16), at
    2048^3 in f32, the MLP's ragged layer-1 products (its forward
    (8192, 784) @ (784, 4096) and its dW1 (8192, 784)^T @ (8192, 4096): K
    784 is 12 K-tiles of 64 and a part, M 784 in tn), 1030^3, whose rows are
    no multiple of 16 bytes (the WMMA tile's predicated loads), and in bf16
    1032^3 (no dimension a multiple of a tile) and 8192 x 8192 x 64 and x 16
    (one K-tile, part of one): each within TOL["matmul"] of its plain
    version, on the tile kernels.matmul.mm_plan gives it, and every bf16 case
    the same bits on a second run (one owner per output tile)."""
    from minidiff_tpu_torch.kernels import matmul as M

    fns = {"nn": M.matmul, "nt": M.matmul_nt, "tn": M.matmul_tn}
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ([(v, MM_N, MM_N, MM_N, bf16) for v in fns]
              + [(v, TAPE_GATE_N, TAPE_GATE_N, TAPE_GATE_N, f32) for v in fns]
              + [(v, m, MLP_HIDDEN, k, dt) for dt in (bf16, f32)
                 for v, m, k in (("nn", MLP_BATCH, MLP_IN), ("tn", MLP_IN, MLP_BATCH))]
              + [(v, 1030, 1030, 1030, dt) for dt in (bf16, f32) for v in fns]
              + [(v, m, n, k, bf16) for m, n, k in MM_EDGES for v in fns])
    cases = []
    for variant, m, n, k, dtype in shapes:
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        x = randn(*((k, m) if variant == "tn" else (m, k)), dtype=dtype)
        y = randn(*((n, k) if variant == "nt" else (k, n)), dtype=dtype)
        check(M.uses_kernel(variant, x.shape, y.shape, x.dtype, y.dtype),
              f"matmul_{variant} {[m, n, k]} {dn} must take the kernel")
        fn = fns[variant]
        library = {"nn": lambda: x @ y, "nt": lambda: x @ y.T,
                   "tn": lambda: x.T @ y}[variant]
        out = fn(x, y)
        if dtype == bf16:
            check(torch.equal(out, fn(x, y)),
                  f"matmul_{variant} {[m, n, k]}: a second run gave other bits")
        plan = M.mm_plan(variant, m, n, k, dtype)
        cases.append(dict(
            name=f"matmul_{variant}", dtype=dn, shape=[m, n, k],
            tile=plan.route + (f"{plan.tile_n}" if plan.tile_n else ""),
            max_abs_err=max_err(torch, out, M._plain(variant, x, y), "matmul", dn),
            ms=device_ms(torch, lambda: fn(x, y), iters=20),
            plain_ms=device_ms(torch, lambda: M._plain(variant, x, y), iters=20),
            library_ms=device_ms(torch, library, iters=20),
            **bound((m * k + k * n + m * n) * size, 2 * m * n * k, dn)))
    return cases


def _mm_operands(torch, randn, variant, m, n, k):
    """bf16 operands of one product in their stored layouts, its plain
    version, and the library call that computes it."""
    from minidiff_tpu_torch.kernels import matmul as M

    x = randn(*((k, m) if variant == "tn" else (m, k)), dtype=torch.bfloat16)
    y = randn(*((n, k) if variant == "nt" else (k, n)), dtype=torch.bfloat16)
    library = {"nn": lambda: x @ y, "nt": lambda: x @ y.T, "tn": lambda: x.T @ y}[variant]
    return x, y, M._plain(variant, x, y), library


def _mm_turns(torch, routes, variant, x, y, ref):
    """Each of ``routes`` ({label: (library or None, plan or None)}) within
    TOL["matmul"] of ``ref``, then timed in turns, forward and back: us per
    route as [forward, back] and the max |err|."""
    from minidiff_tpu_torch.kernels import matmul as M

    us, err = {r: [] for r in routes}, {}
    for order in (list(routes), list(routes)[::-1]):
        for r in order:
            lib, plan = routes[r]
            with contextlib.ExitStack() as stack:
                if lib is not None:
                    stack.enter_context(built_as("matmul", lib))
                if r not in err:
                    err[r] = max_err(torch, M._launch(variant, x, y, plan), ref, "matmul",
                                     "bfloat16")
                us[r].append(device_ms(torch, lambda: M._launch(variant, x, y, plan),
                                       iters=20) * 1e3)
    return us, err


def matmul_route_ab(torch, randn, wmma_lib) -> list:
    """The bf16 matmuls at MM_AB's shapes: the wgmma tile on mm_plan's tile
    against the WMMA tile of ``wmma_lib`` (matmul.cu built with
    -DMM_WMMA_BF16), each within TOL["matmul"] of the plain version, timed
    in turns (WMMA, wgmma, wgmma, WMMA), with the library call beside."""
    from minidiff_tpu_torch.kernels import matmul as M

    wmma = lib_at("matmul", wmma_lib)
    rows = []
    for variant, m, n, k in MM_AB:
        x, y, ref, library = _mm_operands(torch, randn, variant, m, n, k)
        us, err = _mm_turns(torch, {"wmma": (wmma, None), "wgmma": (None, None)},
                            variant, x, y, ref)
        plan = M.mm_plan(variant, m, n, k, torch.bfloat16)
        b = bound((m * k + k * n + m * n) * 2, 2 * m * n * k, "bfloat16")
        row = dict(name=f"matmul_{variant}", shape=[m, n, k], tile=plan.tile_n,
                   wmma_us=us["wmma"], wgmma_us=us["wgmma"],
                   library_us=device_ms(torch, library, iters=20) * 1e3,
                   bound_us=b["bound_ms"] * 1e3, max_abs_err=err)
        rows.append(row)
        log(f"[mm ab] {row['name']} {str([m, n, k]):20s} tile {plan.tile_n:3d} | WMMA "
            f"{us['wmma'][0]:8.2f} / {us['wmma'][1]:8.2f} us | wgmma {us['wgmma'][0]:7.2f} / "
            f"{us['wgmma'][1]:7.2f} us | library {row['library_us']:7.2f} us | bound "
            f"{row['bound_us']:6.2f} us")
    return rows


def matmul_tile_ab(torch, randn) -> list:
    """The bf16 wgmma tile at MM_AB's shapes: 128 x 256 (one CTA per SM)
    and 128 x 128 (two), CTAs in bands of 8 tile-rows and of 1, each within
    TOL["matmul"] of the plain version, timed in turns: the readings behind
    mm_plan's tile and order."""
    from minidiff_tpu_torch.kernels import matmul as M

    routes = {"t256g8": (None, M.MmPlan("wgmma", 256, 8)),
              "t128g8": (None, M.MmPlan("wgmma", 128, 8)),
              "t256g1": (None, M.MmPlan("wgmma", 256, 1)),
              "t128g1": (None, M.MmPlan("wgmma", 128, 1))}
    rows = []
    for variant, m, n, k in MM_AB:
        x, y, ref, _ = _mm_operands(torch, randn, variant, m, n, k)
        us, err = _mm_turns(torch, routes, variant, x, y, ref)
        plan = M.mm_plan(variant, m, n, k, torch.bfloat16)
        fastest = min(us, key=lambda r: sum(us[r]))
        row = dict(name=f"matmul_{variant}", shape=[m, n, k],
                   plan=f"t{plan.tile_n}g{plan.group}", fastest=fastest, us=us,
                   max_abs_err=err)
        rows.append(row)
        log(f"[mm tile ab] {row['name']} {str([m, n, k]):20s} plan {row['plan']} fastest "
            f"{fastest} | " + " | ".join(f"{r} {v[0]:7.2f} / {v[1]:7.2f}" for r, v in us.items())
            + " us")
    return rows


def _dq_row(torch, name, dn, shape, x, run, plain, lib, w, plan, nbytes, flops, timed,
            **extra) -> dict:
    """One dequant case: the kernel's ``run()`` held by dq_hold against
    ``plain()`` on activations x and the dequantized weight w (f64); with
    ``timed``, the kernel's, the plain version's and the library call
    ``lib()``'s device times and the bound."""
    err, shares = dq_hold(torch, run(), plain(), x, w, dn)
    row = dict(name=name, dtype=dn, shape=shape, **extra, **_plan_info(plan),
               max_abs_err=err)
    if shares:
        row["bound_share"] = shares
    if timed:
        row.update(ms=device_ms(torch, run), plain_ms=device_ms(torch, plain),
                   library_ms=device_ms(torch, lib), **bound(nbytes, flops, dn))
    return row


def quant_cases(torch, gen, randn, dtypes=None, timed=True):
    """dq_mm / dq4_mm at a decode step's projections (m = 8: QKV [1024,
    3072], out [1024, 1024], fc1 [1024, 4096], fc2 [4096, 1024], the head
    [1024, 512]) and at m = 128 (the bench prefill of 8 x 16 tokens), in
    ``dtypes`` (bf16 and f32), held by dq_hold; with ``timed``, beside
    torch.matmul on the dequantized weight."""
    from minidiff_tpu_torch.kernels import quant as Q

    cases = []
    d = MODEL["dim"]
    shapes = [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d), (d, MODEL["vocab_size"])]
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for m in (BATCH, 128):
            for k, n in shapes:
                x = randn(m, k, dtype=dtype)
                w = randn(k, n, dtype=torch.float32) * k ** -0.5
                q8, s8 = Q.quantize_int8(w)
                p4, s4 = Q.quantize_int4(w)
                for name, fn, plain, wq, sq, wbytes in (
                        ("dq_mm", Q.dequant_matmul, Q._plain_dequant_matmul, q8, s8,
                         k * n + 4 * n),
                        ("dq4_mm", Q.dequant_matmul4, Q._plain_dequant_matmul4, p4, s4,
                         k * n // 2 + 4 * (k // 128) * n)):
                    wd = (Q._dequantized4(p4, s4, dtype) if name == "dq4_mm"
                          else (q8.float() * s8).to(dtype))
                    w64 = (wd.double() if name == "dq4_mm"
                           else q8.double() * s8.double())
                    cases.append(_dq_row(
                        torch, name, dn, [m, k, n], x, lambda: fn(x, wq, sq),
                        lambda: plain(x, wq, sq), lambda: x @ wd, w64,
                        Q.dq_plan(4 if name == "dq4_mm" else 8, m, n, k, dtype, group=128),
                        (m * k + m * n) * size + wbytes, 2 * m * n * k, timed))
    return cases


def dq_bmm_cases(torch, randn, dtypes=None, timed=True):
    """dq_bmm at the MoE serving model's banks ([E, C, K, N]): a decode step's
    w1 (8, 8, 1024) @ (8, 1024, 4096) and w2 (8, 8, 2048) @ (8, 2048, 1024),
    the bench prefill's w1 and w2 (8 x 16 tokens: C = 128; w2 splits K on
    the large tile), a C of 5 (no multiple of the kernel's 8 rows), 16 (a
    16-token bucket), and 40 and 200 (large tiles cut short by rows), in
    ``dtypes`` (bf16 and f32), held by dq_hold; with ``timed``, beside
    torch.bmm on the dequantized bank.  A C of 384 (a server prefill's
    bucket) takes the plain version: no launch."""
    from minidiff_tpu_torch.kernels import quant as Q

    e, d, ff = MOE_MODEL["num_experts"], MOE_MODEL["dim"], MOE_MODEL["mlp_hidden"]
    cases = []
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for c, k, n in ((BATCH, d, 2 * ff), (BATCH, ff, d), (128, d, 2 * ff),
                        (128, ff, d), (5, d, 2 * ff), (16, d, 2 * ff), (40, d, 2 * ff),
                        (200, ff, d)):
            x = randn(e, c, k, dtype=dtype)
            q, s = Q.quantize_int8_stacked(randn(e, k, n, dtype=torch.float32)
                                           * k ** -0.5)
            wd = (q.float() * s[:, None, :]).to(dtype)
            cases.append(_dq_row(
                torch, "dq_bmm", dn, [e, c, k, n], x, lambda: Q.dequant_matmul_bmm(x, q, s),
                lambda: Q._plain_dequant_bmm(x, q, s), lambda: torch.bmm(x, wd),
                q.double() * s.double()[:, None, :], Q.dq_plan(8, c, n, k, dtype, experts=e),
                # x and the output in x's dtype, the int8 bank and its scales
                (e * c * k + e * c * n) * size + e * k * n + 4 * e * n,
                2 * e * c * n * k, timed))
    if timed:
        x = randn(e, 384, q.shape[1], dtype=torch.bfloat16)
        before = Q.LAUNCHES["dq_bmm"]
        out = Q.dequant_matmul_bmm(x, q, s)
        check(Q.LAUNCHES["dq_bmm"] == before, "dq_bmm launched at C = 384")
        check(torch.equal(out, Q._plain_dequant_bmm(x, q, s)),
              "dq_bmm at C = 384 is not its plain version")
    return cases


def _plan_info(plan) -> dict:
    """The tile and the K splits a dq_bmm / dq4_mm case launches with."""
    return dict(tile=plan.tile, splits=plan.splits)


def _dq_case(torch, randn, bits, dtype, shape, group=128):
    """One dq_bmm ([E, C, K, N], bits 8), dq_mm ([M, K, N], bits 8) or
    dq4_mm ([M, K, N], bits 4) case: the kernel's name, its entry point on x
    and a quantized weight, the plain version, the library call on the
    dequantized weight (torch.bmm / x @ w), the dequantized weight in f64
    (``exact``, dq_hold's), the plan, the bound's bytes and flops, and a
    maker of fresh weight copies."""
    from minidiff_tpu_torch.kernels import quant as Q

    size = torch.finfo(dtype).bits // 8
    name = "dq4_mm" if bits == 4 else "dq_bmm" if len(shape) == 4 else "dq_mm"
    if name == "dq_mm":
        m, k, n = shape
        x = randn(m, k, dtype=dtype)

        def weight():
            return Q.quantize_int8(randn(k, n, dtype=torch.float32) * k ** -0.5)

        def dequant(q, s):
            return (q.float() * s).to(dtype)

        def exact(q, s):
            return q.double() * s.double()

        run, plain, lib = Q.dequant_matmul, Q._plain_dequant_matmul, torch.matmul
        plan = Q.dq_plan(8, m, n, k, dtype)
        nbytes = (m * k + m * n) * size + k * n + 4 * n
        flops = 2 * m * n * k
    elif bits == 8:
        e, c, k, n = shape
        x = randn(e, c, k, dtype=dtype)

        def weight():
            return Q.quantize_int8_stacked(randn(e, k, n, dtype=torch.float32) * k ** -0.5)

        def dequant(q, s):
            return (q.float() * s[:, None, :]).to(dtype)

        def exact(q, s):
            return q.double() * s.double()[:, None, :]

        run, plain, lib = Q.dequant_matmul_bmm, Q._plain_dequant_bmm, torch.bmm
        plan = Q.dq_plan(8, c, n, k, dtype, experts=e)
        nbytes = (e * c * k + e * c * n) * size + e * k * n + 4 * e * n
        flops = 2 * e * c * n * k
    else:
        m, k, n = shape
        x = randn(m, k, dtype=dtype)

        def weight():
            return Q.quantize_int4(randn(k, n, dtype=torch.float32) * k ** -0.5, group=group)

        def dequant(p, s):
            return Q._dequantized4(p, s, dtype)

        def exact(p, s):  # the weight both sides multiply by (f32 in f32)
            return Q._dequantized4(p, s, dtype).double()

        run, plain, lib = Q.dequant_matmul4, Q._plain_dequant_matmul4, torch.matmul
        plan = Q.dq_plan(4, m, n, k, dtype, group=group)
        nbytes = (m * k + m * n) * size + k * n // 2 + 4 * (k // group) * n
        flops = 2 * m * n * k
    return dict(name=name, x=x, weight=weight, dequant=dequant, exact=exact, run=run,
                plain=plain, lib=lib, plan=plan, nbytes=nbytes, flops=flops)


def dq_edge_cases(torch, randn, dtypes=None, timed=True):
    """dq4_mm at int4 groups 64 and 256, a ragged N (520: no multiple of 16,
    8-byte weight copies), one row, 16 rows (a 16-token bucket) and 40 and
    200 rows (large tiles cut short by rows); dq_bmm at N 520; each in
    ``dtypes`` (bf16 and f32) held by dq_hold (dq_bmm_cases holds C = 5)."""
    cases = []
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for bits, shape, group in ((4, [8, 1024, 3072], 64), (4, [128, 1024, 3072], 64),
                                   (4, [8, 1024, 3072], 256), (4, [128, 1024, 3072], 256),
                                   (4, [8, 1024, 520], 128), (4, [128, 1024, 520], 128),
                                   (4, [1, 1024, 3072], 128), (4, [16, 1024, 3072], 128),
                                   (4, [40, 1024, 3072], 128), (4, [200, 4096, 1024], 128),
                                   (8, [8, 8, 1024, 520], 128)):
            d = _dq_case(torch, randn, bits, dtype, shape, group)
            q, s = d["weight"]()
            x, wd = d["x"], d["dequant"](q, s)
            cases.append(_dq_row(
                torch, d["name"], dn, shape, x, lambda: d["run"](x, q, s),
                lambda: d["plain"](x, q, s), lambda: d["lib"](x, wd), d["exact"](q, s),
                d["plan"],
                d["nbytes"], d["flops"], timed, group=group if bits == 4 else None))
    return cases


def dq_f32_cases(torch) -> list:
    """The f32 cases of quant_cases, dq_bmm_cases and dq_edge_cases at each
    seed of DQ_F32_SEEDS, each drawn from a generator of its own, so that
    the f32 gate (dq_hold) holds on more than one draw; the first seed's
    cases are timed, the others only held."""
    cases = []
    for i, seed in enumerate(DQ_F32_SEEDS):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)

        def randn(*shape, dtype):
            return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

        f32 = (torch.float32,)
        rows = (quant_cases(torch, gen, randn, f32, i == 0)
                + dq_bmm_cases(torch, randn, f32, i == 0)
                + dq_edge_cases(torch, randn, f32, i == 0))
        for r in rows:
            r["seed"] = seed
        cases += rows
    worst = {}
    for r in cases:
        for side, share in r["bound_share"].items():
            key = (r["name"], side)
            worst[key] = max(worst.get(key, 0.0), share)
    log(f"[kernel] the f32 dequant cases at seeds {DQ_F32_SEEDS}: kernel and plain version "
        "within dq_f32_bound of the f64 product; the largest share of the bound used: "
        + ", ".join(f"{n} {side} {v:.3g}" for (n, side), v in sorted(worst.items())))
    return cases


def cold_ms(torch, fn, copies) -> float:
    """device_ms of fn(copy), each call on the next of ``copies`` (whose
    total exceeds the L2), so that every call finds its weight cold."""
    import itertools

    it = itertools.cycle(copies)
    return device_ms(torch, lambda: fn(next(it)))


def lib_at(source: str, path):
    """A build of ``csrc/<source>.cu`` at ``path`` (an A/B variant), loaded
    with the C signatures."""
    import ctypes

    from minidiff_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    for fn, (src, argtypes) in _build.SIGNATURES.items():
        if src == source:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def built_as(source: str, lib):
    """Every kernel of ``csrc/<source>.cu`` launched from ``lib`` until the
    block ends.  Each swap bumps the library epoch, so a captured decode
    step re-captures on the swapped library and again after it."""
    from minidiff_tpu_torch.kernels import _build

    own = _build._lib(source)
    _build.use_library(source, lib)
    try:
        yield
    finally:
        _build.use_library(source, own)


@contextlib.contextmanager
def norm_fwd_v1(report):
    """Every norm kernel launched from the -DNORM_FWD_V1 builds of phase 2
    (the earlier forwards) until the block ends."""
    with contextlib.ExitStack() as stack:
        for src, path in report["norm_fwd_v1_libs"].items():
            stack.enter_context(built_as(src, lib_at(src, path)))
        yield


@contextlib.contextmanager
def bwd_v1(report):
    """Every kernel of xent.cu, rmsnorm.cu and layernorm.cu launched from
    their -DXENT_BWD_V1 and -DNORM_BWD_V1 builds of phase 2 (the old
    backwards) until the block ends."""
    with contextlib.ExitStack() as stack:
        for src, path in report["bwd_v1_libs"].items():
            stack.enter_context(built_as(src, lib_at(src, path)))
        yield


def profile_bwd_v1(torch, report, out, label, run, kernels):
    """Profile ``run`` once more on the old backwards (after one call
    outside the profiler, which captures a train step on them; phase 2 built them;
    a CPU rehearsal has no ``bwd_v1_libs`` and skips it) into
    ``out["train_profile_bwd_v1"]``, and log the device time per step of
    each redesigned backward of ``kernels`` (those the run launches) on
    both."""
    if "bwd_v1_libs" not in report:
        return
    with bwd_v1(report):
        out["train_profile_bwd_v1"] = profile_captured(
            torch, f"{label}, -DXENT_BWD_V1 / -DNORM_BWD_V1", run)
    new, old = out["train_profile"]["bwd"], out["train_profile_bwd_v1"]["bwd"]
    log(f"[profile]   {label}: device us per step new / old: " + ", ".join(
        f"{k} {new.get(k, [0.0])[0]:.1f} / {old.get(k, [0.0])[0]:.1f}" for k in kernels))


@contextlib.contextmanager
def fwd_v1(report):
    """The old forward cross-entropy and the old scan until the
    block ends: xent.cu's and scan.cu's kernels launched from their
    -DXENT_FWD_V1 and -DSCAN_V1 builds of phase 2, and ScanFn's backward
    computing its cotangent as flip(scan(shift(flip(a)), flip(g)))."""
    import torch

    from minidiff_tpu_torch.kernels import scan as S

    plan_cls = S.ScanFn

    class FlipScanFn(plan_cls):
        @staticmethod
        def backward(ctx, g):
            a, y = ctx.saved_tensors
            r = torch.flip(S.scan(S._shift(torch.flip(a, [1])),
                                  torch.flip(g.contiguous(), [1])), [1])
            return r * S._shift(y), r

    with contextlib.ExitStack() as stack:
        for src, path in report["fwd_v1_libs"].items():
            stack.enter_context(built_as(src, lib_at(src, path)))
        S.ScanFn = FlipScanFn
        try:
            yield
        finally:
            S.ScanFn = plan_cls


def profile_fwd_v1(torch, report, out, label, run, groups):
    """Profile ``run`` once more on the old forward and scan (fwd_v1; after
    one call outside the profiler, as profile_bwd_v1; a CPU
    rehearsal has no ``fwd_v1_libs`` and skips it) into
    ``out["train_profile_fwd_v1"]``, and log the device us per step of
    ``groups`` (step_group's) on both."""
    if "fwd_v1_libs" not in report:
        return
    with fwd_v1(report):
        out["train_profile_fwd_v1"] = profile_captured(
            torch, f"{label}, -DXENT_FWD_V1 / -DSCAN_V1 and the flip route", run)
    new, old = out["train_profile"]["groups"], out["train_profile_fwd_v1"]["groups"]
    log(f"[profile]   {label}: device us per step new / old: " + ", ".join(
        f"{g} {new.get(g, [0.0])[0]:.1f} / {old.get(g, [0.0])[0]:.1f}" for g in groups))


def dq_route_ab(torch, randn, simt_lib) -> list:
    """dq_bmm and dq4_mm in bf16 at the main path's shapes (DQ_BMM_AB,
    DQ4_AB): the tensor-core tiles against the SIMT tile of ``simt_lib``
    (quant.cu built with -DDQ_SIMT_BF16), timed in turns (SIMT, tiles,
    tiles, SIMT), each within TOL["dq"] of the plain version; beside them the
    library call warm, and the tiles and the library call cold (weights
    rotated over COLD_BYTES)."""
    import math

    from minidiff_tpu_torch.kernels import _build

    simt, tiles = lib_at("quant", simt_lib), _build._lib("quant")
    dtype, dn = torch.bfloat16, "bfloat16"
    rows = []
    for bits, shapes in ((8, DQ_BMM_AB), (8, DQ_MM_AB), (4, DQ4_AB)):
        for shape in shapes:
            d = _dq_case(torch, randn, bits, dtype, shape)
            q, s = d["weight"]()
            x, run = d["x"], d["run"]
            ref = d["plain"](x, q, s)
            us = {}
            for route, lib in (("simt", simt), ("tiles", tiles), ("tiles2", tiles),
                               ("simt2", simt)):
                with built_as("quant", lib):
                    us[route + "_err"] = max_err(torch, run(x, q, s), ref, "dq", dn)
                    us[route] = device_ms(torch, lambda: run(x, q, s)) * 1e3
            wbytes = q.numel() * q.element_size() + s.numel() * 4
            copies = [d["weight"]() for _ in range(math.ceil(COLD_BYTES / wbytes) + 1)]
            cold = cold_ms(torch, lambda c: run(x, *c), copies) * 1e3
            del copies
            wd = d["dequant"](q, s)
            lib_us = device_ms(torch, lambda: d["lib"](x, wd)) * 1e3
            lcopies = [wd.clone() for _ in range(
                math.ceil(COLD_BYTES / (wd.numel() * wd.element_size())) + 1)]
            lib_cold = cold_ms(torch, lambda c: d["lib"](x, c), lcopies) * 1e3
            del lcopies
            b = bound(d["nbytes"], d["flops"], dn)
            row = dict(name=d["name"], shape=shape,
                       **_plan_info(d["plan"]), ctas=d["plan"].ctas,
                       simt_us=[us["simt"], us["simt2"]], tiles_us=[us["tiles"], us["tiles2"]],
                       tiles_cold_us=cold, library_us=lib_us, library_cold_us=lib_cold,
                       bound_us=b["bound_ms"] * 1e3, bound_by=b["bound_by"],
                       max_abs_err=us["tiles_err"], simt_max_abs_err=us["simt_err"])
            rows.append(row)
            log(f"[dq ab] {row['name']:6s} {str(shape):21s} {row['tile']:7s}x{row['splits']:<2d} "
                f"SIMT {us['simt']:8.2f} / {us['simt2']:8.2f} us | tiles {us['tiles']:7.2f} / "
                f"{us['tiles2']:7.2f} us, cold {cold:7.2f} | library {lib_us:6.2f}, cold "
                f"{lib_cold:6.2f} | bound {row['bound_us']:6.2f} us | err {row['max_abs_err']:.3g}")
    return rows


def _ab_turns(torch, routes, x, q, s, ref, dn):
    """Each of ``routes`` ({label: plan}) within TOL["dq"] of ``ref``, then
    timed in turns, forward and back over the routes; us per route as
    [forward, back] and the max |err|."""
    from minidiff_tpu_torch.kernels import quant as Q

    us = {r: [] for r in routes}
    err = {}
    for r, p in routes.items():
        try:
            err[r] = max_err(torch, Q._dq_tiles(x, q, s, p), ref, "dq", dn)
        except SmokeFailure as e:
            raise SmokeFailure(f"{Q.__name__} {tuple(x.shape)} x {tuple(q.shape)} on {p}: {e}")
    for order in (list(routes), list(routes)[::-1]):
        for r in order:
            p = routes[r]
            us[r].append(device_ms(torch, lambda: Q._dq_tiles(x, q, s, p)) * 1e3)
    return us, err


def dq_split_ab(torch, randn) -> list:
    """dq_bmm and dq4_mm in bf16 at DQ_SPLIT_AB's shapes, each on its plan's
    tile at 1, 2, 4, 8 and 16 K splits (no more than its units, and no
    fewer than the tile's min_splits), in turns: the readings behind
    dq_plan's split rule, and a check of every split count's K ranges
    (tc_body's) against the plain version."""
    from minidiff_tpu_torch.kernels import quant as Q

    dtype, dn = torch.bfloat16, "bfloat16"
    rows = []
    for bits, shape in DQ_SPLIT_AB:
        d = _dq_case(torch, randn, bits, dtype, shape)
        q, s = d["weight"]()
        x, plan = d["x"], d["plan"]
        k = shape[-2]
        units = (k // 2 // 128) if bits == 4 else k // Q.TILES[8][plan.tile][2]
        tiles = plan.ctas // plan.splits
        routes = {n: Q.DqPlan(plan.tile, n, tiles * n)
                  for n in (1, 2, 4, 8, 16) if Q.min_splits(k, plan.tile) <= n <= units}
        us, err = _ab_turns(torch, routes, x, q, s, d["plain"](x, q, s), dn)
        row = dict(name=d["name"], shape=shape, tile=plan.tile,
                   tiles=tiles, plan_splits=plan.splits,
                   us={str(n): v for n, v in us.items()},
                   max_abs_err={str(n): v for n, v in err.items()})
        rows.append(row)
        log(f"[dq splits] {row['name']:6s} {str(shape):21s} {plan.tile:7s} {tiles:4d} tiles, "
            f"plan x{plan.splits:<2d} | " + " | ".join(
                f"x{n} {v[0]:6.2f} / {v[1]:6.2f}" for n, v in us.items()) + " us")
    return rows


def dq_tile_ab(torch, randn) -> list:
    """dq_bmm and dq4_mm in bf16 at 16 rows (DQ_TILE_AB) on each tensor-core
    tile, with the split rule's splits for that tile, in turns, each within
    TOL["dq"] of the plain version: the readings behind the row rule."""
    from minidiff_tpu_torch.kernels import quant as Q

    dtype, dn = torch.bfloat16, "bfloat16"
    rows = []
    for bits, shape in DQ_TILE_AB:
        d = _dq_case(torch, randn, bits, dtype, shape)
        q, s = d["weight"]()
        x = d["x"]
        m, k, n = shape[-3:]
        routes = {t: Q.dq_plan(bits, m, n, k, dtype, group=128 if bits == 4 else None,
                               experts=shape[0] if len(shape) == 4 else 1, tile=t)
                  for t in ("small8", "small16", "large")}
        us, err = _ab_turns(torch, routes, x, q, s, d["plain"](x, q, s), dn)
        row = dict(name=d["name"], shape=shape,
                   plan_tile=d["plan"].tile,
                   routes={t: dict(splits=p.splits, ctas=p.ctas, us=us[t], max_abs_err=err[t])
                           for t, p in routes.items()})
        rows.append(row)
        log(f"[dq tiles] {row['name']:6s} {str(shape):19s} plan {d['plan'].tile:7s} | " + " | ".join(
            f"{t} x{p.splits} {us[t][0]:6.2f} / {us[t][1]:6.2f}" for t, p in routes.items())
            + " us")
    return rows


def _decode_attn(torch, gen, randn, name, dtype, spec) -> dict:
    """One sdpa_int8 ([B, heads, kv heads, hd, L, pos], SDPA_CASES) or
    paged_attn ([kv heads, g, hd, pages used], PAGED_CASES) case: the
    kernel on a launch plan (the wrapper's own by default), its plain
    version, the library call (SDPA over the dequantized cache or the
    gathered view), the plan of each split count, the arguments of the
    kernel's cluster query, and the bound's bytes and flops."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import paged as P
    from minidiff_tpu_torch.kernels import quant as Q

    size = torch.finfo(dtype).bits // 8
    if name == "sdpa_int8":
        b, h, kv, hd, L, pos = spec
        q = randn(b, h, 1, hd, dtype=dtype)
        k8, ks = Q.quantize_int8_rows(randn(b, kv, L, hd, dtype=torch.float32))
        v8, vs = Q.quantize_int8_rows(randn(b, kv, L, hd, dtype=torch.float32))
        posv = torch.full((b,), pos, device=DEVICE, dtype=torch.int32)
        args = (q, k8, ks, v8, vs, posv)
        kd = (k8.float() * ks[..., None]).to(dtype)
        vd = (v8.float() * vs[..., None]).to(dtype)
        mask = (torch.arange(L, device=DEVICE) <= pos).reshape(1, L)
        qg, c, scale = Q._grouped(q, k8, None)
        gc, live = qg.shape[2], pos + 1  # keys this step reads: the rest are masked

        def run(plan=None):
            if plan is None:
                return Q.sdpa_int8_cache(*args)
            return Q._sdpa_launch(qg, k8, ks, v8, vs, posv, c, scale, plan).reshape(q.shape)

        return dict(
            shape=[b, h, 1, hd, L], extra=dict(pos=pos, groups=h // kv), run=run,
            plain=lambda: Q._plain_sdpa_int8_cache(*args),
            library=lambda: TF.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask, enable_gqa=h != kv),
            plan_of=lambda n=None: Q.sdpa_int8_plan(b, kv, gc, hd, L, dtype, splits=n),
            clusters=("sdpa_int8_clusters", (gc, hd, L)),
            # K and V lines with their scales, q and o; QK^T and PV
            nbytes=2 * b * kv * live * (hd + 4) + 2 * b * h * hd * size + 4 * b,
            flops=4 * b * h * live * hd)
    kv, g, hd, used = spec
    b, maxp = PAGED_SLOTS, PAGED_SEQ // P.PAGE
    npages = b * maxp + 1
    pk = randn(npages, kv, P.PAGE, hd, dtype=dtype)
    pv = randn(npages, kv, P.PAGE, hd, dtype=dtype)
    table = (1 + torch.randperm(npages - 1, generator=gen, device=DEVICE)).reshape(
        b, maxp).to(torch.int32)
    q = randn(b, kv, g, hd, dtype=dtype)
    live = used * P.PAGE - 20
    pos = torch.full((b,), live - 1, device=DEVICE, dtype=torch.int32)
    args = (q, pk, pv, table, pos)
    view = table[:, :used].long()
    kd = pk[view].transpose(1, 2).reshape(b, kv, used * P.PAGE, hd)
    vd = pv[view].transpose(1, 2).reshape(b, kv, used * P.PAGE, hd)
    mask = (torch.arange(used * P.PAGE, device=DEVICE) < live).reshape(1, -1)
    scale = hd ** -0.5

    def run(plan=None):
        if plan is None:
            return P.paged_attention(*args)
        return P._launch(*args, scale, None, 0, plan)

    return dict(
        shape=[b, kv, g, hd, used], extra=dict(groups=g), run=run,
        plain=lambda: P.paged_attention_reference(*args, scale),
        library=lambda: TF.scaled_dot_product_attention(
            q.reshape(b, kv * g, 1, hd), kd, vd, attn_mask=mask, enable_gqa=g > 1),
        plan_of=lambda n=None: P.paged_plan(b, kv, g, hd, maxp, dtype, splits=n),
        clusters=("paged_attn_clusters", (g, hd)),
        # the live K and V rows (l <= pos), q, o and the table rows and
        # positions; QK^T and PV over the live rows
        nbytes=2 * b * kv * live * hd * size + 2 * b * kv * g * hd * size
        + 4 * b * (used + 1),
        flops=4 * b * kv * g * live * hd)


def _same_bits(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def decode_attn_cases(torch, gen, randn) -> list:
    """sdpa_int8 at SDPA_CASES and paged_attn at PAGED_CASES, in bf16 and
    f32, each on its plan against its plain version within TOL["attn"] and
    every bf16 output the same bits on a second run, with the times of the
    kernel, the plain version and the library call, and the bound."""
    cases = []
    for name, specs in (("sdpa_int8", SDPA_CASES), ("paged_attn", PAGED_CASES)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            for spec in specs:
                d = _decode_attn(torch, gen, randn, name, dtype, spec)
                out = d["run"]()
                err = max_err(torch, out, d["plain"](), "attn", dn)
                if dtype == torch.bfloat16:
                    check(_same_bits(torch, out, d["run"]()),
                          f"{name} {d['shape']}: a second run gave other bits")
                cases.append(dict(
                    name=name, dtype=dn, shape=d["shape"], **d["extra"],
                    splits=d["plan_of"]().splits, max_abs_err=err,
                    ms=device_ms(torch, d["run"]), plain_ms=device_ms(torch, d["plain"]),
                    library_ms=device_ms(torch, d["library"]),
                    **bound(d["nbytes"], d["flops"], dn)))
                del d, out
    return cases


def decode_attn_route_ab(torch, gen, randn, one_cta_libs) -> list:
    """sdpa_int8 and paged_attn at every case of decode_attn_cases: the split
    kernels on their plans against the one-CTA kernels of ``one_cta_libs``
    ({source: path}: quant.cu and paged.cu built with -DDECODE_ATTN_ONE_CTA),
    each within TOL["attn"] of the plain version, timed in turns (one CTA,
    split, split, one CTA), with the library call beside.  A shape the
    one-CTA kernel refuses is recorded with its error."""
    from minidiff_tpu_torch.kernels import _build

    rows = []
    for name, specs, source in (("sdpa_int8", SDPA_CASES, "quant"),
                                ("paged_attn", PAGED_CASES, "paged")):
        old = lib_at(source, one_cta_libs[source])
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            for spec in specs:
                d = _decode_attn(torch, gen, randn, name, dtype, spec)
                ref = d["plain"]()
                us, err = {"one_cta": [], "split": []}, {}
                for route in ("one_cta", "split", "split", "one_cta"):
                    with contextlib.ExitStack() as stack:
                        if route == "one_cta":
                            stack.enter_context(built_as(source, old))
                        try:
                            if route not in err:
                                err[route] = max_err(torch, d["run"](), ref, "attn", dn)
                            us[route].append(device_ms(torch, d["run"]) * 1e3)
                        except _build.KernelLaunchError as e:
                            check(route == "one_cta", f"{name} {d['shape']}: {e}")
                            err[route] = f"refused: {e}"
                b = bound(d["nbytes"], d["flops"], dn)
                row = dict(name=name, dtype=dn, shape=d["shape"], **d["extra"],
                           splits=d["plan_of"]().splits, one_cta_us=us["one_cta"],
                           split_us=us["split"],
                           library_us=device_ms(torch, d["library"]) * 1e3,
                           bound_us=b["bound_ms"] * 1e3, bound_by=b["bound_by"],
                           max_abs_err=err)
                rows.append(row)
                old_us = (" / ".join(f"{v:8.2f}" for v in us["one_cta"]) + " us"
                          if us["one_cta"] else err["one_cta"])
                log(f"[decode ab] {name:10s} {dn:8s} {str(d['shape']):26s} x{row['splits']:<2d} "
                    f"| one CTA {old_us} | split {us['split'][0]:7.2f} / {us['split'][1]:7.2f} us "
                    f"| library {row['library_us']:7.2f} us | bound {row['bound_us']:6.2f} us")
                del d, ref
    return rows


def decode_split_ab(torch, gen, randn) -> list:
    """sdpa_int8 and paged_attn in bf16 at every case of decode_attn_cases at
    1, 2, 4, 8 and 16 splits (those whose scores fit a CTA), each within
    TOL["attn"] of the plain version, timed in turns forward and back, with
    the whole clusters the card holds at once at each count
    (cudaOccupancyMaxActiveClusters): the readings behind paged_plan's and
    sdpa_int8_plan's split rules."""
    import ctypes

    from minidiff_tpu_torch.kernels import _build

    dtype, dn = torch.bfloat16, "bfloat16"
    rows = []
    for name, specs in (("sdpa_int8", SDPA_CASES), ("paged_attn", PAGED_CASES)):
        for spec in specs:
            d = _decode_attn(torch, gen, randn, name, dtype, spec)
            ref = d["plain"]()
            plans = {n: d["plan_of"](n) for n in (1, 2, 4, 8, 16)}
            plans = {n: p for n, p in plans.items() if p.smem <= _build.SMEM_LIMIT}
            err = {n: max_err(torch, d["run"](p), ref, "attn", dn) for n, p in plans.items()}
            us = {n: [] for n in plans}
            for order in (list(plans), list(plans)[::-1]):
                for n in order:
                    us[n].append(device_ms(torch, lambda: d["run"](plans[n])) * 1e3)
            clusters = {}
            fn, dims = d["clusters"]
            for n, p in plans.items():
                got = ctypes.c_int(0)
                code = _build.function(fn)(*dims, p.rows, p.splits, p.smem,
                                           _build.DTYPE_CODES[dtype], ctypes.addressof(got))
                clusters[n] = got.value if code == 0 else f"error {code}"
            plan = d["plan_of"]()
            row = dict(name=name, shape=d["shape"], **d["extra"], plan_splits=plan.splits,
                       us={str(n): v for n, v in us.items()},
                       max_abs_err={str(n): v for n, v in err.items()},
                       clusters={str(n): v for n, v in clusters.items()})
            rows.append(row)
            check(isinstance(clusters[plan.splits], int) and clusters[plan.splits] > 0,
                  f"{name} {d['shape']}: the card holds no cluster of the plan's "
                  f"{plan.splits} CTAs ({clusters[plan.splits]})")
            log(f"[decode splits] {name:10s} {str(d['shape']):26s} plan x{plan.splits:<2d} | "
                + " | ".join(f"x{n} {v[0]:7.2f} / {v[1]:7.2f} ({clusters[n]})"
                             for n, v in us.items()) + " us")
            del d, ref
    return rows


def scan_cases(torch, gen) -> list:
    """scan at the SSM train step's and long prefill's (8, 1024, 32768) in
    bf16 and f32, at a server slot's one-row prefill (1, 384, 32768) in
    bf16, and the backward's reverse scan at (8, 1024, 32768), against the
    plain version.  Decays in [0.5, 1), inputs normal.  The plain version is
    a loop of T steps of a few launches each, timed over 2 calls.  No single
    PyTorch call computes a linear recurrence: no library time."""
    from minidiff_tpu_torch.kernels import scan as S

    cases = []
    c = SSM_SCAN[2]
    for dtype, lead, t, reverse in ((torch.bfloat16, SSM_SCAN[0], SSM_SCAN[1], False),
                                    (torch.float32, SSM_SCAN[0], SSM_SCAN[1], False),
                                    (torch.bfloat16, 1, 384, False),
                                    (torch.bfloat16, SSM_SCAN[0], SSM_SCAN[1], True)):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        a = torch.rand((lead, t, c), generator=gen, device=DEVICE) * 0.5 + 0.5
        b = torch.randn((lead, t, c), generator=gen, device=DEVICE)
        a, b = a.to(dtype), b.to(dtype)
        plan = S.scan_plan(lead, t, c, dtype)
        cases.append(dict(
            name="scan", dtype=dn, shape=[lead, t, c], backward=reverse,
            route=plan.route, tile=plan.tile, steps=plan.steps, stages=plan.stages,
            max_abs_err=max_err(torch, S.scan(a, b, reverse), S._plain_scan(a, b, reverse),
                                "scan", dn),
            ms=device_ms(torch, lambda: S.scan(a, b, reverse)),
            plain_ms=device_ms(torch, lambda: S._plain_scan(a, b, reverse), iters=2),
            library_ms=None,
            # a and b read once, y written once; one f32 multiply and add
            **bound(3 * lead * t * c * size, 2 * lead * t * c, "float32")))
        del a, b
    return cases


def _server_scan_lengths() -> list:
    """T of a server slot's one-row prefills: REQUESTS' prompts in the
    server's buckets."""
    from minidiff_tpu_torch.models.server import _BUCKET

    return sorted({-(-p // _BUCKET) * _BUCKET for p, _ in REQUESTS})


def scan_ab_shapes() -> list:
    """scan_route_ab's (dtype name, lead, T, C): the SSM train step's width
    at every lead from 1 to 8 at its T, a server slot's one-row prefills,
    generate_compiled_ssm's prefill (batch 8, prompt 16) and the tape gate's
    shape, in bf16; the train step's and the one-row prefill's in f32."""
    lead, t, c = SSM_SCAN
    shapes = [("bfloat16", n, t, c) for n in range(1, lead + 1)]
    shapes += [("bfloat16", 1, n, c) for n in _server_scan_lengths()]
    shapes += [("bfloat16", BATCH, PROMPT, c), ("bfloat16", *SSM_TAPE_GATE)]
    shapes += [("float32", lead, t, c), ("float32", 1, max(_server_scan_lengths()), c)]
    return shapes


# the ring tiles scan_route_ab times beside the plan's
SCAN_AB_TILES = (256, 128, 64)


def _scan_ring_choices(S, lead, t, c, dtype, plan) -> dict:
    """The ring shapes scan_route_ab times beside the plan's: the ring
    where the plan takes the thread kernel, each other tile of
    SCAN_AB_TILES at the plan's depth, and the ring tile at half and twice
    its steps a stage."""
    tile = plan.tile or S.RING_TILE
    steps = plan.steps or S.RING_STEPS
    tried = {}
    for name, kw in ([("ring", {})] * (plan.route != "ring")
                     + [(f"tile {w}", dict(tile=w)) for w in SCAN_AB_TILES if w != tile]
                     + [(f"steps {n}", dict(tile=tile, steps=n))
                        for n in (steps // 2, 2 * steps)]):
        try:
            tried[name] = S.scan_plan(lead, t, c, dtype, route="ring", **kw)
        except ValueError:
            pass
    return tried


def scan_route_ab(torch, gen, v1_lib) -> list:
    """The scan at scan_ab_shapes(): the plan's route and the ring shapes
    of _scan_ring_choices against the thread kernel of ``v1_lib`` (scan.cu
    built with -DSCAN_V1), in turns (old, plan, back, then the others),
    every route the old build's bits and the same bits on a second run;
    then the reverse scan against the old composition flip(scan(shift(flip(
    a)), flip(g))) on the old build, in turns, the same bits, and at the
    one-row prefills against the plain version too.  The plan must be no
    more than 3% slower than the old build in either turn at every shape,
    forward and reverse: the readings behind kernels.scan's tile rule and
    ring depth; except the forward where the plan is the thread kernel,
    which is the old build's own kernel from the same source: there the
    bit-for-bit equality with the old build (held for every route) is the
    gate, and both times are kept.  Each forward reading covers at least
    GATE_READ_MS of device time."""
    from minidiff_tpu_torch.kernels import scan as S

    old = lib_at("scan", v1_lib)
    out = []
    for dn, lead, t, c in scan_ab_shapes():
        dtype = getattr(torch, dn)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        a = (torch.rand((lead, t, c), generator=gen, device=DEVICE) * 0.5 + 0.5).to(dtype)
        b = torch.randn((lead, t, c), generator=gen, device=DEVICE).to(dtype)
        plan = S.scan_plan(lead, t, c, dtype)
        plans = {"plan": plan, **_scan_ring_choices(S, lead, t, c, dtype, plan)}
        with built_as("scan", old):
            want = S.scan(a, b).view(bits)

        def run(name):
            if name == "old":
                with built_as("scan", old):
                    return S.scan(a, b)
            return S._launch(a, b, False, plans[name])

        def first(name, got):
            check(torch.equal(got.view(bits), want),
                  f"scan {name} {[lead, t, c]} {dn}: other bits than the -DSCAN_V1 build")
            if name != "old":
                check(torch.equal(run(name).view(bits), want),
                      f"scan {name} {[lead, t, c]} {dn}: a second run gave other bits")

        us = _turns(torch, ("old", *plans), run, first, min_ms=GATE_READ_MS)
        del want

        # the reverse scan, against the composition it replaces
        def run_rev(name):
            if name == "old":
                with built_as("scan", old):
                    return torch.flip(S.scan(S._shift(torch.flip(a, [1])),
                                             torch.flip(b, [1])), [1])
            return S.scan(a, b, reverse=True)

        with built_as("scan", old):
            want = run_rev("old").view(bits)

        def first_rev(name, got):
            check(torch.equal(got.view(bits), want),
                  f"scan reverse {name} {[lead, t, c]} {dn}: other bits than the old "
                  "composition")
            if name != "old":
                check(torch.equal(run_rev(name).view(bits), want),
                      f"scan reverse {[lead, t, c]} {dn}: a second run gave other bits")

        rev = _turns(torch, ("old", "reverse"), run_rev, first_rev)
        if lead == 1:
            check(torch.equal(want, S._plain_scan(a, b, True).view(bits)),
                  f"scan reverse {[lead, t, c]} {dn}: other bits than the plain version")
        del want
        gated = (("plan", us["plan"], us["old"]),) if plan.route != "thread" else ()
        for name, times, old_us in gated + (("reverse", rev["reverse"], rev["old"]),):
            check(max(times) <= 1.03 * min(old_us),
                  f"scan {name} {[lead, t, c]} {dn}: {times} us is more than 3% slower than "
                  f"the old build's {old_us} us")
        out.append(dict(dtype=dn, shape=[lead, t, c], route=plan.route, tile=plan.tile,
                        steps=plan.steps, stages=plan.stages, ctas=plan.ctas, us=us,
                        reverse_us=rev, **bound(3 * lead * t * c * dtype.itemsize,
                                                2 * lead * t * c, "float32")))
        log(f"[scan ab] {dn:8s} {str([lead, t, c]):18s} plan {plan.route} tile {plan.tile} "
            f"{plan.steps}x{plan.stages} | " + " | ".join(
                f"{n} {v[0]:8.2f} / {v[1]:8.2f}" for n, v in us.items())
            + f" us | reverse {rev['reverse'][0]:.2f} / {rev['reverse'][1]:.2f}, old "
            f"composition {rev['old'][0]:.2f} / {rev['old'][1]:.2f} us | bound "
            f"{out[-1]['bound_ms'] * 1e3:.2f} us")
        del a, b
    return out


def wide_norm_case(torch, randn) -> dict:
    """RMSNorm and LayerNorm at d 16,384, wider than the kernels take
    (MAX_WIDTH 8192), forward and backward in bf16: the composed path on the
    card, no launch, equal to the plain version."""
    from minidiff_tpu_torch import kernels as K
    from minidiff_tpu_torch.kernels import layernorm as L

    d = 16384
    check(d > L.MAX_WIDTH, "the wide case must exceed MAX_WIDTH")
    x, dy = (randn(8, d, dtype=torch.bfloat16) for _ in range(2))
    g, b = (1 + 0.1 * randn(d, dtype=torch.bfloat16) for _ in range(2))
    xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, b))
    K.reset_launch_counts()
    y_rms = L.rmsnorm(xl, gl)
    y_ln = L.layernorm(xl, gl, bl)
    torch.autograd.backward((y_rms, y_ln), (dy, dy))
    torch.cuda.synchronize()
    counts = {k: n for k, n in K.launch_counts().items() if n}
    check(counts == {}, f"norms at d {d}: launches {counts}, expected none")
    err = max(max_err(torch, y_rms, L._plain_rmsnorm(x, g), "ln", "bfloat16"),
              max_err(torch, y_ln, L._plain_layernorm(x, g, b), "ln", "bfloat16"))
    log(f"[kernel] rmsnorm / layernorm at d {d} bf16: composed, no launch; err "
        f"vs plain {err:.3g}")
    return dict(d=d, launches=counts, max_abs_err=err)


def bound(nbytes: int, flops: int, dtype_name: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _timed_steps(torch, K, step, state, warmup, steps, expected, label):
    """Run ``state = step(state)`` warm-up then timed; the launches per timed
    step must be exactly ``expected``.  Returns (state, seconds per step,
    launch counts of the timed steps)."""
    for _ in range(warmup):
        state = step(state)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    counts = {k: n for k, n in K.launch_counts().items() if n}
    per_step = {k: n / steps for k, n in counts.items()}
    check(per_step == expected,
          f"{label}: launches per step {per_step}, expected {expected}")
    return state, dt, counts


# ---------------------------------------------------------------------------
# captured decoding against the eager step loop (phases 3, 4 and 7-12)
# ---------------------------------------------------------------------------

# rounds of each decode A/B: captured, eager, then eager, captured, ...
AB_ROUNDS = 2


def clear_programs() -> None:
    """Drop the cached decode programs: each pins its model, its caches and
    its graph's memory, which the next phase needs back."""
    from minidiff_tpu_torch.models import decode, ssm

    decode._decode_cache.clear()
    ssm._ssm_decode_cache.clear()


def eager_generate(torch, model, prompt, new, kv_quant=False):
    """generate_compiled's greedy decode as the eager step loop (the port
    before capture): the prefill, then ``new - 1`` calls of ``_chunk_step``
    launched from Python.  The A/B's other arm: measurement code, not a
    switch of the package."""
    from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill

    prompt = torch.as_tensor(prompt, dtype=torch.long).to(model.device)
    b, s0 = prompt.shape
    L = min(model.max_seq_len, -(-(s0 + new) // 128) * 128)
    with torch.inference_mode():
        caches, logits = _prefill(model, prompt, L, kv_quant=kv_quant)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        pos = torch.full((b,), s0, dtype=torch.long, device=prompt.device)
        for j in range(new - 1):
            logits = _chunk_step(model, caches, tok.reshape(b, 1), pos + j, L)
            tok = torch.argmax(logits[:, 0], dim=-1)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def eager_generate_ssm(torch, model, prompt, new):
    """generate_compiled_ssm's greedy decode as the eager step loop: the
    prefill, then ``new - 1`` calls of ``MambaLM.step`` from Python."""
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(model.device)
    with torch.inference_mode():
        logits, states = model.prefill(prompt)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for _ in range(new - 1):
            logits, states = model.step(states, tok)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def eager_server(torch, srv):
    """``srv`` with its steps run eagerly: ``_device_step`` launched from
    Python on device copies of the step's inputs, no graph (the A/B's other
    arm; measurement code, not a switch of the package)."""
    def run(inputs):
        return srv._device_step(**{k: torch.as_tensor(v).to(srv.device)
                                   for k, v in inputs.items()})

    srv._run_step = run
    return srv


def schedule_on(srv, prompts):
    """run_schedule on ``srv`` from its first slot and lowest page on, so
    that every run of one schedule places its requests alike."""
    srv._free = list(range(srv.max_batch))
    if hasattr(srv, "_free_pages"):
        srv._free_pages.sort()
    return run_schedule(srv, prompts)


def profile_captured(torch, label, run):
    """profile_run of ``run`` after one call outside the profiler, which
    captures whatever ``run`` has not captured yet (a capture inside the
    profiler's window is not measured here)."""
    run()
    torch.cuda.synchronize()
    return profile_run(torch, label, run)


def decode_ab(torch, label, captured, eager, steps: int, tokens: int, generated,
              profiled, gate_repeat: bool = True) -> dict:
    """A decode path captured against its eager step loop in this call.

    ``captured()`` runs the entry point (its programs captured already),
    ``eager()`` the same decode launched step by step from Python; each run
    makes ``tokens`` tokens in ``steps`` decode steps, and ``generated(out)``
    lists a run's generated tokens.  The two arms run in turns for
    AB_ROUNDS rounds (captured, eager, eager, captured).  Then each arm's
    ``profiled`` run, a shorter decode of the same path (``profiled`` is
    (captured run, eager run, its decode steps); a profile's cost grows with
    its events, and an eager step makes hundreds), is profiled once after
    one call outside the profiler.  Gates: exactly one graph replay per
    step and no capture in a captured run, none in an eager one; with
    ``gate_repeat`` every captured run the same tokens.  The agreement of
    the captured tokens with the eager loop's is reported (the f32 paths
    gate it on each request's solo decode, ``eager_generate``).  Returns ms per step and tok/s of
    every timed run, and each arm's profile with its busy share, busy us
    and device calls per decode step (the prefill's share included)."""
    from minidiff_tpu_torch.models import capture

    runs = {"captured": captured, "eager": eager}
    secs = {arm: [] for arm in runs}
    outs = {arm: [] for arm in runs}
    for r in range(AB_ROUNDS):
        for arm in (("captured", "eager") if r % 2 == 0 else ("eager", "captured")):
            torch.cuda.synchronize()
            capture.reset_stats()
            t0 = time.perf_counter()
            outs[arm].append(generated(runs[arm]()))
            torch.cuda.synchronize()
            secs[arm].append(time.perf_counter() - t0)
            got = (capture.STATS["replays"], capture.STATS["captures"])
            want = (steps, 0) if arm == "captured" else (0, 0)
            check(got == want, f"{label} {arm}: {got[0]} graph replays and {got[1]} "
                  f"captures over {steps} steps, expected {want}")
    if gate_repeat:
        check(all(o == outs["captured"][0] for o in outs["captured"]),
              f"{label}: two captured runs at one seed gave other tokens")
    a, b = outs["captured"][0], outs["eager"][0]
    agreement = sum(x == y for x, y in zip(a, b)) / max(1, len(a))
    check(len(a) == len(b) == tokens, f"{label}: {len(a)} / {len(b)} tokens, "
          f"expected {tokens}")
    out = {"steps": steps, "tokens": tokens, "agreement": agreement,
           "replays_per_step": 1.0, "profiled_steps": profiled[2]}
    for arm, run in zip(runs, profiled[:2]):
        prof = profile_captured(torch, f"{label}, {arm}, {profiled[2]} steps", run)
        out[arm] = dict(
            ms_per_step=[t / steps * 1e3 for t in secs[arm]],
            tok_s=[tokens / t for t in secs[arm]],
            busy_share=prof["device_busy_us"] / prof["wall_us"],
            busy_us_per_step=prof["device_busy_us"] / profiled[2],
            device_calls_per_step=prof["device_calls"] / profiled[2], profile=prof)
    cap, eag = out["captured"], out["eager"]
    log(f"[capture] {label}: captured {min(cap['ms_per_step']):.3f} ms/step "
        f"({max(cap['tok_s']):.0f} tok/s, busy {cap['busy_share']:.1%}, "
        f"{cap['device_calls_per_step']:.1f} device calls a step) | eager "
        f"{min(eag['ms_per_step']):.3f} ms/step ({max(eag['tok_s']):.0f} tok/s, busy "
        f"{eag['busy_share']:.1%}, {eag['device_calls_per_step']:.1f} calls a step) | "
        f"runs ms/step captured {[round(t, 3) for t in cap['ms_per_step']]} eager "
        f"{[round(t, 3) for t in eag['ms_per_step']]} | one replay a step; token "
        f"agreement {agreement:.4f}")
    return out


def short_generate(torch, entry, eager, model, prompt, **kw):
    """decode_ab's profiled runs of a compiled decode: 32 new tokens
    through ``entry`` and through ``eager``."""
    return (lambda: entry(model, prompt, 32, device=DEVICE, **kw),
            lambda: eager(torch, model, prompt, 32, **kw), 31)


def short_schedule(srv, eager_srv, prompts):
    """decode_ab's profiled runs of a server: the first four requests at 8
    new tokens each on ``srv`` and on ``eager_srv``, run once here to count
    its steps (and capture any table width the full schedule did not)."""
    short = [(p, min(n, 8)) for p, n in prompts[:4]]
    steps = schedule_on(srv, short)[1]
    return (lambda: schedule_on(srv, short), lambda: schedule_on(eager_srv, short),
            steps)


def captures() -> int:
    """The captures since ``capture.STATS`` was last reset: each one's
    warm-up runs its step once, and those launches count."""
    from minidiff_tpu_torch.models import capture

    return capture.STATS["captures"]


def capture_seconds(torch, run) -> float:
    """Seconds of the captures ``run()`` makes (warm-up and capture)."""
    from minidiff_tpu_torch.models import capture

    torch.cuda.synchronize()
    capture.reset_stats()
    run()
    torch.cuda.synchronize()
    return capture.STATS["capture_seconds"]


# ---------------------------------------------------------------------------
# captured train steps against the eager step (phases 5, 6, 9, 10 and 12)
# ---------------------------------------------------------------------------

# steps in each timed run of a train A/B (AB_ROUNDS runs an arm)
TRAIN_AB_STEPS = 5
# the steps that make a host sync or a host copy inside a capture, each run
# in a child process of its own (capture_refusals): a refused capture can
# leave the process's CUDA generator unusable
REFUSALS = ("train_item", "jit_item", "jit_host_copy")


def model_arms(torch, model, opt, loss_fn, x, y, moe: bool = False):
    """train_ab's arms of ``make_train_step`` on ``model``: each arm trains
    its own copy of the weights as they stand now (the captured arm with
    ``jit=True``, the eager arm with ``jit=False``), one step on (x, y) a
    call, with a new ``opt()``.  ``model``'s gradients are dropped first."""
    import copy

    from minidiff_tpu_torch import make_train_step

    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    init = copy.deepcopy(model)

    def make(arm):
        m = copy.deepcopy(init)
        step = make_train_step(m, opt(), loss_fn=loss_fn, jit=arm == "captured",
                               device=DEVICE, apply_fn=m.forward_with_aux if moe else None)
        return lambda: step(x, y)

    return make


def train_ab(torch, label, make, steps: int = TRAIN_AB_STEPS) -> dict:
    """A train step captured against its eager step in this call.

    ``make(arm)`` gives an arm ("captured" or "eager"): a callable that runs
    one train step from the arm's own state and returns its loss (a device
    tensor); both arms start from the same state.  First each arm's first
    two steps, with the device memory they take beyond what was held before
    them (peak, and held after them) and the capture's seconds (its
    warm-up step included); then AB_ROUNDS timed runs of ``steps`` steps
    an arm in turns (captured, eager, eager, captured); then one profiled
    step of each arm (busy share, busy us and device calls a step).  Gates:
    the captured arm captures once at its first step and replays once a
    step after it, the eager arm neither; every loss finite; the two arms'
    losses bit-equal step for step, or, where they are not, within the
    spread of a second eager run from the same state (the result says
    which)."""
    from minidiff_tpu_torch.models import capture

    arms = {arm: make(arm) for arm in ("captured", "eager")}
    losses = {arm: [] for arm in arms}
    out = {"steps": steps, "rounds": AB_ROUNDS}
    for arm, run in arms.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        capture.reset_stats()
        losses[arm] += [run(), run()]
        torch.cuda.synchronize()
        first = (capture.STATS["captures"], capture.STATS["replays"])
        want = (1, 1) if arm == "captured" else (0, 0)
        check(first == want, f"{label} {arm}: {first[0]} captures and {first[1]} replays "
              f"over its first two steps, expected {want}")
        out[arm] = dict(peak_mib=(torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                        held_mib=(torch.cuda.memory_allocated() - base) / 2 ** 20,
                        capture_seconds=capture.STATS["capture_seconds"], ms_per_step=[])
    for r in range(AB_ROUNDS):
        for arm in (("captured", "eager") if r % 2 == 0 else ("eager", "captured")):
            torch.cuda.synchronize()
            capture.reset_stats()
            t0 = time.perf_counter()
            for _ in range(steps):
                losses[arm].append(arms[arm]())
            torch.cuda.synchronize()
            out[arm]["ms_per_step"].append((time.perf_counter() - t0) / steps * 1e3)
            got = (capture.STATS["replays"], capture.STATS["captures"])
            want = (steps, 0) if arm == "captured" else (0, 0)
            check(got == want, f"{label} {arm}: {got[0]} graph replays and {got[1]} "
                  f"captures over {steps} steps, expected {want}")
    cap, eag = (torch.stack(losses[arm]).double().cpu() for arm in arms)
    check(bool(torch.isfinite(cap).all() and torch.isfinite(eag).all()),
          f"{label}: non-finite losses {cap.tolist()} / {eag.tolist()}")
    diff, spread = (cap - eag).abs().max().item(), 0.0
    out["held"] = "bit-equal"
    if not torch.equal(cap, eag):
        again = make("eager")
        eag2 = torch.stack([again() for _ in range(len(eag))]).double().cpu()
        spread = (eag2 - eag).abs().max().item()
        check(diff <= spread, f"{label}: captured losses differ from the eager run's by "
              f"{diff:.3g}, beyond the spread of two eager runs {spread:.3g}")
        out["held"] = "within the spread of two eager runs"
        del again
    out.update(max_abs_diff=diff, eager_spread=spread, losses_captured=cap.tolist(),
               losses_eager=eag.tolist())
    for arm, run in arms.items():
        prof = profile_run(torch, f"{label}, {arm}, one step", run)
        out[arm].update(busy_share=prof["device_busy_us"] / prof["wall_us"],
                        busy_us_per_step=prof["device_busy_us"],
                        device_calls_per_step=prof["device_calls"], profile=prof)
    c, e = out["captured"], out["eager"]
    log(f"[train_ab] {label}: captured {min(c['ms_per_step']):.3f} ms/step (busy "
        f"{c['busy_share']:.1%}, {c['device_calls_per_step']} device calls a step, "
        f"capture {c['capture_seconds']:.2f} s, peak {c['peak_mib']:.0f} MiB, held "
        f"{c['held_mib']:.0f} MiB) | eager {min(e['ms_per_step']):.3f} ms/step (busy "
        f"{e['busy_share']:.1%}, {e['device_calls_per_step']} calls, peak "
        f"{e['peak_mib']:.0f} MiB, held {e['held_mib']:.0f} MiB) | runs ms/step captured "
        f"{[round(t, 3) for t in c['ms_per_step']]} eager "
        f"{[round(t, 3) for t in e['ms_per_step']]} | {len(cap)} losses {out['held']} "
        f"(max |diff| {diff:.3g}, eager spread {spread:.3g}); one replay a step")
    return out


def refusal_case(torch, case: str) -> int:
    """A child process's one case of capture_refusals: a captured step that
    makes a host sync (``.item()``) or a host-to-device copy (a numpy array
    made a Tensor inside ``fn``).  Its first call runs the step eagerly,
    where both are allowed, then captures it, which must raise.  Prints one
    JSON line; exits 0 where the call raised."""
    import numpy as np

    import minidiff_tpu_torch as md
    from minidiff_tpu_torch import SGD, TransformerLM, lm_loss, make_train_step

    if case == "train_item":
        model = TransformerLM(dtype=torch.float32, device=DEVICE, seed=0, vocab_size=64,
                              dim=128, num_heads=2, num_layers=1, max_seq_len=64)
        toks = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 64))).to(DEVICE)

        def loss_fn(logits, y):
            loss = lm_loss(logits, y)
            return loss if loss.item() >= 0 else -loss  # a host read of the loss

        step = make_train_step(model, SGD(1e-3), loss_fn=loss_fn, device=DEVICE)

        def call():
            return step(toks, toks)
    else:
        md.set_backend(DEVICE)
        x = md.Tensor(np.ones((64, 64)), dtype=md.float32)
        if case == "jit_item":
            def fn(x):
                return x * float(md.sum(x).item())
        else:
            def fn(x):
                return x + md.Tensor(np.ones((64, 64)), dtype=md.float32)
        jitted = md.jit(fn)

        def call():
            return jitted(x)
    try:
        call()
    except Exception as e:  # the refusal this case looks for
        print(json.dumps({"case": case, "raised": True,
                          "error": f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"}))
        return 0
    print(json.dumps({"case": case, "raised": False}))
    return 1


def capture_refusals(torch, report) -> None:
    """Each of REFUSALS in a child process (``--refusal CASE``): the capture
    of a step with a host sync or a host copy must raise on the card."""
    out = {}
    for case in REFUSALS:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--refusal",
                               case], capture_output=True, text=True, timeout=600, cwd=ROOT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {"case": case, "raised": None}
        check(proc.returncode == 0 and res.get("raised") is True,
              f"capture refusal {case}: rc {proc.returncode}, {res}; stderr "
              f"{proc.stderr[-1500:]}")
        out[case] = res
        log(f"[refusal] {case}: the capture raised {res['error']}")
    report["capture_refusals"] = out


# ---------------------------------------------------------------------------
# phase 3: generate_compiled at full width
# ---------------------------------------------------------------------------


def phase_generate(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import TransformerLM, generate_compiled
    from minidiff_tpu_torch import kernels as K

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **MODEL)
    prompt = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        1, MODEL["vocab_size"], size=(BATCH, PROMPT)))
    # the first call captures the step (warm-up: the allocator's pools,
    # cuBLAS handles); the timed one replays it
    cap_s = capture_seconds(torch, lambda: generate_compiled(model, prompt, NEW,
                                                             device=DEVICE))
    out, dt, counts = _counted(torch, K, lambda: generate_compiled(
        model, prompt, NEW, device=DEVICE))
    report["launches_generate"] = K.launch_counts()
    want = {k: n * (NEW if k != "flash_fwd" else 1)
            for k, n in forward_launches(model).items()}
    check(counts == want, f"generate: launches {counts}, expected {want}")
    check(tuple(out.shape) == (BATCH, PROMPT + NEW), f"generate shape {out.shape}")
    check(torch.equal(out[:, :PROMPT].cpu(), prompt), "generate must keep the prompt")
    check(bool(((out >= 0) & (out < MODEL["vocab_size"])).all()), "token out of range")
    tok_s = BATCH * NEW / dt
    report["generate"] = dict(seconds=dt, tok_s=tok_s, ms_per_step=dt / NEW * 1e3,
                              capture_seconds=cap_s)
    log(f"[generate] bf16 V{MODEL['vocab_size']} d{MODEL['dim']} "
        f"L{MODEL['num_layers']} batch {BATCH} prompt {PROMPT} new {NEW}: "
        f"{dt:.3f} s, {tok_s:.0f} tok/s, {dt / NEW * 1e3:.2f} ms/step (captured in "
        f"{cap_s:.3f} s) | launches {report['launches_generate']}")
    report["generate_ab"] = decode_ab(
        torch, "generate bf16", lambda: generate_compiled(model, prompt, NEW, device=DEVICE),
        lambda: eager_generate(torch, model, prompt, NEW), NEW - 1, BATCH * NEW,
        lambda o: o[:, PROMPT:].flatten().tolist(),
        short_generate(torch, generate_compiled, eager_generate, model, prompt))
    # generate_compiled's 32 new tokens, captured
    report["generate_profile"] = report["generate_ab"]["captured"]["profile"]
    if "norm_fwd_v1_libs" in report:  # phase 2 built them (absent in a CPU rehearsal)
        with norm_fwd_v1(report):
            report["generate_profile_norm_fwd_v1"] = profile_captured(
                torch, "generate_compiled 32 new tokens, -DNORM_FWD_V1 norms",
                lambda: generate_compiled(model, prompt, 32, device=DEVICE))


def _flags(args: str) -> list:
    """The bool template arguments of a profiler key's kernel, demangled
    (``<__nv_bfloat16, 2, true, false>``) or mangled (``I13__nv_bfloat16Li2ELb1ELb0E``)."""
    if args.startswith("<"):
        return [a.strip() in ("true", "(bool)1") for a in args[1:-1].split(",")
                if a.strip() in ("true", "false", "(bool)1", "(bool)0")]
    return [b == "1" for b in re.findall(r"Lb([01])E", args)]


def norm_fwd_instance(key: str):
    """The forward norm a profiler key names, as its symbol, with \"+add\"
    for the instantiation that adds the residual (each of NORM_FWD_SYMBOLS
    takes ADD as its last template argument), or None for another kernel.
    The key is demangled (``norm_wave_kernel<__nv_bfloat16, 1, true,
    false>``) or mangled (``norm_wave_kernelI13__nv_bfloat16Li1ELb1ELb0E``)."""
    for sym in NORM_FWD_SYMBOLS:
        m = re.search(rf"(?<![A-Za-z_]){sym}(<[^<>]*>|I.*)", key)
        if m is not None:
            return sym + ("+add" if _flags(m.group(1))[-1:] == [True] else "")
    return None


def bwd_instance(key: str):
    """The redesigned backward (BWD_REDESIGNED) a profiler key's kernel
    serves, or None: xent_bwd for the row and warp kernels; by their RMS and
    ADD flags (their last two template arguments) the ring
    norm_ring_bwd_kernel, its partial rows' sum ring_sum_kernel and the old
    norm_bwd_kernel: rms_bwd for RMS without ADD, ln_bwd for neither,
    addln_bwd for ADD without RMS (addrms_bwd's norm_bwd_kernel is none);
    and the old ln_bwd_kernel by its ADD flag.  Demangled or mangled, as
    norm_fwd_instance reads them."""
    if re.search(r"(?<![A-Za-z_])xent_(row_)?bwd_kernel", key) or xent_fwd_instance(key) is False:
        return "xent_bwd"
    m = re.search(r"(?<![A-Za-z_])(norm_ring_bwd|ring_sum|norm_bwd|ln_bwd)_kernel"
                  r"(<[^<>]*>|I.*)", key)
    if m is None:
        return None
    flags = _flags(m.group(2))
    if m.group(1) == "ln_bwd":
        return "addln_bwd" if flags[-1:] == [True] else "ln_bwd"
    return {(True, False): "rms_bwd", (False, False): "ln_bwd",
            (False, True): "addln_bwd"}.get(tuple(flags[-2:]))


def xent_fwd_instance(key: str):
    """Whether a profiler key's kernel is a forward cross-entropy kernel
    (xent_fwd_kernel, or xent_row_kernel with BWD false: True), the row
    kernel's backward (False), or neither (None); demangled or mangled."""
    if re.search(r"(?<![A-Za-z_])xent_fwd_kernel", key):
        return True
    m = re.search(r"(?<![A-Za-z_])xent_row_kernel(<[^<>]*>|I.*)", key)
    if m is None:
        return None
    return _flags(m.group(1))[-1:] != [True]


def step_group(key: str):
    """The group a profiler key's kernel belongs to in the train profiles'
    ``groups``, or None: "xent_fwd" (the forward cross-entropy's kernels),
    "scan" (scan_kernel and scan_ring_kernel), "flip" (PyTorch's flip
    kernels) and "cat" (its cat kernels)."""
    if xent_fwd_instance(key):
        return "xent_fwd"
    if re.search(r"(?<![A-Za-z_])scan_(ring_)?kernel", key):
        return "scan"
    if "flip" in key:
        return "flip"
    if "CatArray" in key:
        return "cat"
    return None


def profile_run(torch, label, run):
    """Device-busy share and device time by kernel over one run, from
    torch.profiler (kernels on one stream never overlap, so the sum of their
    device times is the busy time).  A first run warms the tracer up and is
    discarded: a window that opens cold loses the device events of its
    first milliseconds.  The profiler places each kernel on the host's
    clock through a mapping that can be off by most of a millisecond (a
    kernel stamped before its own launch) and drops the kernels that then
    fall outside its window, which lost every kernel of a one-step window
    of a few milliseconds: so the profiled run sits between two idle
    pauses of PROFILE_PAD_S, outside its wall time.  A window that still
    sees no device time is profiled once more, then fails the run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def window():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_PAD_S)
            prof.step()
        # device-side kernel events only: operator events carry their
        # kernels' time too, and counting both would count it twice; the
        # schedule's step annotation spans the whole window and is no kernel
        return wall_us, [(e.key, e.self_device_time_total, e.count)
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.self_device_time_total > 0
                         and not e.key.startswith("ProfilerStep")]

    wall_us, rows = window()
    if not rows:
        log(f"[profile] {label}: the profiler saw no device time; once more")
        wall_us, rows = window()
    check(bool(rows), f"profile of {label}: the profiler saw no device time")
    busy_us = sum(r[1] for r in rows)
    calls = sum(r[2] for r in rows)
    by_kind: dict = {}
    for k, t, _ in rows:
        kind = ("ported kernels" if any(n in k for n in PORTED_SYMBOLS)
                else "cuBLAS" if k.startswith("nvjet") or "gemm" in k.lower()
                else "other PyTorch kernels and copies")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    ported = {}  # device us and calls of each ported kernel, by symbol
    for sym in PORTED_SYMBOLS:
        hits = [(t, n) for k, t, n in rows if re.search(rf"\b{sym}\b", k)]
        if hits:
            ported[sym] = [sum(t for t, _ in hits), sum(n for _, n in hits)]
    rows.sort(key=lambda r: -r[1])
    top = [dict(kernel=k[:90], device_us=t, calls=n) for k, t, n in rows[:12]]
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}) in "
        f"{calls} device calls")
    log("[profile]   by kind: " + ", ".join(
        f"{kind} {t / 1e3:.2f} ms" for kind, t in sorted(by_kind.items())))
    for r in top:
        log(f"[profile]   {r['device_us']:9.1f} us {r['calls']:5d} calls  {r['kernel']}")
    log("[profile]   ported: " + ", ".join(
        f"{sym} {us:.1f} us in {n}" for sym, (us, n) in sorted(ported.items())))
    # the forward norms by instantiation: device us and calls of each
    norm_fwd: dict = {}
    for k, t, n in rows:
        inst = norm_fwd_instance(k)
        if inst is not None:
            us, c = norm_fwd.get(inst, (0.0, 0))
            norm_fwd[inst] = [us + t, c + n]
    norms = {inst: us / n for inst, (us, n) in norm_fwd.items()}
    if norms:
        log(f"[profile]   forward norms {sum(us for us, _ in norm_fwd.values()):.1f} us; "
            "device us a call: " + ", ".join(
                f"{inst} {norms[inst]:.2f} in {n}" for inst, (_, n) in sorted(norm_fwd.items())))
    # the redesigned backwards: device us and calls of each
    bwd: dict = {}
    for k, t, n in rows:
        inst = bwd_instance(k)
        if inst is not None:
            us, c = bwd.get(inst, (0.0, 0))
            bwd[inst] = [us + t, c + n]
    if bwd:
        log("[profile]   redesigned backwards: " + ", ".join(
            f"{inst} {us:.1f} us in {n}" for inst, (us, n) in sorted(bwd.items())))
    # step_group's groups: device us and calls of each
    groups: dict = {}
    for k, t, n in rows:
        grp = step_group(k)
        if grp is not None:
            us, c = groups.get(grp, (0.0, 0))
            groups[grp] = [us + t, c + n]
    if groups:
        log("[profile]   groups: " + ", ".join(
            f"{g} {us:.1f} us in {n}" for g, (us, n) in sorted(groups.items())))
    return dict(wall_us=wall_us, device_busy_us=busy_us, device_calls=calls,
                device_us_by_kind=by_kind, top=top, ported=ported,
                norm_fwd=norm_fwd, norm_us_per_call=norms, bwd=bwd, groups=groups)


# ---------------------------------------------------------------------------
# phase 4: the continuous-batching server
# ---------------------------------------------------------------------------


def run_schedule(srv, prompts):
    """Staggered arrivals over more requests than slots: one submit every
    few steps while a slot is free, a batched step, then collect what
    finished (which frees its slot for the next arrival)."""
    pending = list(enumerate(prompts))
    slot_of, results, steps = {}, {}, 0
    while pending or srv.active():
        outstanding = len(slot_of) - len(results)
        if pending and outstanding < srv.max_batch and (
                steps % 4 == 0 or not srv.active()):
            i, (p, n) = pending.pop(0)
            slot_of[i] = srv.submit(p, n, seed=i)
        srv.step()
        steps += 1
        for i, slot in slot_of.items():
            if i not in results and srv.done(slot):
                results[i] = srv.collect(slot)
    return [results[i] for i in range(len(prompts))], steps, len(set(slot_of.values()))


def phase_server(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import DecodeServer, TransformerLM, generate_compiled
    from minidiff_tpu_torch import kernels as K

    rng = np.random.RandomState(seed + 2)
    prompts = [([int(t) for t in rng.randint(1, MODEL["vocab_size"], n)], new)
               for n, new in REQUESTS]
    n_tokens = sum(new for _, new in REQUESTS)

    # f32: the server must reproduce solo decoding token for token, and the
    # captured steps the eager ones
    model = TransformerLM(dtype=torch.float32, device=DEVICE, seed=seed, **MODEL)
    srv = DecodeServer(model, max_batch=8, window=512, device=DEVICE)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got, steps, slots = run_schedule(srv, prompts)
    torch.cuda.synchronize()
    dt32 = time.perf_counter() - t0
    check(slots < len(prompts), "no slot was reused")
    report["launches_server"] = K.launch_counts()
    solo = [generate_compiled(model, [p], n, device=DEVICE)[0, len(p):].tolist()
            for p, n in prompts]
    eager = [eager_generate(torch, model, [p], n)[0, len(p):].tolist()
             for p, n in prompts]
    check(solo == eager, "f32 solo generate_compiled differs from the eager step loop")
    for i, (g, s) in enumerate(zip(got, solo)):
        check(len(g) == REQUESTS[i][1], f"request {i}: {len(g)} tokens")
        if g != s:
            first = next(j for j, (a, b) in enumerate(zip(g, s)) if a != b)
            raise SmokeFailure(f"f32 server request {i} (prompt {REQUESTS[i][0]}) "
                               f"differs from its solo decode at token {first}")
    log(f"[server] f32: {len(REQUESTS)} requests over 8 slots, {steps} steps, "
        f"{n_tokens} tokens in {dt32:.3f} s ({n_tokens / dt32:.0f} tok/s): every "
        f"request token-identical to its solo generate_compiled and to the eager "
        f"step loop | launches {report['launches_server']}")

    # the f32 kernel path against the plain path on the CPU, full width
    toks = torch.from_numpy(rng.randint(1, MODEL["vocab_size"], size=(2, 16)))
    with torch.inference_mode():
        lg = model(toks.to(DEVICE)).float().cpu()
        ref = model.to("cpu")(toks).float()
    err = (lg - ref).abs().max().item()
    # f32 through 4 layers in other summation orders: ~1e-5; a wrong kernel
    # is off by O(1)
    check(err < 1e-3, f"f32 logits GPU vs CPU plain path: max |err| {err:.3g}")
    log(f"[server] f32 logits, kernels on the GPU vs plain path on the CPU: "
        f"max |err| {err:.3g}")
    del model, srv
    clear_programs()

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **MODEL)
    srv = DecodeServer(model, max_batch=8, window=512, device=DEVICE)
    cap_s = capture_seconds(torch, lambda: run_schedule(srv, prompts[:2]))  # warm-up
    t0 = time.perf_counter()
    got, steps, _ = schedule_on(srv, prompts)
    torch.cuda.synchronize()
    dt16 = time.perf_counter() - t0
    solo = [generate_compiled(model, [p], n, device=DEVICE)[0, len(p):].tolist()
            for p, n in prompts]
    same = sum(a == b for g, s in zip(got, solo) for a, b in zip(g, s))
    eager_srv = eager_server(torch, DecodeServer(model, max_batch=8, window=512,
                                                 device=DEVICE))
    schedule_on(eager_srv, prompts[:2])  # warm-up
    bf16_ab = decode_ab(
        torch, "server bf16", lambda: schedule_on(srv, prompts),
        lambda: schedule_on(eager_srv, prompts), steps, n_tokens,
        lambda o: [t for g in o[0] for t in g],
        short_schedule(srv, eager_srv, prompts), gate_repeat=False)
    report["server"] = dict(
        requests=len(REQUESTS), tokens=n_tokens, steps=steps,
        f32_seconds=dt32, f32_tok_s=n_tokens / dt32, bf16_seconds=dt16,
        bf16_tok_s=n_tokens / dt16, bf16_agreement=same / n_tokens,
        f32_logits_max_err_vs_cpu=err, capture_seconds=cap_s, bf16_ab=bf16_ab)
    log(f"[server] bf16: {n_tokens} tokens in {dt16:.3f} s "
        f"({n_tokens / dt16:.0f} tok/s, captured in {cap_s:.3f} s); agreement with "
        f"solo decode {same}/{n_tokens} = {same / n_tokens:.4f}")


# ---------------------------------------------------------------------------
# phase 5: the train step at full width, and the f32 gradient gate
# ---------------------------------------------------------------------------


def phase_train(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import SGD, TransformerLM, lm_loss, make_train_step
    from minidiff_tpu_torch import kernels as K

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed,
                          **TRAIN_MODEL)
    toks = torch.from_numpy(np.random.RandomState(seed + 3).randint(
        0, TRAIN_MODEL["vocab_size"], size=(TRAIN_BATCH, TRAIN_SEQ))).to(DEVICE)
    step = make_train_step(model, SGD(1e-3), loss_fn=lm_loss, device=DEVICE)
    losses, dt, counts = _timed_steps(
        torch, K, lambda losses: losses + [step(toks, toks)], [], TRAIN_WARMUP,
        TRAIN_STEPS, TRAIN_LAUNCHES, "train step")
    report["launches_train"] = {k: counts.get(k, 0) for k in K.launch_counts()}
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    per_step = {k: n / TRAIN_STEPS for k, n in counts.items()}

    # bench.py:683-690: 6*P*T for the parameters' products, forward and
    # backward, plus 3.5 x the causal attention forward's 4*b*h*s^2*hd / 2
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    hd = TRAIN_MODEL["dim"] // TRAIN_MODEL["num_heads"]
    flops = (6 * n_params * tokens + 3.5 * 4 * TRAIN_BATCH * TRAIN_MODEL["num_heads"]
             * TRAIN_SEQ * TRAIN_SEQ * hd / 2)
    report["train"] = dict(
        ms_per_step=dt * 1e3, tok_s=tokens / dt, model_tflop_s=flops / dt / 1e12,
        n_params=n_params, flops_per_step=flops, losses=losses,
        launches_per_step=per_step)
    log(f"[train] bf16 V{TRAIN_MODEL['vocab_size']} d{TRAIN_MODEL['dim']} "
        f"h{TRAIN_MODEL['num_heads']} L{TRAIN_MODEL['num_layers']} batch "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ}, SGD(1e-3), lm_loss: {dt * 1e3:.2f} ms/step "
        f"over {TRAIN_STEPS} steps, {tokens / dt:.0f} tok/s, "
        f"{flops / dt / 1e12:.1f} model TFLOP/s ({n_params / 1e6:.1f}M params)")
    log(f"[train] losses (2 warm-up steps first): "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"[train] launches per step {per_step}")
    report["train_profile"] = profile_run(
        torch, "one train step", lambda: step(toks, toks))
    profile_bwd_v1(torch, report, report, "one train step", lambda: step(toks, toks),
                   ("xent_bwd", "ln_bwd", "addln_bwd"))
    del step
    report.setdefault("train_ab", {})["flagship"] = train_ab(
        torch, "flagship train step",
        model_arms(torch, model, lambda: SGD(1e-3), lm_loss, toks, toks))
    del model

    # f32 gradient gate: the kernel path on the card against the plain path
    # on the CPU, the same weights (drawn from the seed on the CPU)
    gpu = TransformerLM(dtype=torch.float32, device=DEVICE, seed=seed, **TRAIN_MODEL)
    cpu = TransformerLM(dtype=torch.float32, device="cpu", seed=seed, **TRAIN_MODEL)
    t = torch.from_numpy(np.random.RandomState(seed + 4).randint(
        0, TRAIN_MODEL["vocab_size"], size=(1, GATE_SEQ)))
    loss_gpu = lm_loss(gpu(t.to(DEVICE)), t.to(DEVICE))
    loss_gpu.backward()
    loss_cpu = lm_loss(cpu(t), t)
    loss_cpu.backward()
    loss_err = abs(loss_gpu.item() - loss_cpu.item())
    # f32 through 4 layers forward and backward in other summation orders
    # (cuBLAS without TF32 against the CPU): ~1e-6 relative, so 1e-4 holds
    # it with margin; TF32 rounding (~1e-3) or a wrong kernel or a cut
    # gradient (O(1) of the largest value) fails it
    check(loss_err <= 1e-5 * abs(loss_cpu.item()),
          f"f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        ref = cpu_params[name].grad
        check(p.grad is not None and ref is not None, f"no gradient for {name}")
        rel = ((p.grad.cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"f32 gradient of {worst_name} GPU vs CPU: max |err| "
          f"{worst:.3g} of its largest value")
    report["train_gate"] = dict(loss_gpu=loss_gpu.item(), loss_cpu=loss_cpu.item(),
                                worst_grad_rel_err=worst, worst_param=worst_name)
    log(f"[train] f32 gate, batch 1 x {GATE_SEQ}: loss GPU {loss_gpu.item():.6f} "
        f"CPU {loss_cpu.item():.6f}; every gradient within {worst:.3g} of its "
        f"largest value (worst {worst_name})")
    capture_refusals(torch, report)


# ---------------------------------------------------------------------------
# phase 6: the tape engine on the card
# ---------------------------------------------------------------------------


def phase_tape(torch, seed, report):
    import numpy as np

    import minidiff_tpu_torch as md
    from minidiff_tpu_torch import kernels as K

    md.set_backend(DEVICE)
    md.seed(seed)

    # bench.py:196-234: value_and_grad of sum(tanh(x @ w)), SGD
    rng = np.random.RandomState(seed)
    x = md.Tensor(rng.randn(MM_N, MM_N), dtype=md.bfloat16)
    w = md.Tensor(rng.randn(MM_N, MM_N) / np.sqrt(MM_N), dtype=md.bfloat16)
    vag = md.value_and_grad(lambda x, w: md.sum(md.tanh(x @ w)), argnums=(0, 1))

    def mm_core(x, w):
        out, (gx, gw) = vag(x, w)
        return x - MM_LR * gx, w - MM_LR * gw, out

    # the step captured: md.jit, one graph replay a step after the first
    mm_jit = md.jit(mm_core)

    def mm_step(state):
        return mm_jit(*state[:2])

    state, dt, counts = _timed_steps(torch, K, mm_step, (x, w, None), MM_WARMUP,
                                     MM_STEPS, MM_STEP_LAUNCHES, "tape matmul step")
    value = float(state[2].item())
    check(np.isfinite(value), f"tape matmul step: value {value}")
    flops = 3 * 2 * MM_N ** 3  # bench.py:229's count
    report["tape_matmul_step"] = dict(ms_per_step=dt * 1e3, tflop_s=flops / dt / 1e12,
                                      value=value, launches=counts)
    log(f"[tape] matmul step (bench.py) {MM_N}^2 bf16: {dt * 1e3:.3f} ms/step over "
        f"{MM_STEPS} steps, {flops / dt / 1e12:.1f} TFLOP/s, value {value:.6g} | "
        f"launches {counts}")
    report["tape_matmul_profile"] = profile_run(
        torch, "one tape matmul step", lambda: mm_step(state))
    launches = dict(counts)
    del mm_jit, state
    report.setdefault("train_ab", {})["tape_matmul"] = train_ab(
        torch, "tape matmul step (md.jit)", tape_arms(md, mm_core, (x, w)))
    del x, w

    # mlp_bench.py's device-bound MLP on synthetic_classification-style data
    centroids = np.random.RandomState(42).randn(MLP_OUT, MLP_IN)
    rng = np.random.RandomState(seed + 6)
    labels = rng.randint(0, MLP_OUT, MLP_BATCH)
    xs = md.Tensor(centroids[labels] + 0.3 * rng.randn(MLP_BATCH, MLP_IN),
                   dtype=md.float32)
    ys = md.Tensor(labels)
    params = {"w1": rng.randn(MLP_IN, MLP_HIDDEN) / np.sqrt(MLP_IN),
              "b1": np.zeros(MLP_HIDDEN),
              "w2": rng.randn(MLP_HIDDEN, MLP_OUT) / np.sqrt(MLP_HIDDEN),
              "b2": np.zeros(MLP_OUT)}
    params = params0 = {k: md.Tensor(v, dtype=md.float32) for k, v in params.items()}

    def mlp_loss(p, x, y):
        h = md.maximum(x @ p["w1"] + p["b1"], 0.0)
        logits = h @ p["w2"] + p["b2"]
        return md.mean(md.softmax_xent(logits, y))

    mlp_vag = md.value_and_grad(mlp_loss)

    def mlp_core(p, x, y):
        loss, g = mlp_vag(p, x, y)
        return {k: p[k] - MLP_LR * g[k] for k in p}, loss

    mlp_jit = md.jit(mlp_core)

    def mlp_step(state):
        p, history = state
        p, loss = mlp_jit(p, xs, ys)
        return p, history + [loss]

    (params, losses), dt, counts = _timed_steps(
        torch, K, mlp_step, (params, []), 1, MLP_STEPS, MLP_STEP_LAUNCHES,
        "tape MLP step")
    losses = [float(t.item()) for t in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"tape MLP: the loss must fall, got {losses}")
    flops = 6 * MLP_BATCH * (MLP_IN * MLP_HIDDEN + MLP_HIDDEN * MLP_OUT)
    report["tape_mlp"] = dict(ms_per_step=dt * 1e3, steps_per_s=1 / dt,
                              model_tflop_s=flops / dt / 1e12, losses=losses,
                              launches=counts)
    log(f"[tape] MLP (mlp_bench.py) batch {MLP_BATCH} {MLP_IN}->{MLP_HIDDEN}->"
        f"{MLP_OUT} f32 SGD {MLP_LR}: {dt * 1e3:.3f} ms/step ({1 / dt:.1f} steps/s, "
        f"{flops / dt / 1e12:.1f} model TFLOP/s) | losses "
        + " ".join(f"{v:.4f}" for v in losses) + f" | launches {counts}")
    report["tape_mlp_profile"] = profile_run(
        torch, "one tape MLP step", lambda: mlp_step((params, [])))
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    report["launches_tape"] = {k: launches.get(k, 0) for k in K.launch_counts()}
    del mlp_jit
    report["train_ab"]["tape_mlp"] = train_ab(
        torch, "tape MLP step (md.jit)",
        tape_arms(md, lambda p: mlp_core(p, xs, ys), (params0,)))
    del xs, ys, params, params0
    tape_rng(torch, md, report)

    tape_gate(torch, md, seed, report)
    tape_closed_forms(torch, md, report)


def tape_arms(md, core, state0):
    """train_ab's arms of a functional tape step ``core(*state) -> (*state,
    loss)``: the captured arm runs ``md.jit(core)``, the eager arm ``core``,
    each from ``state0``; a call runs one step and returns the loss's
    device tensor."""
    def make(arm):
        fn = md.jit(core) if arm == "captured" else core
        state = list(state0)

        def run():
            *state[:], loss = fn(*state)
            return loss._data

        return run

    return make


def tape_rng(torch, md, report):
    """A draw from the tape's generator inside md.jit on the card: the
    capture registers the generator with its graph, so every call draws
    anew, the same numbers as the eager function's calls from the same
    seed (the JAX package bakes such a draw in as a constant)."""
    import numpy as np

    x = md.Tensor(torch.zeros(4, 4, device=DEVICE))

    def fn(x):
        return x + md.randn(4, 4)

    runs = {}
    for name, f in (("eager", fn), ("jit", md.jit(fn))):
        md.seed(11)
        runs[name] = [np.asarray(f(x)) for _ in range(4)]
    fresh = all(not np.array_equal(a, b) for a, b in zip(runs["jit"], runs["jit"][1:]))
    same = all(np.array_equal(a, b) for a, b in zip(runs["jit"], runs["eager"]))
    check(fresh and same, f"md.jit draws: fresh each call {fresh}, the eager draws {same}")
    report["tape_rng"] = dict(fresh_each_call=fresh, equal_to_eager=same)
    log("[tape] md.jit of a draw from md.randn: a fresh draw each replay, the eager "
        "function's numbers from the same seed")


def tape_gate(torch, md, seed, report):
    """value_and_grad and an hvp of sum(tanh(x @ w)) at 2048^2 f32: the
    kernels on the card (the hvp re-tapes the matmul VJPs, so they run
    inside a second-order sweep too) against the same tape on the CPU.  f32
    in other summation orders: ~1e-6 relative; TF32 (~1e-3) fails it."""
    import numpy as np

    rng = np.random.RandomState(seed + 5)
    n = TAPE_GATE_N
    xv, vv = (rng.randn(n, n).astype(np.float32) for _ in range(2))
    wv = (rng.randn(n, n) / np.sqrt(n)).astype(np.float32)

    def run():
        x, w, v = md.Tensor(xv), md.Tensor(wv), md.Tensor(vv)
        value, (gx, gw) = md.value_and_grad(
            lambda x, w: md.sum(md.tanh(x @ w)), argnums=(0, 1))(x, w)
        hv = md.hvp(lambda x: md.sum(md.tanh(x @ w)))(x, v)
        return [np.asarray(t) for t in (value, gx, gw, hv)]

    from minidiff_tpu_torch import kernels as K

    K.reset_launch_counts()
    card = run()
    counts = {k: c for k, c in K.launch_counts().items() if c}
    check(all(counts.get(k, 0) > 0 for k in TAPE_ONLY),
          f"tape gate: every matmul kernel must run, got {counts}")
    with md.use_backend("cpu"):
        cpu = run()
    value_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    check(value_err <= 1e-5, f"tape gate: value card {card[0]} cpu {cpu[0]}")
    errs = {}
    for name, c, r in zip(("gx", "gw", "hvp"), card[1:], cpu[1:]):
        errs[name] = float(np.abs(c - r).max() / np.abs(r).max())
        check(errs[name] <= 1e-4, f"tape gate: {name} off by {errs[name]:.3g} "
              "of its largest value")
    report["tape_gate"] = dict(value_card=float(card[0]), value_cpu=float(cpu[0]),
                               value_rel_err=value_err, rel_errs=errs,
                               launches=counts)
    log(f"[tape] f32 gate {n}^2: value card {float(card[0]):.6f} cpu "
        f"{float(cpu[0]):.6f} (rel {value_err:.3g}); gx / gw / hvp within "
        + " / ".join(f"{e:.3g}" for e in errs.values())
        + f" of their largest values | launches {counts}")


def tape_closed_forms(torch, md, report):
    """The README demo (first and second order) and the 64-dim Rosenbrock
    md.hessian on the card, in f64 (torch ops and torch.matmul), against
    their closed forms; wall time and device busy time of each."""
    import numpy as np

    xv = np.array([[0, 2, -2, 1], [-1, -1, -2, -2]])
    yv = np.array([[2, 3, 4, 5], [0, -1, -3, 2]])

    def demo():
        x = md.Tensor(xv, allow_grad=True)
        y = md.Tensor(yv, allow_grad=True)
        f = 2 * y * md.sin(x) - x ** 2
        f.backward(allow_higher_order=True)
        first = (np.asarray(x.grad), np.asarray(y.grad))
        x.grad.backward()
        return (*first, np.asarray(x.grad), np.asarray(y.grad))

    def rosen(t):
        return md.sum(100.0 * (t[1:] - t[:-1] ** 2) ** 2 + (1.0 - t[:-1]) ** 2)

    x0 = np.linspace(-1.2, 1.2, HESS_N)

    def hessian():
        h = md.hessian(rosen)(md.Tensor(x0))
        return np.asarray(h)

    want = np.zeros((HESS_N, HESS_N))
    for i in range(HESS_N - 1):
        want[i, i] += 1200 * x0[i] ** 2 - 400 * x0[i + 1] + 2
        want[i + 1, i + 1] += 200
        want[i, i + 1] = want[i + 1, i] = -400 * x0[i]
    closed = [2 * yv * np.cos(xv) - 2 * xv, 2 * np.sin(xv),
              -2 * yv * np.sin(xv) - 2, 2 * np.cos(xv)]
    out = {}
    for name, fn, ref in (("readme_demo", demo, closed),
                          ("rosenbrock_hessian", hessian, [want])):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
        check(err <= 1e-10, f"tape {name}: max |err| {err:.3g} against the closed form")
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_run(torch, f"tape {name}", fn)
        out[name] = dict(max_abs_err=err, wall_ms=wall_ms, profile=prof)
        log(f"[tape] {name} f64 on the card: max |err| {err:.3g} against the "
            f"closed form; {wall_ms:.2f} ms wall")
    report["tape_closed_forms"] = out


# ---------------------------------------------------------------------------
# phase 7: quantized decode
# ---------------------------------------------------------------------------


def _counted(torch, K, run):
    """(result, seconds, nonzero launch counts) of ``run()`` from reset
    counters (the launch counts and ``capture.STATS``), synchronised."""
    from minidiff_tpu_torch.models import capture

    torch.cuda.synchronize()
    K.reset_launch_counts()
    capture.reset_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: n for k, n in K.launch_counts().items() if n}


def decode_launches(dq: str, new: int, prefill_dq: int, kv_quant: bool) -> dict:
    """The launches of one generate_compiled of ``new`` tokens: the prefill
    (4 ln1 + ln_f, 4 add+LN, 4 flash, ``prefill_dq`` projections through the
    kernel), then per decode step 5 LN, 4 add+LN, DQ_PER_STEP dequant
    products and, with kv_quant, SDPA8_PER_STEP int8-cache attentions."""
    steps = new - 1
    want = {"ln_fwd": 5 * new, "addln_fwd": 4 * new, "flash_fwd": 4,
            dq: prefill_dq + DQ_PER_STEP * steps}
    if kv_quant:
        want["sdpa_int8"] = SDPA8_PER_STEP * steps
    return want


def phase_quant(torch, seed: int, report):
    import copy

    import numpy as np

    from minidiff_tpu_torch import (TransformerLM, generate_compiled,
                                    quantize_for_serving, quantized_bytes)
    from minidiff_tpu_torch import kernels as K

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **MODEL)
    q8 = quantize_for_serving(model)
    q4 = quantize_for_serving(model, bits=4)
    weight_bytes = {"bf16": quantized_bytes(model), "int8": quantized_bytes(q8),
                    "int4": quantized_bytes(q4)}
    del model
    prompt = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        1, MODEL["vocab_size"], size=(BATCH, PROMPT)))
    out = {"weight_bytes": weight_bytes}
    launches: dict = {}
    toks = {}
    # the bench prefill's 8 x 16 rows take the kernel (<= 256 rows)
    for label, qm, dq, kv_quant in (("int8", q8, "dq_mm", False),
                                    ("int4", q4, "dq4_mm", False),
                                    ("int8_kv", q8, "dq_mm", True)):
        run = (lambda qm=qm, kv_quant=kv_quant: generate_compiled(
            qm, prompt, NEW, device=DEVICE, kv_quant=kv_quant))
        cap_s = capture_seconds(torch, run)  # the capture, and the warm-up
        toks[label], dt, counts = _counted(torch, K, run)
        want = decode_launches(dq, NEW, DQ_PER_STEP, kv_quant)
        check(counts == want, f"quant {label}: launches {counts}, expected {want}")
        check(tuple(toks[label].shape) == (BATCH, PROMPT + NEW)
              and bool(((toks[label] >= 0) & (toks[label] < MODEL["vocab_size"])).all()),
              f"quant {label}: tokens {tuple(toks[label].shape)} out of range")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        out[label] = dict(seconds=dt, tok_s=BATCH * NEW / dt, ms_per_step=dt / NEW * 1e3,
                          launches=counts, capture_seconds=cap_s, launches_per_step={
                              dq: DQ_PER_STEP, **({"sdpa_int8": SDPA8_PER_STEP}
                                                  if kv_quant else {})})
        out[label]["ab"] = decode_ab(
            torch, f"quant {label}", run,
            lambda qm=qm, kv_quant=kv_quant: eager_generate(torch, qm, prompt, NEW,
                                                            kv_quant=kv_quant),
            NEW - 1, BATCH * NEW, lambda o: o[:, PROMPT:].flatten().tolist(),
            short_generate(torch, generate_compiled, eager_generate, qm, prompt,
                           kv_quant=kv_quant))
        log(f"[quant] {label} bf16 batch {BATCH} prompt {PROMPT} new {NEW}: "
            f"{dt:.3f} s, {BATCH * NEW / dt:.0f} tok/s, {dt / NEW * 1e3:.2f} ms/step "
            f"| per step {out[label]['launches_per_step']} | launches {counts}")
    # an int8 cache is deterministic per seed; its agreement with the bf16
    # cache is reported, not gated (quantization can flip a near-tie)
    again = generate_compiled(q8, prompt, NEW, device=DEVICE, kv_quant=True)
    check(torch.equal(again, toks["int8_kv"]), "kv_quant decode is not deterministic")
    agree = (toks["int8_kv"][:, PROMPT:] == toks["int8"][:, PROMPT:]).float().mean().item()
    out["int8_kv_agreement_with_int8"] = agree
    log(f"[quant] weight bytes bf16 {weight_bytes['bf16']:,} int8 "
        f"{weight_bytes['int8']:,} ({weight_bytes['int8'] / weight_bytes['bf16']:.3f}x) "
        f"int4 {weight_bytes['int4']:,} ({weight_bytes['int4'] / weight_bytes['bf16']:.3f}x); "
        f"int8-cache tokens equal to the bf16 cache's: {agree:.4f}")
    # the int8 and int4 decodes' 32 new tokens, captured; the int4 decode
    # on the tensor-core tiles, then on the SIMT tile
    out["profile"] = out["int8"]["ab"]["captured"]["profile"]
    out["profile_int4"] = out["int4"]["ab"]["captured"]["profile"]
    if "simt_quant_lib" in report:  # phase 2 built it (absent in a CPU rehearsal)
        with built_as("quant", lib_at("quant", report["simt_quant_lib"])):
            out["profile_int4_simt"] = profile_captured(
                torch, "int4 generate_compiled 32 new tokens, SIMT tile",
                lambda: generate_compiled(q4, prompt, 32, device=DEVICE))
    del q8, q4
    clear_programs()

    # the int8 KV cache at long context (bench.py:413-443): the prefill's
    # 15,872 rows take the plain product on the dequantized weight, its
    # head (4 rows) the kernel
    lc = quantize_for_serving(TransformerLM(
        dtype=torch.bfloat16, device=DEVICE, seed=seed + 4,
        **dict(MODEL, max_seq_len=LC_SEQ)))
    prompt_lc = torch.from_numpy(np.random.RandomState(seed + 5).randint(
        1, MODEL["vocab_size"], size=(LC_BATCH, LC_PROMPT)))
    lc_out = {}
    for label, kv_quant in (("int8", False), ("int8_kv", True)):
        run = (lambda kv_quant=kv_quant: generate_compiled(
            lc, prompt_lc, LC_NEW, device=DEVICE, kv_quant=kv_quant))
        cap_s = capture_seconds(torch, run)
        lc_out[label], dt, counts = _counted(torch, K, run)
        want = decode_launches("dq_mm", LC_NEW, 1, kv_quant)
        check(counts == want, f"quant 4k {label}: launches {counts}, expected {want}")
        out[f"4k_{label}"] = dict(seconds=dt, tok_s=LC_BATCH * LC_NEW / dt,
                                  ms_per_token=dt / LC_NEW * 1e3, launches=counts,
                                  capture_seconds=cap_s)
        out[f"4k_{label}"]["ab"] = decode_ab(
            torch, f"quant 4k {label} (prefill included)", run,
            lambda kv_quant=kv_quant: eager_generate(torch, lc, prompt_lc, LC_NEW,
                                                     kv_quant=kv_quant),
            LC_NEW - 1, LC_BATCH * LC_NEW, lambda o: o[:, LC_PROMPT:].flatten().tolist(),
            (run, lambda kv_quant=kv_quant: eager_generate(
                torch, lc, prompt_lc, LC_NEW, kv_quant=kv_quant), LC_NEW - 1))
        log(f"[quant] 4k {label}: batch {LC_BATCH} prompt {LC_PROMPT} new {LC_NEW}: "
            f"{dt:.3f} s with the prefill, {LC_BATCH * LC_NEW / dt:.0f} tok/s")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    out["4k_int8_kv_agreement_with_int8"] = (
        lc_out["int8_kv"][:, LC_PROMPT:] == lc_out["int8"][:, LC_PROMPT:]).float().mean().item()
    del lc
    clear_programs()

    # f32 gate: the same codes on the card and on the CPU (quantized once,
    # then moved), the kernels against the plain path, full width
    cpu = TransformerLM(dtype=torch.float32, device="cpu", seed=seed, **MODEL)
    gate_toks = torch.from_numpy(np.random.RandomState(seed + 6).randint(
        1, MODEL["vocab_size"], size=(2, 16)))
    errs = {}
    for bits in (8, 4):
        qcpu = quantize_for_serving(cpu, bits=bits)
        qgpu = copy.deepcopy(qcpu).to(DEVICE)
        K.reset_launch_counts()
        with torch.inference_mode():
            lg = qgpu(gate_toks.to(DEVICE)).float().cpu()
            ref = qcpu(gate_toks).float()
        used = {k: n for k, n in K.launch_counts().items() if n}
        check(used.get("dq_mm" if bits == 8 else "dq4_mm", 0) == DQ_PER_STEP,
              f"quant gate int{bits}: launches {used}")
        errs[f"int{bits}"] = (lg - ref).abs().max().item()
        # f32 through 4 layers in other summation orders: ~1e-5; a wrong
        # kernel is off by O(1)
        check(errs[f"int{bits}"] < 1e-3, f"f32 int{bits} logits GPU vs CPU: max "
              f"|err| {errs[f'int{bits}']:.3g}")
    out["f32_logits_max_err_vs_cpu"] = errs
    log(f"[quant] f32 logits of the quantized model, kernels on the GPU vs plain "
        f"path on the CPU (same codes): max |err| int8 {errs['int8']:.3g}, "
        f"int4 {errs['int4']:.3g}")
    report["quant"] = out
    report["launches_quant"] = {k: launches.get(k, 0) for k in K.launch_counts()}


# ---------------------------------------------------------------------------
# phase 8: the paged server
# ---------------------------------------------------------------------------


def phase_paged(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import (DecodeServer, PagedDecodeServer, TransformerLM,
                                    generate_compiled)
    from minidiff_tpu_torch import kernels as K

    rng = np.random.RandomState(seed + 2)
    prompts = [([int(t) for t in rng.randint(1, MODEL["vocab_size"], n)], new)
               for n, new in REQUESTS]
    n_tokens = sum(new for _, new in REQUESTS)
    # requests whose decode crosses into a page their bucketed prompt did
    # not take
    crossings = sum(-(-(n + new - 1) // 128) > -(-n // 128) for n, new in REQUESTS)
    check(crossings > 0, "no request crosses a page boundary")

    # f32: every request token-identical to its solo decode
    model = TransformerLM(dtype=torch.float32, device=DEVICE, seed=seed, **MODEL)
    srv = PagedDecodeServer(model, max_batch=8, window=512, device=DEVICE)
    gaps = []
    step = srv.step

    def spy():
        # the smallest top-2 logit gap of the live slots at every step
        live = [s for s in range(srv.max_batch)
                if s not in srv._free and srv._budget[s] > 0]
        out = step()
        if live:
            top = srv.last_logits[live].float().topk(2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
        return out

    srv.step = spy
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got, steps, slots = run_schedule(srv, prompts)
    torch.cuda.synchronize()
    dt32 = time.perf_counter() - t0
    report["launches_paged"] = K.launch_counts()
    check(slots < len(prompts), "no slot was reused")
    check(srv.pages_in_use() == 0, f"{srv.pages_in_use()} pages not released")
    solo = [generate_compiled(model, [p], n, device=DEVICE)[0, len(p):].tolist()
            for p, n in prompts]
    eager = [eager_generate(torch, model, [p], n)[0, len(p):].tolist()
             for p, n in prompts]
    check(solo == eager, "f32 solo generate_compiled differs from the eager step loop")
    for i, (g, s) in enumerate(zip(got, solo)):
        check(len(g) == REQUESTS[i][1], f"paged request {i}: {len(g)} tokens")
        if g != s:
            first = next(j for j, (a, b) in enumerate(zip(g, s)) if a != b)
            raise SmokeFailure(f"f32 paged request {i} (prompt {REQUESTS[i][0]}) "
                               f"differs from its solo decode at token {first}")
    min_gap = torch.cat(gaps).min().item()
    log(f"[paged] f32: {len(REQUESTS)} requests over 8 slots, {steps} steps, "
        f"{crossings} page-boundary crossings, {n_tokens} tokens in {dt32:.3f} s: "
        f"every request token-identical to its solo generate_compiled; smallest "
        f"top-2 logit gap {min_gap:.3g} | launches {report['launches_paged']}")
    del model, srv
    clear_programs()

    # bf16: paged against dense at equal batch (serving_bench.paged_vs_dense)
    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed,
                          **dict(MODEL, max_seq_len=PAGED_SEQ))
    rng = np.random.RandomState(0)
    bench_prompts = [[int(t) for t in rng.randint(1, MODEL["vocab_size"], PAGED_PROMPT)]
                     for _ in range(PAGED_SLOTS)]

    def setup(cls, **kw):
        srv = cls(model, max_batch=PAGED_SLOTS, window=PAGED_SEQ, device=DEVICE, **kw)
        for p in bench_prompts:
            srv.submit(p, max_new_tokens=PAGED_SEQ - PAGED_PROMPT - 2)
        return srv

    servers = {"dense": setup(DecodeServer), "paged": setup(PagedDecodeServer),
               "paged_oversub": setup(PagedDecodeServer, num_pages=max(
                   PAGED_SLOTS + 1, PAGED_SLOTS * (PAGED_SEQ // 128) // 4)),
               "dense_eager": eager_server(torch, setup(DecodeServer)),
               "paged_eager": eager_server(torch, setup(PagedDecodeServer))}
    times = {name: [] for name in servers}
    cap_s = {name: capture_seconds(torch, srv.step)  # warm-up; the capture
             for name, srv in servers.items()}
    for _ in range(PAGED_ROUNDS):  # in turns, so that drift cancels
        for name, srv in servers.items():
            _, dt, counts = _timed_steps(
                torch, K, lambda _: srv.step(), None, 0, PAGED_STEPS,
                DENSE_STEP_LAUNCHES if name.startswith("dense") else PAGED_STEP_LAUNCHES,
                f"{name} server step")
            times[name].append(dt)
    tok_s = {name: PAGED_SLOTS / min(ts) for name, ts in times.items()}
    # 2 x 4 profiled steps keep every slot within its first page (16 + 1 +
    # 3 x 32 + 8 positions), so the profile replays and never captures
    step_profile = profile_run(torch, "4 paged server steps",
                               lambda: [servers["paged"].step() for _ in range(4)])
    eager_profile = profile_run(torch, "4 paged server steps, eager",
                                lambda: [servers["paged_eager"].step() for _ in range(4)])
    kv = {name: (srv.kv_bytes() if name.startswith("paged") else sum(
        t.numel() * t.element_size() for c in srv._caches for t in c.values()))
        for name, srv in servers.items()}
    pages = {name: srv.pages_in_use() for name, srv in servers.items()
             if name.startswith("paged")}

    # pool exhaustion: at submit, and mid-decode when a step crosses a page
    errors = []
    for num_pages, prompt_len, run in ((2, 130, "submit"), (1, 126, "step")):
        srv = PagedDecodeServer(model, max_batch=2, window=PAGED_SEQ,
                                num_pages=num_pages, device=DEVICE)
        srv.submit((bench_prompts[0] * 9)[:prompt_len], max_new_tokens=8)
        try:
            if run == "submit":
                srv.submit(bench_prompts[1], max_new_tokens=8)
            else:
                while srv.active():
                    srv.step()
        except RuntimeError as e:
            errors.append(str(e))
            continue
        raise SmokeFailure(f"an exhausted page pool did not raise at {run}")
    check(all("page pool exhausted" in e for e in errors), f"exhaustion: {errors}")
    report["paged"] = dict(
        requests=len(REQUESTS), tokens=n_tokens, steps=steps, crossings=crossings,
        f32_seconds=dt32, f32_min_top2_gap=min_gap, bf16_step_ms={
            name: [t * 1e3 for t in ts] for name, ts in times.items()},
        bf16_tok_s=tok_s, paged_vs_dense=tok_s["paged"] / tok_s["dense"],
        kv_bytes=kv, pages_in_use=pages, exhaustion=errors, profile=step_profile,
        eager_profile=eager_profile, capture_seconds=cap_s,
        captured_vs_eager={"dense": tok_s["dense"] / tok_s["dense_eager"],
                           "paged": tok_s["paged"] / tok_s["paged_eager"]})
    log(f"[paged] bf16 {PAGED_SLOTS} slots window {PAGED_SEQ}, {PAGED_STEPS} steps x "
        f"{PAGED_ROUNDS} rounds in turns: dense {tok_s['dense']:.0f} tok/s, paged "
        f"{tok_s['paged']:.0f} tok/s ({tok_s['paged'] / tok_s['dense']:.3f}x), "
        f"oversubscribed {tok_s['paged_oversub']:.0f} tok/s; eager steps dense "
        f"{tok_s['dense_eager']:.0f} paged {tok_s['paged_eager']:.0f} tok/s | kv bytes dense "
        f"{kv['dense']:,} paged {kv['paged']:,} oversubscribed {kv['paged_oversub']:,} "
        f"({kv['paged_oversub'] / kv['dense']:.3f}x) | pages in use {pages} | pool "
        f"exhaustion raised at submit and mid-decode")


# ---------------------------------------------------------------------------
# phase 9: the LLaMA-style options at Mistral-7B-v0.3's widths
# ---------------------------------------------------------------------------


def forward_launches(model) -> dict:
    """The kernel launches of one forward of ``model``, read off its
    modules: a norm forward for each LayerNorm or RMSNorm used alone (ln1 of
    each block, ln_f), a fused add+norm for each block's ln2
    (residual_norm), a flash forward for each attention, a ``dq_mm`` for each
    int8 Linear and two ``dq_bmm`` for each int8 expert bank (routing C <=
    256 rows per expert)."""
    from minidiff_tpu_torch.models.layers import Linear
    from minidiff_tpu_torch.models.moe import Experts
    from minidiff_tpu_torch.models.transformer import (LayerNorm,
                                                       MultiHeadAttention, RMSNorm)

    out = {}
    for cls, alone, fused in ((LayerNorm, "ln_fwd", "addln_fwd"),
                              (RMSNorm, "rms_fwd", "addrms_fwd")):
        names = [n for n, m in model.named_modules() if isinstance(m, cls)]
        out[fused] = sum(n.endswith(".ln2") for n in names)
        out[alone] = len(names) - out[fused]
    mods = list(model.modules())
    out["flash_fwd"] = sum(isinstance(m, MultiHeadAttention) for m in mods)
    out["dq_mm"] = sum(isinstance(m, Linear) and m.w_q is not None for m in mods)
    out["dq_bmm"] = 2 * sum(isinstance(m, Experts) and m.w1_q is not None
                            for m in mods)
    return {k: n for k, n in out.items() if n}


_BACKWARD = {"ln_fwd": ("ln_bwd",), "addln_fwd": ("addln_bwd",),
             "rms_fwd": ("rms_bwd",), "addrms_fwd": ("addrms_bwd",),
             "flash_fwd": ("flash_bwd_dkv", "flash_bwd_dq")}


def train_launches(model) -> dict:
    """The launches of one train step: the forward's, the loss, and one
    backward kernel for each forward kernel."""
    fwd = forward_launches(model)
    out = {**fwd, "xent_fwd": 1, "xent_bwd": 1}
    for k, n in fwd.items():
        for b in _BACKWARD[k]:
            out[b] = n
    return out


def _f32_prefix(torch, model, layers: int):
    """A float32 copy of ``model`` cut to its first ``layers`` blocks."""
    import copy

    out = copy.deepcopy(model)
    del out.blocks[layers:]
    out.dtype = torch.float32
    return out.float()


def phase_options(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import (SGD, DecodeServer, TransformerLM,
                                    generate_compiled, lm_loss, make_train_step)
    from minidiff_tpu_torch import kernels as K
    from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill

    cfg = OPT_MODEL
    t0 = time.perf_counter()
    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **cfg)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[options] Mistral-7B-v0.3 widths, {cfg['num_layers']} layers, bf16: "
        f"{n_params / 1e6:.1f}M parameters drawn in {init_s:.1f} s")
    out = {"n_params": n_params, "init_seconds": init_s}
    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # generate_compiled at bench.py:311-323's shape
    fwd = forward_launches(model)
    prompt = torch.from_numpy(np.random.RandomState(seed + 7).randint(
        1, cfg["vocab_size"], size=(BATCH, PROMPT)))
    run = lambda: generate_compiled(model, prompt, NEW, device=DEVICE)  # noqa: E731
    cap_s = capture_seconds(torch, run)  # the capture, and the warm-up
    toks, dt, counts = _counted(torch, K, run)
    # the prefill runs every forward kernel once, each decode step all but flash
    want = {k: n * (NEW if k != "flash_fwd" else 1) for k, n in fwd.items()}
    check(counts == want, f"options generate: launches {counts}, expected {want}")
    check(tuple(toks.shape) == (BATCH, PROMPT + NEW)
          and bool(((toks >= 0) & (toks < cfg["vocab_size"])).all()),
          f"options generate: tokens {tuple(toks.shape)} out of range")
    add(counts)
    out["generate"] = dict(seconds=dt, tok_s=BATCH * NEW / dt,
                           ms_per_step=dt / NEW * 1e3, launches=counts,
                           capture_seconds=cap_s)
    log(f"[options] generate_compiled batch {BATCH} prompt {PROMPT} new {NEW}: "
        f"{dt:.3f} s, {BATCH * NEW / dt:.0f} tok/s, {dt / NEW * 1e3:.2f} ms/step "
        f"(captured in {cap_s:.3f} s) | launches {counts}")
    out["generate_ab"] = decode_ab(
        torch, "options generate bf16", run,
        lambda: eager_generate(torch, model, prompt, NEW), NEW - 1, BATCH * NEW,
        lambda o: o[:, PROMPT:].flatten().tolist(),
        short_generate(torch, generate_compiled, eager_generate, model, prompt))
    # the options decode's 32 new tokens, captured
    out["generate_profile"] = out["generate_ab"]["captured"]["profile"]
    if "norm_fwd_v1_libs" in report:  # phase 2 built them (absent in a CPU rehearsal)
        with norm_fwd_v1(report):
            out["generate_profile_norm_fwd_v1"] = profile_captured(
                torch, "options generate_compiled 32 new tokens, -DNORM_FWD_V1 norms",
                lambda: generate_compiled(model, prompt, 32, device=DEVICE))

    # the server: phase 4's staggered schedule on 8 slots, window 1024
    rng = np.random.RandomState(seed + 8)
    prompts = [([int(t) for t in rng.randint(1, cfg["vocab_size"], n)], new)
               for n, new in REQUESTS]
    n_tokens = sum(new for _, new in REQUESTS)
    srv = DecodeServer(model, max_batch=8, window=cfg["max_seq_len"], device=DEVICE)
    srv_cap_s = capture_seconds(torch, lambda: run_schedule(srv, prompts[:2]))  # warm-up
    (got, steps, slots), dt, counts = _counted(torch, K, lambda: schedule_on(
        srv, prompts))
    check(slots < len(prompts), "options server: no slot was reused")
    # every request's prefill runs each forward kernel once, and every step
    # (each finds a live slot: run_schedule submits whenever none is) the
    # norms again
    want = {k: n * (len(REQUESTS) + (steps if k != "flash_fwd" else 0))
            for k, n in fwd.items()}
    check(counts == want, f"options server: launches {counts}, expected {want}")
    add(counts)
    kv_bytes = sum(t.numel() * t.element_size() for c in srv._caches
                   for t in c.values())
    mha_bytes = kv_bytes * cfg["num_heads"] // cfg["num_kv_heads"]
    solo = [generate_compiled(model, [p], n, device=DEVICE)[0, len(p):].tolist()
            for p, n in prompts]
    same = sum(a == b for g, s_ in zip(got, solo) for a, b in zip(g, s_))
    check(all(len(g) == n for g, (_, n) in zip(got, prompts)),
          "options server: wrong token counts")
    eager_srv = eager_server(torch, DecodeServer(
        model, max_batch=8, window=cfg["max_seq_len"], device=DEVICE))
    schedule_on(eager_srv, prompts[:2])  # warm-up
    server_ab = decode_ab(
        torch, "options server bf16", lambda: schedule_on(srv, prompts),
        lambda: schedule_on(eager_srv, prompts), steps, n_tokens,
        lambda o: [t for g in o[0] for t in g], short_schedule(srv, eager_srv, prompts),
        gate_repeat=False)
    out["server"] = dict(requests=len(REQUESTS), tokens=n_tokens, steps=steps,
                         seconds=dt, tok_s=n_tokens / dt, ms_per_step=dt / steps * 1e3,
                         kv_bytes=kv_bytes, mha_kv_bytes=mha_bytes,
                         bf16_agreement=same / n_tokens, launches=counts,
                         capture_seconds=srv_cap_s, ab=server_ab)
    log(f"[options] server bf16: {len(REQUESTS)} requests over 8 slots, {steps} "
        f"steps, {n_tokens} tokens in {dt:.3f} s ({n_tokens / dt:.0f} tok/s, "
        f"{dt / steps * 1e3:.2f} ms/step); KV bytes {kv_bytes:,} "
        f"(multi-head {mha_bytes:,}, {kv_bytes / mha_bytes:.3f}x); agreement "
        f"with solo decode {same}/{n_tokens} | launches {counts}")
    del srv, eager_srv
    clear_programs()

    # the f32 gates take the first layer of these weights in f32
    gate = _f32_prefix(torch, model, OPT_GATE_LAYERS)

    # the train step at bench.py:636-661's shape
    train_toks = torch.from_numpy(np.random.RandomState(seed + 9).randint(
        0, cfg["vocab_size"], size=(OPT_TRAIN_BATCH, OPT_TRAIN_SEQ))).to(DEVICE)
    step = make_train_step(model, SGD(1e-3), loss_fn=lm_loss, device=DEVICE)
    want = train_launches(model)
    losses, dt, counts = _timed_steps(
        torch, K, lambda losses: losses + [step(train_toks, train_toks)], [],
        TRAIN_WARMUP, OPT_TRAIN_STEPS, want, "options train step")
    add(counts)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"options: non-finite train loss {losses}")
    tokens = OPT_TRAIN_BATCH * OPT_TRAIN_SEQ
    hd = cfg["dim"] // cfg["num_heads"]
    # bench.py:683-690's count: 6*P*T, plus 3.5 x the causal attention
    # forward's 4*b*h*s^2*hd / 2
    flops = (6 * n_params * tokens + 3.5 * 4 * OPT_TRAIN_BATCH * cfg["num_heads"]
             * OPT_TRAIN_SEQ ** 2 * hd / 2)
    out["train"] = dict(ms_per_step=dt * 1e3, tok_s=tokens / dt,
                        model_tflop_s=flops / dt / 1e12, flops_per_step=flops,
                        losses=losses, launches_per_step=want)
    log(f"[options] train bf16 batch {OPT_TRAIN_BATCH} x S {OPT_TRAIN_SEQ}, "
        f"SGD(1e-3), lm_loss: {dt * 1e3:.2f} ms/step over {OPT_TRAIN_STEPS} steps, "
        f"{tokens / dt:.0f} tok/s, {flops / dt / 1e12:.1f} model TFLOP/s | launches "
        f"per step {want} | losses " + " ".join(f"{x:.4f}" for x in losses))
    out["train_profile"] = profile_run(
        torch, "one options train step", lambda: step(train_toks, train_toks))
    profile_bwd_v1(torch, report, out, "one options train step",
                   lambda: step(train_toks, train_toks), ("xent_bwd", "rms_bwd"))
    if "train_profile_bwd_v1" in out:
        new, was = out["train_profile"]["bwd"], out["train_profile_bwd_v1"]["bwd"]
        for k in ("xent_bwd", "rms_bwd"):
            check(k in new and k in was and new[k][0] < was[k][0],
                  f"options train step: {k}'s device time per step {new.get(k)} is not "
                  f"below the old build's {was.get(k)}")
    profile_fwd_v1(torch, report, out, "one options train step",
                   lambda: step(train_toks, train_toks), ("xent_fwd",))
    del step
    report.setdefault("train_ab", {})["options"] = train_ab(
        torch, "options train step",
        model_arms(torch, model, lambda: SGD(1e-3), lm_loss, train_toks, train_toks))
    del model

    # f32 gates, full width and one layer: the kernel path on the card
    # against the plain path on the CPU, the same weights.  f32 through one
    # layer in other summation orders leaves ~1e-6 relative; TF32 rounding
    # (~1e-3) or a wrong kernel fails 1e-4
    cpu = _f32_prefix(torch, gate, OPT_GATE_LAYERS).to("cpu")
    n = OPT_GATE_PROMPT + OPT_GATE_STEPS
    gt = torch.from_numpy(np.random.RandomState(seed + 10).randint(
        0, cfg["vocab_size"], size=(2, n)))
    L = 128
    with torch.inference_mode():
        caches, last = _prefill(gate, gt[:, :OPT_GATE_PROMPT].to(DEVICE), L)
        cached = [last]
        for j in range(OPT_GATE_PROMPT, n):
            pos = torch.full((2,), j, dtype=torch.long, device=DEVICE)
            cached.append(_chunk_step(gate, caches, gt[:, j:j + 1].to(DEVICE),
                                      pos, L)[:, 0])
        cached = torch.stack(cached, dim=1).cpu()
        ref = cpu(gt)[:, OPT_GATE_PROMPT - 1:]
    logit_err = ((cached - ref).abs().max() / ref.abs().max()).item()
    check(logit_err <= 1e-4, f"options f32 cached logits GPU vs CPU full forward: "
          f"max |err| {logit_err:.3g} of the largest logit")
    st = torch.from_numpy(np.random.RandomState(seed + 11).randint(
        0, cfg["vocab_size"], size=(1, OPT_GATE_SEQ)))
    loss_gpu = lm_loss(gate(st.to(DEVICE)), st.to(DEVICE))
    loss_gpu.backward()
    loss_cpu = lm_loss(cpu(st), st)
    loss_cpu.backward()
    check(abs(loss_gpu.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"options f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gate.named_parameters():
        r = cpu_params[name].grad
        check(p.grad is not None and r is not None, f"options: no gradient for {name}")
        rel = ((p.grad.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"options f32 gradient of {worst_name} GPU vs CPU: max "
          f"|err| {worst:.3g} of its largest value")
    out["gate"] = dict(layers=OPT_GATE_LAYERS, logits_rel_err=logit_err,
                       loss_gpu=loss_gpu.item(), loss_cpu=loss_cpu.item(),
                       worst_grad_rel_err=worst, worst_param=worst_name)
    log(f"[options] f32 gates, 1 layer at full width: prefill + {OPT_GATE_STEPS} "
        f"cached steps within {logit_err:.3g} of the largest logit of the CPU "
        f"full forward; loss GPU {loss_gpu.item():.6f} CPU {loss_cpu.item():.6f}; "
        f"every gradient within {worst:.3g} of its largest value (worst "
        f"{worst_name}), {OPT_GATE_SEQ} tokens")
    report["options"] = out
    report["launches_options"] = {k: launches.get(k, 0) for k in K.launch_counts()}


# ---------------------------------------------------------------------------
# phase 10: the Mamba family
# ---------------------------------------------------------------------------


def ssm_launches(model, forwards: int = 0, steps: int = 0, train_steps: int = 0):
    """The launches of ``forwards`` parallel forwards or prefills (a scan per
    block, an RMSNorm forward per block and for ln_f), ``steps`` decode
    steps (the RMSNorms alone) and ``train_steps`` train steps (a forward,
    the loss, and one backward kernel for each forward kernel)."""
    n = len(model.blocks)
    fwd = forwards + train_steps
    want = {"scan": n * (fwd + train_steps), "rms_fwd": (n + 1) * (fwd + steps),
            "rms_bwd": (n + 1) * train_steps, "xent_fwd": train_steps,
            "xent_bwd": train_steps}
    return {k: v for k, v in want.items() if v}


def phase_ssm(torch, seed: int, report):
    import copy

    import numpy as np

    import minidiff_tpu_torch as md
    from minidiff_tpu_torch import (SGD, MambaLM, SSMDecodeServer,
                                    generate_compiled_ssm, lm_loss, make_train_step)
    from minidiff_tpu_torch import kernels as K

    cfg = SSM_MODEL
    model = MambaLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **cfg)
    n_params = sum(p.numel() for p in model.parameters())
    out = {"n_params": n_params}
    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # generate_compiled_ssm at bench.py:602-632's shape, then after
    # ssm_bench.decode_bench's 1,024-token prompt with the prefill timed
    rng = np.random.RandomState(seed + 12)
    for label, plen in (("generate", PROMPT), ("generate_long", SSM_LONG_PROMPT)):
        prompt = torch.from_numpy(rng.randint(1, cfg["vocab_size"], size=(BATCH, plen)))
        run = (lambda prompt=prompt: generate_compiled_ssm(model, prompt, NEW,
                                                           device=DEVICE))
        cap_s = capture_seconds(torch, run)  # the capture, and the warm-up
        toks, dt, counts = _counted(torch, K, run)
        want = ssm_launches(model, forwards=1, steps=NEW - 1)
        check(counts == want, f"ssm {label}: launches {counts}, expected {want}")
        check(tuple(toks.shape) == (BATCH, plen + NEW)
              and bool(((toks >= 0) & (toks < cfg["vocab_size"])).all())
              and torch.equal(toks[:, :plen].cpu(), prompt),
              f"ssm {label}: tokens {tuple(toks.shape)} out of range")
        add(counts)

        def prefill():
            with torch.inference_mode():
                return model.prefill(prompt.to(DEVICE))

        prefill()  # warm-up
        _, pre_s, _ = _counted(torch, K, prefill)
        out[label] = dict(prompt=plen, seconds=dt, tok_s=BATCH * NEW / dt,
                          ms_per_step=dt / NEW * 1e3, prefill_ms=pre_s * 1e3,
                          launches=counts, capture_seconds=cap_s)
        out[label]["ab"] = decode_ab(
            torch, f"ssm {label} bf16", run,
            lambda prompt=prompt: eager_generate_ssm(torch, model, prompt, NEW),
            NEW - 1, BATCH * NEW, lambda o, plen=plen: o[:, plen:].flatten().tolist(),
            short_generate(torch, generate_compiled_ssm, eager_generate_ssm, model,
                           prompt))
        log(f"[ssm] generate_compiled_ssm bf16 batch {BATCH} prompt {plen} new "
            f"{NEW}: {dt:.3f} s, {BATCH * NEW / dt:.0f} tok/s, "
            f"{dt / NEW * 1e3:.2f} ms/step (prefill alone {pre_s * 1e3:.2f} ms) "
            f"| launches {counts}")
    # generate_compiled_ssm's 32 new tokens after the 16-token prompt, captured
    out["generate_profile"] = out["generate"]["ab"]["captured"]["profile"]

    # SSMDecodeServer: phase 4's staggered schedule on 8 slots; in f32 every
    # request must equal its solo decode token for token
    prompts = [([int(t) for t in rng.randint(1, cfg["vocab_size"], n)], new)
               for n, new in REQUESTS]
    n_tokens = sum(new for _, new in REQUESTS)
    m32 = MambaLM(dtype=torch.float32, device=DEVICE, seed=seed, **cfg)
    srv = SSMDecodeServer(m32, max_batch=8, device=DEVICE)
    (got, steps, slots), dt32, counts = _counted(torch, K, lambda: run_schedule(
        srv, prompts))
    check(slots < len(prompts), "ssm server: no slot was reused")
    # each capture's warm-up runs the step once more
    want = ssm_launches(m32, forwards=len(REQUESTS), steps=steps + captures())
    check(counts == want, f"ssm server: launches {counts}, expected {want}")
    add(counts)
    for i, ((p, n), g) in enumerate(zip(prompts, got)):
        solo = generate_compiled_ssm(m32, [p], n, device=DEVICE)[0, len(p):].tolist()
        check(solo == eager_generate_ssm(torch, m32, [p], n)[0, len(p):].tolist(),
              f"f32 ssm request {i}: generate_compiled_ssm differs from the eager loop")
        if g != solo:
            first = next(j for j, (a, b) in enumerate(zip(g, solo)) if a != b)
            raise SmokeFailure(f"f32 ssm server request {i} (prompt {len(p)}) "
                               f"differs from its solo decode at token {first}")
    log(f"[ssm] server f32: {len(REQUESTS)} requests over 8 slots, {steps} steps, "
        f"{n_tokens} tokens in {dt32:.3f} s: every request token-identical to its "
        f"solo generate_compiled_ssm and to the eager loop | launches {counts}")
    del srv
    clear_programs()

    # f32 gates, full width and one layer: the kernel path on the card
    # against the plain path on the CPU, the same weights.  f32 through one
    # layer in other summation orders leaves ~1e-6 relative; TF32 rounding
    # (~1e-3) or a wrong kernel fails 1e-4
    gate = copy.deepcopy(m32)
    del gate.blocks[1:], gate.norms[1:]
    del m32
    cpu = copy.deepcopy(gate).to("cpu")
    n = SSM_GATE_PROMPT + SSM_GATE_STEPS
    gt = torch.from_numpy(np.random.RandomState(seed + 13).randint(
        0, cfg["vocab_size"], size=(2, n)))
    with torch.inference_mode():
        last, states = gate.prefill(gt[:, :SSM_GATE_PROMPT].to(DEVICE))
        stepped = [last]
        for j in range(SSM_GATE_PROMPT, n):
            logits, states = gate.step(states, gt[:, j].to(DEVICE))
            stepped.append(logits)
        stepped = torch.stack(stepped, dim=1).cpu()
        ref = cpu(gt)[:, SSM_GATE_PROMPT - 1:]
        logit_err = ((stepped - ref).abs().max() / ref.abs().max()).item()
        check(logit_err <= 1e-4, f"ssm f32 prefill + steps GPU vs CPU full forward: "
              f"max |err| {logit_err:.3g} of the largest logit")
        lengths = torch.tensor([n, 3, 11])
        rt = torch.from_numpy(np.random.RandomState(seed + 14).randint(
            0, cfg["vocab_size"], size=(3, n)))
        lg_card, st_card = gate.prefill(rt.to(DEVICE), lengths=lengths.to(DEVICE))
        lg_cpu, st_cpu = cpu.prefill(rt, lengths=lengths)
        state_err = max(((st_card[0][k].cpu() - st_cpu[0][k]).abs().max()
                         / st_cpu[0][k].abs().max()).item() for k in ("h", "conv"))
        state_err = max(state_err, ((lg_card.cpu() - lg_cpu).abs().max()
                                    / lg_cpu.abs().max()).item())
        check(state_err <= 1e-4, f"ssm f32 ragged prefill GPU vs CPU: max |err| "
              f"{state_err:.3g} of the largest value")
    # targets drawn apart from the inputs: with the tied head, a token's own
    # embedding dominates its logits, so the identity task's loss is ~1e-7
    # and its f32 rounding alone exceeds any relative bound
    st, sy = (torch.from_numpy(np.random.RandomState(seed + 15 + i).randint(
        0, cfg["vocab_size"], size=(1, SSM_GATE_SEQ))) for i in (0, 20))
    loss_gpu = lm_loss(gate(st.to(DEVICE)), sy.to(DEVICE))
    loss_gpu.backward()
    loss_cpu = lm_loss(cpu(st), sy)
    loss_cpu.backward()
    check(abs(loss_gpu.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"ssm f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gate.named_parameters():
        r = cpu_params[name].grad
        check(p.grad is not None and r is not None, f"ssm: no gradient for {name}")
        rel = ((p.grad.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"ssm f32 gradient of {worst_name} GPU vs CPU: max |err| "
          f"{worst:.3g} of its largest value")
    out["gate"] = dict(layers=1, logits_rel_err=logit_err, ragged_rel_err=state_err,
                       loss_gpu=loss_gpu.item(), loss_cpu=loss_cpu.item(),
                       worst_grad_rel_err=worst, worst_param=worst_name)
    log(f"[ssm] f32 gates, 1 layer at full width: prefill + {SSM_GATE_STEPS} "
        f"steps within {logit_err:.3g} of the largest logit of the CPU forward; "
        f"ragged prefill's logits and states within {state_err:.3g}; loss GPU "
        f"{loss_gpu.item():.6f} CPU {loss_cpu.item():.6f}; every gradient within "
        f"{worst:.3g} of its largest value (worst {worst_name}), {SSM_GATE_SEQ} "
        f"tokens")
    del gate, cpu

    # bf16 server throughput and the state's bytes beside the flagship's KV
    # cache for the same 8 slots (window 512, bf16)
    srv = SSMDecodeServer(model, max_batch=8, device=DEVICE)
    srv_cap_s = capture_seconds(torch, lambda: run_schedule(srv, prompts[:2]))  # warm-up
    (got, steps, _), dt16, counts = _counted(torch, K, lambda: schedule_on(
        srv, prompts))
    check(counts == ssm_launches(model, forwards=len(REQUESTS), steps=steps),
          f"ssm bf16 server: launches {counts}")
    add(counts)
    state_bytes = sum(t.numel() * t.element_size() for st_ in srv._caches
                      for t in st_.values())
    kv_bytes = (2 * MODEL["num_layers"] * 8 * MODEL["dim"] * 512
                * torch.finfo(torch.bfloat16).bits // 8)
    eager_srv = eager_server(torch, SSMDecodeServer(model, max_batch=8, device=DEVICE))
    schedule_on(eager_srv, prompts[:2])  # warm-up
    server_ab = decode_ab(
        torch, "ssm server bf16", lambda: schedule_on(srv, prompts),
        lambda: schedule_on(eager_srv, prompts), steps, n_tokens,
        lambda o: [t for g in o[0] for t in g], short_schedule(srv, eager_srv, prompts),
        gate_repeat=False)
    out["server"] = dict(requests=len(REQUESTS), tokens=n_tokens, steps=steps,
                         f32_seconds=dt32, f32_tok_s=n_tokens / dt32,
                         bf16_seconds=dt16, bf16_tok_s=n_tokens / dt16,
                         ms_per_step=dt16 / steps * 1e3, state_bytes=state_bytes,
                         flagship_kv_bytes=kv_bytes, launches=counts,
                         capture_seconds=srv_cap_s, ab=server_ab)
    log(f"[ssm] server bf16: {n_tokens} tokens in {dt16:.3f} s ({n_tokens / dt16:.0f} "
        f"tok/s, {dt16 / steps * 1e3:.2f} ms/step); state {state_bytes:,} bytes for 8 "
        f"slots against the flagship's KV cache of {kv_bytes:,} (window 512)")
    del srv, eager_srv
    clear_programs()

    # the train step at ssm_bench.train_race's shape
    trng = np.random.RandomState(seed + 16)
    x, y = (torch.from_numpy(trng.randint(0, cfg["vocab_size"], size=(
        SSM_TRAIN_BATCH, SSM_TRAIN_SEQ))).to(DEVICE) for _ in range(2))
    step = make_train_step(model, SGD(SSM_LR), loss_fn=lm_loss, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    want = ssm_launches(model, train_steps=1)
    losses, dt, counts = _timed_steps(
        torch, K, lambda losses: losses + [step(x, y)], [], TRAIN_WARMUP,
        SSM_TRAIN_STEPS, want, "ssm train step")
    peak = torch.cuda.max_memory_allocated()
    add(counts)
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"ssm: non-finite train loss {losses}")
    tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    # 6 x the projections' weights (in_proj, x_proj, dt_proj, out_proj and
    # the tied head) x tokens: forward and backward products
    proj = sum(m.w.numel() for blk in model.blocks
               for m in (blk.in_proj, blk.x_proj, blk.dt_proj, blk.out_proj))
    flops = 6 * (proj + model.tok_emb.numel()) * tokens
    out["train"] = dict(ms_per_step=dt * 1e3, tok_s=tokens / dt,
                        model_tflop_s=flops / dt / 1e12, flops_per_step=flops,
                        losses=losses, launches_per_step=want,
                        peak_memory_bytes=peak)
    log(f"[ssm] train bf16 batch {SSM_TRAIN_BATCH} x S {SSM_TRAIN_SEQ}, "
        f"SGD({SSM_LR}), lm_loss: {dt * 1e3:.2f} ms/step over {SSM_TRAIN_STEPS} "
        f"steps, {tokens / dt:.0f} tok/s, {flops / dt / 1e12:.1f} model TFLOP/s, "
        f"peak memory {peak / 2 ** 30:.2f} GiB | launches per step {want} | "
        "losses " + " ".join(f"{v:.4f}" for v in losses))
    out["train_profile"] = profile_run(torch, "one ssm train step", lambda: step(x, y))
    profile_bwd_v1(torch, report, out, "one ssm train step", lambda: step(x, y),
                   ("xent_bwd", "rms_bwd"))
    # the backward's cotangent is one reverse scan: no flip kernel
    flips = out["train_profile"].get("groups", {}).get("flip")
    check(flips is None, f"ssm train step: flip kernels in the profile {flips}")
    profile_fwd_v1(torch, report, out, "one ssm train step", lambda: step(x, y),
                   ("flip", "cat", "scan"))
    del step
    report.setdefault("train_ab", {})["mamba"] = train_ab(
        torch, "MambaLM train step", model_arms(torch, model, lambda: SGD(SSM_LR), lm_loss, x, y))
    del model, x, y

    # the tape: md.value_and_grad of a linear_scan loss; an f32 gate against
    # the CPU tape, then bf16 timed at the train step's scan shape (the
    # forward scan and one reverse scan a step)
    def scan_operands(shape, dtype, device, seed_):
        # decays in [0.5, 1), inputs and loss weights normal
        g = torch.Generator(device=device).manual_seed(seed_)
        a = torch.rand(shape, generator=g, device=device) * 0.5 + 0.5
        b, c = (torch.randn(shape, generator=g, device=device) for _ in range(2))
        return [t.to(dtype) for t in (a, b, c)]

    vag = md.value_and_grad(
        lambda a, b, c: md.sum(md.linear_scan(a, b, axis=1) * c), argnums=(0, 1))
    av, bv, cv = (t.numpy() for t in scan_operands(
        SSM_TAPE_GATE, torch.float32, "cpu", seed + 17))

    def tape_run():
        value, grads = vag(*(md.Tensor(v) for v in (av, bv, cv)))
        return [np.asarray(t) for t in (value, *grads)]

    with md.use_backend(DEVICE):
        card, dt, counts = _counted(torch, K, tape_run)
    check(counts == SSM_TAPE_LAUNCHES, f"ssm tape gate: launches {counts}")
    with md.use_backend("cpu"):
        ref = tape_run()
    tape_err = abs(float(card[0]) - float(ref[0])) / abs(float(ref[0]))
    check(tape_err <= 1e-5, f"ssm tape gate: value card {card[0]} cpu {ref[0]}")
    grad_err = max(float(np.abs(c - r).max() / np.abs(r).max())
                   for c, r in zip(card[1:], ref[1:]))
    check(grad_err <= 1e-4, f"ssm tape gate: gradients off by {grad_err:.3g}")
    with md.use_backend(DEVICE):
        ops = [md.Tensor(t) for t in scan_operands(SSM_SCAN, torch.bfloat16,
                                                    DEVICE, seed + 18)]
        _, dt, counts = _timed_steps(
            torch, K, lambda state: vag(*ops), None, TRAIN_WARMUP, SSM_TRAIN_STEPS,
            SSM_TAPE_LAUNCHES, "ssm tape scan step")
        add(counts)
        del ops
    out["tape"] = dict(gate_shape=list(SSM_TAPE_GATE), value_rel_err=tape_err,
                       grad_rel_err=grad_err, shape=list(SSM_SCAN),
                       ms_per_step=dt * 1e3, launches=counts)
    log(f"[ssm] tape value_and_grad of sum(linear_scan(a, b) * c): f32 gate at "
        f"{SSM_TAPE_GATE} value within {tape_err:.3g}, gradients within "
        f"{grad_err:.3g} of the CPU tape; bf16 at {SSM_SCAN}: {dt * 1e3:.3f} "
        f"ms/step | launches {counts}")
    report["ssm"] = out
    report["launches_ssm"] = {k: launches.get(k, 0) for k in K.launch_counts()}


# ---------------------------------------------------------------------------
# phase 11: head dims other than 128
# ---------------------------------------------------------------------------


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def flash_launches(model, kinds) -> dict:
    """One launch of each flash kernel in ``kinds`` per attention layer where
    the model's head dim takes the kernels (``attention.HEAD_DIMS``, the
    rule of ``flash_eligible``), none where it composes."""
    from minidiff_tpu_torch.kernels.attention import HEAD_DIMS

    if model.blocks[0].attn.head_dim not in HEAD_DIMS:
        return {}
    return {k: len(model.blocks) for k in kinds}


def phase_head_dims(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import (SGD, TransformerLM, generate_compiled, lm_loss,
                                    make_train_step)
    from minidiff_tpu_torch import kernels as K

    out, launches = {}, {}
    rng = np.random.RandomState(seed + 19)
    flash_names = FLASH_KERNELS

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # TransformerLM() at its own defaults (head dim 32, f32), and the
    # head-dim-256 model in bf16 at its train shape
    for label, cfg, dtype, batch, seq in (
            ("defaults", {}, torch.float32, 2, 128),
            ("hd256", HD256_MODEL, torch.bfloat16, 8, HD256_SEQ)):
        model = TransformerLM(dtype=dtype, device=DEVICE, seed=seed, **cfg)
        hd = model.blocks[0].attn.head_dim
        flash = bool(flash_launches(model, flash_names))
        prompt = torch.from_numpy(rng.randint(1, model.vocab_size, size=(batch, 16)))
        toks, dt_gen, counts = _counted(torch, K, lambda: generate_compiled(
            model, prompt, 32, device=DEVICE))
        add(counts)
        want = flash_launches(model, ("flash_fwd",))
        got = {k: counts[k] for k in flash_names if k in counts}
        check(got == want, f"{label} generate: flash launches {got}, expected {want}")
        check(bool(((toks >= 0) & (toks < model.vocab_size)).all()),
              f"{label} generate: token out of range")
        x = torch.from_numpy(rng.randint(0, model.vocab_size, size=(batch, seq)))
        step = make_train_step(model, SGD(1e-3), loss_fn=lm_loss, device=DEVICE)
        loss, dt_train, counts = _counted(torch, K, lambda: step(x, x))
        add(counts)
        want = flash_launches(model, flash_names)
        got = {k: counts[k] for k in flash_names if k in counts}
        check(got == want, f"{label} train step: flash launches {got}, expected {want}")
        check(bool(torch.isfinite(loss)), f"{label} train step: loss {loss}")
        out[label] = dict(head_dim=hd, route="flash" if flash else "composed",
                          generate_seconds=dt_gen, train_seconds=dt_train,
                          loss=float(loss), train_launches=counts)
        log(f"[head dims] {label}: head dim {hd}, {out[label]['route']}; "
            f"generate_compiled batch {batch} prompt 16 new 32 in {dt_gen:.3f} s, "
            f"one train step {batch} x {seq} in {dt_train * 1e3:.1f} ms, loss "
            f"{float(loss):.4f} | train launches {counts}")
        del model, step

    # the head-dim-256 model's f32 loss and gradients against the CPU
    gpu = TransformerLM(dtype=torch.float32, device=DEVICE, seed=seed, **HD256_MODEL)
    cpu = TransformerLM(dtype=torch.float32, device="cpu", seed=seed, **HD256_MODEL)
    t = torch.from_numpy(rng.randint(0, HD256_MODEL["vocab_size"], size=(1, 256)))
    K.reset_launch_counts()
    loss_gpu = lm_loss(gpu(t.to(DEVICE)), t.to(DEVICE))
    loss_gpu.backward()
    counts = {k: n for k, n in K.launch_counts().items() if n and k in flash_names}
    check(counts == flash_launches(gpu, flash_names),
          f"hd256 f32 gate: flash launches {counts}")
    loss_cpu = lm_loss(cpu(t), t)
    loss_cpu.backward()
    check(abs(loss_gpu.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"hd256 f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        r = cpu_params[name].grad
        rel = ((p.grad.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"hd256 f32 gradient of {worst_name} GPU vs CPU: max "
          f"|err| {worst:.3g} of its largest value")
    out["hd256_gate"] = dict(loss_gpu=loss_gpu.item(), loss_cpu=loss_cpu.item(),
                             worst_grad_rel_err=worst, worst_param=worst_name)
    log(f"[head dims] hd256 f32 gate, 256 tokens: loss GPU {loss_gpu.item():.6f} "
        f"CPU {loss_cpu.item():.6f}; every gradient within {worst:.3g} of its "
        f"largest value (worst {worst_name})")
    report["head_dims"] = out
    report["launches_head_dims"] = {k: launches.get(k, 0) for k in K.launch_counts()}


# ---------------------------------------------------------------------------
# phase 12: the Mixture-of-Experts family
# ---------------------------------------------------------------------------


def _record_routes(torch, model, routes):
    """Make every MoE layer of ``model`` append, per routing call, its slot
    tables (on the CPU) and the smallest gap between the k-th and the
    (k+1)-th router probability of its tokens."""
    from minidiff_tpu_torch.models import functional as F

    for blk in model.blocks:
        moe = blk.moe

        def spy(xt, c, moe=moe, route=moe.compute_routing_sparse):
            probs = F.softmax(xt @ moe.router.w, dim=-1).float()
            top = probs.topk(moe.k + 1, dim=-1).values
            choices, aux = route(xt, c)
            routes.append(([slot.cpu() for slot, _ in choices],
                           (top[:, moe.k - 1] - top[:, moe.k]).min().item()))
            return choices, aux

        moe.compute_routing_sparse = spy


def _cached_logits(torch, model, toks, prompt: int, L: int):
    """Logits (B, n - prompt + 1, V) on the CPU of a prefill of ``prompt``
    tokens and one cached step for each token after it."""
    from minidiff_tpu_torch.models.speculative import _chunk_step, _prefill

    dev = model.device
    b, n = toks.shape
    with torch.inference_mode():
        caches, last = _prefill(model, toks[:, :prompt].to(dev), L)
        out = [last]
        for j in range(prompt, n):
            pos = torch.full((b,), j, dtype=torch.long, device=dev)
            out.append(_chunk_step(model, caches, toks[:, j:j + 1].to(dev), pos,
                                   L)[:, 0])
        return torch.stack(out, dim=1).float().cpu()


def phase_moe(torch, seed: int, report):
    import copy

    import numpy as np

    from minidiff_tpu_torch import (SGD, DecodeServer, MoETransformerLM,
                                    PagedDecodeServer, TransformerLM,
                                    generate_compiled, lm_loss, make_moe_loss,
                                    make_train_step, quantize_for_serving,
                                    quantized_bytes)
    from minidiff_tpu_torch import kernels as K

    cfg = MOE_MODEL
    out, launches = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    model = MoETransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **cfg)
    q8 = quantize_for_serving(model)
    weight_bytes = {"bf16": quantized_bytes(model), "int8": quantized_bytes(q8)}
    out["n_params"] = sum(p.numel() for p in model.parameters())
    out["weight_bytes"] = weight_bytes

    # generate_compiled over bf16 and int8 banks at bench.py:502-530's shape;
    # the prefill (C = 128 slots per expert) and every step (C = 8) run each
    # forward kernel once, flash only in the prefill
    prompt = torch.from_numpy(np.random.RandomState(seed + 20).randint(
        1, cfg["vocab_size"], size=(BATCH, PROMPT)))
    for label, m in (("bf16", model), ("int8", q8)):
        run = lambda m=m: generate_compiled(m, prompt, MOE_NEW, device=DEVICE)  # noqa: E731
        cap_s = capture_seconds(torch, run)  # the capture, and the warm-up
        toks, dt, counts = _counted(torch, K, run)
        per_forward = forward_launches(m)
        want = {k: n * (MOE_NEW if k != "flash_fwd" else 1)
                for k, n in per_forward.items()}
        check(counts == want, f"moe generate {label}: launches {counts}, "
              f"expected {want}")
        check(tuple(toks.shape) == (BATCH, PROMPT + MOE_NEW)
              and bool(((toks >= 0) & (toks < cfg["vocab_size"])).all()),
              f"moe generate {label}: tokens {tuple(toks.shape)} out of range")
        add(counts)
        out[f"generate_{label}"] = dict(
            seconds=dt, tok_s=BATCH * MOE_NEW / dt, ms_per_step=dt / MOE_NEW * 1e3,
            launches=counts, per_forward=per_forward, capture_seconds=cap_s)
        out[f"generate_{label}"]["ab"] = decode_ab(
            torch, f"moe generate {label} banks", run,
            lambda m=m: eager_generate(torch, m, prompt, MOE_NEW), MOE_NEW - 1,
            BATCH * MOE_NEW, lambda o: o[:, PROMPT:].flatten().tolist(),
            short_generate(torch, generate_compiled, eager_generate, m, prompt))
        log(f"[moe] generate_compiled {label} banks, batch {BATCH} prompt {PROMPT} "
            f"new {MOE_NEW}: {dt:.3f} s, {BATCH * MOE_NEW / dt:.0f} tok/s, "
            f"{dt / MOE_NEW * 1e3:.2f} ms/step | per prefill and step {per_forward}")
    check(out["generate_int8"]["per_forward"].get("dq_bmm") == 2 * cfg["num_layers"],
          "moe int8: two dq_bmm per layer")
    ratio = out["generate_bf16"]["seconds"] / out["generate_int8"]["seconds"]
    out["int8_speedup_vs_bf16"] = ratio
    log(f"[moe] int8 / bf16 speed-up {ratio:.4f} (bench's "
        f"decode_moe_int8_speedup_vs_bf16); weight bytes bf16 "
        f"{weight_bytes['bf16']:,} int8 {weight_bytes['int8']:,} "
        f"({weight_bytes['int8'] / weight_bytes['bf16']:.3f}x)")
    # the int8 decode's 32 new tokens, captured
    out["generate_profile"] = out["generate_int8"]["ab"]["captured"]["profile"]
    if "simt_quant_lib" in report:  # phase 2 built it (absent in a CPU rehearsal)
        with built_as("quant", lib_at("quant", report["simt_quant_lib"])):
            out["generate_profile_simt"] = profile_captured(
                torch, "moe int8 generate_compiled 32 new tokens, SIMT tile",
                lambda: generate_compiled(q8, prompt, 32, device=DEVICE))
    del q8

    # the servers: 10 staggered requests on 8 slots, window 256; bf16 timed,
    # f32 token-identical to solo decoding (no token is dropped at capacity
    # E / k, so a request routes as it would alone)
    rng = np.random.RandomState(seed + 21)
    prompts = [([int(t) for t in rng.randint(1, cfg["vocab_size"], n)], new)
               for n, new in MOE_REQUESTS]
    n_tokens = sum(new for _, new in MOE_REQUESTS)
    m32 = _f32_prefix(torch, model, cfg["num_layers"])
    fwd = forward_launches(model)
    for dtype, m in (("bf16", model), ("f32", m32)):
        solo = [generate_compiled(m, [p], n, device=DEVICE)[0, len(p):].tolist()
                for p, n in prompts]
        if dtype == "f32":
            eager = [eager_generate(torch, m, [p], n)[0, len(p):].tolist()
                     for p, n in prompts]
            check(solo == eager, "f32 moe solo generate_compiled differs from the "
                  "eager step loop")
        for cls in (DecodeServer, PagedDecodeServer):
            name = f"{cls.__name__}_{dtype}"
            if dtype == "bf16":
                run_schedule(cls(m, max_batch=8, window=cfg["max_seq_len"],
                                 device=DEVICE), prompts[:2])  # warm-up
            srv = cls(m, max_batch=8, window=cfg["max_seq_len"], device=DEVICE)
            (got, steps, slots), dt, counts = _counted(
                torch, K, lambda: run_schedule(srv, prompts))
            check(slots < len(prompts), f"moe {name}: no slot was reused")
            # each capture's warm-up runs the step once more
            runs = steps + captures()
            want = {k: n * (len(prompts) + (runs if k != "flash_fwd" else 0))
                    for k, n in fwd.items()}
            if cls is PagedDecodeServer:
                want["paged_attn"] = cfg["num_layers"] * runs
            check(counts == want, f"moe {name}: launches {counts}, expected {want}")
            add(counts)
            check(all(len(g) == n for g, (_, n) in zip(got, prompts)),
                  f"moe {name}: wrong token counts")
            same = sum(a == b for g, s_ in zip(got, solo) for a, b in zip(g, s_))
            if dtype == "f32":
                for i, (g, s_) in enumerate(zip(got, solo)):
                    if g != s_:
                        first = next(j for j, (a, b) in enumerate(zip(g, s_))
                                     if a != b)
                        raise SmokeFailure(
                            f"f32 moe {name} request {i} (prompt {len(prompts[i][0])})"
                            f" differs from its solo decode at token {first}")
            out[name] = dict(requests=len(prompts), tokens=n_tokens, steps=steps,
                             seconds=dt, tok_s=n_tokens / dt,
                             ms_per_step=dt / steps * 1e3,
                             agreement=same / n_tokens, launches=counts)
            if dtype == "bf16":
                eager_srv = eager_server(torch, cls(m, max_batch=8,
                                                    window=cfg["max_seq_len"],
                                                    device=DEVICE))
                schedule_on(eager_srv, prompts[:2])  # warm-up
                out[name]["ab"] = decode_ab(
                    torch, f"moe {name}", lambda srv=srv: schedule_on(srv, prompts),
                    lambda eager_srv=eager_srv: schedule_on(eager_srv, prompts),
                    steps, n_tokens, lambda o: [t for g in o[0] for t in g],
                    short_schedule(srv, eager_srv, prompts), gate_repeat=False)
                del eager_srv
            log(f"[moe] {name}: {len(prompts)} requests over 8 slots, {steps} "
                f"steps, {n_tokens} tokens in {dt:.3f} s ({n_tokens / dt:.0f} "
                f"tok/s); agreement with solo decode {same}/{n_tokens}")
            del srv
    del m32
    clear_programs()

    # f32 gates at full width and one layer, the card against the CPU: the
    # same routes first (a probability gap under f32 rounding would flip a
    # route), then prefill + 8 cached steps' logits over float and int8
    # banks (the same codes on both devices), then the loss with aux and
    # every gradient.  f32 through one layer in other summation orders
    # leaves ~1e-6 relative; TF32 rounding (~1e-3) or a wrong kernel fails
    # 1e-4
    gate = _f32_prefix(torch, model, 1)
    del model
    cpu = copy.deepcopy(gate).to("cpu")
    n = MOE_GATE_PROMPT + MOE_GATE_STEPS
    gt = torch.from_numpy(np.random.RandomState(seed + 22).randint(
        0, cfg["vocab_size"], size=(2, n)))
    gate_out = {}
    qcpu = quantize_for_serving(cpu)
    for label, g_model, c_model in (
            ("float", gate, cpu),
            ("int8", copy.deepcopy(qcpu).to(DEVICE), qcpu)):
        routes = {"card": [], "cpu": []}
        _record_routes(torch, g_model, routes["card"])
        _record_routes(torch, c_model, routes["cpu"])
        K.reset_launch_counts()
        lg = _cached_logits(torch, g_model, gt, MOE_GATE_PROMPT, 128)
        used = {k: v for k, v in K.launch_counts().items() if v}
        ref = _cached_logits(torch, c_model, gt, MOE_GATE_PROMPT, 128)
        for m in (g_model, c_model):  # the spies go with the gate
            for blk in m.blocks:
                del blk.moe.compute_routing_sparse
        check(len(routes["card"]) == len(routes["cpu"]) == 1 + MOE_GATE_STEPS,
              f"moe gate {label}: {len(routes['card'])} routing calls")
        for i, ((a, _), (b, _)) in enumerate(zip(routes["card"], routes["cpu"])):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"moe f32 gate {label}: slot tables of call {i} differ between "
                  f"the card and the CPU")
        gap = min(g for _, g in routes["card"])
        err = ((lg - ref).abs().max() / ref.abs().max()).item()
        check(err <= 1e-4, f"moe f32 {label} prefill + steps GPU vs CPU: max "
              f"|err| {err:.3g} of the largest logit")
        if label == "int8":
            check(used.get("dq_bmm") == 2 * (1 + MOE_GATE_STEPS),
                  f"moe gate int8: launches {used}")
        gate_out[label] = dict(logits_rel_err=err, min_topk_gap=gap, launches=used)
        log(f"[moe] f32 gate {label} banks, 1 layer: slot tables of the prefill "
            f"and {MOE_GATE_STEPS} steps identical on the card and the CPU "
            f"(smallest top-{cfg['k']} probability gap {gap:.3g}); logits within "
            f"{err:.3g} of the largest | launches {used}")
    st, sy = (torch.from_numpy(np.random.RandomState(seed + 23 + i).randint(
        0, cfg["vocab_size"], size=(1, MOE_GATE_SEQ))) for i in range(2))
    loss_fn = make_moe_loss(0.01)
    K.reset_launch_counts()
    loss_gpu = loss_fn(gate.forward_with_aux(st.to(DEVICE)), sy.to(DEVICE))
    loss_gpu.backward()
    add({k: v for k, v in K.launch_counts().items() if v})
    loss_cpu = loss_fn(cpu.forward_with_aux(st), sy)
    loss_cpu.backward()
    check(abs(loss_gpu.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"moe f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gate.named_parameters():
        r = cpu_params[name].grad
        check(p.grad is not None and r is not None, f"moe: no gradient for {name}")
        rel = ((p.grad.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"moe f32 gradient of {worst_name} GPU vs CPU: max "
          f"|err| {worst:.3g} of its largest value")
    check(gate.blocks[0].moe.router.w.grad is not None, "moe: no router gradient")
    gate_out.update(loss_gpu=loss_gpu.item(), loss_cpu=loss_cpu.item(),
                    worst_grad_rel_err=worst, worst_param=worst_name)
    out["gate"] = gate_out
    log(f"[moe] f32 gate, 1 layer at full width, {MOE_GATE_SEQ} tokens: loss with "
        f"aux GPU {loss_gpu.item():.6f} CPU {loss_cpu.item():.6f}; every gradient "
        f"(the router's included) within {worst:.3g} of its largest value (worst "
        f"{worst_name})")
    del gate, cpu

    # the train step at benchmarks/moe_bench.py's configuration: grouped and
    # one-hot MoE and the equal-FLOPs dense step, timed in turns
    tcfg = MOE_TRAIN
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg["vocab_size"], size=(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ))).to(DEVICE)
    models = {
        "grouped": MoETransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed,
                                    grouped=True, **tcfg),
        "onehot": MoETransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed,
                                   grouped=False, **tcfg),
        "dense": TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed,
                               **{k: v for k, v in tcfg.items() if k not in (
                                   "num_experts", "k", "capacity_factor")}),
    }
    steps = {name: make_train_step(
        m, SGD(1e-3), loss_fn=lm_loss if name == "dense" else make_moe_loss(0.01),
        device=DEVICE, apply_fn=None if name == "dense" else m.forward_with_aux)
        for name, m in models.items()}
    times = {name: [] for name in models}
    losses = {name: [] for name in models}
    for r in range(MOE_TRAIN_ROUNDS):
        for name in models:
            want = train_launches(models[name])
            losses[name], dt, counts = _timed_steps(
                torch, K, lambda ls: ls + [steps[name](toks, toks)], losses[name],
                TRAIN_WARMUP if r == 0 else 0, MOE_TRAIN_STEPS, want,
                f"moe train step {name}")
            times[name].append(dt)
            add(counts)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    best = {name: min(ts) for name, ts in times.items()}
    for name, ls in losses.items():
        ls = [float(x) for x in ls]
        check(all(np.isfinite(ls)), f"moe train {name}: non-finite loss {ls}")
        losses[name] = ls
    out["train"] = dict(
        ms_per_step={name: [t * 1e3 for t in ts] for name, ts in times.items()},
        tok_s={name: tokens / t for name, t in best.items()},
        grouped_speedup_vs_onehot=best["onehot"] / best["grouped"],
        moe_vs_dense=best["grouped"] / best["dense"],
        launches_per_step={name: train_launches(m) for name, m in models.items()},
        losses=losses)
    log(f"[moe] train bf16 batch {MOE_TRAIN_BATCH} x S {MOE_TRAIN_SEQ} (moe_bench): "
        + ", ".join(f"{name} {best[name] * 1e3:.2f} ms/step ({tokens / best[name]:.0f} "
                    f"tok/s)" for name in models)
        + f" | grouped speed-up vs one-hot {best['onehot'] / best['grouped']:.4f}, "
        f"MoE / dense {best['grouped'] / best['dense']:.4f} | launches per step "
        f"{train_launches(models['grouped'])} | final losses "
        + " ".join(f"{name} {ls[-1]:.4f}" for name, ls in losses.items()))
    out["train_profile"] = profile_run(
        torch, "one grouped moe train step", lambda: steps["grouped"](toks, toks))
    profile_bwd_v1(torch, report, out, "one grouped moe train step",
                   lambda: steps["grouped"](toks, toks), ("xent_bwd", "ln_bwd", "addln_bwd"))
    grouped = models["grouped"]
    del steps, models
    report.setdefault("train_ab", {})["moe_grouped"] = train_ab(
        torch, "moe grouped train step",
        model_arms(torch, grouped, lambda: SGD(1e-3), make_moe_loss(0.01), toks, toks,
                   moe=True))
    report["moe"] = out
    report["launches_moe"] = {k: launches.get(k, 0) for k in K.launch_counts()}



# ---------------------------------------------------------------------------
# phase 13: sliding windows with attention sinks, and packed sequences
# ---------------------------------------------------------------------------


def packed_batch(rng, b: int, s: int, vocab: int, lo: int, hi: int) -> dict:
    """``pack_documents``' tables for b full rows of s tokens: documents
    with lengths drawn in [lo, hi] from ``rng`` until the packing fills b
    rows, then its first b rows."""
    from minidiff_tpu_torch.models import pack_documents

    docs, total = [], 0
    while True:
        n = int(rng.randint(lo, hi + 1))
        docs.append(rng.randint(0, vocab, size=n))
        total += n
        if total >= (b + 1) * s:
            packed = pack_documents(docs, s)
            if packed["tokens"].shape[0] >= b:
                return {k: v[:b] for k, v in packed.items()}


def phase_window(torch, seed: int, report):
    import copy

    import numpy as np

    import minidiff_tpu_torch as md
    from minidiff_tpu_torch import (SGD, PagedDecodeServer, TransformerLM,
                                    generate_compiled, lm_loss)
    from minidiff_tpu_torch import kernels as K
    from minidiff_tpu_torch.kernels import attention as A
    from minidiff_tpu_torch.models import make_packed_train_step

    cfg = WIN_MODEL
    t0 = time.perf_counter()
    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **cfg)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[window] Mistral-7B-v0.1 widths, window {cfg['window']} sinks {cfg['sinks']}, "
        f"{cfg['num_layers']} layers, bf16: {n_params / 1e6:.1f}M parameters drawn in "
        f"{init_s:.1f} s")
    out = {"n_params": n_params, "init_seconds": init_s}
    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # the packed train step, captured, against the eager step on a copy of
    # the same weights: the same losses, bit for bit
    rng = np.random.RandomState(seed + 13)
    batches = [packed_batch(rng, WIN_TRAIN_BATCH, WIN_TRAIN_SEQ, cfg["vocab_size"],
                            *WIN_DOCS) for _ in range(WIN_TRAIN_STEPS)]
    docs = [int(b["segment_ids"].max()) + 1 for b in batches]
    twin = copy.deepcopy(model)
    step = make_packed_train_step(model, SGD(1e-4), device=DEVICE)
    want = {k: n * WIN_TRAIN_STEPS for k, n in train_launches(model).items()}
    times = []

    def run_steps():
        losses = []
        for bt in batches:
            t = time.perf_counter()
            losses.append(step(bt))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return losses

    losses, dt, counts = _counted(torch, K, run_steps)
    check(counts == want, f"window packed train: launches {counts}, expected {want}")
    add(counts)
    eager = make_packed_train_step(twin, SGD(1e-4), jit=False, device=DEVICE)
    eager_losses = [eager({k: torch.from_numpy(v) for k, v in bt.items()})
                    for bt in batches]
    losses = [x.item() for x in losses]
    eager_losses = [x.item() for x in eager_losses]
    check(all(np.isfinite(losses)), f"window packed train: non-finite losses {losses}")
    check(losses == eager_losses, f"window packed train: captured losses {losses} are not "
          f"the eager step's {eager_losses}")
    del twin, eager
    out["train"] = dict(batch=[WIN_TRAIN_BATCH, WIN_TRAIN_SEQ], documents=docs,
                        ms_per_step=[t * 1e3 for t in times], losses=losses,
                        launches=counts)
    log(f"[window] packed train step (captured) {WIN_TRAIN_BATCH} x {WIN_TRAIN_SEQ}, "
        f"{docs} documents: " + " ".join(f"{t * 1e3:.1f}" for t in times)
        + " ms/step (the first eager, then the capture) | losses "
        + " ".join(f"{x:.4f}" for x in losses) + f" = eager | launches {counts}")
    del step
    clear_programs()

    # generate_compiled past the window, against the eager loop
    fwd = forward_launches(model)
    prompt = torch.from_numpy(rng.randint(1, cfg["vocab_size"], size=(1, WIN_PROMPT)))
    run = lambda: generate_compiled(model, prompt, WIN_NEW, device=DEVICE)  # noqa: E731
    cap_s = capture_seconds(torch, run)
    toks, dt, counts = _counted(torch, K, run)
    want = {k: n * (WIN_NEW if k != "flash_fwd" else 1) for k, n in fwd.items()}
    check(counts == want, f"window generate: launches {counts}, expected {want}")
    add(counts)
    eager_toks = eager_generate(torch, model, prompt, WIN_NEW)
    check(torch.equal(toks.cpu(), eager_toks.cpu()),
          "window generate: captured tokens differ from the eager loop's")
    out["generate"] = dict(prompt=WIN_PROMPT, new=WIN_NEW, seconds=dt,
                           ms_per_step=dt / WIN_NEW * 1e3, capture_seconds=cap_s,
                           launches=counts)
    log(f"[window] generate_compiled prompt {WIN_PROMPT} new {WIN_NEW}: {dt:.3f} s "
        f"(prefill and {WIN_NEW - 1} replays; captured in {cap_s:.2f} s), tokens = eager "
        f"loop | launches {counts}")
    clear_programs()

    # the paged server, every prompt past the window, against solo decodes:
    # in bf16 their agreement (near-tied logits of random weights may flip
    # where the batched step's products round otherwise), in f32 equal
    prompts = [([int(t) for t in rng.randint(1, cfg["vocab_size"], n)], new)
               for n, new in WIN_REQUESTS]

    def serve(m):
        srv = PagedDecodeServer(m, max_batch=len(prompts), window=cfg["max_seq_len"],
                                device=DEVICE)
        slots = [srv.submit(p, n, seed=i) for i, (p, n) in enumerate(prompts)]
        steps = 0
        while srv.active():
            srv.step()
            steps += 1
        return [srv.collect(sl) for sl in slots], steps

    def solo(m):
        return [generate_compiled(m, [p], n, device=DEVICE)[0, len(p):].tolist()
                for p, n in prompts]

    (got, steps), dt, counts = _counted(torch, K, lambda: serve(model))
    check(counts.get("paged_attn", 0) > 0
          and counts.get("flash_fwd", 0) == len(prompts) * cfg["num_layers"],
          f"window paged server: launches {counts}")
    add(counts)
    n_tokens = sum(n for _, n in WIN_REQUESTS)
    same = sum(a == b for g, s_ in zip(got, solo(model)) for a, b in zip(g, s_))
    clear_programs()
    f32 = _f32_prefix(torch, model, cfg["num_layers"])
    (got32, _), _, counts32 = _counted(torch, K, lambda: serve(f32))
    add(counts32)
    check(got32 == solo(f32), "window paged server f32: a request differs from its solo "
          "decode")
    del f32
    out["paged_server"] = dict(requests=WIN_REQUESTS, steps=steps, seconds=dt,
                               bf16_agreement=same / n_tokens, launches=counts)
    log(f"[window] PagedDecodeServer {len(prompts)} requests, prompts "
        f"{[n for n, _ in WIN_REQUESTS]}: {steps} steps in {dt:.3f} s; bf16 agreement "
        f"with solo decode {same}/{n_tokens}, f32 every request = its solo decode | "
        f"launches {counts}")
    clear_programs()

    # the f32 gate: one layer at full width, window 96 with 4 sinks, packed
    # ids; the loss and every gradient against the CPU
    gate = _f32_prefix(torch, model, 1)
    del model
    for m in (gate, *(blk.attn for blk in gate.blocks)):
        m.window, m.sinks = WIN_GATE_WINDOW, WIN_GATE_SINKS
    gb = packed_batch(rng, 1, WIN_GATE_SEQ, cfg["vocab_size"], 16, 100)
    cpu = copy.deepcopy(gate).to("cpu")

    def loss_of(m, dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in gb.items()}
        return lm_loss(m(t["tokens"], segment_ids=t["segment_ids"], positions=t["positions"]),
                       t["targets"], mask=t["loss_mask"])

    K.reset_launch_counts()
    loss_gpu = loss_of(gate, DEVICE)
    loss_gpu.backward()
    torch.cuda.synchronize()
    gate_counts = {k: n for k, n in K.launch_counts().items() if n}
    check(all(gate_counts.get(k, 0) == 1 for k in ("flash_fwd", "flash_bwd_dkv",
                                                  "flash_bwd_dq")),
          f"window f32 gate: launches {gate_counts}")
    add(gate_counts)
    loss_cpu = loss_of(cpu, "cpu")
    loss_cpu.backward()
    check(abs(loss_gpu.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"window f32 loss GPU {loss_gpu.item()} vs CPU {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gate.named_parameters():
        r = cpu_params[name].grad
        check(p.grad is not None and r is not None, f"window gate: no gradient for {name}")
        rel = ((p.grad.cpu() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"window f32 gradient of {worst_name} GPU vs CPU: max |err| "
          f"{worst:.3g} of its largest value")
    out["gate"] = dict(seq=WIN_GATE_SEQ, window=WIN_GATE_WINDOW, sinks=WIN_GATE_SINKS,
                       documents=int(gb["segment_ids"].max()) + 1, loss_gpu=loss_gpu.item(),
                       loss_cpu=loss_cpu.item(), worst_grad_rel_err=worst,
                       worst_param=worst_name)
    log(f"[window] f32 gate, 1 layer at full width, S {WIN_GATE_SEQ} window "
        f"{WIN_GATE_WINDOW} sinks {WIN_GATE_SINKS}, {out['gate']['documents']} packed "
        f"documents: loss GPU {loss_gpu.item():.6f} CPU {loss_cpu.item():.6f}; every "
        f"gradient within {worst:.3g} of its largest value (worst {worst_name})")
    del gate, cpu

    # the tape's sdpa with a key-padding mask, forward and backward
    b, h, s, hd = WIN_SDPA
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    q, k, v, ct = (torch.randn((b, h, s, hd), generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    lens = rng.randint(s // 8, s + 1, size=b)
    kvm = torch.from_numpy(np.arange(s)[None] < lens[:, None]).to(DEVICE)
    with md.use_backend(DEVICE):
        tq, tk, tv = (md.Tensor(t, allow_grad=True) for t in (q, k, v))

        def tape():
            o = md.sdpa(tq, tk, tv, mask=md.Tensor(kvm.reshape(b, 1, 1, s)))
            md.sum(o * md.Tensor(ct)).backward()
            return o

        o, dt, counts = _counted(torch, K, tape)
    check(counts == {"flash_fwd": 2, "flash_bwd_dkv": 1, "flash_bwd_dq": 1},
          f"window tape sdpa: launches {counts}")
    add(counts)
    k32 = kvm.to(torch.int32)
    q3, k3, v3, do3 = (t.reshape(b * h, s, hd) for t in (q, k, v, ct))
    op, lp = A._plain_flash_fwd(q3, k3, v3, hd ** -0.5, False, kvm=k32, h=h)
    pq, pk, pv = A._plain_flash_bwd(q3, k3, v3, op, lp, do3, hd ** -0.5, False, kvm=k32, h=h)
    err = max([max_err(torch, o._data.reshape(op.shape), op, "attn", "bfloat16")]
              + [max_err(torch, t.grad._data.reshape(r.shape), r, "attn_bwd", "bfloat16")
                 for t, r in zip((tq, tk, tv), (pq, pk, pv))])
    out["tape_sdpa"] = dict(shape=list(WIN_SDPA), lengths=lens.tolist(), seconds=dt,
                            max_abs_err=err, launches=counts)
    log(f"[window] tape md.sdpa key-padding mask {list(WIN_SDPA)} lengths {lens.tolist()}: "
        f"value and gradients within {err:.3g} of the plain versions, {dt * 1e3:.1f} ms "
        f"| launches {counts}")
    report["window"] = out
    report["launches_window"] = {k: launches.get(k, 0) for k in K.launch_counts()}


if __name__ == "__main__":
    sys.exit(main())
