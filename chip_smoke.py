#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and tape paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json PATH]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
kernels build from ``minidiff_tpu_torch/kernels/csrc`` into
``minidiff_tpu_torch/_build/`` on first use.  Phases:

1. device: the card's name and power limit; TF32 off for f32 products;
2. kernels: each hand-written kernel against its plain PyTorch version at
   the serving, train and tape paths' shapes, in bf16 and f32, with times for
   the kernel, the plain version and the library call, and the card's lower
   bound;
3. ``generate_compiled`` at full width (V512 d1024 h8 L4, max_seq_len 512,
   bf16, batch 8, prompt 16, 128 new tokens);
4. ``DecodeServer`` (8 slots, window 512, staggered requests over 1-3
   prompt buckets, slot reuse): in f32 every request must equal its solo
   ``generate_compiled`` decode token for token, and the f32 logits of the
   kernel path must match the plain path run on the CPU; then bf16
   throughput and agreement;
5. the train step at full width (V512 d1024 h8 L4, S 1024, batch 8, bf16,
   ``make_train_step(model, SGD(1e-3), lm_loss)`` on the identity task, as
   the JAX repo's ``bench.py`` headline): finite losses, ms/step, tokens/s,
   model TFLOP/s, the launches per step of every kernel, one profiled step;
   then the f32 gradient gate: loss and every parameter's gradient of the
   kernel path on the card against the plain path on the CPU (batch 1 x
   256 tokens);
6. the tape engine under ``md.use_backend("cuda")``: the JAX repo's
   ``bench.py`` matmul step (``md.value_and_grad`` of ``sum(tanh(x @ w))``
   at 4096² bf16 and an SGD update; ms/step, TFLOP/s, exactly one launch of
   each matmul kernel per step), the device-bound MLP of
   ``benchmarks/mlp_bench.py`` (batch 8192, 784 -> 4096 -> 10, f32, SGD 0.1:
   the loss must fall, exact launches per step), an f32 gate (the value,
   gradients and an hvp of ``sum(tanh(x @ w))`` at 2048² on the card against
   the same tape on the CPU), and the README demo and the 64-dim Rosenbrock
   ``md.hessian`` against their closed forms;
7. the kernels line: every kernel must have launched on its paths (counts
   are reset just before phases 3, 4, 5 and each timed part of 6 and read
   just after each).

Prints progress lines, a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
that line; without a CUDA device, or without the package beside this file,
it exits 2 and prints no result.  ``--json PATH`` also writes every
measurement (all kernel cases, the profile) to PATH.
"""

from __future__ import annotations

import argparse
import json
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
#   dz (order 1/V) rounds once to the logits' dtype.
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
       ("xent_dz", "float32"): (1e-5, 1e-7), ("xent_dz", "bfloat16"): (2 ** -7, 1e-6),
       ("attn_bwd", "float32"): (1e-4, 1e-5), ("attn_bwd", "bfloat16"): (2 ** -6, 2 ** -6),
       ("matmul", "float32"): (0.0, 1e-5), ("matmul", "bfloat16"): (0.0, 1e-2)}
# the kinds whose atol is a share of the plain output's largest magnitude.
#  matmul: both sides accumulate in f32; bf16 rounds the output once (one
#   bf16 ulp, under 2^-8 of the largest value), f32 sums up to K = 8192
#   products in another order: 1e-2 and 1e-5 of the largest value.
SCALED = {"attn_bwd", "matmul"}

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
PORTED_SYMBOLS = ("ln_rows_kernel", "ln_bwd_kernel", "flash_fwd_kernel",
                  "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                  "xent_fwd_kernel", "xent_bwd_kernel", "mm_bf16_kernel",
                  "mm_f32_kernel")
# the kernels that the train path runs and the serving path does not
TRAIN_ONLY = {"ln_bwd", "addln_bwd", "flash_bwd_dkv", "flash_bwd_dq",
              "xent_fwd", "xent_bwd"}
# the kernels that only the tape path runs
TAPE_ONLY = {"matmul_nn", "matmul_nt", "matmul_tn"}

# the tape path.  bench.py:196-234's matmul step: 4096^2 bf16, lr 1e-6, 2
# warm-up and 10 timed steps; each step's forward is one nn product and its
# backward one nt (dx) and one tn (dw)
MM_N, MM_LR, MM_WARMUP, MM_STEPS = 4096, 1e-6, 2, 10
MM_STEP_LAUNCHES = {"matmul_nn": 1, "matmul_nt": 1, "matmul_tn": 1}
# benchmarks/mlp_bench.py's device-bound config mlp_784x4096x10_b8192:
# batch 8192, 784 -> 4096 (relu) -> 10, f32, SGD 0.1.  Per step: layer 1's
# forward (nn) and dW1 (tn) are 52.6 GFLOP each and launch the kernels; x
# takes no gradient (no nt); layer 2's three products are 0.67 GFLOP each,
# under the 2^31-flop rule, and go to torch.matmul; the loss launches
# xent_fwd and its first-order VJP xent_bwd
MLP_BATCH, MLP_IN, MLP_HIDDEN, MLP_OUT, MLP_LR, MLP_STEPS = 8192, 784, 4096, 10, 0.1, 10
MLP_STEP_LAUNCHES = {"matmul_nn": 1, "matmul_tn": 1, "xent_fwd": 1, "xent_bwd": 1}
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
    kernels = phase_kernels(torch, report)
    phase_generate(torch, args.seed, report)
    phase_server(torch, args.seed, report)
    phase_train(torch, args.seed, report)
    phase_tape(torch, args.seed, report)

    from minidiff_tpu_torch import kernels as K

    for k in kernels:
        gen = report["launches_generate"][k["name"]]
        srv = report["launches_server"][k["name"]]
        train = report["launches_train"][k["name"]]
        tape = report["launches_tape"][k["name"]]
        k["launches"] = gen + srv + train + tape
        k["launches_generate"], k["launches_server"] = gen, srv
        k["launches_train"], k["launches_tape"] = train, tape
        if k["name"] in TAPE_ONLY:
            ok = tape > 0
        else:
            serving = k["name"] not in TRAIN_ONLY
            ok = train > 0 and (not serving or (gen > 0 and srv > 0))
        check(ok, f"kernel {k['name']} did not launch on its paths (generate "
                  f"{gen}, server {srv}, train {train}, tape {tape})")
    check(set(K.launch_counts()) == {k["name"] for k in kernels},
          "the kernels line must list every ported kernel")
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
        "launches_generate", "launches_server", "launches_train",
        "launches_tape")}
        for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz: longer than the enqueue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, out, ref, kind, dtype_name):
    rtol, atol = TOL[(kind, dtype_name)]
    out, ref = out.float(), ref.float()
    if kind in SCALED:
        atol *= ref.abs().max().item()
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{kind}: non-finite output")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{kind} {dtype_name}: max |err| {err.max().item():.3g} beyond "
          f"rtol {rtol} atol {atol}")
    return err.max().item()


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
    return lines


def phase_kernels(torch, report):
    from minidiff_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    report["build"] = []
    for name in _build.SOURCES:
        for line in ptxas_report(_build.build_log(name)):
            report["build"].append(f"{name}: {line}")
            log(f"[build] {name}: {line}")

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = (norm_cases(torch, randn) + flash_cases(torch, randn)
             + xent_cases(torch, gen, randn) + matmul_cases(torch, randn))
    torch.cuda.synchronize()
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms'] * 1e3:8.2f}"
        log(f"[kernel] {c['name']:13s} {c['dtype']:8s} {str(c['shape']):18s}"
            f"{' causal' if c.get('causal') else '':7s}"
            f"{' w' + str(c['window']) if c.get('window') else '':5s} "
            f"err {c['max_abs_err']:.3g} "
            f"| kernel {c['ms'] * 1e3:9.2f} us | plain {c['plain_ms'] * 1e3:9.2f} us "
            f"| library {lib} us | bound {c['bound_ms'] * 1e3:7.2f} us "
            f"({c['bound_by']})")
    report["kernel_cases"] = cases

    # the kernels line reports the serving kernels at the shape the bf16
    # serving path gives them most often (the norms at a decode step's 8
    # rows, flash at generate_compiled's prefill of 8 sequences x 8 heads of
    # 16 tokens), the train path's kernels at the train step's shapes and
    # the matmul kernels at the tape's matmul step ([m, n, k])
    d, rows = TRAIN_MODEL["dim"], TRAIN_BATCH * TRAIN_SEQ
    bhs = [TRAIN_BATCH * TRAIN_MODEL["num_heads"], TRAIN_SEQ, 128]
    ln_src = "minidiff_tpu_torch/kernels/csrc/layernorm.cu"
    mm_src = "minidiff_tpu_torch/kernels/csrc/matmul.cu"
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
    }
    line = []
    for name, (src, replaces, shape) in meta.items():
        c = next(c for c in cases if c["name"] == name and c["dtype"] == "bfloat16"
                 and c["shape"] == shape and not c.get("window")
                 and c.get("causal", True))
        line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         shape=shape, **{key: c[key] for key in (
                             "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}))
    return line


def norm_cases(torch, randn):
    """ln_fwd / addln_fwd and ln_bwd / addln_bwd at the decode step's 8 rows,
    prefill-sized rows and the train step's 8192 rows of d = 1024."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import layernorm as L

    cases = []
    d = MODEL["dim"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows in (8, 128, 1024, TRAIN_BATCH * TRAIN_SEQ):
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


def flash_cases(torch, randn):
    """flash_fwd at the serving path's prefill shapes and the train step's
    (64, 1024, 128); flash_bwd_dkv / flash_bwd_dq at the train step's shape
    and smaller ones, full, causal and windowed."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import attention as A

    cases = []
    scale = 128 ** -0.5
    bh_train = TRAIN_BATCH * TRAIN_MODEL["num_heads"]
    fwd = [(torch.bfloat16, 64, 16, True, None), (torch.bfloat16, 8, 128, True, None),
           (torch.bfloat16, 8, 384, True, None), (torch.bfloat16, 8, 384, False, None),
           (torch.bfloat16, 8, 384, True, 100),
           (torch.bfloat16, bh_train, TRAIN_SEQ, True, None),
           (torch.float32, 64, 16, True, None), (torch.float32, 8, 384, True, None),
           (torch.float32, 8, 384, True, 100)]
    bwd = [(torch.bfloat16, bh_train, TRAIN_SEQ, True, None),
           (torch.bfloat16, 8, 384, True, None), (torch.bfloat16, 8, 384, False, None),
           (torch.bfloat16, 8, 384, True, 100), (torch.float32, 8, 256, True, None)]
    for kind, (dtype, bh, s, causal, window) in (
            [("fwd", c) for c in fwd] + [("bwd", c) for c in bwd]):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        q, k, v = (randn(bh, s, 128, dtype=dtype) for _ in range(3))
        q4, k4, v4 = (t.reshape(1, bh, s, 128) for t in (q, k, v))
        # visible (query, key) pairs: the work this run's mask leaves
        pairs = (int(A._keep_mask(s, s, window, "cpu").sum()) if causal
                 else s * s)
        shape = dict(dtype=dn, shape=[bh, s, 128], causal=causal, window=window)
        o, lse = A.flash_fwd(q, k, v, scale, causal, window)
        if kind == "fwd":
            op, lp = A._plain_flash_fwd(q, k, v, scale, causal, window)
            err = max(max_err(torch, o, op, "attn", dn),
                      max_err(torch, lse, lp, "lse", dn))
            library = None if window is not None else device_ms(
                torch, lambda: TF.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal))
            cases.append(dict(
                name="flash_fwd", max_abs_err=err, **shape,
                ms=device_ms(torch, lambda: A.flash_fwd(q, k, v, scale, causal,
                                                        window)),
                plain_ms=device_ms(torch, lambda: A._plain_flash_fwd(
                    q, k, v, scale, causal, window)),
                library_ms=library,
                **bound((4 * bh * s * 128) * size + bh * s * 4,
                        4 * bh * pairs * 128, dn)))
            continue
        do = randn(bh, s, 128, dtype=dtype)
        ops, dims, flags = A._bwd_operands(q, k, v, o, lse, do, window, causal)
        dk, dv = A.flash_bwd_dkv(ops, dims, scale, flags)
        dq = A.flash_bwd_dq(ops, dims, scale, flags)
        pq, pk, pv = A._plain_flash_bwd(q, k, v, o, lse, do, scale, causal, window)
        plain_ms = device_ms(torch, lambda: A._plain_flash_bwd(
            q, k, v, o, lse, do, scale, causal, window), iters=10)
        library = None
        if window is None:
            # autograd of SDPA, the backward only: dq, dk and dv in one call
            ql, kl, vl = (t.clone().requires_grad_() for t in (q4, k4, v4))
            ol = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            do4 = do.reshape(1, bh, s, 128)
            library = device_ms(torch, lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do4, retain_graph=True), iters=10)
        io = bh * s * 128 * size
        stats = 2 * bh * s * 4  # lse and delta, f32
        cases.append(dict(
            name="flash_bwd_dkv", **shape,
            max_abs_err=max(max_err(torch, dk, pk, "attn_bwd", dn),
                            max_err(torch, dv, pv, "attn_bwd", dn)),
            ms=device_ms(torch, lambda: A.flash_bwd_dkv(ops, dims, scale, flags)),
            plain_ms=plain_ms, library_ms=library,
            # S^T, dP^T, P^T dO, dS^T Q over the visible pairs
            **bound(6 * io + stats, 8 * bh * pairs * 128, dn)))
        cases.append(dict(
            name="flash_bwd_dq", **shape,
            max_abs_err=max_err(torch, dq, pq, "attn_bwd", dn),
            ms=device_ms(torch, lambda: A.flash_bwd_dq(ops, dims, scale, flags)),
            plain_ms=plain_ms, library_ms=library,
            # S, dP, dS K
            **bound(5 * io + stats, 6 * bh * pairs * 128, dn)))
    return cases


def xent_cases(torch, gen, randn):
    """xent_fwd / xent_bwd at the train step's (8192, 512) and (1024, 512),
    and at the tape MLP's (8192, 10), whose rows are no whole number of
    16-byte vectors (the kernels' one-element-per-lane route)."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import xent as X

    cases = []
    shapes = [(TRAIN_BATCH * TRAIN_SEQ, TRAIN_MODEL["vocab_size"]),
              (1024, TRAIN_MODEL["vocab_size"]), (MLP_BATCH, MLP_OUT)]
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
                                    X._plain_xent_grad(z, lab, g), "xent_dz", dn),
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
    (8192, 784) @ (784, 4096) and its dW1 (8192, 784)^T @ (8192, 4096)),
    and 1030^3, whose rows are no multiple of 16 bytes (edge tiles in every
    dimension, the bf16 kernels' predicated loads)."""
    from minidiff_tpu_torch.kernels import matmul as M

    fns = {"nn": M.matmul, "nt": M.matmul_nt, "tn": M.matmul_tn}
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ([(v, MM_N, MM_N, MM_N, bf16) for v in fns]
              + [(v, TAPE_GATE_N, TAPE_GATE_N, TAPE_GATE_N, f32) for v in fns]
              + [(v, m, MLP_HIDDEN, k, dt) for dt in (bf16, f32)
                 for v, m, k in (("nn", MLP_BATCH, MLP_IN), ("tn", MLP_IN, MLP_BATCH))]
              + [(v, 1030, 1030, 1030, dt) for dt in (bf16, f32) for v in fns])
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
        cases.append(dict(
            name=f"matmul_{variant}", dtype=dn, shape=[m, n, k],
            max_abs_err=max_err(torch, fn(x, y), M._plain(variant, x, y),
                                "matmul", dn),
            ms=device_ms(torch, lambda: fn(x, y), iters=20),
            plain_ms=device_ms(torch, lambda: M._plain(variant, x, y), iters=20),
            library_ms=device_ms(torch, library, iters=20),
            **bound((m * k + k * n + m * n) * size, 2 * m * n * k, dn)))
    return cases


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
# phase 3: generate_compiled at full width
# ---------------------------------------------------------------------------


def phase_generate(torch, seed: int, report):
    import numpy as np

    from minidiff_tpu_torch import TransformerLM, generate_compiled
    from minidiff_tpu_torch import kernels as K

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **MODEL)
    prompt = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        1, MODEL["vocab_size"], size=(BATCH, PROMPT)))
    # warm-up: the allocator's pools and cuBLAS handles
    generate_compiled(model, prompt, 4, device=DEVICE)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_compiled(model, prompt, NEW, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    report["launches_generate"] = K.launch_counts()
    check(tuple(out.shape) == (BATCH, PROMPT + NEW), f"generate shape {out.shape}")
    check(torch.equal(out[:, :PROMPT].cpu(), prompt), "generate must keep the prompt")
    check(bool(((out >= 0) & (out < MODEL["vocab_size"])).all()), "token out of range")
    tok_s = BATCH * NEW / dt
    report["generate"] = dict(seconds=dt, tok_s=tok_s, ms_per_step=dt / NEW * 1e3)
    log(f"[generate] bf16 V{MODEL['vocab_size']} d{MODEL['dim']} "
        f"L{MODEL['num_layers']} batch {BATCH} prompt {PROMPT} new {NEW}: "
        f"{dt:.3f} s, {tok_s:.0f} tok/s, {dt / NEW * 1e3:.2f} ms/step | "
        f"launches {report['launches_generate']}")
    report["generate_profile"] = profile_run(
        torch, "generate_compiled 32 new tokens",
        lambda: generate_compiled(model, prompt, 32, device=DEVICE))


def profile_run(torch, label, run):
    """Device-busy share and device time by kernel over one run, from
    torch.profiler (kernels on one stream never overlap, so the sum of their
    device times is the busy time).  A first run warms the tracer up and is
    discarded: a window that opens cold loses the device events of its
    first milliseconds."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    # device-side kernel events only: operator events carry their kernels'
    # time too, and counting both would count it twice; the schedule's step
    # annotation spans the whole window and is no kernel
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    busy_us = sum(r[1] for r in rows)
    calls = sum(r[2] for r in rows)
    by_kind: dict = {}
    for k, t, _ in rows:
        kind = ("ported kernels" if any(n in k for n in PORTED_SYMBOLS)
                else "cuBLAS" if k.startswith("nvjet") or "gemm" in k.lower()
                else "other PyTorch kernels and copies")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    rows.sort(key=lambda r: -r[1])
    top = [dict(kernel=k[:90], device_us=t, calls=n) for k, t, n in rows[:12]]
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}) in "
        f"{calls} device calls"
        + ("" if rows else " -- the profiler saw no device time"))
    log("[profile]   by kind: " + ", ".join(
        f"{kind} {t / 1e3:.2f} ms" for kind, t in sorted(by_kind.items())))
    for r in top:
        log(f"[profile]   {r['device_us']:9.1f} us {r['calls']:5d} calls  {r['kernel']}")
    return dict(wall_us=wall_us, device_busy_us=busy_us, device_calls=calls,
                device_us_by_kind=by_kind, top=top)


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

    # f32: the server must reproduce solo decoding token for token
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
    for i, (g, s) in enumerate(zip(got, solo)):
        check(len(g) == REQUESTS[i][1], f"request {i}: {len(g)} tokens")
        if g != s:
            first = next(j for j, (a, b) in enumerate(zip(g, s)) if a != b)
            raise SmokeFailure(f"f32 server request {i} (prompt {REQUESTS[i][0]}) "
                               f"differs from its solo decode at token {first}")
    log(f"[server] f32: {len(REQUESTS)} requests over 8 slots, {steps} steps, "
        f"{n_tokens} tokens in {dt32:.3f} s ({n_tokens / dt32:.0f} tok/s): every "
        f"request token-identical to its solo generate_compiled | launches "
        f"{report['launches_server']}")

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
    del model

    model = TransformerLM(dtype=torch.bfloat16, device=DEVICE, seed=seed, **MODEL)
    srv = DecodeServer(model, max_batch=8, window=512, device=DEVICE)
    run_schedule(srv, prompts[:2])  # warm-up
    t0 = time.perf_counter()
    srv = DecodeServer(model, max_batch=8, window=512, device=DEVICE)
    got, steps, _ = run_schedule(srv, prompts)
    torch.cuda.synchronize()
    dt16 = time.perf_counter() - t0
    solo = [generate_compiled(model, [p], n, device=DEVICE)[0, len(p):].tolist()
            for p, n in prompts]
    same = sum(a == b for g, s in zip(got, solo) for a, b in zip(g, s))
    report["server"] = dict(
        requests=len(REQUESTS), tokens=n_tokens, steps=steps,
        f32_seconds=dt32, f32_tok_s=n_tokens / dt32, bf16_seconds=dt16,
        bf16_tok_s=n_tokens / dt16, bf16_agreement=same / n_tokens,
        f32_logits_max_err_vs_cpu=err)
    log(f"[server] bf16: {n_tokens} tokens in {dt16:.3f} s "
        f"({n_tokens / dt16:.0f} tok/s); agreement with solo decode "
        f"{same}/{n_tokens} = {same / n_tokens:.4f}")


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
    del model, step

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

    def mm_step(state):
        x, w, _ = state
        out, (gx, gw) = vag(x, w)
        return x - MM_LR * gx, w - MM_LR * gw, out

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
    del x, w, state

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
    params = {k: md.Tensor(v, dtype=md.float32) for k, v in params.items()}

    def mlp_loss(p, x, y):
        h = md.maximum(x @ p["w1"] + p["b1"], 0.0)
        logits = h @ p["w2"] + p["b2"]
        return md.mean(md.softmax_xent(logits, y))

    mlp_vag = md.value_and_grad(mlp_loss)

    def mlp_step(state):
        p, history = state
        loss, g = mlp_vag(p, xs, ys)
        return {k: p[k] - MLP_LR * g[k] for k in p}, history + [loss]

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
    del xs, ys, params

    tape_gate(torch, md, seed, report)
    tape_closed_forms(torch, md, report)


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


if __name__ == "__main__":
    sys.exit(main())
