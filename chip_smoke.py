#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json PATH]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
kernels build from ``minidiff_tpu_torch/kernels/csrc`` into
``minidiff_tpu_torch/_build/`` on first use.  Phases:

1. device: the card's name and power limit; TF32 off for f32 products;
2. kernels: each hand-written kernel against its plain PyTorch version at
   the serving and train paths' shapes, in bf16 and f32, with times for the
   kernel, the plain version and the library call, and the card's lower
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
6. the kernels line: every kernel must have launched on its paths (counts
   are reset just before phases 3, 4 and 5 and read just after each).

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
       ("attn_bwd", "float32"): (1e-4, 1e-5), ("attn_bwd", "bfloat16"): (2 ** -6, 2 ** -6)}
# the kinds whose atol is a share of the plain output's largest magnitude
SCALED = {"attn_bwd"}

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
                  "xent_fwd_kernel", "xent_bwd_kernel")
# the kernels that only the train path runs
TRAIN_ONLY = {"ln_bwd", "addln_bwd", "flash_bwd_dkv", "flash_bwd_dq",
              "xent_fwd", "xent_bwd"}


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

    report = {"device": smi, "seed": args.seed}
    kernels = phase_kernels(torch, report)
    phase_generate(torch, args.seed, report)
    phase_server(torch, args.seed, report)
    phase_train(torch, args.seed, report)

    from minidiff_tpu_torch import kernels as K

    for k in kernels:
        gen = report["launches_generate"][k["name"]]
        srv = report["launches_server"][k["name"]]
        train = report["launches_train"][k["name"]]
        k["launches"] = gen + srv + train
        k["launches_generate"], k["launches_server"] = gen, srv
        k["launches_train"] = train
        serving = k["name"] not in TRAIN_ONLY
        check(train > 0 and (not serving or (gen > 0 and srv > 0)),
              f"kernel {k['name']} did not launch on its paths "
              f"(generate {gen}, server {srv}, train {train})")
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
        "launches_generate", "launches_server", "launches_train")}
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
    for name in _build.SOURCES:
        for line in ptxas_report(_build.build_log(name)):
            log(f"[build] {name}: {line}")

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = (norm_cases(torch, randn) + flash_cases(torch, randn)
             + xent_cases(torch, gen, randn))
    torch.cuda.synchronize()
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms'] * 1e3:8.2f}"
        log(f"[kernel] {c['name']:13s} {c['dtype']:8s} {str(c['shape']):16s}"
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
    # 16 tokens) and the train path's kernels at the train step's shapes
    d, rows = TRAIN_MODEL["dim"], TRAIN_BATCH * TRAIN_SEQ
    bhs = [TRAIN_BATCH * TRAIN_MODEL["num_heads"], TRAIN_SEQ, 128]
    ln_src = "minidiff_tpu_torch/kernels/csrc/layernorm.cu"
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
    """xent_fwd / xent_bwd at the train step's (8192, 512) and (1024, 512)."""
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import xent as X

    cases = []
    v = TRAIN_MODEL["vocab_size"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows in (TRAIN_BATCH * TRAIN_SEQ, 1024):
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


def bound(nbytes: int, flops: int, dtype_name: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    losses = [step(toks, toks) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(toks, toks) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = K.launch_counts()
    report["launches_train"] = counts
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    per_step = {k: n / TRAIN_STEPS for k, n in counts.items()}
    check(per_step == TRAIN_LAUNCHES,
          f"launches per train step {per_step}, expected {TRAIN_LAUNCHES}")

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


if __name__ == "__main__":
    sys.exit(main())
