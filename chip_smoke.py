#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json PATH]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc; the
kernels build from ``minidiff_tpu_torch/kernels/csrc`` into
``minidiff_tpu_torch/_build/`` on first use.  Phases:

1. device: the card's name and power limit; TF32 off for f32 products;
2. kernels: each hand-written kernel against its plain PyTorch version at
   the serving path's shapes, in bf16 and f32, with times for the kernel,
   the plain version and the library call, and the card's lower bound;
3. ``generate_compiled`` at full width (V512 d1024 h8 L4, max_seq_len 512,
   bf16, batch 8, prompt 16, 128 new tokens);
4. ``DecodeServer`` (8 slots, window 512, staggered requests over 1-3
   prompt buckets, slot reuse): in f32 every request must equal its solo
   ``generate_compiled`` decode token for token, and the f32 logits of the
   kernel path must match the plain path run on the CPU; then bf16
   throughput and agreement;
5. the kernels line: every kernel must have launched on the path (counts
   are reset just before phases 3 and 4 and read just after each).

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
TOL = {("ln", "float32"): (1e-5, 1e-5), ("ln", "bfloat16"): (2 ** -7, 1e-3),
       ("attn", "float32"): (1e-5, 1e-5), ("attn", "bfloat16"): (2 ** -6, 2 ** -7),
       ("lse", "float32"): (0.0, 1e-4), ("lse", "bfloat16"): (0.0, 1e-4)}


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

    from minidiff_tpu_torch import kernels as K

    for k in kernels:
        gen = report["launches_generate"][k["name"]]
        srv = report["launches_server"][k["name"]]
        k["launches"] = gen + srv
        k["launches_generate"], k["launches_server"] = gen, srv
        check(gen > 0 and srv > 0,
              f"kernel {k['name']} did not launch on the main path "
              f"(generate {gen}, server {srv})")
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
        "launches_generate", "launches_server")} for k in kernels]}))
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
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{kind}: non-finite output")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{kind} {dtype_name}: max |err| {err.max().item():.3g} beyond "
          f"rtol {rtol} atol {atol}")
    return err.max().item()


def phase_kernels(torch, report):
    import torch.nn.functional as TF

    from minidiff_tpu_torch.kernels import _build
    from minidiff_tpu_torch.kernels import attention as A
    from minidiff_tpu_torch.kernels import layernorm as L

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            spills = "spill" in line and not line.strip().startswith("0 bytes")
            if "registers" in line or spills:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    d = MODEL["dim"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        size = torch.finfo(dtype).bits // 8
        for rows in (8, 128, 1024):
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
        # the path's prefill shapes, one full (non-causal) case, and one
        # sliding-window case that sdpa's window option reaches
        for bh, s, causal, window in ((64, 16, True, None), (8, 128, True, None),
                                      (8, 384, True, None), (8, 384, False, None),
                                      (8, 384, True, 100)):
            q, k, v = (randn(bh, s, 128, dtype=dtype) for _ in range(3))
            scale = 128 ** -0.5
            o, lse = A.flash_fwd(q, k, v, scale, causal, window)
            op, lp = A._plain_flash_fwd(q, k, v, scale, causal, window)
            err = max(max_err(torch, o, op, "attn", dn),
                      max_err(torch, lse, lp, "lse", dn))
            q4, k4, v4 = (t.reshape(1, bh, s, 128) for t in (q, k, v))
            # visible (query, key) pairs: the work this run's mask leaves
            pairs = (int(A._keep_mask(s, s, window, "cpu").sum()) if causal
                     else s * s)
            library = None if window is not None else device_ms(
                torch, lambda: TF.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal))
            cases.append(dict(
                name="flash_fwd", dtype=dn, shape=[bh, s, 128], causal=causal,
                window=window, max_abs_err=err,
                ms=device_ms(torch, lambda: A.flash_fwd(q, k, v, scale, causal,
                                                        window)),
                plain_ms=device_ms(torch, lambda: A._plain_flash_fwd(
                    q, k, v, scale, causal, window)),
                library_ms=library,
                **bound((4 * bh * s * 128) * size + bh * s * 4,
                        4 * bh * pairs * 128, dn)))
    torch.cuda.synchronize()
    for c in cases:
        lib = "-" if c["library_ms"] is None else f"{c['library_ms'] * 1e3:8.2f}"
        log(f"[kernel] {c['name']:9s} {c['dtype']:8s} {str(c['shape']):15s}"
            f"{' causal' if c.get('causal') else '':7s}"
            f"{' w' + str(c['window']) if c.get('window') else '':5s} "
            f"err {c['max_abs_err']:.3g} "
            f"| kernel {c['ms'] * 1e3:8.2f} us | plain {c['plain_ms'] * 1e3:8.2f} us "
            f"| library {lib} us | bound {c['bound_ms'] * 1e3:6.2f} us "
            f"({c['bound_by']})")
    report["kernel_cases"] = cases

    # the kernels line reports each kernel at the shape the bf16 serving path
    # gives it most often: the norms at a decode step's 8 rows, flash at
    # generate_compiled's prefill (8 sequences x 8 heads of 16 tokens)
    meta = {
        "ln_fwd": ("minidiff_tpu_torch/kernels/csrc/layernorm.cu",
                   "minidiff_tpu/kernels/layernorm.py:84", [8, d]),
        "addln_fwd": ("minidiff_tpu_torch/kernels/csrc/layernorm.cu",
                      "minidiff_tpu/kernels/layernorm.py:123", [8, d]),
        "flash_fwd": ("minidiff_tpu_torch/kernels/csrc/flash_fwd.cu",
                      "minidiff_tpu/kernels/attention.py:171", [64, 16, 128]),
    }
    line = []
    for name, (src, replaces, shape) in meta.items():
        c = next(c for c in cases if c["name"] == name and c["dtype"] == "bfloat16"
                 and c["shape"] == shape and not c.get("window"))
        line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         shape=shape, **{key: c[key] for key in (
                             "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}))
    return line


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
    report["generate_profile"] = profile_generate(
        torch, lambda: generate_compiled(model, prompt, 32, device=DEVICE))


def profile_generate(torch, run):
    """Device-busy share and device time by kernel over one decode run,
    from torch.profiler (kernels on one stream never overlap, so the sum of
    their device times is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel events only: operator events carry their kernels'
    # time too, and counting both would count it twice
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    top = [dict(kernel=k[:90], device_us=t, calls=n) for k, t, n in rows[:10]]
    log(f"[profile] generate_compiled 32 new tokens: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%})"
        + ("" if rows else " -- the profiler saw no device time"))
    for r in top:
        log(f"[profile]   {r['device_us']:9.1f} us {r['calls']:5d} calls  {r['kernel']}")
    return dict(wall_us=wall_us, device_busy_us=busy_us, top=top)


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


if __name__ == "__main__":
    sys.exit(main())
