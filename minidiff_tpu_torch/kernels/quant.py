"""Weight-only int8 / int4 dequant-matmuls and attention over an int8 KV
cache, for quantized serving.

Port of ``minidiff_tpu/kernels/quant.py``: the quantizers
(``quantize_int8``, ``quantize_int8_rows``, ``quantize_int4``,
``unpack_int4``, ``quantize_int8_stacked``, plain torch in both packages,
bit-identical codes and scales), ``dequant_matmul``, ``dequant_matmul4``,
``dequant_matmul_bmm`` (an MoE expert bank) and ``sdpa_int8_cache``.
Semantics, shared by the CUDA kernels and the plain versions (acc = f32 for
sub-f32 inputs, else the input dtype):

    dequant_matmul(x, q, s)  = ((x @ q) in acc * s)             -> x.dtype
    dequant_matmul_bmm(x (E, C, K), q (E, K, N), s (E, N))
                             = dequant_matmul(x[e], q[e], s[e]) for each e
    dequant_matmul4(x, p, s) = x @ (unpack(p) * s[group]).to(x.dtype),
                               summed in acc                    -> x.dtype
    sdpa_int8_cache: scores (q . k8) * (ks * scale) in f32, masked to
        l <= pos + (row % c), softmax in f32, (p * vs) rounded to q.dtype
        before the PV product, summed in f32                    -> q.dtype

int8 scales the f32 accumulator after the product; int4 rounds each scaled
weight to x.dtype before it.  int4 packs split-half: ``packed[i]`` holds row
i in its low nibble and row i + K/2 in its high nibble.

A CUDA tensor goes to the hand-written kernels of ``csrc/quant.cu``
(``dq_mm``, ``dq4_mm``, ``dq_bmm``, ``sdpa_int8``); a CPU tensor to the plain
versions (``_plain_dequant_matmul``, ``_plain_dequant_matmul4``,
``_plain_dequant_bmm``, ``_plain_sdpa_int8``, the ports of the JAX
``_jnp_*`` functions).  As in the JAX dispatcher (``quant.py:102-114``), a
product of more than 256 rows (a prefill; for a bank, rows per expert) is
not weight-streaming: ``uses_kernel`` sends it to the plain version on the
dequantized weight, a ``torch.matmul``, on either device.  ``dq_bmm`` and
``dq4_mm`` launch by the plan of ``dq_plan``, decided from shapes and dtypes
before launch: bf16 inside the tensor-core tiles' rule takes a tile (and a
split of K when its output tiles cannot fill the card), everything else the
SIMT tile.  ``dq_mm`` launches by the same plan (``dq_bmm``'s int8 tiles
with one expert).  ``sdpa_int8`` splits each (batch row, kv head) over the
CTAs of one thread-block cluster by the plan of ``sdpa_int8_plan``, from
shapes before launch, and raises there when even 16 splits cannot hold a
split's scores.  A CUDA tensor the kernels do not take raises: nothing
falls back.  These ops serve decoding only and have no autograd; the tape's
ops supply the VJPs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from minidiff_tpu_torch.kernels import _build

# launches of each kernel since the last reset (kernels.reset_launch_counts)
LAUNCHES = {"dq_mm": 0, "dq4_mm": 0, "dq_bmm": 0, "sdpa_int8": 0}
# the most activation rows a dequant-matmul kernel takes (quant.py:111)
MAX_KERNEL_ROWS = 256
# a launch of few output tiles splits K to fill the card (``dq_plan``)
SMS = _build.SMS
# the most K splits of one output tile: the CTAs of a thread-block cluster
# (16, the H100's non-portable cluster size), which sum their partials
# through distributed shared memory
MAX_SPLITS = 16
# csrc/quant.cu's tiles for dq_mm / dq_bmm (8 bits) and dq4_mm (4 bits):
# activation rows and output columns per CTA, and stored weight rows (packed
# rows for int4) per cp.async stage.  "small8" and "small16" compute out^T =
# W^T x^T on mma.sync (rows on the MMA's 8-wide side), "large" the same on
# wgmma (rows on its N side); "simt" is the FFMA tile (8 rows x 64 columns,
# all of K).
TILES = {
    8: {"simt": (8, 64, 0), "small8": (8, 64, 64), "small16": (16, 64, 64),
        "large": (128, 256, 64)},
    4: {"simt": (8, 64, 0), "small8": (8, 64, 32), "small16": (16, 64, 32),
        "large": (128, 128, 32)},
}
# the CTAs up to which splitting K pays on each tensor-core tile: each split
# shortens the CTAs' walk along K but adds its share of the cluster's
# exchange of f32 partials.  From chip_smoke.py's dq_split_ab (PERF.md §6):
# at each of the eight shapes timed, the best split count was the largest
# that kept the launch within 2 x SMS CTAs on the small tiles (4 CTAs an SM)
# and within 3/4 of SMS on the large one (1-2 an SM: a split launch of 128
# CTAs ran slower than one of 64 at each shape that allows both)
SPLIT_CTAS = {"small8": 2 * SMS, "small16": 2 * SMS, "large": 3 * SMS // 4}
# the most k16 tensor-core steps (16 of K each) one split of the large tile
# accumulates: its f32 accumulator does not round as an f32 sum does.  At
# 256 steps (dq4_mm's K 4,096 at one split) an output of chip_smoke.py's
# dq_split_ab that cancels to 6.70e-6 came out 4.9e-6 off its f64 value,
# beyond TOL["dq"]'s 1e-6 of the largest output (4.47e-6); at 128 steps
# 2.0e-6 (PERF.md §6)
LARGE_STEPS = 128
# the C entries' `tile` argument
TILE_CODES = {"simt": 0, "small8": 1, "small16": 2, "large": 3}
# the head dims the attention kernel is built for; others take the plain
# version on either device (``sdpa_int8_cache``)
HEAD_DIMS = (64, 128, 256)
# csrc/quant.cu's sdpa_int8 (namespace dattn): a split's keys start on
# KEY_UNIT boundaries; its ring holds SDPA_STAGES stages of SDPA_STAGE bytes
KEY_UNIT, SDPA_STAGES, SDPA_STAGE = 16, 4, 16384
# a launch splits each (batch row, kv head) until its CTAs reach FILL_CTAS,
# then further while the doubled count of CTAs stays within SDPA_SPLIT_CTAS
# and each split keeps MIN_SPLIT_KEYS keys (``sdpa_int8_plan``).  From
# chip_smoke.py's decode_split_ab (PERF.md §6): one split at 64 (row, head)
# pairs of 256 keys, 4 at 16 pairs of 256, 8 at 32 pairs of 4,096 and 16
# at 8 pairs of 16,384 were the fastest
FILL_CTAS, SDPA_SPLIT_CTAS, MIN_SPLIT_KEYS = 64, 2 * SMS, 512
_NEG_INF = -1e30


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


# ---------------------------------------------------------------------------
# quantizers: plain torch, as in the JAX package
# ---------------------------------------------------------------------------


def quantize_int8(w):
    """(K, N) float -> (q int8 (K, N), s f32 (N,)), symmetric per column:
    s = max|w[:, n]| / 127 (1 for an all-zero column), q = round(w / s)."""
    if w.dim() != 2:
        raise ValueError("quantize_int8 expects a 2-D weight matrix")
    return _quantize_rows(w, 0, 127.0)


def quantize_int8_stacked(w):
    """(E, K, N) float expert bank -> (q int8 (E, K, N), s f32 (E, N)),
    symmetric per (expert, output column)."""
    if w.dim() != 3:
        raise ValueError("quantize_int8_stacked expects a 3-D weight bank")
    return _quantize_rows(w, 1, 127.0)


def quantize_int8_rows(x):
    """(..., hd) float -> (q int8 same shape, s f32 (...,)), per row."""
    return _quantize_rows(x, -1, 127.0)


def _quantize_rows(w, dim: int, qmax: float):
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=dim, keepdim=True)
    s = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / s), -qmax, qmax).to(torch.int8)
    return q, s.squeeze(dim)


def quantize_int4(w, group: int = 128):
    """(K, N) float -> (packed int8 (K/2, N), s f32 (K/group, N)): 4-bit
    symmetric codes in [-7, 7] with one scale per (group of K rows, column),
    packed split-half."""
    if w.dim() != 2:
        raise ValueError("quantize_int4 expects a 2-D weight matrix")
    k, n = w.shape
    if k % 2 or k % group:
        raise ValueError(f"K={k} must be even and divisible by group={group}")
    w32 = w.to(torch.float32)
    amax = w32.reshape(k // group, group, n).abs().amax(dim=1)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / torch.repeat_interleave(s, group, dim=0)),
                    -7, 7).to(torch.int32)
    lo, hi = q[: k // 2], q[k // 2:]
    packed = (((hi << 4) | (lo & 0xF)) & 0xFF).to(torch.uint8)
    return packed.view(torch.int8), s


def unpack_int4(packed):
    """(K/2, N) packed int8 -> (K, N) int8 in [-7, 7] (split-half)."""
    pi = packed.to(torch.int32)
    lo = (pi << 28) >> 28
    hi = (pi << 24) >> 28
    return torch.cat([lo, hi], dim=0).to(torch.int8)


# ---------------------------------------------------------------------------
# plain versions: the ports of the JAX _jnp_* functions
# ---------------------------------------------------------------------------


def _plain_dequant_matmul(x, q, s):
    """(x @ q) in acc, times s, cast to x.dtype (``_jnp_dequant_matmul``)."""
    acc = _acc_dtype(x.dtype)
    return (torch.matmul(x.to(acc), q.to(acc)) * s.to(acc)).to(x.dtype)


def _plain_dequant_bmm(x, q, s):
    """Each expert's (x[e] @ q[e]) in acc, times s[e], cast to x.dtype
    (``_jnp_dequant_bmm``)."""
    acc = _acc_dtype(x.dtype)
    return (torch.bmm(x.to(acc), q.to(acc)) * s.to(acc)[:, None, :]).to(x.dtype)


def _dequantized4(p, s, dtype):
    """The int4 weight (K, N): each code times its group's scale in at least
    f32, rounded to ``dtype``."""
    k, n = 2 * p.shape[0], p.shape[1]
    groups = s.shape[0]
    acc = _acc_dtype(dtype)
    q = unpack_int4(p).reshape(groups, k // groups, n).to(acc)
    return (q * s.to(acc)[:, None, :]).reshape(k, n).to(dtype)


def _plain_dequant_matmul4(x, p, s):
    """x @ the rounded int4 weight, summed in acc (``_jnp_dequant_matmul4``)."""
    acc = _acc_dtype(x.dtype)
    w = _dequantized4(p, s, x.dtype)
    return torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)


def _visible(pos, gc: int, c: int, L: int, device):
    """(B, 1, gc, L) mask: key l is visible to row r iff l <= pos + r % c."""
    row_i = (torch.arange(gc, device=device) % c).reshape(1, 1, gc, 1)
    col_l = torch.arange(L, device=device).reshape(1, 1, 1, L)
    return col_l <= pos.to(torch.int64).reshape(-1, 1, 1, 1) + row_i


def _plain_sdpa_int8(q, k8, ks, v8, vs, pos, c: int, scale: float):
    """q (B, kv, g*c, hd) over the int8 cache (``_jnp_sdpa_int8``)."""
    acc = _acc_dtype(q.dtype)
    gc, L = q.shape[2], k8.shape[2]
    scores = torch.einsum("bkqd,bkld->bkql", q.to(acc), k8.to(acc)) * (
        ks.to(acc)[:, :, None, :] * scale)
    scores = torch.where(_visible(pos, gc, c, L, q.device), scores,
                         torch.full_like(scores, _NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pv = (p * vs.to(acc)[:, :, None, :]).to(q.dtype)
    return torch.einsum("bkql,bkld->bkqd", pv.to(acc), v8.to(acc)).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch and launch
# ---------------------------------------------------------------------------


def uses_kernel(rows: int) -> bool:
    """True when a dequant-matmul of ``rows`` activation rows is weight
    streaming and goes to its kernel; more rows go to the plain version on
    the dequantized weight (``torch.matmul``), as the JAX dispatcher leaves
    them to XLA."""
    return rows <= MAX_KERNEL_ROWS


class DqPlan(NamedTuple):
    """How ``dq_mm`` / ``dq_bmm`` / ``dq4_mm`` launch: the tile (``TILES``;
    "matmul" for more than ``MAX_KERNEL_ROWS`` rows, which launch nothing),
    the K splits of each output tile (the kernel gives split s the units
    [s * units / S, (s + 1) * units / S) of the stored weight rows, a unit
    one stage for int8 and one scale group for int4), and the CTAs."""

    tile: str
    splits: int
    ctas: int


def _tile(bits: int, rows: int, n: int, k: int, dtype, group) -> str:
    """The tile of a product of ``rows`` <= ``MAX_KERNEL_ROWS`` rows: a
    tensor-core tile for bf16 with K a multiple of 16, weight rows 8-byte
    aligned (n % 8 == 0) and, for int4, a group that the tile's stages
    divide and that divides K/2 (every stage inside one group of each
    plane); the SIMT tile for everything else."""
    if dtype != torch.bfloat16 or k % 16 or n % 8:
        return "simt"
    tile = "small8" if rows <= 8 else "small16" if rows <= 16 else "large"
    if bits == 4 and (group % TILES[4][tile][2] or (k // 2) % group):
        return "simt"
    return tile


def dq_plan(bits: int, rows: int, n: int, k: int, dtype, group=None,
            experts: int = 1, tile: str | None = None) -> DqPlan:
    """The launch plan of an int8 (``bits`` 8: ``dq_mm``, or ``dq_bmm`` for
    a bank of ``experts``) or int4 (``bits`` 4, ``group`` rows per scale)
    dequant-matmul of ``rows`` activation rows (per expert), ``k``
    contraction and ``n`` output columns, on the card.  The route is
    decided here, from shapes and dtypes, never after a failed launch:

    - more than ``MAX_KERNEL_ROWS`` rows: "matmul" (the plain product);
    - f32, or a shape outside the tiles' rule (``_tile``): the SIMT tile,
      all of K;
    - else "small8" / "small16" for <= 8 / <= 16 rows, "large" above
      (``tile`` names another tensor-core tile for the same shape, for
      chip_smoke.py's A/B of the tiles).

    A launch splits K, doubling the splits while the doubled count of CTAs
    stays within the tile's ``SPLIT_CTAS``, up to ``MAX_SPLITS`` and the
    units, and never below ``min_splits`` (a K the large tile cannot split
    that far takes the SIMT tile)."""
    if rows > MAX_KERNEL_ROWS:
        return DqPlan("matmul", 1, 0)
    rule = _tile(bits, rows, n, k, dtype, group)
    tile = rule if tile is None or rule == "simt" else tile
    units = 0
    if tile != "simt":
        units = -(-(k // 2 if bits == 4 else k) // (group if bits == 4 else TILES[bits][tile][2]))
        if min_splits(k, tile) > min(units, MAX_SPLITS):
            tile = "simt"
    tr, tc, _ = TILES[bits][tile]
    tiles = experts * -(-rows // tr) * -(-n // tc)
    if tile == "simt":
        return DqPlan(tile, 1, tiles)
    splits = 1
    while (2 * tiles * splits <= SPLIT_CTAS[tile]
           and 2 * splits <= min(units, MAX_SPLITS)):
        splits *= 2
    splits = max(splits, min_splits(k, tile))
    return DqPlan(tile, splits, tiles * splits)


def min_splits(k: int, tile: str) -> int:
    """The fewest K splits ``tile`` takes for a contraction of ``k``: the
    large tile keeps at most ``LARGE_STEPS`` k16 steps in each split's
    accumulator (csrc/quant.cu's tc_args_ok refuses more)."""
    splits = 1
    while tile == "large" and k > 16 * LARGE_STEPS * splits:
        splits *= 2
    return splits


def _check_cuda(name: str, x, *others, dtypes):
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    for t, dt in zip(others, dtypes):
        if t.device != x.device:
            raise TypeError(f"{name}: every operand must be on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operand of {t.dtype} where {dt} is taken")


def _launch(name: str, x, args, dims) -> None:
    with torch.cuda.device(x.device):
        err = _build.function(name)(*_build.ptrs(*args), *dims,
                                    _build.DTYPE_CODES[x.dtype], _build.stream())
    _build.check(err, name)
    LAUNCHES[name] += 1


def dequant_matmul(x, q, s):
    """x (..., K) float @ q (K, N) int8 scaled by s (N,) -> (..., N)."""
    if q.dim() != 2:
        raise ValueError("dequant_matmul expects a 2-D int8 weight")
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"dequant_matmul: x contracts {x.shape[-1]}, weight "
                         f"has {k} rows")
    m = math.prod(x.shape[:-1])
    if x.device.type == "cpu" or not uses_kernel(m):
        return _plain_dequant_matmul(x, q, s)
    _check_cuda("dq_mm", x, q, s, dtypes=(torch.int8, torch.float32))
    if s.shape != (n,):
        raise ValueError(f"dq_mm: scales {tuple(s.shape)}, expected ({n},)")
    if not m:
        return torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    out = _dq_tiles(x.reshape(m, k), q, s, dq_plan(8, m, n, k, x.dtype))
    return out.reshape(*x.shape[:-1], n)


def dequant_matmul_bmm(x, q, s):
    """x (E, C, K) float @ q (E, K, N) int8 * s (E, N) -> (E, C, N).  C > 256
    rows per expert take the plain version (``uses_kernel``)."""
    if x.dim() != 3 or q.dim() != 3:
        raise ValueError("dequant_matmul_bmm expects 3-D x and weight bank")
    if x.shape[0] != q.shape[0] or x.shape[2] != q.shape[1]:
        raise ValueError(f"dequant_matmul_bmm: x {tuple(x.shape)} vs bank "
                         f"{tuple(q.shape)}")
    e, c, k = x.shape
    n = q.shape[2]
    if x.device.type == "cpu" or not uses_kernel(c):
        return _plain_dequant_bmm(x, q, s)
    _check_cuda("dq_bmm", x, q, s, dtypes=(torch.int8, torch.float32))
    if s.shape != (e, n):
        raise ValueError(f"dq_bmm: scales {tuple(s.shape)}, expected ({e}, {n})")
    if not e * c * n:
        return torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    return _dq_tiles(x, q, s, dq_plan(8, c, n, k, x.dtype, experts=e))


def dequant_matmul4(x, p, s):
    """x (..., K) @ (unpack_int4(p (K/2, N)) * s (K/G, N)) -> (..., N)."""
    if p.dim() != 2 or s.dim() != 2:
        raise ValueError("dequant_matmul4 expects a 2-D packed weight and "
                         "2-D group scales")
    k, n = 2 * p.shape[0], p.shape[1]
    if x.shape[-1] != k:
        raise ValueError(f"dequant_matmul4: x contracts {x.shape[-1]}, "
                         f"weight has {k} rows")
    groups = s.shape[0]
    if groups < 1 or k % groups or s.shape[1] != n:
        raise ValueError(f"dequant_matmul4: scales {tuple(s.shape)} do not "
                         f"group {k} rows of {n} columns")
    m = math.prod(x.shape[:-1])
    if x.device.type == "cpu" or not uses_kernel(m):
        return _plain_dequant_matmul4(x, p, s)
    _check_cuda("dq4_mm", x, p, s, dtypes=(torch.int8, torch.float32))
    if not m:
        return torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    out = _dq_tiles(x.reshape(m, k), p, s, dq_plan(4, m, n, k, x.dtype, group=k // groups))
    return out.reshape(*x.shape[:-1], n)


def _dq_tiles(x, w, s, plan: DqPlan):
    """``dq_bmm`` (x (E, C, K), w an int8 bank), ``dq_mm`` (x (M, K), w int8,
    s (N,)) or ``dq4_mm`` (x (M, K), w packed int4, s (K/G, N)) launched by
    ``plan``, into a new output."""
    n = w.shape[-1]
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    ops = [_build.operand(t) for t in (x, w, s)]
    tile = (TILE_CODES[plan.tile], plan.splits)
    if x.dim() == 3:
        e, c, k = x.shape
        _launch("dq_bmm", x, (*ops, out), (e, c, n, k, *tile))
    elif s.dim() == 1:
        m, k = x.shape
        _launch("dq_mm", x, (*ops, out), (m, n, k, *tile))
    else:
        m, k = x.shape
        _launch("dq4_mm", x, (*ops, out), (m, n, k, k // s.shape[0], *tile))
    return out


class SdpaPlan(NamedTuple):
    """How ``sdpa_int8`` launches: query rows per block of its PV phase (1,
    2, 4 or 8; the scores take blocks of up to 4), the CTAs per (batch row,
    kv head) (one cluster), the shared memory of each CTA in bytes, and the
    CTAs."""

    rows: int
    splits: int
    smem: int
    ctas: int


def split_keys(L: int, splits: int) -> int:
    """The most keys of one split: ``KEY_UNIT`` * ceil(ceil(L / KEY_UNIT) /
    splits) (split s takes units [s U / S, (s + 1) U / S) of the U 16-key
    units of its live range)."""
    return KEY_UNIT * -(-(-(-L // KEY_UNIT)) // splits)


def _sdpa_smem(rows: int, gc: int, hd: int, L: int, splits: int) -> int:
    """csrc/quant.cu's dattn::smem_bytes: the ring, the receive buffer
    [rows * hd], q [gc][hd] in f32, the scores [gc][split_keys], the splits'
    row maxima and sums [S][gc], the row statistics [4][gc], then one
    mbarrier per stage."""
    floats = rows * hd + gc * hd + gc * split_keys(L, splits) + 2 * splits * gc + 4 * gc
    return SDPA_STAGES * SDPA_STAGE + -(-4 * floats // 8) * 8 + 8 * SDPA_STAGES


def sdpa_int8_plan(b: int, kv: int, gc: int, hd: int, L: int, dtype,
                   splits=None) -> SdpaPlan:
    """The launch plan of ``sdpa_int8`` for ``b`` rows of ``kv`` KV heads,
    ``gc`` query rows per KV head (group x chunk), head dim ``hd`` and a
    cache of ``L`` lines, from shapes only (a read of ``pos`` would
    synchronise every step).  A split holds the f32 scores of its keys, so
    the splits are at least the least power of two whose share fits the
    block (``_build.SMEM_LIMIT``); past ``MAX_SPLITS`` this raises a
    ValueError before launch.  At 16 splits the plan takes gc x L up to
    595,968-664,832 (L 74,496 at hd 256 and gc 8, 162,048 at hd 128 and gc
    4), so every g <= 8 at c = 1 and L <= 65,536.  Above that least count the
    splits double while the CTAs are fewer than ``FILL_CTAS`` (and each
    split gets a 16-key unit of L), then while the doubled count of CTAs
    stays within ``SDPA_SPLIT_CTAS`` and each split keeps
    ``MIN_SPLIT_KEYS`` keys (``splits`` names another count, for
    chip_smoke.py's split A/B; the dtype does not change the plan: q is
    staged in f32)."""
    del dtype
    rows = 1 if gc == 1 else 2 if gc == 2 else 4 if gc <= 4 else 8
    least = 1
    while _sdpa_smem(rows, gc, hd, L, least) > _build.SMEM_LIMIT:
        least *= 2
        if least > MAX_SPLITS:
            raise ValueError(
                f"sdpa_int8: {gc} query rows over {L} cache lines need "
                f"{_sdpa_smem(rows, gc, hd, L, MAX_SPLITS)} bytes of shared "
                f"memory per CTA at MAX_SPLITS = {MAX_SPLITS} splits, beyond "
                f"the {_build.SMEM_LIMIT} a CTA may use")
    if splits is None:
        splits, units = 1, -(-L // KEY_UNIT)
        while 2 * splits <= min(MAX_SPLITS, units) and b * kv * splits < FILL_CTAS:
            splits *= 2
        while (2 * splits <= MAX_SPLITS and 2 * b * kv * splits <= SDPA_SPLIT_CTAS
               and split_keys(L, 2 * splits) >= MIN_SPLIT_KEYS):
            splits *= 2
        splits = max(splits, least)
    return SdpaPlan(rows, splits, _sdpa_smem(rows, gc, hd, L, splits),
                    b * kv * splits)


def _grouped(q, k8, scale):
    """q (B, h, c, hd) as (B, kv, g*c, hd) rows (head-in-group, chunk
    position), its chunk size and the scale."""
    bq, h, c, hd = q.shape
    kv = k8.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (hd ** 0.5)
    return q.reshape(bq, kv, (h // kv) * c, hd), c, scale


def _plain_sdpa_int8_cache(q, k8, ks, v8, vs, pos, scale=None):
    """``sdpa_int8_cache`` by its plain version, on any device."""
    qg, c, scale = _grouped(q, k8, scale)
    return _plain_sdpa_int8(qg, k8, ks, v8, vs, pos, c, scale).reshape(q.shape)


def sdpa_int8_cache(q, k8, ks, v8, vs, pos, scale=None):
    """Masked attention over an int8 KV cache (serving).

    q (B, h, c, hd) with h a multiple of the cache's kv heads; k8/v8
    (B, kv, L, hd) int8; ks/vs (B, kv, L) f32 per-row scales; pos (B,) int:
    key l is visible to chunk position i iff l <= pos + i.  Returns
    (B, h, c, hd) in q.dtype.  A head dim the kernel is not built for
    (``HEAD_DIMS``) takes the plain version on either device.
    """
    if q.device.type == "cpu" or q.shape[-1] not in HEAD_DIMS:
        return _plain_sdpa_int8_cache(q, k8, ks, v8, vs, pos, scale)
    _check_cuda("sdpa_int8", q, k8, ks, v8, vs,
                dtypes=(torch.int8, torch.float32, torch.int8, torch.float32))
    qg, c, scale = _grouped(q, k8, scale)
    bq, kv, gc, hd = qg.shape
    L = k8.shape[2]
    if (k8.shape != (bq, kv, L, hd) or v8.shape != k8.shape
            or ks.shape != (bq, kv, L) or vs.shape != ks.shape
            or gc * kv != q.shape[1] * c):
        raise ValueError(f"sdpa_int8: q {tuple(q.shape)}, cache "
                         f"{tuple(k8.shape)}, scales {tuple(ks.shape)}")
    plan = sdpa_int8_plan(bq, kv, gc, hd, L, q.dtype)
    return _sdpa_launch(qg, k8, ks, v8, vs, pos, c, scale, plan).reshape(q.shape)


def _sdpa_launch(qg, k8, ks, v8, vs, pos, c: int, scale: float, plan: SdpaPlan):
    """``sdpa_int8`` on qg (B, kv, g*c, hd) launched by ``plan``, into a
    new output."""
    bq, kv, gc, hd = qg.shape
    out = torch.empty_like(qg)
    if qg.numel():
        posc = pos.to(device=qg.device, dtype=torch.int32)
        ops = [_build.operand(t) for t in (qg, k8, ks, v8, vs, posc)]
        _launch("sdpa_int8", qg, (*ops, out), (bq, kv, gc, c, hd, k8.shape[2], scale,
                                               plan.rows, plan.splits, plan.smem))
    return out


def for_tape(name: str):
    """The tape's forward of the op ``name``, chosen by the activations'
    dtype as ``_build.tape_entry`` chooses."""
    return _build.tape_entry(name, *{
        "dequant_matmul": (dequant_matmul, _plain_dequant_matmul),
        "dequant_matmul4": (dequant_matmul4, _plain_dequant_matmul4),
        "dequant_matmul_bmm": (dequant_matmul_bmm, _plain_dequant_bmm),
        "sdpa_int8_cache": (sdpa_int8_cache, _plain_sdpa_int8_cache)}[name])
