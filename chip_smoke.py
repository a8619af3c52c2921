"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_recognition_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and drives four paths:

- decode+augment: holds the kernel against its plain PyTorch version at
  the train step's shapes, holds the flagship's logits on the card
  against the CPU, then runs the port's main path — 20 bf16 train steps
  of ``conv_1d_time_sliced_with_attention`` at batch 384 on a synthetic
  bank the size of the full Speech Commands corpus, and one validation
  sweep — and checks that every train step launched the kernel;
- separable block (``[separable]``): holds the fused forward kernel, in
  its ``fuse`` and ``fold`` variants, against its plain version at the
  flagship's 11 trunk shapes at batch 384 in bf16 and f32, then runs the
  block benchmark (``benchmark_separable_blocks``) and checks that it
  launched both variants; prints each shape's ``fuse`` and ``fold`` time
  against its bound, the time of the pointwise product alone in cuBLAS
  (a yardstick the port never calls), a ``torch.profiler`` account of
  the forward's kernels and ``ptxas -v``'s registers, shared memory and
  spills for each build;
- separable block backward (``[separable-bwd]``): holds the backward
  kernel against its plain version at the same shapes and dtypes, and
  without the prologue and at a VALID stride-2 shape with T - k odd;
  holds the gradients of ``fused_separable_block_vjp`` against autograd
  of the ATen block; then runs the forward+backward benchmark
  (``benchmark_separable_block_grads``) and checks that it launched the
  backward and ``fold`` kernels as often as it called them; prints each
  shape's backward time against its bound, the time of the backward's
  two products alone in cuBLAS (a yardstick the port never calls), a
  ``torch.profiler`` account of the backward's kernels and of a
  ``vjp_grad`` call's, ``vjp_grad``'s host time split into autograd's
  own, the forward's and the backward wrapper's, and ``ptxas -v``'s
  registers, shared memory and spills for each kernel;
- data-parallel training (``[dp]``): two ranks, spawned processes joined
  by NCCL when each has a card of its own and by gloo when they share
  one. Each rank builds and replicates the full-corpus bank, holds
  ``decode_augment_sharded`` against its plain version on its rows,
  holds a 2-rank step in f32 and in f64 against one process on the batch,
  trains 20 bf16 steps at global batch 384 and sweeps validation; the
  parent checks that the kernel launched once per step on every rank,
  that the losses and the parameters are the same on both ranks.

Any failure, on any rank, raises and exits non-zero; without a CUDA
device it exits non-zero before printing any result. The last two lines
of standard output are a JSON record of the kernels (each with its
bound: the larger of its bytes over 3.35 TB/s and its operations over
the peak rate of its type, the H100 SXM data sheet's) and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
import hashlib
import json
import re
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch

MODEL = "conv_1d_time_sliced_with_attention"
BATCH = 384
T = 16000
STEPS, WARMUP = 15, 5             # 20 train steps in all
# bench.py's full_corpus scale: 75,621 clips = 2.42 GB of int16
NUM_TRAIN, NUM_VAL, NUM_PSEUDO = 64_727, 6_798, 4_096
NUM_BACKGROUND, BACKGROUND_LEN = 6, 16000 * 60
KERNEL_ATOL = 1e-6
LOGITS_ATOL = 1e-3
KERNEL_SOURCES = ("decode_augment", "separable_block", "separable_block_bwd")
# separable block, kernel against its plain version on the same inputs.
# y: f32 (TF32 off) differs only in the order of the f32 sums of up to
# 3 x 512 products, |y| < ~10; bf16 rounds at the same points as the plain
# version, so a y differs by at most the one bf16 step that a different
# f32 sum can round it to.
SEP_Y_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}
# s1, s2: f32 sums over 384 x To rows taken with atomics in another
# order, per channel relative to sum|y| (s1) and to s2.
SEP_STATS_RTOL = 1e-4
# separable block backward, kernel against its plain version on the same
# inputs, each output relative to its largest |value|. dx (rtol, atol): in
# f32 it differs only by ddw's f32 sum order; in bf16 a different f32 sum
# can flip ddw to the neighbouring bf16 value, which moves one tap piece
# of dx by a bf16 step (measured up to 8.6e-4 of max|dx|, at T=11
# 512->512). The f32 sums dw_dw, dw_pw, da, db are taken over up to 152k
# rows with atomics in another order (f32: measured up to 2.1e-6); in bf16
# a flipped ddw also moves one term of a sum by a bf16 step (measured up
# to 1.5e-4).
SEP_BWD_DX_TOL = {torch.float32: (0.0, 1e-5),
                  torch.bfloat16: (2.0 ** -6, 2.0 ** -8)}
SEP_BWD_SUM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# the VJP's gradients against autograd of the ATen block, f32 (the JAX
# test's bound: the kernel recomputes the depthwise chain in another order)
VJP_GRAD_RTOL = 5e-4
BWD_NAMES = ("dx", "dw_dw", "dw_pw", "da", "db")
# the [dp] phase
DP_RANKS = 2
DP_TIMEOUT_S = 600
# one 2-rank step against one process on the same global batch, weights
# and dropout masks (TF32 off): (loss relative to its value, median and
# max over a gradient's entries of the error relative to its max |value|).
# The two take the BN statistics and the gradient sums in another order
# (two halves, then the all-reduce), and cuDNN may pick other algorithms
# at batch 192 than at 384. f32 itself is only so accurate here: on one
# process its gradients differ from f64's by a median of up to 9e-4 of
# max |g| in the first layers (the BN backward's sums cancel) and by up
# to 1.9e-2 in the row of an output channel where a BN output lies within
# f32 rounding of relu6's clamp and takes its gradient on one side only
# (CPU, batch 48). So the f32 bounds are f32's own error, several times
# over; per-rank BN statistics miss them by far (CPU, batch 48: loss 3e-3,
# median 0.24). In f64 no clamp is that close and the sums keep ~1e-16, so
# the f64 bounds are tight.
DP_TOL = {torch.float32: (1e-5, 1e-2, 1e-1),
          torch.float64: (1e-12, 1e-12, 1e-9)}
# NVIDIA H100 SXM data sheet: HBM bytes/s; dense FLOP/s in f32 (CUDA
# cores) and bf16 (tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and do ``flops`` operations of ``dtype``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def decode_augment_bound(bank, bg_flat, file_ids, shifts, fg_vol, bg_pos,
                         bg_vol):
    """(ms, bound_by, bytes) of one decode+augment call on these inputs:
    the bank rows that a row with fg_vol != 0 reads (each distinct row
    once), the background samples that a row with bg_vol != 0 reads (the
    union of their windows), the five [B] vectors and the [B, T] f32
    output; 3 f32 operations per output sample."""
    b, t = file_ids.shape[0], bank.shape[1]
    bank_rows = torch.unique(file_ids[fg_vol != 0]).numel()
    pos = bg_pos[bg_vol != 0].long()
    edges = torch.zeros(bg_flat.shape[0] + 1, dtype=torch.int64,
                        device=pos.device)
    edges.index_add_(0, pos, torch.ones_like(pos))
    edges.index_add_(0, pos + t, -torch.ones_like(pos))
    bg_samples = int((edges.cumsum(0)[:-1] > 0).sum())
    nbytes = (bank_rows * t * bank.element_size()
              + bg_samples * bg_flat.element_size()
              + sum(v.numel() * v.element_size()
                    for v in (file_ids, shifts, fg_vol, bg_pos, bg_vol))
              + b * t * 4)
    return (*bound(nbytes, 3 * b * t, torch.float32), nbytes)


def separable_bound(shape, batch: int, backward: bool):
    """(ms, bound_by, bytes, FLOP) of the separable block in bf16 with the
    prologue and the statistics at one ``(T, Cin, Cout, stride,
    padding)``. Forward: x, the weights, a and b in; y, s1 and s2 out;
    the pointwise product (2 B To Cin Cout) plus the depthwise taps, the
    prologue and the statistics. Backward: x, y, dy, ds1, ds2, the
    weights, a and b in; dx, dw_dw, dw_pw, da and db out; the two
    products (4 B To Cin Cout) plus the recomputed taps, the taps of ddw
    into dx and dw_dw, the prologue and its gradient, and dy's
    statistics terms."""
    from speech_recognition_tpu_torch.ops.kernels.separable_block import (
        out_len,
    )
    t, cin, cout, stride, padding = shape
    to = out_len(t, 3, stride, padding)[0]
    x, y = batch * t * cin * 2, batch * to * cout * 2
    weights = 3 * cin * 2 + cin * cout * 2 + 2 * cin * 4
    taps = 2 * 3 * batch * to * cin
    if backward:
        nbytes = 2 * x + 2 * y + weights + 2 * cout * 4 \
            + (3 * cin + cin * cout + 2 * cin) * 4
        flops = (4 * batch * to * cin * cout + 3 * taps
                 + 4 * batch * t * cin + 3 * batch * to * cout)
    else:
        nbytes = x + y + weights + 2 * cout * 4
        flops = (2 * batch * to * cin * cout + taps
                 + 2 * batch * t * cin + 3 * batch * to * cout)
    return (*bound(nbytes, flops, torch.bfloat16), nbytes, flops)


def separable_bounds(shapes, batch: int, backward: bool):
    """(ms, bound_by) of the separable block summed over ``shapes`` (see
    ``separable_bound``)."""
    parts = [separable_bound(s, batch, backward) for s in shapes]
    return (sum(p[0] for p in parts),
            "/".join(sorted({p[1] for p in parts})))


def timed_build(name: str):
    from speech_recognition_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    lib = build.build(name)
    return lib, time.perf_counter() - t0


def compare_block(got, want, dtype):
    """(max abs err of y, y elements out of tolerance, worst relative
    error of s1, of s2) of the kernel's ``got`` against ``want``."""
    y, s1, s2 = got
    yw, s1w, s2w = want
    if y.shape != yw.shape or y.dtype != dtype or not torch.isfinite(y).all():
        raise RuntimeError(f"separable kernel output {y.dtype} "
                           f"{tuple(y.shape)} (want {tuple(yw.shape)}), or "
                           f"non-finite values")
    rtol, atol = SEP_Y_TOL[dtype]
    d = (y.float() - yw.float()).abs()
    bad = int((d > atol + rtol * yw.float().abs()).sum())
    scale1 = yw.float().abs().sum((0, 1)).clamp_min(1e-30)
    e1 = float(((s1 - s1w).abs() / scale1).max())
    e2 = float(((s2 - s2w).abs() / s2w.clamp_min(1e-30)).max())
    return float(d.max()), bad, e1, e2


def separable_phase(device, card: str, build_s: float, ptxas: list[str]):
    """The separable block: kernel against plain at the 11 trunk shapes,
    two extra cases, then the benchmark, each shape's time against its
    bound and the cuBLAS yardstick (``profile_separable`` profiles the
    forward's kernels after the backward's phase). Returns the
    ``kernels`` entries."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
        benchmark_separable_blocks, separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    phase_t0 = time.perf_counter()
    log(f"[separable] library built in {build_s:.2f} s | tolerances: y "
        f"bf16 rtol 2^-7 atol 1e-5, f32 atol 1e-4 (TF32 off); s1, s2 "
        f"relative {SEP_STATS_RTOL}")
    for line in ptxas:
        log(f"[separable] ptxas -v {line}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = dict(S.LAUNCHES)
    calls = {"fuse": 0, "fold": 0}
    worst = {"fuse": 0.0, "fold": 0.0}
    failures = []

    def check(label, variant, dtype, ins, **kw):
        fold = variant == "fold"
        got = S.fused_separable_block(*ins, fold_weights=fold, **kw)
        want = S.separable_block_plain(*ins, fold_weights=fold, **kw)
        calls[variant] += 1
        if not kw.get("emit_stats", True):
            if not isinstance(got, torch.Tensor):
                raise RuntimeError("emit_stats=False returned more than y")
            none = torch.zeros(1, device=device)
            got, want = (got, none, none), (want, none, none)
        err, bad, e1, e2 = compare_block(got, want, dtype)
        worst[variant] = max(worst[variant], err)
        if bad or e1 > SEP_STATS_RTOL or e2 > SEP_STATS_RTOL:
            failures.append(f"{label} {variant} {dtype}: y max abs err "
                            f"{err:.3g} ({bad} out of tolerance), s1 {e1:.3g},"
                            f" s2 {e2:.3g}")
        return err, e1, e2

    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(
            t, cin, cout, batch=BATCH, dtype=torch.float32, device=device)
        parts = []
        for dtype in (torch.bfloat16, torch.float32):
            ins = [v.to(dtype) for v in (x, w_dw, w_pw)] + [a, b]
            for variant in ("fuse", "fold"):
                err, e1, e2 = check(f"T={t} {cin}->{cout} s{stride}", variant,
                                    dtype, ins, stride=stride,
                                    padding=padding)
                parts.append(f"{variant} {str(dtype)[6:]} {err:.3g}"
                             f"/{max(e1, e2):.2g}")
        torch.cuda.synchronize()
        log(f"[separable] T={t:3d} {cin}->{cout} s{stride} {padding:5s} "
            f"B={BATCH}: y max abs err / stats rel err: " + ", ".join(parts))
    # a stride-2 SAME shape without the prologue, and without the
    # statistics
    t, cin, cout, stride, padding = SEPARABLE_SHAPES[1]
    x, w_dw, w_pw, _, _ = separable_block_inputs(
        t, cin, cout, batch=BATCH, device=device)
    for variant in ("fuse", "fold"):
        check("no prologue", variant, torch.bfloat16, (x, w_dw, w_pw),
              stride=stride, padding=padding)
        check("emit_stats=False", variant, torch.bfloat16, (x, w_dw, w_pw),
              stride=stride, padding=padding, emit_stats=False)
    torch.cuda.synchronize()
    log(f"[separable] T={t} {cin}->{cout} s{stride} {padding} bf16 without "
        f"the prologue and with emit_stats=False: checked")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    rose = {v: S.LAUNCHES[v] - before[v] for v in calls}
    if rose != calls:
        raise RuntimeError(f"separable LAUNCHES rose by {rose} in {calls} "
                           f"calls")
    if failures:
        raise RuntimeError("separable kernel against its plain version: "
                           + "; ".join(failures))

    # the path: the block benchmark, with the counts set to 0 just before
    for variant in S.LAUNCHES:
        S.LAUNCHES[variant] = 0
    records = benchmark_separable_blocks(device)
    launches = dict(S.LAUNCHES)
    expected = len(SEPARABLE_SHAPES) * (1 + SEPARABLE_ITERS * SEPARABLE_RUNS)
    if launches != {"fuse": expected, "fold": expected, "bwd": 0}:
        raise RuntimeError(f"the block benchmark launched {launches}, "
                           f"expected {expected} of each")
    totals = {v: sum(r[f"{v}_ms"] for r in records)
              for v in ("plain", "fuse", "fold")}
    for r in records:
        if not all(np.isfinite(r[f"{v}_ms"]) and r[f"{v}_ms"] > 0
                   for v in totals):
            raise RuntimeError(f"benchmark record {r}")
        log(f"[separable] bench T={r['T']:3d} {r['Cin']}->{r['Cout']} "
            f"s{r['stride']} {r['padding']:5s} B={r['batch']} bf16: plain "
            f"{r['plain_ms']:.4f} ms, fuse {r['fuse_ms']:.4f} ms, fold "
            f"{r['fold_ms']:.4f} ms | {card}")
    log(f"[separable] total over {len(records)} shapes: plain "
        f"{totals['plain']:.4f} ms, fuse {totals['fuse']:.4f} ms, fold "
        f"{totals['fold']:.4f} ms (best of {SEPARABLE_RUNS} x "
        f"{SEPARABLE_ITERS} calls); "
        f"launches in the benchmark {launches}; phase "
        f"{time.perf_counter() - phase_t0:.1f} s | {card}")
    bound_ms, bound_by = separable_bounds(SEPARABLE_SHAPES, BATCH,
                                          backward=False)
    log(f"[separable] bound over the {len(records)} shapes: "
        f"{bound_ms:.4f} ms ({bound_by}); fuse at "
        f"{100 * bound_ms / totals['fuse']:.1f} %, fold at "
        f"{100 * bound_ms / totals['fold']:.1f} % of it")
    gemm_ms = gemm_yardstick(device, backward=False)
    for r, shape, lib_ms in zip(records, SEPARABLE_SHAPES, gemm_ms):
        ms, by, nbytes, flops = separable_bound(shape, BATCH, backward=False)
        label = (f"T={r['T']:3d} {r['Cin']}->{r['Cout']} s{r['stride']} "
                 f"{r['padding']:5s}")
        log(f"[separable] {label} bound {ms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); fuse "
            f"{r['fuse_ms']:.4f} ms, share {100 * ms / r['fuse_ms']:.1f} %; "
            f"fold {r['fold_ms']:.4f} ms, share "
            f"{100 * ms / r['fold_ms']:.1f} %; plain {r['plain_ms']:.4f} ms; "
            f"yardstick, the pointwise product alone in cuBLAS (torch.matmul "
            f"of a precomputed bf16 dw by w_pw) {lib_ms:.4f} ms | {card}")
    log(f"[separable] yardstick total {sum(gemm_ms):.4f} ms; no single "
        f"library call computes the block, so library_ms is null")
    return [{
        "name": f"separable_block/{variant}",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/separable_block.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/experiments/"
                    "separable_kernel.py:167",
        "launches": launches[variant],
        "max_abs_err": worst[variant],
        "ms": totals[variant],
        "plain_ms": totals["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    } for variant in ("fuse", "fold")]


def bwd_operands(shape, device):
    """The inputs of the backward at ``shape``, batch 384, bf16, with the
    cotangents and the prologue: ``(args, kw)`` for
    ``separable_block_bwd``."""
    from speech_recognition_tpu_torch.export.benchmark import (
        separable_block_cotangents, separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    t, cin, cout, stride, padding = shape
    x, w_dw, w_pw, a, b = separable_block_inputs(t, cin, cout, batch=BATCH,
                                                 device=device)
    kw = dict(stride=stride, padding=padding)
    y = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)[0]
    dy, ds1, ds2 = separable_block_cotangents(y.shape[1], cout, batch=BATCH,
                                              device=device)
    return (x, y, dy, ds1, ds2, w_dw, w_pw, a, b), kw


def fwd_operands(shape, device):
    """The forward's inputs at ``shape``, batch 384, bf16, with the
    prologue: ``(args, kw)`` for ``fused_separable_block``."""
    from speech_recognition_tpu_torch.export.benchmark import (
        separable_block_inputs,
    )
    t, cin, cout, stride, padding = shape
    return (separable_block_inputs(t, cin, cout, batch=BATCH, device=device),
            dict(stride=stride, padding=padding))


def gemm_yardstick(device, backward: bool):
    """ms per shape of the block's pointwise products alone by
    ``torch.matmul`` (cuBLAS) on bf16 operands computed beforehand with
    the plain version's arithmetic: forward dw @ w_pw; backward dw^T @
    dyt and dyt @ w_pw^T. What a library gives for the GEMM part; the
    port never calls it."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES, time_calls,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    out = []
    for shape in SEPARABLE_SHAPES:
        (x, y, dy, ds1, ds2, w_dw, w_pw, a, b), kw = bwd_operands(shape,
                                                                  device)
        t, cin, cout = shape[:3]
        t_out, pad_lo = S.out_len(t, 3, kw["stride"], kw["padding"])
        xin = torch.clamp(x * a.bfloat16() + b.bfloat16(), 0, 6)
        dw = S._depthwise_fuse(xin, w_dw, kw["stride"], pad_lo,
                               t_out).reshape(-1, cin)
        wpw = w_pw.reshape(cin, cout)
        if backward:
            dyt = (dy.float() + ds1 + 2 * y.float() * ds2).bfloat16() \
                .reshape(-1, cout)
            out.append(time_calls(lambda: (torch.matmul(dw.T, dyt),
                                           torch.matmul(dyt, wpw.T)),
                                  SEPARABLE_ITERS, SEPARABLE_RUNS))
        else:
            out.append(time_calls(lambda: torch.matmul(dw, wpw),
                                  SEPARABLE_ITERS, SEPARABLE_RUNS))
    return out


def profile_kernels(groups) -> None:
    """Device time by kernel by ``torch.profiler``, in one session for
    every ``(tag, what, calls)`` group: the calls (one per trunk shape,
    each after a warm-up call) run inside a ``record_function`` range of
    their group that ends in a synchronize, so each kernel counts for the
    group whose range holds its start (kernels launched through ctypes
    are linked to no torch op, so the profiler's own attribution misses
    them). Logs per group the sums over its calls."""
    for _, _, calls in groups:
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    label = "profiled group "
    with torch.profiler.profile(activities=acts) as prof:
        for i, (_, _, calls) in enumerate(groups):
            with torch.profiler.record_function(f"{label}{i}"):
                for fn in calls:
                    fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {int(e.name[len(label):]): e.time_range for e in prof.events()
              if e.device_type != cuda and e.name.startswith(label)}
    sums = [{} for _ in groups]
    for e in prof.events():
        if e.device_type != cuda or e.is_user_annotation \
                or e.name.startswith(label):
            continue
        i = next((i for i, r in ranges.items()
                  if r.start <= e.time_range.start <= r.end), None)
        if i is None:
            continue
        found = re.search(r"\w+_kernel\b", e.name)
        name = found.group(0) if found else e.name.split("(")[0].strip()
        sums[i][name] = sums[i].get(name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3
    for (tag, what, calls), kernels in zip(groups, sums):
        if not kernels:
            log(f"{tag} profiler, {what}: no device time recorded")
            continue
        busy = sum(kernels.values())
        log(f"{tag} profiler, {what}, device ms summed over the {len(calls)} "
            f"shapes: busy {busy:.4f}; " + ", ".join(
                f"{n} {ms:.4f} ({100 * ms / busy:.0f} %)" for n, ms in
                sorted(kernels.items(), key=lambda kv: -kv[1])))


def vjp_grad_call(shape, device):
    """One ``vjp_grad`` call of the gradient benchmark at ``shape`` as a
    callable: autograd.grad through ``fused_separable_block_vjp`` to its
    five leaves (bf16 x, w_dw, w_pw; f32 a, b). Returns ``(call, leaves,
    cotangents, kw)``."""
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    (x, _, dy, ds1, ds2, w_dw, w_pw, a, b), kw = bwd_operands(shape, device)
    leaves = [v.detach().requires_grad_() for v in (x, a, b, w_dw, w_pw)]
    cts = (dy, ds1, ds2)
    return (lambda: torch.autograd.grad(S.fused_separable_block_vjp(
        *leaves, kw["stride"], kw["padding"]), leaves, cts),
        leaves, cts, kw)


def profile_separable(device) -> None:
    """The profiler's account of the separable block's kernels: one
    ``fuse``, one ``fold``, one backward and one ``vjp_grad`` call per
    trunk shape."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_SHAPES,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    devices = [device] * len(SEPARABLE_SHAPES)
    fwd = list(map(fwd_operands, SEPARABLE_SHAPES, devices))
    profile_kernels([
        ("[separable]", f"one {variant} call per shape", [
            functools.partial(S.fused_separable_block, *ins,
                              fold_weights=variant == "fold", **kw)
            for ins, kw in fwd])
        for variant in ("fuse", "fold")] + [
        ("[separable-bwd]", "one bwd call per shape", [
            functools.partial(S.separable_block_bwd, *args, **kw)
            for args, kw in map(bwd_operands, SEPARABLE_SHAPES, devices)]),
        ("[separable-bwd]", "one vjp_grad call per shape", [
            vjp_grad_call(shape, device)[0] for shape in SEPARABLE_SHAPES])])


class _NoLaunch(torch.autograd.Function):
    """The VJP's leaves and outputs with nothing launched: ``apply(x, a, b,
    w_dw, w_pw, zeros, outs)`` returns empty tensors like ``outs`` and
    takes ``zeros`` as the leaves' gradients. What autograd costs alone."""

    @staticmethod
    def forward(ctx, x, a, b, w_dw, w_pw, zeros, outs):
        ctx.zeros = zeros
        return tuple(torch.empty_like(o) for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        return (*ctx.zeros, None, None)


def vjp_host_account(device, card: str) -> None:
    """Where ``vjp_grad``'s time goes when the host sets its pace: ms per
    call on the host clock, summed over the 11 trunk shapes, of
    autograd.grad through a Function that launches nothing (autograd's
    own cost, with the VJP's leaves and outputs), of the forward alone
    (``fused_separable_block_vjp``, recording the graph), of the backward
    wrapper alone, of ``SeparableBlockFunction.backward`` called on this
    thread, of autograd.grad through the real forward whose backward
    returns gradients made beforehand, and of the whole ``vjp_grad``
    call. Each is the best of 3 runs of 20 calls after one call, with no
    synchronize inside a run, so it is host time: the card's queue never
    fills."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(SEPARABLE_RUNS):
            t0 = time.perf_counter()
            for _ in range(SEPARABLE_ITERS):
                fn()
            best = min(best, (time.perf_counter() - t0) / SEPARABLE_ITERS)
            torch.cuda.synchronize()
        return 1e3 * best

    class ForwardOnly(S.SeparableBlockFunction):
        """The VJP's forward; its backward returns ``grads``."""
        grads = None

        @staticmethod
        def backward(ctx, *cts):
            return ForwardOnly.grads

    parts = {"autograd.grad through a Function that launches nothing": 0.0,
             "the forward (fused_separable_block_vjp)": 0.0,
             "the backward wrapper (separable_block_bwd)": 0.0,
             "SeparableBlockFunction.backward on the calling thread": 0.0,
             "autograd.grad through the forward with a backward that "
             "launches nothing": 0.0,
             "the whole vjp_grad call": 0.0}
    names = list(parts)
    for shape in SEPARABLE_SHAPES:
        call, leaves, cts, kw = vjp_grad_call(shape, device)
        x, a, b, w_dw, w_pw = leaves
        y, s1, s2 = (v.detach() for v in S.fused_separable_block(
            x, w_dw, w_pw, a, b, **kw))
        zeros = tuple(torch.zeros_like(v) for v in leaves)
        ForwardOnly.grads = (*zeros, None, None)
        args = [v.detach() for v in (x, y, *cts, w_dw, w_pw, a, b)]
        ctx = types.SimpleNamespace(
            saved_tensors=(*(v.detach() for v in leaves), y), conv=kw)
        fns = (lambda: torch.autograd.grad(_NoLaunch.apply(
                   *leaves, zeros, (y, s1, s2)), leaves, cts),
               lambda: S.fused_separable_block_vjp(*leaves, kw["stride"],
                                                   kw["padding"]),
               lambda: S.separable_block_bwd(*args, **kw),
               lambda: S.SeparableBlockFunction.backward(ctx, *cts),
               lambda: torch.autograd.grad(ForwardOnly.apply(
                   *leaves, kw["stride"], kw["padding"]), leaves, cts),
               call)
        for name, fn in zip(names, fns):
            parts[name] += host_ms(fn)
    log(f"[separable-bwd] vjp_grad on the host clock, ms per call summed "
        f"over the {len(SEPARABLE_SHAPES)} shapes: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in parts.items()) + f" | {card}")


def compare_bwd(got, want, dtype):
    """Per output of the backward (dx, dw_dw, dw_pw, da, db; da and db
    only with the prologue): (max abs err, max abs err relative to the
    output's largest |value|, elements out of tolerance) of the kernel's
    ``got`` against ``want``."""
    errs = {}
    for name, g, w in zip(BWD_NAMES, got, want):
        if (g is None) != (w is None):
            raise RuntimeError(f"backward {name}: {g} against {w}")
        if w is None:
            continue
        want_dtype = dtype if name == "dx" else torch.float32
        if g.shape != w.shape or g.dtype != want_dtype \
                or not torch.isfinite(g).all():
            raise RuntimeError(f"backward {name} {g.dtype} {tuple(g.shape)}"
                               f" (want {want_dtype} {tuple(w.shape)}), or "
                               f"non-finite values")
        d = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max())
        rtol, atol = (SEP_BWD_DX_TOL[dtype] if name == "dx"
                      else (0.0, SEP_BWD_SUM_RTOL[dtype]))
        bad = int((d > rtol * w.float().abs() + atol * scale).sum())
        errs[name] = (float(d.max()), float(d.max()) / max(scale, 1e-30), bad)
    return errs


def separable_bwd_phase(device, card: str, build_s: float,
                        ptxas: list[str]):
    """The separable block's backward: kernel against plain at the 11
    trunk shapes and two extra cases, the VJP against autograd of the
    ATen block, then the forward+backward benchmark, each shape's time
    against its bound, the cuBLAS yardstick and a profile of the
    backward's kernels. Returns the ``kernels`` entry."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
        benchmark_separable_block_grads, separable_block_cotangents,
        separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    phase_t0 = time.perf_counter()
    log(f"[separable-bwd] library built in {build_s:.2f} s | tolerances, "
        f"relative to each output's max |value|: dx f32 atol 1e-5 (TF32 "
        f"off), bf16 rtol 2^-6 atol 2^-8; dw_dw, dw_pw, da, db f32 "
        f"{SEP_BWD_SUM_RTOL[torch.float32]}, bf16 "
        f"{SEP_BWD_SUM_RTOL[torch.bfloat16]}; VJP against autograd "
        f"{VJP_GRAD_RTOL}")
    for line in ptxas:
        log(f"[separable-bwd] ptxas -v {line}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = dict(S.LAUNCHES)
    calls = 0
    worst = 0.0
    failures = []

    def check(label, dtype, x, w_dw, w_pw, a, b, **kw):
        nonlocal calls, worst
        y = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)[0]
        cts = separable_block_cotangents(y.shape[1], w_pw.shape[2],
                                         batch=x.shape[0], dtype=dtype,
                                         device=device)
        args = (x, y, *cts, w_dw, w_pw, a, b)
        got = S.separable_block_bwd(*args, **kw)
        calls += 1
        errs = compare_bwd(got, S.separable_block_bwd_plain(*args, **kw),
                           dtype)
        worst = max([worst] + [e[0] for e in errs.values()])
        bad = {n: e[2] for n, e in errs.items() if e[2]}
        if bad:
            failures.append(f"{label} {dtype}: out of tolerance {bad}; "
                            f"{errs}")
        return got, errs

    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(
            t, cin, cout, batch=BATCH, dtype=torch.float32, device=device)
        parts = []
        for dtype in (torch.bfloat16, torch.float32):
            _, errs = check(f"T={t} {cin}->{cout} s{stride}", dtype,
                            *(v.to(dtype) for v in (x, w_dw, w_pw)), a, b,
                            stride=stride, padding=padding)
            parts.append(f"{str(dtype)[6:]} " + " ".join(
                f"{n} {e[1]:.2g}" for n, e in errs.items()))
        torch.cuda.synchronize()
        log(f"[separable-bwd] T={t:3d} {cin}->{cout} s{stride} "
            f"{padding:5s} B={BATCH}: max abs err / max |value|: "
            + "; ".join(parts))
    # a stride-2 SAME shape without the prologue, and a VALID stride-2
    # shape with T - k odd (its last input row feeds no output)
    t, cin, cout, stride, padding = SEPARABLE_SHAPES[1]
    x, w_dw, w_pw, _, _ = separable_block_inputs(t, cin, cout, batch=BATCH,
                                                 device=device)
    check("no prologue", torch.bfloat16, x, w_dw, w_pw, None, None,
          stride=stride, padding=padding)
    x, w_dw, w_pw, a, b = separable_block_inputs(t + 1, cin, cout,
                                                 batch=BATCH, device=device)
    got, _ = check("odd VALID", torch.bfloat16, x, w_dw, w_pw, a, b,
                   stride=2, padding="VALID")
    if not (got[0][:, -1] == 0).all():
        failures.append(f"T={t + 1} s2 VALID: the last input row has a "
                        f"gradient")
    torch.cuda.synchronize()
    log(f"[separable-bwd] T={t} {cin}->{cout} s{stride} {padding} bf16 "
        f"without the prologue, and T={t + 1} s2 VALID (last row dx 0): "
        f"checked")

    # the VJP in f32 against autograd of the ATen block
    vjp_before = dict(S.LAUNCHES)
    leaves = [v.float().requires_grad_() for v in separable_block_inputs(
        t, cin, cout, batch=BATCH, device=device)]
    x, w_dw, w_pw, a, b = leaves
    cts = separable_block_cotangents(S.out_len(t, 3, stride, padding)[0],
                                     cout, batch=BATCH, dtype=torch.float32,
                                     device=device)
    got = torch.autograd.grad(S.fused_separable_block_vjp(
        x, a, b, w_dw, w_pw, stride, padding), leaves, cts)
    rose = {v: S.LAUNCHES[v] - vjp_before[v] for v in S.LAUNCHES}
    if rose != {"fuse": 0, "fold": 1, "bwd": 1}:
        raise RuntimeError(f"the VJP launched {rose}")
    want = torch.autograd.grad(S.reference_block(
        x, w_dw, w_pw, a, b, stride=stride, padding=padding), leaves, cts)
    vjp_errs = {}
    for name, g, w in zip(("dx", "dw_dw", "dw_pw", "da", "db"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"VJP {name} {g.dtype} {tuple(g.shape)}")
        vjp_errs[name] = float((g - w).abs().max()) / float(w.abs().max())
    if max(vjp_errs.values()) > VJP_GRAD_RTOL:
        failures.append(f"VJP against autograd: {vjp_errs}")
    log(f"[separable-bwd] VJP T={t} {cin}->{cout} s{stride} {padding} "
        f"B={BATCH} f32, gradients against autograd of reference_block, "
        f"max abs err / max |value|: " + ", ".join(
            f"{n} {e:.2g}" for n, e in vjp_errs.items()))
    del leaves, x, w_dw, w_pw, a, b, got, want
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    rose = {v: S.LAUNCHES[v] - before[v] for v in S.LAUNCHES}
    if rose != {"fuse": 0, "fold": 1, "bwd": calls + 1}:
        raise RuntimeError(f"separable LAUNCHES rose by {rose} in {calls} "
                           f"backward calls and one VJP")
    if failures:
        raise RuntimeError("separable backward: " + "; ".join(failures))

    # the path: the gradient benchmark, with the counts set to 0 just before
    for variant in S.LAUNCHES:
        S.LAUNCHES[variant] = 0
    records = benchmark_separable_block_grads(device)
    launches = dict(S.LAUNCHES)
    per_variant = 1 + SEPARABLE_ITERS * SEPARABLE_RUNS
    # per shape: one forward for y, then vjp_grad (fold + bwd) and bwd
    expected = {"fuse": 0,
                "fold": len(SEPARABLE_SHAPES) * (1 + per_variant),
                "bwd": len(SEPARABLE_SHAPES) * 2 * per_variant}
    if launches != expected:
        raise RuntimeError(f"the gradient benchmark launched {launches}, "
                           f"expected {expected}")
    names = ("plain_grad", "vjp_grad", "bwd", "bwd_plain")
    totals = {v: sum(r[f"{v}_ms"] for r in records) for v in names}
    for r in records:
        if not all(np.isfinite(r[f"{v}_ms"]) and r[f"{v}_ms"] > 0
                   for v in names):
            raise RuntimeError(f"benchmark record {r}")
        log(f"[separable-bwd] bench T={r['T']:3d} {r['Cin']}->{r['Cout']} "
            f"s{r['stride']} {r['padding']:5s} B={r['batch']} bf16: "
            + ", ".join(f"{v} {r[f'{v}_ms']:.4f} ms" for v in names)
            + f" | {card}")
    log(f"[separable-bwd] total over {len(records)} shapes: " + ", ".join(
        f"{v} {totals[v]:.4f} ms" for v in names)
        + f" (best of {SEPARABLE_RUNS} x {SEPARABLE_ITERS} calls); launches "
        f"in the benchmark {launches}; phase "
        f"{time.perf_counter() - phase_t0:.1f} s | {card}")
    bound_ms, bound_by = separable_bounds(SEPARABLE_SHAPES, BATCH,
                                          backward=True)
    log(f"[separable-bwd] bound over the {len(records)} shapes: "
        f"{bound_ms:.4f} ms ({bound_by}); bwd at "
        f"{100 * bound_ms / totals['bwd']:.1f} % of it")
    gemm_ms = gemm_yardstick(device, backward=True)
    for r, shape, lib_ms in zip(records, SEPARABLE_SHAPES, gemm_ms):
        ms, by, nbytes, flops = separable_bound(shape, BATCH, backward=True)
        label = (f"T={r['T']:3d} {r['Cin']}->{r['Cout']} s{r['stride']} "
                 f"{r['padding']:5s}")
        log(f"[separable-bwd] {label} bwd {r['bwd_ms']:.4f} ms, bound "
            f"{ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP), share {100 * ms / r['bwd_ms']:.1f} % | {card}")
        log(f"[separable-bwd] {label} yardstick, the two products alone in "
            f"cuBLAS (torch.matmul on precomputed bf16 dw, dyt, w_pw): "
            f"{lib_ms:.4f} ms | {card}")
    log(f"[separable-bwd] yardstick total {sum(gemm_ms):.4f} ms; no single "
        f"library call computes the backward, so library_ms is null")
    return {
        "name": "separable_block/bwd",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/separable_block_bwd.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/experiments/"
                    "separable_kernel.py:391",
        "launches": launches["bwd"],
        "max_abs_err": worst,
        "ms": totals["bwd"],
        "plain_ms": totals["bwd_plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def edge_case_draws(trainer, ds, starts=(0,)):
    """A training batch's draws with the kernel's edge cases written in
    from each row of ``starts``: zero and most-negative shifts, silence
    rows, bg_vol 0, the largest legal background position and the top
    file ids of the bank."""
    d = trainer.draw_batch()
    n, m = ds.num_clips, ds.background.flat.shape[0]
    for i in starts:
        d.shifts[i:i + 4] = torch.tensor([0, -500, -1, -T + 1])
        d.fg_vol[i + 4:i + 8] = 0.0
        d.bg_vol[i + 8:i + 12] = 0.0
        d.bg_pos[i + 12:i + 16] = m - T
        d.file_ids[i + 16:i + 20] = torch.arange(n - 4, n)
    return d


def state_digest(model) -> str:
    """sha256 of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_rank(rank: int, world: int, init_method: str, backend: str,
            results) -> None:
    """One rank of the [dp] phase (a spawned process). It prints nothing:
    it puts one dict of results on ``results``; an exception fails the
    phase."""
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train, time_calls,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        decode_augment as K,
    )
    from speech_recognition_tpu_torch.ops.kernels import sharded as KS
    from speech_recognition_tpu_torch.parallel.collectives import all_reduce_
    from speech_recognition_tpu_torch.parallel.distributed import (
        host_replicated, initialize_distributed,
    )
    from speech_recognition_tpu_torch.parallel.mesh import (
        make_mesh, rank_device, shard_batch,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    device = rank_device(rank)
    torch.cuda.set_device(device)
    initialize_distributed(init_method, world, rank, backend)
    mesh = make_mesh(device)
    out = {"rank": rank, "device": str(device)}

    def barrier():
        all_reduce_(torch.zeros(1, device=device), mesh)
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    ds = synthetic_device_dataset(
        device, num_train=NUM_TRAIN, num_val=NUM_VAL, num_pseudo=NUM_PSEUDO,
        num_classes=12, num_background=NUM_BACKGROUND,
        background_len=BACKGROUND_LEN)
    torch.cuda.synchronize(device)
    out["data_s"] = time.perf_counter() - t0
    barrier()
    t0 = time.perf_counter()
    host_replicated(ds, mesh)
    torch.cuda.synchronize(device)
    out["replicate_s"] = time.perf_counter() - t0
    settings = prepare_model_settings(label_count=12)
    augment = AugmentConfig(pseudo_frequency=0.6)

    # the kernel on this rank's rows against its plain version, on the
    # global draws with edge cases in both ranks' rows
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dp = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                 compute_dtype="float32", mesh=mesh)
    d = edge_case_draws(dp, ds, starts=range(0, BATCH, BATCH // world))
    bg = ds.background.flat
    errs = []
    for index_dtype in (torch.int64, torch.int32):
        args = (mesh, ds.wav_bank, bg, d.file_ids.to(index_dtype),
                d.shifts.to(index_dtype), d.fg_vol, d.bg_pos.to(index_dtype),
                d.bg_vol)
        got = KS.decode_augment_sharded(*args)
        want = KS.decode_augment_sharded_reference(*args)
        torch.cuda.synchronize(device)
        if got.shape != (BATCH // world, T) or not torch.isfinite(got).all():
            raise RuntimeError(f"rank {rank}: sharded kernel output "
                               f"{tuple(got.shape)} or non-finite values")
        errs.append(float((got - want).abs().max()))
    out["max_abs_err"] = max(errs)
    if out["max_abs_err"] > KERNEL_ATOL:
        raise RuntimeError(f"rank {rank}: decode_augment_sharded vs plain "
                           f"max abs err {errs} > {KERNEL_ATOL}")
    args = (mesh, ds.wav_bank, bg, d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
            d.bg_vol)
    out["bound_ms"], out["bound_by"], out["bytes"] = decode_augment_bound(
        ds.wav_bank, bg, *shard_batch(args[3:], mesh))
    for r in range(world):      # one rank at a time on a shared card
        barrier()
        if r == rank:
            plain_ms, kernel_ms, plain_ms2, kernel_ms2 = (
                time_calls(fn, 50, runs=1) for fn in 2 * (
                    lambda: KS.decode_augment_sharded_reference(*args),
                    lambda: KS.decode_augment_sharded(*args)))
            out["ms"] = min(kernel_ms, kernel_ms2)
            out["plain_ms"] = min(plain_ms, plain_ms2)
    barrier()

    # one 2-rank step against one process on the same global batch,
    # weights and dropout masks, in f32 and in f64
    ref = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                  compute_dtype="float32")
    draw_state = dp.generator.get_state()
    out["parity"] = {}
    ref_grads = {}
    for dtype in DP_TOL:
        dp.generator.set_state(draw_state)
        ref.generator.set_state(draw_state)
        dp_state, ref_state = dp.init_state(), ref.init_state()
        dp_state.model.to(dtype)
        ref_state.model.to(dtype)
        got = dp._update_step(dp_state, dp.build_batch(d).to(dtype),
                              shard_batch(d.labels, mesh))
        want = ref._update_step(ref_state, ref.build_batch(d).to(dtype),
                                d.labels)
        ref_grads[dtype] = {n: p.grad.double() for n, p in
                            ref_state.model.named_parameters()}
        medians, maxima = {}, {}
        for name, p in dp_state.model.named_parameters():
            g = ref_grads[dtype][name]
            e = (p.grad - g).abs() / g.abs().max().clamp_min(1e-30)
            medians[name], maxima[name] = float(e.median()), float(e.max())
        loss_err = abs(float(got["loss"]) - float(want["loss"])) \
            / abs(float(want["loss"]))
        name = str(dtype)[6:]
        worst = max(maxima, key=maxima.get)
        worst_median = max(medians, key=medians.get)
        out["parity"][name] = (loss_err, worst_median, medians[worst_median],
                               worst, maxima[worst])
        loss_tol, median_tol, max_tol = DP_TOL[dtype]
        if loss_err > loss_tol or medians[worst_median] > median_tol \
                or maxima[worst] > max_tol:
            raise RuntimeError(f"rank {rank}: {world}-rank {name} step vs "
                               f"one process: {out['parity'][name]}")
        del dp_state, ref_state, got, want
    # f32's own error, for scale: one process, f32 against f64
    out["f32_vs_f64"] = max(
        float(((g - ref_grads[torch.float64][n]).abs()
               / ref_grads[torch.float64][n].abs().max()).median())
        for n, g in ref_grads[torch.float32].items())
    del dp, ref, ref_grads
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32

    # the path: 20 bf16 train steps, then one validation sweep, with the
    # counts set to 0 just before
    trainer = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                      mesh=mesh)
    if trainer.compute_dtype != "bfloat16":
        raise RuntimeError(f"compute dtype {trainer.compute_dtype}")
    state = trainer.init_state()
    barrier()
    torch.cuda.reset_peak_memory_stats(device)
    KS.LAUNCHES = K.LAUNCHES = 0
    result = benchmark_train(trainer, state, steps=STEPS, warmup=WARMUP)
    t0 = time.perf_counter()
    conf, val_loss = trainer.evaluate(state, "validation")
    out["eval_s"] = time.perf_counter() - t0
    out["launches"] = {"decode_augment_sharded": KS.LAUNCHES,
                       "decode_augment": K.LAUNCHES}
    out.update(losses=result["losses"], ms_per_step=result["ms_per_step"],
               clips_per_sec=result["clips_per_sec"],
               wall_ms_per_step=result["wall_ms_per_step"],
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               conf=conf.tolist(), val_loss=val_loss,
               digest=state_digest(state.model))

    # what one all-reduce of the step costs on this backend, host clock
    # around whole calls: a BN layer's [C + 1] statistics (12 layers x 4,
    # and the metrics: 49 small ones per step) and the one gradient bucket
    numel = sum(p.numel() for p in state.model.parameters())
    out["all_reduce_ms"] = {}
    for label, n, reps in (("[513]", 513, 50), ("bucket", numel, 5)):
        x = torch.zeros(n, device=device)
        barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            all_reduce_(x, mesh)
        torch.cuda.synchronize(device)
        out["all_reduce_ms"][label] = 1e3 * (time.perf_counter() - t0) / reps
    results.put(out)
    barrier()
    torch.distributed.destroy_process_group()


def dp_phase(card: str):
    """The [dp] phase: spawn the ranks, collect and check their results.
    Returns the ``kernels`` entry of ``decode_augment_sharded``."""
    import torch.multiprocessing as mp

    from speech_recognition_tpu_torch.parallel.distributed import (
        default_backend,
    )
    from speech_recognition_tpu_torch.parallel.mesh import rank_device

    world = DP_RANKS
    backend = default_backend(world)
    devices = {r: str(rank_device(r)) for r in range(world)}
    shared = len(set(devices.values())) < world
    log(f"[dp] {world} ranks, backend {backend}, rank -> device {devices}; "
        f"{BATCH // world} clips per rank of a global batch of {BATCH}"
        + ("; the ranks share one card" if shared else ""))
    phase_t0 = time.perf_counter()
    queue = mp.get_context("spawn").SimpleQueue()
    procs = mp.spawn(dp_rank, nprocs=world, join=False, args=(
        world, f"tcp://localhost:{free_port()}", backend, queue))
    results = {}

    def collect():
        while not queue.empty():
            r = queue.get()
            results[r["rank"]] = r

    try:
        while not procs.join(timeout=1):    # raises if a rank failed
            collect()
            if time.perf_counter() - phase_t0 > DP_TIMEOUT_S:
                raise RuntimeError(f"[dp] ranks still running after "
                                   f"{DP_TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    collect()
    if sorted(results) != list(range(world)):
        raise RuntimeError(f"[dp] results from ranks {sorted(results)}")
    rs = [results[r] for r in range(world)]

    for r in rs:
        log(f"[dp] rank {r['rank']} on {r['device']}: bank set up in "
            f"{r['data_s']:.1f} s, replicated from rank 0 in "
            f"{r['replicate_s']:.2f} s; decode_augment_sharded "
            f"[{BATCH // world}, {T}] max abs err {r['max_abs_err']:.3g} "
            f"(tol {KERNEL_ATOL}), kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bytes'] / 1e6:.1f} MB) | {card}")
        for dtype, tol in DP_TOL.items():
            loss_err, worst_median, median, worst, worst_err = \
                r["parity"][str(dtype)[6:]]
            log(f"[dp] rank {r['rank']} {str(dtype)[6:]} (TF32 off) "
                f"{world}-rank step vs one process on the global batch: "
                f"loss rel err "
                f"{loss_err:.3g} (tol {tol[0]}); gradient error / max "
                f"|value|: worst median {median:.3g} in {worst_median} (tol "
                f"{tol[1]}), worst max {worst_err:.3g} in {worst} (tol "
                f"{tol[2]})")
        log(f"[dp] rank {r['rank']} one process, f32 against f64: worst "
            f"median gradient error / max |value| {r['f32_vs_f64']:.3g}")
    steps = STEPS + WARMUP
    expected = (NUM_VAL // BATCH) * BATCH
    for r in rs:
        if r["launches"] != {"decode_augment_sharded": steps,
                             "decode_augment": steps}:
            raise RuntimeError(f"[dp] rank {r['rank']} launched "
                               f"{r['launches']} in {steps} train steps")
        if len(r["losses"]) != steps or not np.isfinite(r["losses"]).all():
            raise RuntimeError(f"[dp] rank {r['rank']} losses {r['losses']}")
        if sum(map(sum, r["conf"])) != expected \
                or not np.isfinite(r["val_loss"]):
            raise RuntimeError(f"[dp] rank {r['rank']}: confusion sums to "
                               f"{sum(map(sum, r['conf']))}, expected "
                               f"{expected}; val loss {r['val_loss']}")
    for key in ("losses", "digest", "conf", "val_loss"):
        if any(r[key] != rs[0][key] for r in rs):
            raise RuntimeError(f"[dp] {key} differs between ranks: "
                               f"{[r[key] for r in rs]}")
    log(f"[dp] losses {[round(v, 4) for v in rs[0]['losses']]}, equal on "
        f"every rank; parameters and BN statistics bit-identical (sha256 "
        f"{rs[0]['digest'][:16]})")
    scaling = ("; the ranks share one card, so this is no measure of "
               "scaling" if shared else "")
    for r in rs:
        log(f"[dp] rank {r['rank']} {MODEL} bf16 global batch {BATCH}: "
            f"{r['ms_per_step']:.3f} ms/step, {r['clips_per_sec']:.0f} "
            f"global clips/s (CUDA events over {STEPS} steps after "
            f"{WARMUP}; host clock {r['wall_ms_per_step']:.3f} ms/step); "
            f"peak memory {r['peak_gb']:.2f} GB{scaling} | {card}")
    conf = np.asarray(rs[0]["conf"])
    log(f"[dp] one {backend} all-reduce on the card's tensors, host clock: "
        + "; ".join(f"rank {r['rank']} " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in r["all_reduce_ms"].items())
            for r in rs) + f" | {card}")
    log(f"[dp] validation: {conf.sum()} clips in {rs[0]['eval_s']:.2f} s, "
        f"accuracy {np.trace(conf) / conf.sum():.4f}, loss "
        f"{rs[0]['val_loss']:.4f}; launches per rank in the main path "
        f"{rs[0]['launches']}; phase {time.perf_counter() - phase_t0:.1f} s")
    slowest = max(rs, key=lambda r: r["ms"])
    return {
        "name": "decode_augment_sharded",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/decode_augment.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/sharded.py:22",
        "launches": sum(r["launches"]["decode_augment_sharded"]
                        for r in rs),
        "max_abs_err": max(r["max_abs_err"] for r in rs),
        "ms": slowest["ms"],
        "plain_ms": slowest["plain_ms"],
        "bound_ms": slowest["bound_ms"],
        "bound_by": slowest["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train, time_calls,
    )
    from speech_recognition_tpu_torch.models.layers import BatchNorm
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.kernels import (
        decode_augment as K,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    # 1. device
    device = require_cuda()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)    # nvidia-smi's name, power.limit as it prints them
    log(f"[device] {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. build every kernel at once, one nvcc per source
    from speech_recognition_tpu_torch.ops.kernels import build
    reported = ("separable_block", "separable_block_bwd")
    with concurrent.futures.ThreadPoolExecutor(
            len(KERNEL_SOURCES) + len(reported)) as pool:
        ptxas = {n: pool.submit(build.ptxas_report, n) for n in reported}
        builds = dict(zip(KERNEL_SOURCES,
                          pool.map(timed_build, KERNEL_SOURCES)))
        ptxas = {n: f.result() for n, f in ptxas.items()}
    for lib, secs in builds.values():
        log(f"[build] {lib.name} in {secs:.2f} s")

    # the full-corpus bank the slice trains on (also the kernel's input)
    t0 = time.perf_counter()
    ds = synthetic_device_dataset(
        device, num_train=NUM_TRAIN, num_val=NUM_VAL, num_pseudo=NUM_PSEUDO,
        num_classes=12, num_background=NUM_BACKGROUND,
        background_len=BACKGROUND_LEN)
    torch.cuda.synchronize()
    log(f"[data] {ds.num_clips} clips, "
        f"{ds.wav_bank.numel() * 2 / 1e9:.2f} GB int16 bank on the card, "
        f"{ds.background.flat.numel()} background samples, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    settings = prepare_model_settings(label_count=12)
    trainer = Trainer(MODEL, settings, ds,
                      augment=AugmentConfig(pseudo_frequency=0.6),
                      batch_size=BATCH)
    if trainer.compute_dtype != "bfloat16":
        raise RuntimeError(f"compute dtype {trainer.compute_dtype}")

    # 3. kernel against its plain version
    d = edge_case_draws(trainer, ds)
    bg = ds.background.flat
    before = K.LAUNCHES
    errs = []
    for index_dtype in (torch.int64, torch.int32):
        args = (ds.wav_bank, bg, d.file_ids.to(index_dtype),
                d.shifts.to(index_dtype), d.fg_vol, d.bg_pos.to(index_dtype),
                d.bg_vol)
        got = K.decode_augment(*args)
        want = K.decode_augment_reference(*args)
        torch.cuda.synchronize()
        if got.shape != (BATCH, T) or not torch.isfinite(got).all():
            raise RuntimeError("kernel output has the wrong shape or "
                               "non-finite values")
        errs.append(float((got - want).abs().max()))
    max_err = max(errs)
    if K.LAUNCHES != before + 2:
        raise RuntimeError(f"LAUNCHES went {before} -> {K.LAUNCHES}")
    if max_err > KERNEL_ATOL:
        raise RuntimeError(f"kernel vs plain max abs err {max_err} > "
                           f"{KERNEL_ATOL}")
    args = (ds.wav_bank, bg, d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
            d.bg_vol)
    plain_ms, kernel_ms, plain_ms2, kernel_ms2 = (
        time_calls(fn, 50, runs=1) for fn in 2 * (
            lambda: K.decode_augment_reference(*args),
            lambda: K.decode_augment(*args)))
    kernel_ms, plain_ms = min(kernel_ms, kernel_ms2), min(plain_ms, plain_ms2)
    bound_ms, bound_by, nbytes = decode_augment_bound(*args)
    log(f"[kernel] decode_augment B={BATCH} T={T}: max abs err {max_err:.3g}"
        f" (int64 {errs[0]:.3g}, int32 {errs[1]:.3g}; tol {KERNEL_ATOL}); "
        f"kernel {kernel_ms:.4f} ms ({nbytes / 1e6 / kernel_ms:.0f} GB/s of "
        f"{nbytes / 1e6:.1f} MB; bound {bound_ms:.4f} ms, {bound_by}), "
        f"plain {plain_ms:.4f} ms | {card}")

    # 4. the separable block: kernel against plain, then its benchmark
    separable_kernels = separable_phase(device, card,
                                        builds["separable_block"][1],
                                        ptxas["separable_block"])
    separable_kernels.append(separable_bwd_phase(
        device, card, builds["separable_block_bwd"][1],
        ptxas["separable_block_bwd"]))
    profile_separable(device)
    vjp_host_account(device, card)

    # 5. the flagship on the card against the CPU, f32 with TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = build_model(MODEL, num_classes=12,
                           generator=torch.Generator().manual_seed(1))
    x = ds.decode(ds.partitions["validation"].file_ids[:4])
    # BN running statistics set to these clips' batch statistics (one
    # train-mode pass at momentum 0), so that eval-mode activations keep
    # their scale and the logits are not vanishingly small
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model.train()(x.cpu(), torch.Generator())
    model.eval()
    on_card = copy.deepcopy(model).to(device).eval()
    with torch.no_grad():
        logits_card = on_card(x).cpu()
        logits_cpu = model(x.cpu())
    logit_err = float((logits_card - logits_cpu).abs().max())
    logit_max = float(logits_cpu.abs().max())
    if logits_card.shape != (4, 12) or not logit_err <= LOGITS_ATOL \
            or logit_max < 1e-2:
        raise RuntimeError(f"flagship logits card vs CPU: max abs err "
                           f"{logit_err}, max |logit| {logit_max}")
    log(f"[model] flagship f32 logits, card vs CPU on 4 clips: max abs err "
        f"{logit_err:.3g} (tol {LOGITS_ATOL}; max |logit| {logit_max:.3g})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    del on_card

    # 6. the slice: 20 bf16 train steps, then one validation sweep
    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    result = benchmark_train(trainer, state, steps=STEPS, warmup=WARMUP)
    t0 = time.perf_counter()
    conf, val_loss = trainer.evaluate(state, "validation")
    eval_s = time.perf_counter() - t0
    launches = K.LAUNCHES
    losses = result["losses"]
    if launches != STEPS + WARMUP:
        raise RuntimeError(f"{launches} kernel launches in "
                           f"{STEPS + WARMUP} train steps")
    if len(losses) != STEPS + WARMUP or not np.isfinite(losses).all():
        raise RuntimeError(f"losses: {losses}")
    expected = (NUM_VAL // BATCH) * BATCH
    if conf.sum() != expected or not np.isfinite(val_loss):
        raise RuntimeError(f"confusion sums to {conf.sum()}, expected "
                           f"{expected}; val loss {val_loss}")
    log(f"[slice] losses {[round(v, 4) for v in losses]}")
    log(f"[slice] {MODEL} bf16 batch {BATCH}: {result['ms_per_step']:.3f} "
        f"ms/step, {result['clips_per_sec']:.0f} clips/s (CUDA events over "
        f"{STEPS} steps after {WARMUP}; host clock "
        f"{result['wall_ms_per_step']:.3f} ms/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
    log(f"[slice] validation: {conf.sum()} clips in {eval_s:.2f} s, "
        f"accuracy {np.trace(conf) / conf.sum():.4f}, loss {val_loss:.4f}; "
        f"kernel launches in the main path: {launches}")

    # 7. data-parallel training, in processes of their own
    del trainer, state, ds, d, bg, args
    torch.cuda.empty_cache()
    dp_kernel = dp_phase(card)

    print(json.dumps({"kernels": [{
        "name": "decode_augment",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/decode_augment.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/augment_kernel.py:188",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + separable_kernels + [dp_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
