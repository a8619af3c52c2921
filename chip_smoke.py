"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_recognition_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and drives two paths:

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
  launched both variants.

Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing any result. The last two lines of standard
output are a JSON record of the kernels and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import subprocess
import sys
import time

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
KERNEL_SOURCES = ("decode_augment", "separable_block")
# separable block, kernel against its plain version on the same inputs.
# y: f32 (TF32 off) differs only in the order of the f32 sums of up to
# 3 x 512 products, |y| < ~10; bf16 rounds at the same points as the plain
# version, so a y differs by at most the one bf16 step that a different
# f32 sum can round it to.
SEP_Y_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}
# s1, s2: f32 sums over 384 x To rows taken with atomics in another
# order, per channel relative to sum|y| (s1) and to s2.
SEP_STATS_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def separable_phase(device, card: str, build_s: float):
    """The separable block: kernel against plain at the 11 trunk shapes,
    two extra cases, then the benchmark. Returns the ``kernels`` entries."""
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
    if launches != {"fuse": expected, "fold": expected}:
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
    } for variant in ("fuse", "fold")]


def edge_case_draws(trainer, ds):
    """A training batch's draws with the kernel's edge cases written in:
    zero and most-negative shifts, silence rows, bg_vol 0, the largest
    legal background position and the top file ids of the bank."""
    d = trainer.draw_batch()
    n, m = ds.num_clips, ds.background.flat.shape[0]
    d.shifts[:4] = torch.tensor([0, -500, -1, -T + 1])
    d.fg_vol[4:8] = 0.0
    d.bg_vol[8:12] = 0.0
    d.bg_pos[12:16] = m - T
    d.file_ids[16:20] = torch.arange(n - 4, n)
    return d


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
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES,
                          pool.map(timed_build, KERNEL_SOURCES)))
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
    mbytes = BATCH * T * (2 + 4 + 4) / 1e6
    log(f"[kernel] decode_augment B={BATCH} T={T}: max abs err {max_err:.3g}"
        f" (int64 {errs[0]:.3g}, int32 {errs[1]:.3g}; tol {KERNEL_ATOL}); "
        f"kernel {kernel_ms:.4f} ms ({mbytes / kernel_ms:.0f} GB/s of "
        f"{mbytes:.1f} MB), plain {plain_ms:.4f} ms | {card}")

    # 4. the separable block: kernel against plain, then its benchmark
    separable_kernels = separable_phase(device, card,
                                        builds["separable_block"][1])

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

    print(json.dumps({"kernels": [{
        "name": "decode_augment",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/decode_augment.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/augment_kernel.py:188",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }] + separable_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
