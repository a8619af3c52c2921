"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``speech_recognition_tpu_torch/csrc``,
holds it against its plain PyTorch version at the train step's shapes,
holds the flagship's logits on the card against the CPU, then drives the
port's main path — 20 bf16 train steps of
``conv_1d_time_sliced_with_attention`` at batch 384 on a synthetic bank
the size of the full Speech Commands corpus, and one validation sweep —
and checks that every train step launched the kernel. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero before
printing any result. The last two lines of standard output are a JSON
record of the kernels and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        benchmark_train,
    )
    from speech_recognition_tpu_torch.models.layers import BatchNorm
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.kernels import build
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

    # 2. build
    t0 = time.perf_counter()
    lib = build.build("decode_augment")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

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
    plain_ms = time_cuda(lambda: K.decode_augment_reference(*args))
    kernel_ms = time_cuda(lambda: K.decode_augment(*args))
    plain_ms2 = time_cuda(lambda: K.decode_augment_reference(*args))
    kernel_ms2 = time_cuda(lambda: K.decode_augment(*args))
    kernel_ms, plain_ms = min(kernel_ms, kernel_ms2), min(plain_ms, plain_ms2)
    mbytes = BATCH * T * (2 + 4 + 4) / 1e6
    log(f"[kernel] decode_augment B={BATCH} T={T}: max abs err {max_err:.3g}"
        f" (int64 {errs[0]:.3g}, int32 {errs[1]:.3g}; tol {KERNEL_ATOL}); "
        f"kernel {kernel_ms:.4f} ms ({mbytes / kernel_ms:.0f} GB/s of "
        f"{mbytes:.1f} MB), plain {plain_ms:.4f} ms | {card}")

    # 4. the flagship on the card against the CPU, f32 with TF32 off
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

    # 5. the slice: 20 bf16 train steps, then one validation sweep
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
