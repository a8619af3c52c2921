"""Benchmark entry point of the port (the counterpart of the root bench.py).

    python -m speech_recognition_tpu_torch.bench

The metric of record is end-to-end training clips/s of the flagship
recipe on one card: ``conv_1d_time_sliced_with_attention``, batch 384,
raw waveforms, full augmentation with background mixing, bf16 compute
(BASELINE.md; the reference's K80 did ~450 clips/s). The bank is
synthetic at the real corpus's scale (64,727 + 6,798 + 4,096 clips of
16,000 int16 samples, 6 x 60 s of background), on the card.

Order (bench.py:481-508): the measurement runs first, in a child process
per bank scale (``SCALES``, tried in the order of ``_scale_order``, each
with what is left of ``BENCH_BUDGET_SECS`` less a reserve per scale
still behind it), and its one JSON line ``{"metric":
"train_clips_per_sec", ...}`` is the first line on stdout, printed the
moment the child returns. The accuracy signal follows on stderr, within
what is left of the budget: ``tools/calibrate_accuracy.py`` for seeds 0
and 1 on ``conv_1d_spec`` (12 epochs), one child each, judged by the
band of ``acc_band_verdict`` and by the gate on the seed mean.
Diagnostics go to stderr.

Environment: ``BENCH_BUDGET_SECS`` (1500), ``BENCH_SCALE`` (set in the
children), ``BENCH_SCALE_ORDER`` (comma-separated scales),
``BENCH_SMALL`` (the tiny scale, 3 reps), ``BENCH_BATCH`` (384),
``BENCH_DTYPE`` (auto: bf16), ``BENCH_SPD`` (800: each rep times
max(100, spd) steps) and ``BENCH_SKIP_ACC``.

Each rep is timed by CUDA events over its steps, with the host clock
beside it; the best rep gives the metric. Then one ``torch.profiler``
trace of as many steps (at most 200) gives the device busy time, and
``FlopCounterMode`` over one step the FLOPs, against the H100 SXM's 989
TFLOP/s in bf16. Each step is one call (``steps_per_dispatch: 1``):
after the first, a replay of the train step's CUDA graph; the FLOPs'
step runs eagerly, since ``FlopCounterMode`` sees no replay. The
JAX bench's TPU preflight and compile cache have no counterpart: the
preflight here is a child that asks for the card, and without one the
bench exits non-zero before it prints a metric line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

_T0 = time.time()
BUDGET_SECS = float(os.environ.get("BENCH_BUDGET_SECS", "1500"))

K80_BASELINE_CLIPS_PER_SEC = 450.0

# Real-corpus scale (train.py:21, input_data.py:274-309)
NUM_TRAIN = 64_727
NUM_VAL = 6_798
NUM_PSEUDO = 4_096
BACKGROUND_CLIPS = 6
BACKGROUND_LEN = 16000 * 60

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s
H100_BF16_PEAK_FLOPS = 989e12

SCALES = {
    # name -> (num_train, num_val, num_pseudo, background_len)
    "full_corpus": (NUM_TRAIN, NUM_VAL, NUM_PSEUDO, BACKGROUND_LEN),
    "half_corpus": (32768, 1024, 1024, BACKGROUND_LEN),
    "small": (8192, 256, 256, 16000 * 30),
    "tiny": (4096, 256, 256, 16000 * 30),  # BENCH_SMALL / CI
}
# wall reserved for each scale still behind the one being tried
RESERVE_PER_FALLBACK_SECS = 300.0
# steps in the profiler trace: every step is the same eager program, and
# a trace of the default 800 would hold millions of profiler events
MAX_TRACE_STEPS = 200

# The accuracy signal: conv_1d_spec at the calibration defaults (100
# clips per word), seeds 0 and 1, 12 epochs (bench.py:139-166). The band
# is the JAX package's measured 5-seed range of this configuration
# ([0.8789, 0.8477, 0.8594, 0.8477, 0.8516]: mean 0.8571, sd 0.0131,
# spread 0.0312) widened by the spread: an accuracy, so it carries over.
ACC_SEEDS = (0, 1)
ACC_ARGS = ["--model", "conv_1d_spec",
            "--epochs", "12", "--steps_per_dispatch", "8"]
ACC_BAND = (0.816, 0.910)
ACC_BAND_MEAN, ACC_BAND_SD = 0.8571, 0.0131
# the seed mean must reach the band's mean less two standard deviations
ACC_GATE = round(ACC_BAND_MEAN - 2 * ACC_BAND_SD, 4)


def _remaining() -> float:
    return BUDGET_SECS - (time.time() - _T0)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def acc_band_verdict(bests: Sequence[float], band) -> bool:
    """True iff the per-seed best accuracies flag a regression: every seed
    below the band's floor, or every seed above its ceiling (on the
    alias-ceiling corpus the latter means the corpus lost its ceiling)."""
    return bool(max(bests) < band[0] or min(bests) > band[1])


def acc_gate_passes(bests: Sequence[float]) -> bool:
    """True iff the mean over seeds reaches ``ACC_GATE``."""
    return sum(bests) / len(bests) >= ACC_GATE


def _scale_order() -> List[str]:
    """Scales to try, in order (bench.py:268-273): ``BENCH_SCALE_ORDER``,
    else ``tiny`` under ``BENCH_SMALL``, else ``small`` then ``tiny``."""
    if os.environ.get("BENCH_SCALE_ORDER"):
        return os.environ["BENCH_SCALE_ORDER"].split(",")
    if os.environ.get("BENCH_SMALL"):
        return ["tiny"]
    return ["small", "tiny"]


def _child(args: List[str], env: dict, timeout: float):
    return subprocess.run([sys.executable, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _preflight() -> None:
    """A child process asks for the card; without one, exit non-zero."""
    code = ("from speech_recognition_tpu_torch.device import require_cuda; "
            "require_cuda(); print('DEVOK')")
    try:
        proc = _child(["-c", code], dict(os.environ), 300)
    except subprocess.TimeoutExpired:
        raise SystemExit("CUDA device discovery hung: cannot benchmark")
    if "DEVOK" not in proc.stdout:
        raise SystemExit(f"no CUDA device: cannot benchmark "
                         f"({proc.stderr.strip()[-500:]})")


def _scale_subprocess() -> Optional[str]:
    """Run the measurement at each scale in turn, one fresh child each,
    and return the first child's metric line; None if none succeeded."""
    order = _scale_order()
    for i, scale in enumerate(order):
        if scale not in SCALES:
            raise SystemExit(f"unknown scale {scale!r}; scales: "
                             f"{sorted(SCALES)}")
        reserve = RESERVE_PER_FALLBACK_SECS * (len(order) - 1 - i)
        child_budget = min(1800.0, _remaining() - 60.0 - reserve)
        if child_budget < 180.0:
            _log(f"scale {scale}: skipped, {child_budget:.0f}s usable "
                 f"({_remaining():.0f}s left, {reserve:.0f}s reserved for "
                 f"fallbacks) of the {BUDGET_SECS:.0f}s budget")
            continue
        env = dict(os.environ, BENCH_SCALE=scale)
        try:
            proc = _child(["-m", "speech_recognition_tpu_torch.bench"], env,
                          child_budget)
        except subprocess.TimeoutExpired:
            _log(f"scale {scale}: timed out after {child_budget:.0f}s")
            continue
        sys.stderr.write(proc.stderr[-6000:])
        out = [ln.strip() for ln in proc.stdout.splitlines()
               if ln.strip().startswith("{")]
        if proc.returncode == 0 and out:
            return out[-1]
        _log(f"scale {scale} failed (rc={proc.returncode}); falling back")
    return None


def _measure_in_child() -> None:
    """BENCH_SCALE mode: put the bank on the card at the requested scale,
    run the reps, trace, count FLOPs, print the diagnostics to stderr and
    the metric line to stdout."""
    import torch

    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train, traced_train_device_time, train_step_flops,
    )
    from speech_recognition_tpu_torch.ops.kernels import launch
    from speech_recognition_tpu_torch.train.loop import Trainer

    device = require_cuda()
    scale = os.environ["BENCH_SCALE"]
    small = bool(os.environ.get("BENCH_SMALL"))
    n_train, n_val, n_pseudo, bg_len = SCALES[scale]
    t0 = time.perf_counter()
    dataset = synthetic_device_dataset(
        device, num_train=n_train, num_val=n_val, num_pseudo=n_pseudo,
        num_classes=12, num_background=BACKGROUND_CLIPS,
        background_len=bg_len)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    trainer = Trainer(
        "conv_1d_time_sliced_with_attention",
        prepare_model_settings(label_count=12), dataset,
        augment=AugmentConfig(pseudo_frequency=0.6),
        batch_size=int(os.environ.get("BENCH_BATCH", "384")),
        compute_dtype=os.environ.get("BENCH_DTYPE", "auto"))
    state = trainer.init_state()
    spd = int(os.environ.get("BENCH_SPD", "800"))
    steps = max(100, spd)
    torch.cuda.reset_peak_memory_stats(device)
    launch.reset_runs()
    reps, train_steps = [], 0
    for rep in range(3 if small else 6):
        warmup = 10 if rep == 0 else 5
        r = benchmark_train(trainer, state, steps=steps, warmup=warmup)
        train_steps += warmup + steps
        _log(f"rep {rep}: {r['clips_per_sec']:.1f} clips/s, "
             f"{r['ms_per_step']:.4f} ms/step (CUDA events), host clock "
             f"{r['wall_ms_per_step']:.4f} ms/step")
        reps.append(r)
    best = min(reps, key=lambda r: r["ms_per_step"])
    t0 = time.perf_counter()
    trace_steps = min(steps, MAX_TRACE_STEPS)
    trace = traced_train_device_time(trainer, state, steps=trace_steps,
                                     warmup=5)
    trace_s = time.perf_counter() - t0
    flops = train_step_flops(trainer, state)
    train_steps += trace_steps + 5 + 1
    ms = sorted(r["ms_per_step"] for r in reps)
    diag = {
        "steps": steps,
        "batch_size": trainer.batch_size,
        "steps_per_dispatch": 1,
        "ms_per_step": best["ms_per_step"],
        "clips_per_sec": best["clips_per_sec"],
        "wall_ms_per_step": best["wall_ms_per_step"],
        "sync": "CUDA events on the current stream, then "
                "torch.cuda.synchronize",
        "event_reps_ms_per_step": ms,
        "wall_reps_ms_per_step": sorted(r["wall_ms_per_step"]
                                        for r in reps),
        "event_median_ms_per_step": ms[len(ms) // 2],
        "traced_device_ms_per_step": trace["device_ms_per_step"],
        "traced_steps": trace_steps,
        "trace_s": trace_s,
        "traced_kernels_per_step": trace["kernels_per_step"],
        "traced_top_kernels_ms_per_step": trace["top_kernels"],
        "wall_best_over_traced": (best["ms_per_step"]
                                  / trace["device_ms_per_step"]),
        "device_idle_share": 1.0 - (trace["device_ms_per_step"]
                                    / best["ms_per_step"]),
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "bank_clips": dataset.num_clips,
        "bank_gb": dataset.wav_bank.numel() * 2 / 1e9,
        "bank_scale": scale,
        "bank_setup_s": data_s,
        "compute_dtype": trainer.compute_dtype,
        "flops_per_step": flops,
        "achieved_tflops": flops / (best["ms_per_step"] / 1e3) / 1e12,
        "mfu_vs_bf16_peak": (flops / (best["ms_per_step"] / 1e3)
                             / H100_BF16_PEAK_FLOPS),
        "mfu_device_busy": (flops / (trace["device_ms_per_step"] / 1e3)
                            / H100_BF16_PEAK_FLOPS),
        "train_steps": train_steps,
        # its runs: launched, or in a replay of the step's graph
        "decode_augment_launches": launch.runs()["decode_augment"],
        "device": torch.cuda.get_device_name(device),
    }
    _log(f"diagnostics: {json.dumps(diag)}")
    value = best["clips_per_sec"]
    print(json.dumps({
        "metric": "train_clips_per_sec",
        "value": round(value, 1),
        "unit": "clips/s",
        "vs_baseline": round(value / K80_BASELINE_CLIPS_PER_SEC, 2),
    }), flush=True)


def _accuracy_signal() -> dict:
    """Run the calibration for each seed in a child of its own and print
    one ``accuracy:`` JSON line to stderr. A seed that would overrun the
    budget is skipped. It never fails the bench: it flags."""
    recs, skipped = [], []
    for seed in ACC_SEEDS:
        child_budget = min(900.0, _remaining() - 30.0)
        if child_budget < 120.0:
            skipped.append(seed)
            continue
        args = ["-m", "speech_recognition_tpu_torch.tools.calibrate_accuracy",
                "--seed", str(seed), *ACC_ARGS]
        try:
            proc = _child(args, dict(os.environ), child_budget)
        except subprocess.TimeoutExpired:
            _log(f"acc seed {seed}: timed out after {child_budget:.0f}s")
            continue
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.strip().startswith("{")]
        if proc.returncode == 0 and lines:
            recs.append(json.loads(lines[-1]))
        else:
            _log(f"acc seed {seed}: no record (rc={proc.returncode}) "
                 f"{proc.stderr[-500:]}")
    if not recs:
        out = {"error": "no calibration record",
               "seeds_skipped_for_budget": skipped}
        _log(f"accuracy: {json.dumps(out)}")
        return out
    bests = [r["val_acc_best"] for r in recs]
    out = {
        "config": {"seeds": [s for s in ACC_SEEDS if s not in skipped],
                   "args": " ".join(ACC_ARGS),
                   "compute_dtype": recs[0].get("compute_dtype")},
        "val_acc_best_per_seed": bests,
        "val_acc_final_per_seed": [r["val_acc_final"] for r in recs],
        "band": list(ACC_BAND),
        "accuracy_regression": acc_band_verdict(bests, ACC_BAND),
        "seed_mean": sum(bests) / len(bests),
        "gate": ACC_GATE,
        "gate_passed": acc_gate_passes(bests),
    }
    if skipped:
        out["seeds_skipped_for_budget"] = skipped
    _log(f"accuracy: {json.dumps(out)}")
    return out


def main() -> None:
    if os.environ.get("BENCH_SCALE"):
        return _measure_in_child()
    _preflight()
    metric_line = _scale_subprocess()
    if metric_line is None:
        raise SystemExit("no bench scale ran to its end within the budget")
    value = json.loads(metric_line).get("value")
    if not (isinstance(value, (int, float)) and math.isfinite(value)
            and value > 0):
        raise SystemExit(f"bad metric line: {metric_line}")
    print(metric_line, flush=True)
    if not os.environ.get("BENCH_SKIP_ACC") and _remaining() > 240:
        _accuracy_signal()
    else:
        _log(f"accuracy signal skipped ({_remaining():.0f}s budget left)")
    _log(f"bench total wall: {time.time() - _T0:.0f}s "
         f"(budget {BUDGET_SECS:.0f}s)")


if __name__ == "__main__":
    main()
