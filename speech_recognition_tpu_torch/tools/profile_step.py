"""Device-time trace of the training step (the port's counterpart of
scripts/profile_step.py).

    python -m speech_recognition_tpu_torch.tools.profile_step \\
        [--model conv_1d_time_sliced_with_attention] [--batch_size 384] \\
        [--steps 30] [--warmup 20] [--trace_dir traces/train_step] \\
        [--compute_dtype auto] [--device cuda]

Runs ``--warmup`` untraced steps of the model's recipe on the JAX
script's synthetic bank (8,192 training clips, 256 validation, 256
pseudo, six 30 s background clips), then ``--steps`` steps inside
``utils/profiling.py::trace_context``, and prints what
``summarize_trace`` reads from the trace: the device's busy time per
step (the union of its kernels', copies' and memsets' intervals, host
gaps excluded), the kernels by total time, the classes of operation,
the largest kernels with the host operator that launched each, and the
device's busy and idle time a step under each of the step's profiler
ranges (``train.draw`` ... ``train.optimizer``). Before them it prints
the host's ms a step in each of the step's spans, the median over the
warm-up steps. The flags are the JAX script's, plus ``--device``
(default ``cuda``; on the CPU the trace holds no device time and the
summary is empty).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Device-time trace of the training step (PyTorch port)")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--trace_dir", default="traces/train_step")
    p.add_argument("--compute_dtype", default="auto")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Trace and print; returns ``summarize_trace``'s record."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.train.loop import Trainer
    from speech_recognition_tpu_torch.utils.profiling import (
        clear, reading, spans, step_medians, summarize_trace, trace_context,
    )

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    settings = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation="raw")
    dataset = synthetic_device_dataset(
        device, num_train=8192, num_val=256, num_pseudo=256,
        num_background=6, background_len=16000 * 30)
    trainer = Trainer(args.model, settings, dataset,
                      augment=AugmentConfig(pseudo_frequency=0.6),
                      batch_size=args.batch_size,
                      compute_dtype=args.compute_dtype)
    state = trainer.init_state()
    clear()
    for _ in range(args.warmup):
        trainer.train_step(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if args.warmup:
        print(f"host ms a step by span (median over the {args.warmup} "
              f"warm-up steps):")
        for name, ms in step_medians(spans()).items():
            print(f"  {name:<56s} {ms:9.3f} ms")
        last = state.step - 1
        for r in spans():
            if isinstance(r, reading) and r.step == last:
                print(f"  card, step {last}: {r.name:<38s} "
                      f"{r.device_ms:9.3f} ms")
    with trace_context(args.trace_dir):
        for _ in range(args.steps):
            m = trainer.train_step(state)
        float(m["loss"])

    summary = summarize_trace(args.trace_dir, num_steps=args.steps)
    print(f"device busy: {summary['device_busy_ms']:.2f} ms over "
          f"{args.steps} steps -> {summary['ms_per_step']:.3f} ms/step "
          f"(the union of the device's activities in the trace; "
          f"{summary['activities']} activities)")
    print("kernels:")
    for name, st in sorted(summary["modules"].items(),
                           key=lambda kv: -kv[1]["total_ms"])[:20]:
        print(f"  {name[:56]:<56s} {st['total_ms']:9.2f} ms "
              f"x{st['count']:<4d} {st['ms_per_exec']:8.3f} ms/exec")
    print("op classes:")
    for name, ms in summary["ops"].items():
        print(f"  {name[:56]:<56s} {ms:9.2f} ms")
    print("top kernels (launching operator):")
    for d in summary["detail"][:12]:
        print(f"  {d['op'][:34]:<34s} {d['total_ms']:8.2f} ms  "
              f"{d['category'][:22]:<22s} {d['source']}")
    print("device by profiler range (a step):")
    n = args.steps
    for name, r in sorted(summary["spans"].items(),
                          key=lambda kv: -kv[1]["device_busy_ms"]):
        print(f"  {name[:40]:<40s} busy {r['device_busy_ms'] / n:8.3f} ms"
              f"  idle {r['idle_ms'] / n:8.3f} ms  "
              f"{r['count'] / n:7.1f} activities")
    return summary


if __name__ == "__main__":
    main()
