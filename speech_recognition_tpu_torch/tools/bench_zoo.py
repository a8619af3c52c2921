"""Per-model train-step throughput sweep (the port's counterpart of
scripts/bench_zoo.py).

    python -m speech_recognition_tpu_torch.tools.bench_zoo \\
        [--models NAME ...] [--batch_size 384] [--steps 100] \\
        [--warmup 10] [--trace] [--device cuda]

Measures steady-state end-to-end training throughput (sample, decode +
augment in the kernel, features, forward/backward, update) of each model
with ``export/benchmark.py::benchmark_train`` (CUDA events over
``--steps`` steps after ``--warmup``) on the JAX script's synthetic bank
(8,192 training clips, 256 validation, 256 pseudo, six 30 s background
clips), one representative per family by default, and prints a JSON line
per model and a markdown table on stderr, with the JAX script's keys.
``--trace`` adds the device's busy ms/step in a ``torch.profiler`` trace
of 10 more steps (``traced_train_device_time``).
``--steps_per_dispatch`` is kept for the JAX script's flags: eager steps
have no dispatch to share, so it changes nothing. The timings measure
the card; ``--device`` other than ``cuda`` raises before any step.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import torch

# one representative per family (SURVEY.md §2.2), all four
# representations: the JAX script's list
DEFAULT_MODELS = [
    "conv_1d_time_sliced_with_attention",  # flagship: framed depthwise
    "conv_1d_residual",                    # deep residual raw trunk
    "conv_1d_multi_time_sliced",           # multi-rate reshape branches
    "conv_1d_fast",                        # learned filterbank + grouped
    "inception",                           # inception blocks
    "steffeNet",                           # wide strided residual
    "conv_1d_gru",                         # strided depthwise stem
    "conv_2d_fast",                        # log-mel 2-D CNN (mfcc)
    "conv_1d_log_mfcc",                    # mfcc residual attention
    "conv_1d_spec",                        # linear spectrogram
    "conv_1d_mfcc_and_raw",                # two-input fusion
    "snn",                                 # SELU MLP (mfcc)
]
K80_TRAIN_CLIPS_PER_SEC = 450.0     # the reference's K80 (BASELINE.md)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Per-model train-step throughput (PyTorch port)")
    p.add_argument("--models", nargs="*", default=DEFAULT_MODELS)
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--steps_per_dispatch", type=int, default=25,
                   help="the JAX script's steps per XLA execution; eager "
                        "steps have none to share, so it changes nothing")
    p.add_argument("--trace", action="store_true",
                   help="also record the traced device-busy ms/step per "
                        "model (torch.profiler; a short traced run)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default); the timings need the card")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Run the sweep; returns the rows."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export import benchmark
    from speech_recognition_tpu_torch.train.loop import Trainer

    if args.device != "cuda":
        raise SystemExit("bench_zoo times the card: --device cuda")
    device = require_cuda()
    settings = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation="raw")
    dataset = synthetic_device_dataset(
        device, num_train=8192, num_val=256, num_pseudo=256,
        num_background=6, background_len=16000 * 30)

    rows = []
    for name in args.models:
        trainer = Trainer(name, settings, dataset,
                          augment=AugmentConfig(pseudo_frequency=0.6),
                          batch_size=args.batch_size)
        state = trainer.init_state()
        n_params = sum(p.numel() for p in state.model.parameters())
        r = benchmark.benchmark_train(trainer, state, steps=args.steps,
                                      warmup=args.warmup)
        row = {"model": name, "params": int(n_params),
               "representation": trainer.spec.representation,
               "ms_per_step": round(r["ms_per_step"], 3),
               "clips_per_sec": round(r["clips_per_sec"], 1),
               "vs_k80_450": round(r["clips_per_sec"]
                                   / K80_TRAIN_CLIPS_PER_SEC, 1)}
        if args.trace:
            tr = benchmark.traced_train_device_time(trainer, state, steps=10)
            row["traced_device_ms_per_step"] = round(
                tr["device_ms_per_step"], 4)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del trainer, state
        torch.cuda.empty_cache()

    print("\n| model | repr | params | ms/step | clips/s | vs K80 |",
          file=sys.stderr)
    print("|---|---|---|---|---|---|", file=sys.stderr)
    for r in rows:
        print(f"| {r['model']} | {r['representation']} | {r['params']:,} "
              f"| {r['ms_per_step']} | {r['clips_per_sec']:,} "
              f"| {r['vs_k80_450']}x |", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
