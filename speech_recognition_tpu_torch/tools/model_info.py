"""Static per-model report: parameters, bytes, forward FLOPs, edge budget
(the port's counterpart of scripts/model_info.py).

    python -m speech_recognition_tpu_torch.tools.model_info \\
        [--models NAME ...] [--label_count 12] [--batch_size 1] \\
        [--device cuda]

Prints one JSON line per model on stdout and a markdown table on
stderr, with the JAX script's keys and flags (plus ``--device``, default
``cuda``): the model's representation and optimizer, its parameter
count, its BatchNorm statistics, their float32 bytes, and whether it
fits the reference's Pi budget (fewer than 1,250,000 weights and
5,000,000 bytes, README.md:14).

``forward_flops_per_clip`` is counted by
``torch.utils.flop_counter.FlopCounterMode`` over one eval-mode forward
of ``--batch_size`` zero clips' features: 2 per multiply-add of the
matrix products and convolutions, nothing for elementwise work,
normalisation or the frontend. The count runs on a CPU copy of the
model whatever ``--device``: on a card a GRU's recurrence runs in a
kernel of its own (``ops/kernels/gru.py``), whose products the counter
cannot see. The JAX script's figure is XLA's cost analysis of the
compiled forward, which also counts elementwise work, so the two are
not the same measure (``flops_method`` says which).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Any, Dict, List, Optional

import torch

PI_MAX_PARAMS = 1_250_000       # the reference's special-prize budget
PI_MAX_BYTES = 5_000_000        # (README.md:14)
FLOPS_METHOD = ("torch.utils.flop_counter.FlopCounterMode: matrix products "
                "and convolutions, 2 per multiply-add; the JAX script's "
                "figure is XLA's cost analysis, elementwise work included")


def model_info(name: str, settings, batch_size: int = 1,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The report of one zoo model at ``settings``' geometry."""
    from torch.utils.flop_counter import FlopCounterMode

    from speech_recognition_tpu_torch.models.layers import BatchNorm
    from speech_recognition_tpu_torch.models.zoo import (
        build_model, settings_geometry,
    )
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    device = torch.device("cpu") if device is None else device
    model, spec = build_model(name, num_classes=settings.label_count,
                              **settings_geometry(settings))
    model.to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(m.running_mean.numel() + m.running_var.numel()
                  for m in model.modules() if isinstance(m, BatchNorm))

    def features(on):
        wav = torch.zeros((batch_size, settings.desired_samples), device=on)
        return Frontend(settings, "highest").features(wav, spec.representation)

    counter = FlopCounterMode(display=False)
    on_cpu = model if device.type == "cpu" else copy.deepcopy(model).cpu()
    with torch.no_grad():
        if on_cpu is not model:
            model(features(device))
        x = features("cpu")
        with counter:
            on_cpu(x)
    f32_bytes = (n_params + n_stats) * 4
    return {
        "model": name,
        "representation": spec.representation,
        "optimizer": spec.optimizer,
        "params": n_params,
        "batch_stats": n_stats,
        "f32_bytes": f32_bytes,
        "fits_pi_budget": bool(n_params < PI_MAX_PARAMS
                               and f32_bytes < PI_MAX_BYTES),
        "forward_flops_per_clip": counter.get_total_flops() / batch_size,
        "flops_method": FLOPS_METHOD,
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Static per-model report (PyTorch port)")
    p.add_argument("--models", nargs="*", default=[],
                   help="model names; default: all 25")
    p.add_argument("--label_count", type=int, default=12)
    p.add_argument("--window_size_ms", type=float, default=30.0)
    p.add_argument("--window_stride_ms", type=float, default=10.0)
    p.add_argument("--dct_coefficient_count", type=int, default=80)
    p.add_argument("--num_log_mel_features", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=1,
                   help="batch for the FLOPs count (per-clip FLOPs are "
                        "normalized by it)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Print the reports; returns them."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.models.zoo import MODEL_REGISTRY

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    names = args.models or sorted(MODEL_REGISTRY)
    settings = prepare_model_settings(
        label_count=args.label_count,
        window_size_ms=args.window_size_ms,
        window_stride_ms=args.window_stride_ms,
        dct_coefficient_count=args.dct_coefficient_count,
        num_log_mel_features=args.num_log_mel_features,
        output_representation="raw")
    rows = []
    for name in names:
        info = model_info(name, settings, args.batch_size, device)
        rows.append(info)
        print(json.dumps(info), flush=True)
    print(f"\nforward FLOPs: {FLOPS_METHOD}", file=sys.stderr)
    print("| model | repr | params | f32 bytes | MFLOP/clip | Pi? |",
          file=sys.stderr)
    print("|---|---|---|---|---|---|", file=sys.stderr)
    for r in rows:
        print(f"| {r['model']} | {r['representation']} | {r['params']:,} "
              f"| {r['f32_bytes']:,} | "
              f"{r['forward_flops_per_clip'] / 1e6:,.1f} | "
              f"{'yes' if r['fits_pi_budget'] else 'no'} |", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
