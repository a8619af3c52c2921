"""Batch-1 inference from an exported archive (the port's counterpart of
scripts/run_edge_inference.py; parity: make_submission_on_rpi.py:26-121).

    python -m speech_recognition_tpu_torch.tools.run_edge_inference \\
        --frozen_graph edge_files/frozen.pt2 [--test_data data/test/audio] \\
        [--submission_fn rpi_submission.csv] [--legacy_scale] \\
        [--benchmark] [--device cuda]

Loads the archive (``export/aot.py::load_exported``; no zoo code),
walks the test directory one clip at a time and writes the submission
CSV with the ``_``-stripped 12-class labels the competition harness
expected (make_submission_on_rpi.py:109-110). ``--benchmark`` then
prints the JAX script's report as one JSON line: ``artifact_bytes``,
``clips``, ``avg_ms_per_sample`` (the sweep, decode included),
``avg_model_ms`` (each clip's program call up to its probabilities read
back on the host), ``avg_decode_ms``, the two budget flags (<5,000,000
bytes, <175 ms a clip), ``max_rss_bytes`` and, on the card,
``device_peak_bytes`` (``torch.cuda.max_memory_allocated``). One clip is
run before the sweep, out of the timing. The flags are the JAX
script's, plus ``--device`` (default ``cuda``; the CPU only when asked).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import resource
import time
from typing import Any, Dict, List, Optional

import torch

CLASSES = ("_silence_ _unknown_ stop down off right up go on yes "
           "left no").split()


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Batch-1 inference from an exported archive "
                    "(PyTorch port)")
    p.add_argument("--frozen_graph", required=True)
    p.add_argument("--test_data", default="data/test/audio")
    p.add_argument("--submission_fn", default="rpi_submission.csv")
    p.add_argument("--legacy_scale", action="store_true",
                   help="use the Pi script's 1/32767 scaling "
                        "(make_submission_on_rpi.py:97) instead of "
                        "decode_wav's 1/32768")
    p.add_argument("--benchmark", action="store_true",
                   help="after the sweep, print a benchmark_model-style "
                        "report (reference README.md:146-157)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    """Write the CSV; returns the benchmark report with ``--benchmark``."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.data.wav import load_wav_file
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export.aot import load_exported
    from speech_recognition_tpu_torch.infer.submission import (
        list_test_files,
    )

    device = (require_cuda() if args.device == "cuda"
              else torch.device(args.device))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    fn = load_exported(args.frozen_graph, device)
    scale = 32767.0 if args.legacy_scale else 32768.0
    files = list_test_files(args.test_data)
    if args.benchmark and files:
        warm = load_wav_file(files[0], desired_samples=16000, scale=scale)
        fn(warm[None, :]).cpu()
    rows = []
    decode_s = model_s = 0.0
    t_sweep = time.perf_counter()
    for path in files:
        t0 = time.perf_counter()
        wav = load_wav_file(path, desired_samples=16000, scale=scale)
        t1 = time.perf_counter()
        probs = fn(wav[None, :]).cpu().numpy()
        model_s += time.perf_counter() - t1
        decode_s += t1 - t0
        label = CLASSES[int(probs.argmax())].strip("_")
        rows.append((os.path.basename(path), label))
    sweep_s = time.perf_counter() - t_sweep
    with open(args.submission_fn, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "label"])
        w.writerows(rows)
    print(f"wrote {len(rows)} predictions to {args.submission_fn}")
    if not (args.benchmark and rows):
        return None
    n = len(rows)
    size = os.path.getsize(args.frozen_graph)
    ms = 1000.0 * sweep_s / n
    report: Dict[str, Any] = {
        "artifact_bytes": size,
        "clips": n,
        "avg_ms_per_sample": round(ms, 3),
        "avg_model_ms": round(1000.0 * model_s / n, 3),
        "avg_decode_ms": round(1000.0 * decode_s / n, 3),
        "size_budget_5000000": bool(size < 5_000_000),
        "latency_budget_175ms": bool(ms < 175.0),
        # this process's high-water mark (Python and PyTorch included)
        "max_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    if cuda:
        report["device_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
