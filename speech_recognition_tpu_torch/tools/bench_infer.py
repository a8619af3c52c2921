"""Inference throughput benchmark, the test-set prediction path (the port's
counterpart of scripts/bench_infer.py).

    python -m speech_recognition_tpu_torch.tools.bench_infer \\
        [--num_files 15360] [--no_tta] [--batch_size 384] [--keep_dir DIR] \\
        [--device cuda]

Reference baselines (BASELINE.md): the K80 predicts the 158,538-clip test
set in ~4 min without TTA (~660 clips/s).

Prints one JSON line on stdout, its first key ``end_to_end_clips_per_sec``:

* ``device_clips_per_sec`` and ``device_ms_per_clip``: the predictor alone
  on one synthetic on-device batch (``benchmark_inference``, CUDA events),
  the compute ceiling;
* ``end_to_end_clips_per_sec``: ``predict_directory`` over a WAV tree on
  disk (decode on a worker thread, pinned int16 copies, TTA on the card),
  what ``tools.make_submission`` runs; a warm run, then a timed one;
* ``projected_158538_clip_minutes`` at that rate, beside the K80's 4
  minutes without TTA.

On stderr, ``diagnostics:`` with a JSON object: the device busy ms and
idle share of a ``torch.profiler`` trace of a third end-to-end run, the
host-to-device copies' device ms in it, the timed run's host seconds
split into decoding (on the worker), waiting for the worker, issuing the
copies, issuing the predictions and waiting for results, the traced
device ms per synthetic batch, and the peak device memory.

The model is ``--model`` (a raw-waveform model) with random weights from
seed 0. The test tree is written under the temporary directory
(``$TMPDIR``) and removed afterwards, unless ``--keep_dir`` names one to
keep and reuse. ``--device cpu`` runs the end-to-end leg alone, on the
CPU, and reports no device figures.

Over W ranks (``torchrun --nproc_per_node W -m
speech_recognition_tpu_torch.tools.bench_infer``) the sweep is sharded
as ``tools.make_submission --data_parallel auto`` shards it: each rank
decodes and predicts its B/W rows of every batch and the probabilities
are gathered (``predict_directory`` over the Predictor's mesh). Rank 0
writes the tree while the others wait, and alone prints; the record
adds ``ranks``. The device-only legs (the synthetic batch and the
traces) are left out over several ranks: their figures are ``null``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

REFERENCE_TEST_CLIPS = 158_538  # convert_from_see_v3_bugfix.py:66
K80_NO_TTA_MINUTES = 4.0        # BASELINE.md:17


def build_test_dir(root: str, num_files: int, sr: int = 16000) -> str:
    """Synthetic test tree under ``root/audio``: a tone (200 + 90 (i mod
    37) Hz) plus noise per clip, int16 WAVs like Kaggle's."""
    from speech_recognition_tpu_torch.data.wav import save_wav_file

    d = os.path.join(root, "audio")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    for i in range(num_files):
        f = 200.0 + (i % 37) * 90.0
        clip = (0.4 * np.sin(2 * np.pi * f * t)
                + rng.normal(0, 0.02, sr)).astype(np.float32)
        save_wav_file(os.path.join(d, f"clip_{i:06d}.wav"), clip, sr)
    return d


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Inference throughput benchmark (PyTorch port)")
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--num_files", type=int, default=15_360,
                   help="on-disk WAVs for the end-to-end leg")
    p.add_argument("--no_tta", action="store_true")
    p.add_argument("--keep_dir", default="",
                   help="reuse/keep this test tree instead of a tmp one")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the benchmark; returns the stdout record with the diagnostics
    under ``"diagnostics"``."""
    args = parse_args(argv)
    import torch.distributed as dist

    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_inference, traced_device_time, traced_inference_device_time,
    )
    from speech_recognition_tpu_torch.infer.submission import (
        predict_directory,
    )
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.parallel.distributed import (
        host_replicated, join_from_env,
    )
    from speech_recognition_tpu_torch.tools.make_submission import (
        predictor_mesh,
    )

    device, mesh = join_from_env(args.device)
    shard, choice = predictor_mesh("auto", mesh, args.batch_size)
    main_rank = mesh.rank == 0
    if main_rank:
        _log(choice)
    cuda = device.type == "cuda" and mesh.size == 1
    settings = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation="raw")
    model, spec = build_model(args.model, num_classes=12,
                              generator=torch.Generator().manual_seed(0))
    if spec.representation != "raw":
        raise SystemExit("bench_infer supports raw-representation models")
    predictor = Predictor(host_replicated(model.to(device), mesh),
                          settings, spec.representation,
                          TTAConfig(use_tta=not args.no_tta), device,
                          mesh=shard)
    samples = settings.desired_samples
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        dev = benchmark_inference(predictor, batch_size=args.batch_size,
                                  steps=50, warmup=5,
                                  desired_samples=samples)
        traced = traced_inference_device_time(
            predictor, batch_size=args.batch_size, steps=20, warmup=1,
            desired_samples=samples)

    test_root = args.keep_dir or os.path.join(tempfile.gettempdir(),
                                              "srt_torch_bench_infer")
    test_dir = os.path.join(test_root, "audio")
    existing = len(glob.glob(os.path.join(test_dir, "*.wav")))
    if existing != args.num_files and main_rank:
        if args.keep_dir and existing:
            # a directory the caller asked to keep is never removed
            raise SystemExit(
                f"--keep_dir tree has {existing} WAVs but "
                f"--num_files={args.num_files}; pass a matching "
                "--num_files or clean the directory yourself")
        shutil.rmtree(test_dir, ignore_errors=True)
        _log(f"building {args.num_files}-file test tree...")
        t0 = time.perf_counter()
        test_dir = build_test_dir(test_root, args.num_files)
        _log(f"built in {time.perf_counter() - t0:.1f} s")
    if mesh.size > 1:
        dist.barrier(group=mesh.group)      # the tree is written

    def run(timings=None):
        return predict_directory(predictor, test_dir,
                                 batch_size=args.batch_size,
                                 desired_samples=samples, timings=timings)

    run()                                   # warm: the tail's shape too
    host = {}
    t0 = time.perf_counter()
    basenames, probs = run(host)
    dt = time.perf_counter() - t0
    if len(basenames) != args.num_files or probs.shape != (args.num_files,
                                                           12):
        raise RuntimeError(f"{len(basenames)} names, probs {probs.shape}")
    e2e_cps = args.num_files / dt
    record = {
        "end_to_end_clips_per_sec": e2e_cps,
        "tta": not args.no_tta,
        "device_clips_per_sec": dev["clips_per_sec"] if cuda else None,
        "device_ms_per_clip": dev["ms_per_clip"] if cuda else None,
        "end_to_end_files": args.num_files,
        "batch_size": args.batch_size,
        "projected_158538_clip_minutes":
            REFERENCE_TEST_CLIPS / e2e_cps / 60.0,
        "k80_no_tta_minutes": K80_NO_TTA_MINUTES,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "ranks": mesh.size if shard is not None else 1,
    }
    diag = {"end_to_end_host_s": host,
            "end_to_end_host_share": {
                k[:-2]: v / host["total_s"] for k, v in host.items()
                if k != "total_s"}}
    if cuda:
        trace = traced_device_time(run, device)
        diag.update({
            "end_to_end_traced_wall_ms": trace["wall_ms"],
            "end_to_end_device_busy_ms": trace["device_busy_ms"],
            "end_to_end_device_idle_share":
                1.0 - trace["device_busy_ms"] / trace["wall_ms"],
            "end_to_end_memcpy_htod_ms": trace["memcpy_htod_ms"],
            "end_to_end_top_device_ms": trace["top"],
            "device_ms_per_batch_events": dev["ms_per_batch"],
            "device_ms_per_batch_traced": traced["device_ms_per_batch"],
            "kernels_per_batch": traced["kernels_per_batch"],
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        })
    if mesh.size > 1:
        dist.barrier(group=mesh.group)      # every rank is done reading
    if not main_rank:
        return dict(record, diagnostics=diag)
    print(json.dumps(record), flush=True)
    _log("diagnostics: " + json.dumps(diag))
    if not args.keep_dir:
        shutil.rmtree(test_root, ignore_errors=True)
    return dict(record, diagnostics=diag)


if __name__ == "__main__":
    from speech_recognition_tpu_torch.parallel.distributed import leave

    try:
        main()
    finally:
        leave()
