"""Streaming-mode training throughput (the port's counterpart of
scripts/bench_streaming.py).

    python -m speech_recognition_tpu_torch.tools.bench_streaming \\
        [--num_clips 2048] [--batch_size 384] [--warmup 2] [--steps 30] \\
        [--trace_steps 5] [--prefetch 4] [--wav_dir DIR] [--device cuda]

Measures ``Trainer.fit_streaming`` end to end: a ``HostPrefetchLoader``
decoding WAVs on disk with the native decoder on its thread and copying
each int16 batch to the card while the card trains the flagship (raw
clips, batch 384, the augmentation with a background bank, the
decode+augment kernel on the streamed batch). The bank path
(``bench.py``) stages the corpus on the card; this one never does.

The corpus is ``--num_clips`` synthetic one-second int16 WAVs (U(-0.5,
0.5) from numpy seed 0, labels 2-11, label 2 silence, as the JAX script
writes them) under the temporary directory, removed afterwards, or the
WAVs of ``--wav_dir``; the background bank is six 60 s clips of U(-0.1,
0.1) noise (numpy seed 1). The weights are random (seed 0).

Prints one JSON line on stdout, ``stream_train_clips_per_sec``: the
timed steps' clips over the host clock from their start to the read of
the last step's loss (after ``--warmup`` untimed steps). On stderr,
``diagnostics:`` with a JSON object: ms/step; the loader's host seconds
per step by part (the producer decoding, the producer issuing copies,
the trainer waiting for a batch); the native decoder alone on this host
(clips/s); the device busy ms per step in a ``torch.profiler`` trace of
``--trace_steps`` more steps, and the idle share it leaves of the
untimed-by-the-profiler step (and of the traced window); the peak
device memory; decode+augment's launches against the steps; the final
loss. ``--device cpu`` runs the steps on the CPU and reports no device
figures.

Over W ranks (``torchrun --nproc_per_node W -m
speech_recognition_tpu_torch.tools.bench_streaming``), each rank writes
the same corpus to a directory of its own, its loader holds its
``process_shard`` of the clips and yields ``--batch_size`` / W rows, and
the streamed steps run data-parallel (``Trainer`` over the mesh);
``stream_train_clips_per_sec`` is the global batch's, and rank 0 alone
prints, its own loader's and device's diagnostics with ``ranks``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

K80_TRAIN_CLIPS_PER_SEC = 450.0     # BASELINE.md:25-26


def build_disk_corpus(root: str, num_clips: int, seed: int = 0):
    """``num_clips`` one-second int16 WAVs in ``root``; returns (paths,
    labels, is_silence), as the JAX script writes and labels them."""
    from speech_recognition_tpu_torch.data.wav import save_wav_file

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(num_clips):
        sig = rng.uniform(-0.5, 0.5, 16000).astype(np.float32)
        p = os.path.join(root, f"clip_{i:06d}.wav")
        save_wav_file(p, sig, 16000)
        paths.append(p)
    labels = rng.integers(2, 12, num_clips).astype(np.int64)
    return paths, labels, labels == 2


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Streaming-mode training throughput (PyTorch port)")
    p.add_argument("--num_clips", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=384)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--trace_steps", type=int, default=5)
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--prefetch", type=int, default=4)
    p.add_argument("--model", default="conv_1d_time_sliced_with_attention")
    p.add_argument("--wav_dir", default="",
                   help="stream these WAVs (labels drawn as for the "
                        "synthetic corpus) instead of writing a corpus")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def stream_trainer(model: str, batch_size: int, device: torch.device,
                   mesh=None):
    """A flagship-recipe ``Trainer`` (over ``mesh``, if given) whose
    dataset holds only the background bank (the JAX script's six 60 s
    noise clips)."""
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import DeviceDataset
    from speech_recognition_tpu_torch.ops.augment import BackgroundBank
    from speech_recognition_tpu_torch.train.loop import Trainer

    settings = prepare_model_settings(label_count=12)
    rng = np.random.default_rng(1)
    bg = [rng.uniform(-0.1, 0.1, 16000 * 60).astype(np.float32)
          for _ in range(6)]
    ds = DeviceDataset(
        wav_bank=torch.zeros((0, settings.desired_samples),
                             dtype=torch.int16, device=device),
        partitions={}, num_classes=12,
        background=BackgroundBank.from_arrays(
            bg, settings.desired_samples, device),
        desired_samples=settings.desired_samples)
    return Trainer(model_name=model, settings=settings, dataset=ds,
                   augment=AugmentConfig(), batch_size=batch_size, mesh=mesh)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the benchmark; returns ``{"record", "diagnostics", "trainer",
    "batch"}``: the stdout line, the stderr object, the trainer and one
    more streamed batch (wav, labels, is_silence) for the caller's
    checks."""
    args = parse_args(argv)
    from speech_recognition_tpu_torch.data.prefetch import (
        HostPrefetchLoader,
    )
    from speech_recognition_tpu_torch.data.wav import decode_batch_int16
    from speech_recognition_tpu_torch.export.benchmark import (
        traced_device_time,
    )
    from speech_recognition_tpu_torch.ops.kernels import launch
    from speech_recognition_tpu_torch.parallel.distributed import (
        join_from_env,
    )

    device, mesh = join_from_env(args.device)
    rows = mesh.rows(args.batch_size)
    cuda = device.type == "cuda"
    tmp = None
    t0 = time.perf_counter()
    if args.wav_dir:
        paths = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav")))
        labels = np.random.default_rng(0).integers(2, 12, len(paths))
        silence = labels == 2
    else:
        tmp = tempfile.mkdtemp(prefix="srt_torch_stream_bench_")
        paths, labels, silence = build_disk_corpus(tmp, args.num_clips)
    if mesh.rank == 0:
        print(f"corpus: {len(paths)} clips on disk "
              f"({time.perf_counter() - t0:.1f} s to write)",
              file=sys.stderr)
    try:
        trainer = stream_trainer(args.model, args.batch_size, device, mesh)
        state = trainer.init_state()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        launches0 = launch.runs()["decode_augment"]
        loader = HostPrefetchLoader(
            paths, labels, silence, batch_size=rows.stop - rows.start,
            desired_samples=16000, prefetch=args.prefetch, seed=7,
            device=device, rank=mesh.rank, world=mesh.size)
        spd = args.steps_per_dispatch
        with loader:
            state, warm = trainer.fit_streaming(state, loader,
                                                args.warmup, 0, spd)
            parts0 = dict(loader.timings)
            t1 = time.perf_counter()
            state, hist = trainer.fit_streaming(state, loader, args.steps,
                                                0, spd)
            wall = time.perf_counter() - t1
            parts = {k: (loader.timings[k] - parts0[k]) / args.steps
                     for k in parts0}
            trace = None
            if cuda and args.trace_steps:
                trace = traced_device_time(
                    lambda: trainer.fit_streaming(
                        state, loader, args.trace_steps, 0, spd), device)
            batch = next(loader)
        train_steps = args.warmup + args.steps + (
            args.trace_steps if trace else 0)
        launches = launch.runs()["decode_augment"] - launches0
        files = [paths[i % len(paths)] for i in range(args.batch_size)]
        t2 = time.perf_counter()
        for _ in range(3):
            decode_batch_int16(files, 16000)
        decode_cps = 3 * args.batch_size / (time.perf_counter() - t2)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    clips_per_sec = hist["clips_per_sec"][0]
    losses = warm["loss"] + hist["loss"]
    diag: Dict[str, Any] = {
        "ms_per_step": 1e3 * wall / args.steps,
        "wall_s": wall,
        "steps": args.steps,
        "warmup": args.warmup,
        "batch_size": args.batch_size,
        "steps_per_dispatch": spd,
        "prefetch_depth": args.prefetch,
        "corpus_clips_on_disk": len(paths),
        "loader_s_per_step": parts,
        "host_decode_clips_per_sec": decode_cps,
        "train_steps": train_steps,
        "decode_augment_launches": launches,
        "losses_finite": all(math.isfinite(v) for v in losses),
        "final_loss": hist["loss"][-1],
        "compute_dtype": trainer.compute_dtype,
        "model": args.model,
        "device": str(device),
        "ranks": mesh.size,
    }
    if mesh.size > 1:
        from speech_recognition_tpu_torch.parallel.collectives import (
            all_reduce_,
        )
        diag["decode_augment_launches_all_ranks"] = int(all_reduce_(
            torch.tensor([launches], device=device), mesh))
    if cuda:
        diag["device_name"] = torch.cuda.get_device_name(device)
        diag["peak_memory_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    if trace is not None:
        busy = trace["device_busy_ms"] / args.trace_steps
        diag["device_busy_ms_per_step"] = busy
        diag["traced_wall_ms_per_step"] = trace["wall_ms"] / args.trace_steps
        # idle over the untraced step, as the bank bench reads it; the
        # profiler's own overhead lengthens the traced window
        diag["device_idle_share"] = 1.0 - busy / diag["ms_per_step"]
        diag["traced_idle_share"] = 1.0 - trace["device_busy_ms"] / max(
            trace["wall_ms"], 1e-9)
        diag["memcpy_htod_ms_per_step"] = (trace["memcpy_htod_ms"]
                                           / args.trace_steps)
        diag["kernels_per_step"] = trace["kernels"] / args.trace_steps
    record = {
        "metric": "stream_train_clips_per_sec",
        "value": clips_per_sec,
        "unit": "clips/s",
        "vs_baseline": clips_per_sec / K80_TRAIN_CLIPS_PER_SEC,
    }
    if mesh.rank == 0:
        print(f"diagnostics: {json.dumps(diag)}", file=sys.stderr)
        print(json.dumps(record), flush=True)
    return {"record": record, "diagnostics": diag, "trainer": trainer,
            "batch": batch}


if __name__ == "__main__":
    from speech_recognition_tpu_torch.parallel.distributed import leave

    try:
        main()
    finally:
        leave()
