"""Train-step benchmark on the card (port of
speech_recognition_tpu/export/benchmark.py::benchmark_train).

Times a run of whole train steps with a pair of ``torch.cuda.Event``s on
the current stream and a final ``torch.cuda.synchronize()``: the
elapsed time covers everything from the first timed step's first
enqueued kernel to the last one's end, host gaps included. It refuses to
run anywhere but on a CUDA device: a CPU time is not a device number.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch


def benchmark_train(trainer, state, steps: int = 100,
                    warmup: int = 10) -> Dict[str, Any]:
    """Steady-state training throughput; ``state`` is updated in place.

    Runs ``warmup`` untimed steps, then ``steps`` timed ones. Returns
    ms/step and clips/s from the CUDA events (plus the host-clock time
    for comparison) and the losses of all ``warmup + steps`` steps.
    """
    if trainer.device.type != "cuda":
        raise RuntimeError(f"benchmark_train measures a CUDA device; the "
                           f"trainer runs on {trainer.device}")
    losses: List[torch.Tensor] = []
    for _ in range(warmup):
        losses.append(trainer.train_step(state)["loss"])
    torch.cuda.synchronize(trainer.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        losses.append(trainer.train_step(state)["loss"])
    end.record()
    torch.cuda.synchronize(trainer.device)
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / steps
    return {
        "steps": steps,
        "batch_size": trainer.batch_size,
        "ms_per_step": ms,
        "clips_per_sec": trainer.batch_size * 1e3 / ms,
        "wall_ms_per_step": 1e3 * wall / steps,
        "losses": torch.stack(losses).cpu().tolist(),
        "device": torch.cuda.get_device_name(trainer.device),
    }
