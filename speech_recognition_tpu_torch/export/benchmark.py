"""Benchmarks on the card: the train step (port of
speech_recognition_tpu/export/benchmark.py::benchmark_train) and the
separable-block kernel at the flagship's trunk shapes (port of
scripts/bench_separable_kernel.py).

Each times a run of calls with a pair of ``torch.cuda.Event``s on the
current stream and a final ``torch.cuda.synchronize()``: the elapsed
time covers everything from the first timed call's first enqueued kernel
to the last one's end, host gaps included. They refuse to run anywhere
but on a CUDA device: a CPU time is not a device number.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.kernels.separable_block import (
    fused_separable_block, reference_block,
)

# (T, Cin, Cout, stride, padding) of the flagship's 11 trunk blocks
# (conv_1d_time_sliced_with_attention at 16 kHz), as the JAX block
# benchmark lists them
SEPARABLE_SHAPES = [
    (399, 128, 128, 1, "VALID"),
    (397, 128, 192, 2, "SAME"),
    (199, 192, 192, 1, "VALID"),
    (197, 192, 256, 2, "SAME"),
    (99, 256, 256, 1, "VALID"),
    (97, 256, 320, 2, "SAME"),
    (49, 320, 320, 1, "VALID"),
    (47, 320, 384, 2, "SAME"),
    (24, 384, 384, 1, "VALID"),
    (22, 384, 512, 2, "SAME"),
    (11, 512, 512, 1, "VALID"),
]
SEPARABLE_BATCH = 384
# calls per timed run, and runs per variant and shape (the best is kept)
SEPARABLE_ITERS, SEPARABLE_RUNS = 20, 3


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


def separable_block_inputs(t: int, cin: int, cout: int, *,
                           batch: int = SEPARABLE_BATCH,
                           dtype: torch.dtype = torch.bfloat16,
                           device: torch.device | str = "cpu"):
    """``(x, w_dw, w_pw, a, b)`` of one block from numpy seed 0, at the
    JAX block benchmark's scales: x ~ N(0, 1), w_dw ~ 0.2 N(0, 1), w_pw ~
    0.1 N(0, 1) (these three in ``dtype``), a ~ U(0.5, 1.5) and b ~
    0.1 N(0, 1) in float32."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, t, cin), dtype=np.float32)
    w_dw = rng.standard_normal((3, 1, cin), dtype=np.float32) * 0.2
    w_pw = rng.standard_normal((1, cin, cout), dtype=np.float32) * 0.1
    a = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    b = rng.standard_normal(cin, dtype=np.float32) * 0.1
    return (*(torch.from_numpy(v).to(device, dtype) for v in (x, w_dw, w_pw)),
            *(torch.from_numpy(v).to(device) for v in (a, b)))


def time_calls(fn: Callable[[], Any], iters: int, runs: int = 3) -> float:
    """Best over ``runs`` of the mean ms per call of ``fn`` over ``iters``
    calls (CUDA events), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def benchmark_separable_blocks(device: torch.device | str = "cuda"
                               ) -> List[Dict[str, Any]]:
    """ms per call of the separable block at each trunk shape, batch 384,
    in bf16.

    Three variants on the same inputs: ``plain`` (``reference_block``,
    ATen/cuDNN convolutions, what the port's ``DepthwiseConvBlock`` runs),
    ``fuse`` and ``fold`` (the CUDA kernel, ``fold_weights`` False and
    True), each with the prologue and the statistics on. Each time is the
    best of ``SEPARABLE_RUNS`` runs of ``SEPARABLE_ITERS`` calls. One
    record per shape.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_separable_blocks measures a CUDA "
                           f"device, not {device}")
    records = []
    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(t, cin, cout,
                                                     device=device)
        kw = dict(stride=stride, padding=padding)
        variants = {
            "plain": lambda: reference_block(x, w_dw, w_pw, a, b, **kw),
            "fuse": lambda: fused_separable_block(
                x, w_dw, w_pw, a, b, fold_weights=False, **kw),
            "fold": lambda: fused_separable_block(
                x, w_dw, w_pw, a, b, fold_weights=True, **kw),
        }
        record = dict(T=t, Cin=cin, Cout=cout, stride=stride,
                      padding=padding, batch=SEPARABLE_BATCH)
        for name, fn in variants.items():
            record[f"{name}_ms"] = time_calls(fn, SEPARABLE_ITERS,
                                              SEPARABLE_RUNS)
        record["device"] = torch.cuda.get_device_name(device)
        records.append(record)
    return records
