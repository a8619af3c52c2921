"""Benchmarks on the card: the train step, on one card or one rank of a
data-parallel mesh (port of
speech_recognition_tpu/export/benchmark.py::benchmark_train), its device
busy time by ``torch.profiler`` (``traced_train_device_time``) and its
FLOPs (``train_step_flops``), inference (``benchmark_inference`` and
``traced_inference_device_time``), and the separable-block kernels at the
flagship's trunk shapes: the forward (port of
scripts/bench_separable_kernel.py) and the forward with its gradients
(the path of the JAX package's custom VJP), and the GRU recurrence
kernels against the loop over time (``benchmark_gru``).

Each times a run of calls with a pair of ``torch.cuda.Event``s on the
current stream and a final ``torch.cuda.synchronize()``: the elapsed
time covers everything from the first timed call's first enqueued kernel
to the last one's end, host gaps included. They refuse to run anywhere
but on a CUDA device: a CPU time is not a device number.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.ops.kernels.separable_block import (
    fused_separable_block, fused_separable_block_vjp, reference_block,
    separable_block_bwd, separable_block_bwd_plain,
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
    Under data parallelism each rank calls it and times its own steps on
    its own device; ``batch_size`` and clips/s are the global batch's.
    """
    device = trainer.device
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_train measures a CUDA device; the "
                           f"trainer runs on {device}")
    losses: List[torch.Tensor] = []
    for _ in range(warmup):
        losses.append(trainer.train_step(state)["loss"])
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    start.record(stream)
    for _ in range(steps):
        losses.append(trainer.train_step(state)["loss"])
    end.record(stream)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / steps
    return {
        "steps": steps,
        "batch_size": trainer.batch_size,
        "ms_per_step": ms,
        "clips_per_sec": trainer.batch_size * 1e3 / ms,
        "wall_ms_per_step": 1e3 * wall / steps,
        "losses": torch.stack(losses).cpu().tolist(),
        "ranks": trainer.mesh.size,
        "device": torch.cuda.get_device_name(device),
    }


def traced_train_device_time(trainer, state, steps: int = 20,
                             warmup: int = 2) -> Dict[str, Any]:
    """Device busy time of the train step from a ``torch.profiler`` trace
    (port of export/benchmark.py::traced_train_device_time).

    Runs ``warmup`` untimed steps, then traces ``steps`` steps of the same
    trainer and state (updated in place) and takes the union of the
    intervals in which a kernel, copy or memset ran on the card: the time
    the device was busy, host gaps excluded. An honest host-clock or
    CUDA-event time of the same steps sits at or above it. Returns
    ``device_ms_per_step``, ``device_clips_per_sec``, ``device_busy_ms``,
    ``kernels_per_step`` and ``top_kernels`` (the ten largest by total
    device time, ms per step). Raises if the trace holds no device time.
    """
    device = trainer.device
    if device.type != "cuda":
        raise RuntimeError(f"traced_train_device_time measures a CUDA "
                           f"device; the trainer runs on {device}")
    for _ in range(warmup):
        trainer.train_step(state)
    trace = traced_device_time(
        lambda: [trainer.train_step(state) for _ in range(steps)], device)
    ms_per_step = trace["device_busy_ms"] / steps
    return {
        "device_ms_per_step": ms_per_step,
        "device_clips_per_sec": trainer.batch_size * 1e3 / ms_per_step,
        "device_busy_ms": trace["device_busy_ms"],
        "kernels_per_step": trace["kernels"] / steps,
        "top_kernels": {n: ms / steps for n, ms in trace["top"].items()},
    }


def traced_device_time(fn: Callable[[], Any],
                       device: torch.device) -> Dict[str, Any]:
    """Run ``fn`` once under ``utils/profiling.py::trace_context`` and
    read the trace back with ``summarize_trace``: the union of the
    intervals in which a kernel, copy or memset ran on the card, the
    time the device was busy, host gaps excluded.

    Returns ``device_busy_ms``, ``wall_ms`` (the host clock from the
    start of ``fn`` to the device's last activity, waited for),
    ``kernels`` (the device activities traced), ``memcpy_htod_ms`` (the
    host-to-device copies' device time) and ``top`` (the ten largest
    names by total device ms). Raises if the trace holds no device
    time.
    """
    import tempfile

    from speech_recognition_tpu_torch.utils.profiling import (
        summarize_trace, trace_context,
    )

    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory(prefix="srt_torch_trace_") as td:
        with trace_context(td):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        summary = summarize_trace(td)
    if not summary["activities"]:
        raise RuntimeError("the profiler recorded no device activity")
    top = sorted(summary["modules"].items(),
                 key=lambda kv: -kv[1]["total_ms"])[:10]
    return {
        "device_busy_ms": summary["device_busy_ms"],
        "wall_ms": 1e3 * wall,
        "kernels": summary["activities"],
        "memcpy_htod_ms": summary["memcpy_htod_ms"],
        "top": {n[:60]: m["total_ms"] for n, m in top},
    }


def _synthetic_clips(batch_size: int, samples: int, device: torch.device):
    """The JAX benchmark's inference batch: U(-0.1, 0.1) from numpy seed
    0, float32, on ``device``."""
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -0.1, 0.1, (batch_size, samples)).astype(np.float32)).to(device)


def benchmark_inference(predictor, batch_size: int = 384, steps: int = 20,
                        warmup: int = 3,
                        desired_samples: int = 16000) -> Dict[str, float]:
    """Inference throughput on the card (port of
    export/benchmark.py::benchmark_inference): ``steps`` predictions of
    one synthetic [batch_size, desired_samples] batch, on the device,
    after ``warmup`` untimed ones, timed by CUDA events (the host clock
    beside them). Returns ms per batch, clips/s and ms per clip."""
    device = predictor.device
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_inference measures a CUDA device; "
                           f"the predictor runs on {device}")
    wav = _synthetic_clips(batch_size, desired_samples, device)
    for _ in range(warmup):
        predictor.predict(wav)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        predictor.predict(wav)
    end.record()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / steps
    clips = steps * batch_size
    return {
        "ms_per_batch": ms,
        "clips_per_sec": batch_size * 1e3 / ms,
        "ms_per_clip": ms / batch_size,
        "wall_ms_per_batch": 1e3 * wall / steps,
        "clips": clips,
    }


def traced_inference_device_time(predictor, batch_size: int = 384,
                                 steps: int = 20, warmup: int = 3,
                                 desired_samples: int = 16000,
                                 ) -> Dict[str, Any]:
    """Device busy time of ``predictor.predict`` on the synthetic batch of
    ``benchmark_inference``, from a ``torch.profiler`` trace of ``steps``
    calls after ``warmup``: ``device_ms_per_batch``,
    ``device_clips_per_sec``, ``kernels_per_batch`` and ``top_kernels``
    (ms per batch)."""
    device = predictor.device
    if device.type != "cuda":
        raise RuntimeError(f"traced_inference_device_time measures a CUDA "
                           f"device; the predictor runs on {device}")
    wav = _synthetic_clips(batch_size, desired_samples, device)
    for _ in range(warmup):
        predictor.predict(wav)
    trace = traced_device_time(
        lambda: [predictor.predict(wav) for _ in range(steps)], device)
    ms = trace["device_busy_ms"] / steps
    return {
        "device_ms_per_batch": ms,
        "device_clips_per_sec": batch_size * 1e3 / ms,
        "kernels_per_batch": trace["kernels"] / steps,
        "top_kernels": {n: v / steps for n, v in trace["top"].items()},
    }


def train_step_flops(trainer, state) -> float:
    """FLOPs of one train step as ``torch.utils.flop_counter`` counts
    them: the matmuls and convolutions of the forward and the backward
    (the elementwise work, the optimizer and the data path count 0).
    Runs one step, eagerly: under ``FlopCounterMode`` ``train_step``
    takes no CUDA graph. ``state`` is updated in place."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        trainer.train_step(state)
    return float(counter.get_total_flops())


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


def separable_block_cotangents(t_out: int, cout: int, *,
                               batch: int = SEPARABLE_BATCH,
                               dtype: torch.dtype = torch.bfloat16,
                               device: torch.device | str = "cpu"):
    """``(dy, ds1, ds2)`` of one block from numpy seed 99, at the JAX VJP
    test's scales: dy ~ N(0, 1) in ``dtype`` (y's), ds1 ~ 0.01 N(0, 1) and
    ds2 ~ 0.001 N(0, 1) in float32 (s1's and s2's)."""
    rng = np.random.default_rng(99)
    dy = rng.standard_normal((batch, t_out, cout), dtype=np.float32)
    ds1 = rng.standard_normal(cout, dtype=np.float32) * 0.01
    ds2 = rng.standard_normal(cout, dtype=np.float32) * 0.001
    return (torch.from_numpy(dy).to(device, dtype),
            torch.from_numpy(ds1).to(device), torch.from_numpy(ds2).to(device))


def benchmark_separable_block_grads(device: torch.device | str = "cuda"
                                    ) -> List[Dict[str, Any]]:
    """ms per call of the separable block's gradients at each trunk
    shape, batch 384, in bf16, prologue and statistics on.

    Four timings on the same inputs and cotangents: ``plain_grad``
    (forward and ``torch.autograd.grad`` through ``reference_block``, the
    ATen/cuDNN block, to all five inputs), ``vjp_grad`` (the same through
    ``fused_separable_block_vjp``: the ``fold`` kernel, then the backward
    kernel), ``bwd`` (the backward kernel alone) and ``bwd_plain``
    (``separable_block_bwd_plain`` on the card). Each is the best of
    ``SEPARABLE_RUNS`` runs of ``SEPARABLE_ITERS`` calls. One record per
    shape.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_separable_block_grads measures a CUDA "
                           f"device, not {device}")
    records = []
    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(t, cin, cout,
                                                     device=device)
        kw = dict(stride=stride, padding=padding)
        y = fused_separable_block(x, w_dw, w_pw, a, b, **kw)[0]
        dy, ds1, ds2 = separable_block_cotangents(y.shape[1], cout,
                                                  device=device)
        leaves = [v.detach().requires_grad_() for v in (x, a, b, w_dw, w_pw)]

        def grads(fn):
            return torch.autograd.grad(fn(*leaves), leaves, (dy, ds1, ds2))

        variants = {
            "plain_grad": lambda: grads(lambda x, a, b, w_dw, w_pw:
                                        reference_block(x, w_dw, w_pw, a, b,
                                                        **kw)),
            "vjp_grad": lambda: grads(lambda *v: fused_separable_block_vjp(
                *v, stride, padding)),
            "bwd": lambda: separable_block_bwd(x, y, dy, ds1, ds2, w_dw, w_pw,
                                               a, b, **kw),
            "bwd_plain": lambda: separable_block_bwd_plain(
                x, y, dy, ds1, ds2, w_dw, w_pw, a, b, **kw),
        }
        record = dict(T=t, Cin=cin, Cout=cout, stride=stride,
                      padding=padding, batch=SEPARABLE_BATCH)
        for name, fn in variants.items():
            record[f"{name}_ms"] = time_calls(fn, SEPARABLE_ITERS,
                                              SEPARABLE_RUNS)
        record["device"] = torch.cuda.get_device_name(device)
        records.append(record)
    return records


# (input channels, units, time steps) of the zoo's two BiGRUs:
# xception_with_attention's and conv_1d_simple's
GRU_SHAPES = {"xception_with_attention": (384, 192, 50),
              "conv_1d_simple": (224, 128, 10)}
GRU_BATCH = 384


def _graph_ms(body: Callable[[], Any], generator: torch.Generator,
              iters: int = 20, runs: int = 3) -> float:
    """``body`` captured in a CUDA graph of its own (after two warm-up
    runs on a side stream), then ``time_calls`` of its replays: the
    card's pace, whatever the host's. Each replay counts the runs of the
    kernels its capture launched (``launch.replay``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with launch.capture(graph):
        body()
    return time_calls(functools.partial(launch.replay, graph), iters, runs)


def benchmark_gru(device: torch.device | str = "cuda"
                  ) -> List[Dict[str, Any]]:
    """ms per call of a BiGRU at each of ``GRU_SHAPES``, batch 384, each
    body captured in a CUDA graph and timed over its replays.

    ``train_kernel_ms`` / ``train_loop_ms``: the train step's BiGRU
    (dropout and recurrent dropout 0.2, bf16 autocast), forward and
    backward from the input to every gradient, through the recurrence
    kernels (``BiGRU.run``) and through the loop over time (``GRU.loop``
    of each direction); ``forward_kernel_ms`` / ``backward_kernel_ms``:
    the two kernel launches alone on that layer's inputs and saves;
    ``eval_f32_kernel_ms`` / ``eval_f32_loop_ms``: the Predictor's
    forward (eval mode, float32). One record per shape.
    """
    from speech_recognition_tpu_torch.models.layers import (
        BiGRU, init_parameters,
    )
    from speech_recognition_tpu_torch.ops.kernels import gru as G

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"benchmark_gru measures a CUDA device, not "
                           f"{device}")
    records = []
    for name, (c, u, t) in GRU_SHAPES.items():
        gru = BiGRU(c, u, dropout=0.2, recurrent_dropout=0.2)
        init_parameters(gru, torch.Generator().manual_seed(0))
        gru = gru.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        x = torch.randn(GRU_BATCH, c, t, device=device, requires_grad=True)
        params = [x, *gru.parameters()]
        loop = lambda x: torch.cat([g.loop(x, gen) for g in gru.directions],
                                   dim=1)

        def train(fn):
            def body():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    y = fn(x)
                torch.autograd.grad(y.float().square().sum(), params)
            return body

        def evaluate(fn):
            def body():
                with torch.no_grad():
                    fn(x)
            return body

        record = dict(shape=name, batch=GRU_BATCH, channels=c, units=u,
                      steps=t)
        gru.train()
        record["train_kernel_ms"] = _graph_ms(
            train(lambda x: gru.run(x, gen)), gen)
        record["train_loop_ms"] = _graph_ms(train(loop), gen)
        # the kernels alone, on the train step's inputs
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            proj = [g.project(x.transpose(1, 2), gen)
                    for g in gru.directions]
        xws = [p for p, _ in proj]
        rm = torch.stack([m for _, m in proj]).float()
        wzr = torch.stack([g.recurrent_weight_zr.detach()
                           for g in gru.directions]).bfloat16()
        wh = torch.stack([g.recurrent_weight_h.detach()
                          for g in gru.directions]).bfloat16()
        reverse = (False, True)
        last, hseq, (yz, yr, hh, _) = G.gru_forward(xws, wzr, wh, rm,
                                                    reverse)
        dlast = torch.randn_like(last)
        record["forward_kernel_ms"] = _graph_ms(
            lambda: G.gru_forward(xws, wzr, wh, rm, reverse), gen)
        record["backward_kernel_ms"] = _graph_ms(
            lambda: G.gru_backward(dlast, None, wzr, wh, rm, reverse, hseq,
                                   yz, yr, hh, xws[0].dtype), gen)
        gru.eval()
        record["eval_f32_kernel_ms"] = _graph_ms(
            evaluate(lambda x: gru.run(x)), gen)
        record["eval_f32_loop_ms"] = _graph_ms(evaluate(loop), gen)
        record["device"] = torch.cuda.get_device_name(device)
        records.append(record)
    return records
