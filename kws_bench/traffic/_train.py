"""What the training drivers share: the port's trainer set up from
the configuration with the benchmark's weights, the checked first steps,
the window timed by CUDA events between steps, the traced capture and
the comparison with the reference."""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List

import torch

from kws_bench import harness
from kws_bench.flops import count_flops
from kws_bench.reference import draws as D
from kws_bench.reference import train as RT
from kws_bench.trace import capture, read_events, summarize

CHECKED_STEPS = 3
NUMBERS = ("input_gap", "bn_gap", "grad_gap", "change_gap")
FAULTS = ("half_batch", "wrong_roll")


def background(ctx: harness.Context, g: torch.Generator):
    """The mix's background bank on the card: ``background_clips`` clips
    of ``background_seconds`` of uniform noise in [-0.1, 0.1], flat, with
    each clip's start and length."""
    m, t = ctx.mix, ctx.config["clip_samples"]
    n = m["background_clips"]
    length = int(m["background_seconds"] * ctx.config["sample_rate"])
    flat = (torch.rand(n * length, generator=g, device=ctx.device)
            * 0.2 - 0.1)
    starts = torch.arange(n, device=ctx.device) * length
    lengths = torch.full((n,), length, device=ctx.device)
    if length <= t:
        raise ValueError("a background clip must be longer than a clip")
    return flat, starts, lengths


def training_weights(ctx: harness.Context, model) -> Dict[str, Any]:
    """The benchmark's weights for a training cell, its BatchNorm running
    statistics at 0: train mode never reads them, and from 0 the first
    step's batch statistics come back from them with one rounding
    (``batch_stats``)."""
    w = harness.make_weights(model.param_shapes(ctx.config["num_classes"]),
                             harness.derive_seed(ctx.seed, 2), ctx.device)
    return {k: torch.zeros_like(v) if k.endswith(("running_mean",
                                                  "running_var")) else v
            for k, v in w.items()}


def optimizer_constants(opt) -> Dict[str, float]:
    """The constants of the optimizer the zoo's recipe built, under the
    configuration's names."""
    group = opt.param_groups[0]
    if isinstance(opt, torch.optim.RMSprop):
        return {"rho": group["alpha"], "epsilon": group["eps"]}
    if isinstance(opt, torch.optim.Adam):
        return {"beta_1": group["betas"][0], "beta_2": group["betas"][1],
                "epsilon": group["eps"]}
    if isinstance(opt, torch.optim.SGD):
        return {"momentum": group["momentum"]}
    raise TypeError(f"no check of a {type(opt).__name__}: the benchmark "
                    f"checks RMSprop, Adam and SGD")


def first_gradient(opt, param: torch.Tensor) -> torch.Tensor:
    """|g| of each element of ``param``'s gradient in the optimizer's
    first step, from its state after that step: RMSprop's accumulator
    is (1 - alpha) g^2, Adam's second moment (1 - beta2) g^2, SGD's
    momentum buffer g (so SGD without momentum, which keeps none, is
    refused). A parameter that the step left without state had no
    gradient."""
    group = opt.param_groups[0]
    if isinstance(opt, torch.optim.RMSprop):
        key, keep = "square_avg", 1.0 - group["alpha"]
    elif isinstance(opt, torch.optim.Adam):
        key, keep = "exp_avg_sq", 1.0 - group["betas"][1]
    elif isinstance(opt, torch.optim.SGD) and group["momentum"] > 0:
        key, keep = "momentum_buffer", None
    else:
        raise TypeError(f"no first gradient from a {type(opt).__name__} "
                        f"with {dict(group, params=None)}: RMSprop, Adam "
                        f"and SGD with momentum keep it")
    state = opt.state[param]
    if key not in state:
        return torch.zeros_like(param)
    if keep is None:
        return state[key].abs()
    return (state[key] / keep).sqrt()


def trainer(ctx: harness.Context, dataset, weights):
    """The port's ``Trainer`` for the configuration (its feature geometry
    from the configuration's ``model_settings``, where it has one), its
    state loaded with the benchmark's weights, after a check that the
    zoo's recipe and the optimizer's constants are the configuration's."""
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    cfg = ctx.config
    aug = dict(cfg["augment"])
    aug["time_shift_range"] = tuple(aug["time_shift_range"])
    tr = Trainer(cfg["model"], prepare_model_settings(
                     label_count=cfg["num_classes"],
                     **cfg.get("model_settings", {})), dataset,
                 augment=AugmentConfig(**aug),
                 batch_size=cfg["batch_size"],
                 seed=harness.derive_seed(ctx.seed, 3),
                 compute_dtype=cfg["compute_dtype"])
    spec = tr.spec
    recipe = {"optimizer": spec.optimizer,
              "learning_rate": spec.learning_rate,
              "momentum": spec.momentum,
              "label_smoothing": spec.label_smoothing,
              "l2_reg": spec.l2_reg}
    wanted = {k: cfg.get(k, 0.0) if k == "momentum" else cfg[k]
              for k in recipe}
    if recipe != wanted:
        raise RuntimeError(f"the zoo's recipe {recipe} is not the "
                           f"configuration's {wanted}")
    state = tr.init_state()
    built = optimizer_constants(state.optimizer)
    wanted = {k: cfg.get(k) for k in built}
    if built != wanted:
        raise RuntimeError(f"the program's optimizer has {built}, the "
                           f"configuration {wanted}")
    state.model.load_state_dict(weights, strict=True)
    return tr, state


def _detached(x):
    """A float copy of a model input: a tensor, or each of a tuple."""
    if isinstance(x, (tuple, list)):
        return tuple(_detached(t) for t in x)
    return x.detach().float().clone()


class _Tap:
    """The trainer's frontend, keeping a copy of the first waveform it is
    handed (decode+augment's output) and of the model input it makes."""

    def __init__(self, frontend):
        self.frontend = frontend
        self.seen = None

    def features(self, wav, representation=None):
        out = self.frontend.features(wav, representation)
        if self.seen is None:
            w = _detached(wav)
            self.seen = (w, w if out is wav else _detached(out))
        return out


def checked_steps(tr, state, step: Callable[[], Dict[str, torch.Tensor]],
                  names: List[str], weights) -> Dict[str, Any]:
    """The program's first steps through the window's own call: the
    first step's waveform from decode+augment (as the trainer hands it
    to its frontend) and model input (the frontend's features of it: the
    waveform itself for a raw model), each step's loss, each element's
    first gradient's magnitude from the optimizer's state after one step
    (``first_gradient``), and each leaf's change after the last step,
    before the next moves it."""
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    opt = state.optimizer
    losses, grads, bn_stats = [], None, None
    frontend = tr.frontend
    tap = tr.frontend = _Tap(frontend)
    for i in range(CHECKED_STEPS):
        losses.append(step()["loss"])
        if i == 0:
            tr.frontend = frontend
            grads = [first_gradient(opt, params[n]) for n in names]
            bn_stats = batch_stats(buffers, weights)
    change = torch.stack([(params[n].detach() - weights[n]).norm()
                          for n in names])
    inputs, features = tap.seen
    return {"inputs": inputs, "features": features,
            "losses": torch.stack(losses).float(),
            "grads": grads, "change_norms": change, "bn_stats": bn_stats}


def batch_stats(buffers, weights) -> Dict[str, Any]:
    """Each BatchNorm's batch mean and variance of the step just taken,
    from its running statistics before (the benchmark's weights) and
    after: r1 = m r0 + (1 - m) s, Keras's momentum m = 0.99."""
    from kws_bench.reference.layers import BN_MOMENTUM as m

    out = {}
    for name in buffers:
        if name.endswith(".running_mean"):
            layer = name[:-len(".running_mean")]
            out[layer] = tuple(
                (buffers[f"{layer}.{k}"] - m * weights[f"{layer}.{k}"])
                / (1.0 - m) for k in ("running_mean", "running_var"))
    return out


def window(ctx: harness.Context, step: Callable[[], Dict[str, Any]],
           ) -> Dict[str, Any]:
    """Steps until ``seconds`` of host time have passed, a CUDA event
    recorded on the stream before the first and after each, no wait for
    the card until the window closes; its time is the first event's to
    the last's. Returns the window's start on the host clock, its steps,
    their times (ms), its seconds and the failed (non-finite) steps."""
    losses = []
    start = harness.now()
    events = [harness.event(ctx.device)]
    while True:
        losses.append(step()["loss"])
        events.append(harness.event(ctx.device))
        if harness.now() - start >= ctx.seconds:
            break
    harness.sync(ctx.device)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"start": start, "steps": len(step_ms), "step_ms": step_ms,
            "window_s": events[0].elapsed_time(events[-1]) / 1e3,
            "failed": failed}


def traced(ctx: harness.Context, run_steps: Callable[[int], Any],
           n: int) -> Dict[str, Any]:
    """A ``torch.profiler`` capture of ``n`` steps, read and deleted."""
    path = os.path.join(ctx.workdir, "capture.pt.trace.json")
    _, seconds = capture(lambda: run_steps(n), path)
    summary = summarize(read_events(path))
    os.remove(path)
    return {"summary": summary, "window_s": seconds, "steps": n}


def step_flops(model, cfg: Dict[str, Any]) -> int:
    """FLOPs of one step's forward and backward, from the reference
    model's shapes, its features' products among them where it makes
    features."""
    shapes = model.param_shapes(cfg["num_classes"])
    b = cfg["batch_size"]
    keep = [torch.ones(s, dtype=torch.bool, device="meta")
            for s, _ in model.dropout_shapes(b)]
    featurize = getattr(model, "features", lambda wav: wav)
    return count_flops(
        lambda p, x: model.forward(p, featurize(x), True, keep),
        {n: s for n, s, _ in shapes},
        {n: k in RT.KINDS_TRAINED for n, _, k in shapes},
        b, cfg["clip_samples"])["step"]


def compared(ref: Dict[str, Any]) -> tuple:
    """The names of the numbers a cell compares: ``NUMBERS``, and
    ``feature_gap`` where its reference makes features."""
    return NUMBERS + (("feature_gap",) if ref.get("features") is not None
                      else ())


def numbers(prog: Dict[str, torch.Tensor], ref: Dict[str, Any],
            limits: Dict[str, float]) -> List[harness.Check]:
    got = RT.compare(prog, ref)
    return [harness.Check(k, got[k], limits[k]) for k in compared(ref)]


def trained_names(model, cfg) -> List[str]:
    return [n for n, _, k in model.param_shapes(cfg["num_classes"])
            if k in RT.KINDS_TRAINED]


def layers(ctx, win, trace, flops, host: Dict[str, Any]):
    return {"kind": "train", "cell": ctx.cell["name"],
            "batch": ctx.config["batch_size"], "steps": win["steps"],
            "window_s": win["window_s"], "step_ms": win["step_ms"],
            "flops_step": flops, "trace": trace, "host": host}


def e2e(ctx, win) -> Dict[str, float]:
    from kws_bench.stats import p95, rate
    return {"train_clips_per_s": rate(win["steps"] * ctx.config[
                "batch_size"], win["window_s"]),
            "train_step_ms_p95": p95(win["step_ms"])}


def replay_bytes(g: torch.Generator, draw: Callable[[torch.Generator], Any],
                 model, batch: int, samples: int, n: int,
                 device) -> List[int]:
    """decode+augment's bytes in each of ``n`` steps drawn from ``g``
    (a copy of the trainer's generator at the capture's start): each
    step's draws, then its dropout masks, as the program makes them."""
    out = []
    for _ in range(n):
        d = draw(g)
        D.dropout_masks(g, model.dropout_shapes(batch), device)
        out.append(D.decode_augment_bytes(d, samples))
    return out


def run(ctx: harness.Context, c) -> harness.Run:
    """The run of a training cell ``c`` (a driver's ``Cell``: ``step``,
    ``draw``, ``model``, ``names``, ``weights``, ``free_program`` and
    ``reference``)."""
    cfg, mix = ctx.config, ctx.mix
    prog = checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    pinned = harness.pin_threads()
    for _ in range(mix["warmup_steps"]):
        c.step()
    harness.sync(ctx.device)
    before = harness.host_state()
    win = window(ctx, c.step)
    host = dict(harness.host_record(before, harness.host_state(),
                                    win["step_ms"]), cores=pinned)
    trace, flops = None, None
    if ctx.trace:
        g = torch.Generator(device=ctx.device)
        g.set_state(c.tr.generator.get_state())
        trace = traced(ctx, lambda n: [c.step() for _ in range(n)],
                       mix["trace_steps"])
        trace["decode_augment_bytes"] = replay_bytes(
            g, c.draw, c.model, cfg["batch_size"], cfg["clip_samples"],
            mix["trace_steps"], ctx.device)
        flops = step_flops(c.model, cfg)
    peak = harness.peak_bytes(ctx.device)
    c.free_program()
    ref = c.reference()
    return harness.Run(
        e2e=e2e(ctx, win), window_start=win["start"],
        attempted=win["steps"], failed=win["failed"],
        checks=numbers(prog, ref, ctx.limits), memory_peak_bytes=peak,
        layers=layers(ctx, win, trace, flops, host))


def details(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers with what a look at them needs: each step's relative
    loss gap and the worst leaves."""
    out = RT.compare(prog, ref)
    names = ref["names"]
    norms_p = torch.stack([g.norm() for g in prog["grads"]]).double()
    norms_r = torch.stack([g.norm() for g in ref["grads"]]).double()
    gap = (norms_p - norms_r).abs() / torch.maximum(norms_r,
                                                    norms_r.median())
    out["worst_grad_leaf"] = names[int(gap.argmax())]
    c_p, c_r = prog["change_norms"].double(), ref["change_norms"].double()
    gap = (c_p - c_r).abs() / torch.maximum(c_r, c_r.median())
    out["worst_change_leaf"] = names[int((gap * RT.moved(ref["grads"]))
                                         .argmax())]
    lp, lr_ = prog["losses"].double(), ref["losses"].double()
    for i, g in enumerate(((lp - lr_).abs() / lr_.abs()).tolist()):
        out[f"loss_gap_{i + 1}"] = g
    return out


@contextlib.contextmanager
def planted(tr, fault: str):
    """A fault planted in the program's timed path: ``half_batch``, half
    of the batch left out (of each tensor of a tuple input) and the loss
    the mean over the rest; ``wrong_roll``, decode+augment's time shifts
    turned the wrong way."""
    from speech_recognition_tpu_torch.train import loop

    if fault == "half_batch":
        update = tr._update_step

        def half(x, h):
            if isinstance(x, (tuple, list)):
                return type(x)(half(t, h) for t in x)
            return x[:h]
        tr._update_step = lambda state, x, labels: update(
            state, half(x, labels.shape[0] // 2),
            labels[:labels.shape[0] // 2])
        try:
            yield
        finally:
            del tr._update_step
    elif fault == "wrong_roll":
        decode_augment = loop.decode_augment
        loop.decode_augment = lambda bank, bg, ids, shifts, *rest: \
            decode_augment(bank, bg, ids, -shifts, *rest)
        try:
            yield
        finally:
            loop.decode_augment = decode_augment
    else:
        raise ValueError(f"no fault {fault!r}; faults: {FAULTS}")


def readings(ctx: harness.Context, role: str, make_cell) -> Dict[str, Dict]:
    """A training cell's readings for ``calibrate``: the program's numbers
    (``role`` "program"), the precision control's ("control": float8
    e4m3 products in the reference), or a planted fault's (``role`` one
    of ``FAULTS``)."""
    from kws_bench.reference.layers import fp8_e4m3

    c = make_cell(ctx)
    if role == "control":
        c.free_program()
        ref = c.reference()
        return {"fp8_control": details(c.reference(fp8_e4m3), ref)}
    with (planted(c.tr, role) if role != "program"
          else contextlib.nullcontext()):
        prog = checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    c.free_program()
    return {role: details(prog, c.reference())}
