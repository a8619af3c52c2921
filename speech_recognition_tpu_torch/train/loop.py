"""Training loop (port of speech_recognition_tpu/train/loop.py).

One train step: draw the batch (sample ids and augmentation parameters)
from the trainer's ``torch.Generator``, build it (fused decode+augment
kernel -> ``Frontend`` features), then forward, backward and the
optimizer update of the model's recipe. Everything stays on the
dataset's device, and nothing in a step waits for the device: losses
come back as device tensors.

Ported: ``init_state``, the two halves of ``_sample_batch``
(``draw_batch``/``build_batch``, so tests can inject draws),
``_update_step``, ``train_step``, ``train_many`` (a plain loop),
``_eval_step``, ``evaluate``, BN re-estimation
(``recalibrate_batch_stats``), ``fit`` and
``reference_pseudo_schedule``.

Streaming (``train_step_stream``, ``train_many_stream``,
``fit_streaming``, ``recalibrate_batch_stats_stream``): the batch comes
from a ``data/prefetch.py::HostPrefetchLoader`` as int16 on the device,
and is its own bank: its augmentation is drawn from the trainer's
generator (``draw_stream``) and applied by the decode+augment kernel
with ``file_ids = arange(B)`` (``build_stream_batch``), then the step is
the bank path's ``_update_step``. Its dataset need hold only the
validation partition (and the background bank), for ``evaluate``; such a
trainer refuses the bank path's steps. Over W ranks each rank's loader
holds its ``process_shard`` of the files and yields B/W rows; the global
batch is the ranks' rows in rank order. ``draw_stream`` gathers the
rows' silence flags, draws the augmentation of the global batch and
keeps the rank's rows, so every rank's generator stays in step, as in
the bank path; decode+augment runs once per rank on the rank's own
rows.

Data parallelism (``mesh`` of W > 1 ranks, one process each; the JAX
trainer's multi-device mesh): every rank draws the global batch from the
same seed and keeps its rows, decode+augment runs per rank
(``decode_augment_sharded``), BatchNorm takes global-batch statistics and
Dropout global masks, and the gradients are averaged over ranks before
the optimizer step (one flattened all-reduce after the backward, not
DDP, whose bucket hooks would interleave with BatchNorm's collectives),
so a W-rank step is the one-device step on the same batch and every
rank's parameters stay bit-identical. ``mesh=None`` (or a one-rank mesh)
is the single-device trainer, with no collective.

Each step records its phases as spans (``utils/profiling.py::span``):
``train.step`` (in memory only) around ``train.draw``, ``train.build``,
``train.forward``, ``train.loss``, ``train.backward`` and
``train.optimizer``, which a ``torch.profiler`` capture also shows as
ranges; ``init_state`` records ``setup.init_state``.

On a CUDA device with one rank, the bank path's step is one CUDA graph
(``Trainer._graph_step``): the first step of a state runs eagerly, the
next captures the same step body (draw, decode+augment, features,
forward, loss, backward, optimizer) and every later one replays it, as
long as nothing the graph bakes in changes (``Trainer.graph_key``). A
replayed step records ``train.replay`` inside its ``train.step`` and no
phase spans, since their Python does not run; the capture records
``train.capture``. The CPU, W > 1 ranks and the streamed step (a new
host batch each step) stay eager.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from speech_recognition_tpu_torch.config import AugmentConfig, ModelSettings
from speech_recognition_tpu_torch.data.device_bank import DeviceDataset
from speech_recognition_tpu_torch.data.wav import INT16_DECODE_SCALE
from speech_recognition_tpu_torch.models.layers import (
    at_least_float32, collect_batch_stats, use_mesh,
)
from speech_recognition_tpu_torch.models.zoo import (
    build_model, get_spec, settings_geometry,
)
from speech_recognition_tpu_torch.ops.augment import (
    augment_batch, draw_augment_params,
)
from speech_recognition_tpu_torch.ops.frontend import Frontend
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.ops.kernels.decode_augment import (
    decode_augment,
)
from speech_recognition_tpu_torch.ops.kernels.sharded import (
    decode_augment_sharded,
)
from speech_recognition_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_, average_gradients,
)
from speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, replicated, shard_batch,
)
from speech_recognition_tpu_torch.train import metrics as M
from speech_recognition_tpu_torch.train.optim import (
    build_optimizer, l2_kernel_penalty, smooth_cross_entropy,
)
from speech_recognition_tpu_torch.utils.profiling import (
    device_span, device_spans, span,
)


@dataclasses.dataclass
class TrainState:
    """The model (f32 master weights + BN running statistics), its
    optimizer and the step count; train steps update it in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class _StepGraph:
    """A trainer's CUDA graph of its bank step, and the key it holds
    for. ``graph`` is None after the eager step that warms the key up;
    ``state`` keeps alive the objects the key names by ``id``."""

    key: tuple
    state: TrainState
    graph: Any = None
    outputs: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class Draws:
    """Every random draw of one training batch."""

    file_ids: torch.Tensor
    labels: torch.Tensor
    is_silence: torch.Tensor
    shifts: torch.Tensor
    fg_vol: torch.Tensor
    bg_pos: torch.Tensor
    bg_vol: torch.Tensor


@dataclasses.dataclass
class Trainer:
    """Trainer for one zoo model on a DeviceDataset, on the dataset's device.

    ``compute_dtype``: 'bfloat16' runs forward/backward under bf16
    autocast with f32 master weights and f32 BN statistics; 'float32' is
    reference-exact; 'auto' picks bfloat16 on CUDA and float32 on the CPU.
    ``model_kwargs`` are extra module-constructor arguments (the
    ablation hook of the JAX trainer, e.g. ``{"head": "flatten"}`` on
    ``conv_2d_fast``); None builds the registry's model as it is.
    ``seed`` seeds the weight init and the trainer's generator, which
    draws batches, augmentation and dropout masks. ``batch_size`` is the
    global batch; with a ``mesh`` of W ranks (the dataset on this rank's
    device, the same seed on every rank) each rank computes B/W rows of
    it, and ``B % W != 0`` raises. ``learning_rate`` overrides the
    registry recipe's. ``frontend_precision`` is the ``Frontend``'s
    ('highest' or 'fastest'); 'auto' follows the compute dtype, 'fastest'
    under bfloat16 (the JAX trainer's choice, loop.py:106-112, 169-176).
    ``graph_error`` is None, or the error that made the capture of the
    bank step's CUDA graph fail, after which the trainer's steps stay
    eager.
    """

    model_name: str
    settings: ModelSettings
    dataset: DeviceDataset
    augment: AugmentConfig = AugmentConfig()
    batch_size: int = 384
    seed: int = 0
    compute_dtype: str = "auto"
    mesh: Optional[Mesh] = None
    model_kwargs: Optional[Dict[str, Any]] = None
    learning_rate: Optional[float] = None
    frontend_precision: str = "auto"

    def __post_init__(self):
        self.device = self.dataset.device
        if self.mesh is None:
            self.mesh = Mesh(device=self.device)
        if self.mesh.device not in (None, self.device):
            raise ValueError(f"the dataset is on {self.device}, this "
                             f"rank's device is {self.mesh.device}")
        self.mesh.rows(self.batch_size)     # B % W == 0
        if self.compute_dtype == "auto":
            self.compute_dtype = ("bfloat16" if self.device.type == "cuda"
                                  else "float32")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        self.spec = get_spec(self.model_name)
        if self.frontend_precision == "auto":
            self.frontend_precision = (
                "fastest" if self.compute_dtype == "bfloat16" else "highest")
        self.frontend = Frontend(self.settings, self.frontend_precision)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed + 1)
        bg = self.dataset.background
        t = self.settings.desired_samples
        self._bg_flat = (bg.flat if bg is not None else
                         torch.zeros(t, dtype=torch.float32,
                                     device=self.device))
        self._graph: Optional[_StepGraph] = None
        self.graph_error: Optional[str] = None

    # -- setup ------------------------------------------------------------

    def init_state(self) -> TrainState:
        with span("setup.init_state", profiler_range=False):
            model, _ = build_model(
                self.model_name, num_classes=self.settings.label_count,
                generator=torch.Generator().manual_seed(self.seed),
                model_kwargs=self.model_kwargs,
                **settings_geometry(self.settings))
            model.to(self.device)
            if self.mesh.size > 1:
                use_mesh(model, self.mesh)
                replicated(model, self.mesh)
            optimizer = build_optimizer(
                self.spec.optimizer, model.parameters(),
                self.learning_rate or self.spec.learning_rate,
                self.spec.momentum)
        return TrainState(model=model, optimizer=optimizer)

    def _autocast(self):
        return torch.autocast(device_type=self.device.type,
                              dtype=torch.bfloat16,
                              enabled=self.compute_dtype == "bfloat16")

    # -- steps ------------------------------------------------------------

    def _require_training(self) -> None:
        if "training" not in self.dataset.partitions:
            raise ValueError(
                "the dataset holds no training partition: this trainer is "
                "in streaming mode; use train_step_stream / fit_streaming")

    def draw_batch(self, pseudo_frequency: Optional[float] = None,
                   generator: Optional[torch.Generator] = None) -> Draws:
        """Sample ids and augmentation parameters for one training batch,
        from ``generator`` (default: the trainer's); ``pseudo_frequency``
        defaults to the augment config's."""
        self._require_training()
        ds = self.dataset
        g = self.generator if generator is None else generator
        if pseudo_frequency is None:
            pseudo_frequency = self.augment.pseudo_frequency
        fids, labels, silence = ds.sample_train_ids(g, self.batch_size,
                                                    pseudo_frequency)
        shifts, fg_vol, bg_pos, bg_vol = draw_augment_params(
            g, silence, self.augment, ds.background, self.batch_size,
            ds.desired_samples)
        return Draws(fids, labels, silence, shifts, fg_vol, bg_pos, bg_vol)

    def build_batch(self, d: Draws):
        """Decode + augment (one kernel launch) + featurize this rank's
        rows of the (global) draws. A model that takes features times
        the frontend on the card as the device span ``frontend.forward``
        (``device_spans``; a replay of the step's graph records it too);
        a raw model's waveform, which the frontend hands back as it is,
        records no span."""
        args = (self.dataset.wav_bank, self._bg_flat, d.file_ids, d.shifts,
                d.fg_vol, d.bg_pos, d.bg_vol)
        if self.mesh.size > 1:
            wav = decode_augment_sharded(self.mesh, *args)
        else:
            wav = decode_augment(*args)
        rep = self.spec.representation
        if rep == "raw":
            return self.frontend.features(wav, rep)
        return device_spans(
            "frontend", lambda w: self.frontend.features(w, rep), wav)

    def _update_step(self, state: TrainState, x: torch.Tensor,
                     labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Forward/backward/optimizer update on featurized inputs (this
        rank's rows, and their labels). After it, each parameter's
        ``.grad`` holds this step's gradient (of the global batch), and
        the metrics are means over the global batch. Its phases are spans
        (``utils/profiling.py::span``): ``train.optimizer`` twice, since
        the gradients are cleared before the backward. The update alone
        is timed on the card as the device span ``optimizer.step``
        (``device_span``; a replay of the step's graph records it too)."""
        model = state.model
        model.train()
        with span("train.forward"), self._autocast():
            logits = at_least_float32(model(x, self.generator))
        with span("train.loss"):
            loss = smooth_cross_entropy(logits, labels,
                                        self.spec.label_smoothing)
            loss = loss + l2_kernel_penalty(model, self.spec.l2_reg)
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
            if self.mesh.size > 1:
                average_gradients(model.parameters(), self.mesh)
        with span("train.optimizer"), \
                device_span("optimizer.step", self.device):
            state.optimizer.step()
        state.step += 1
        acc = (logits.argmax(-1) == labels).float().mean()
        if self.mesh.size > 1:
            both = all_reduce_(torch.stack([loss.detach(), acc.to(loss.dtype)]),
                               self.mesh) / self.mesh.size
            return {"loss": both[0], "categorical_accuracy": both[1]}
        return {"loss": loss.detach(), "categorical_accuracy": acc}

    def train_step(self, state: TrainState,
                   pseudo_frequency: Optional[float] = None,
                   ) -> Dict[str, torch.Tensor]:
        """One training step; updates ``state`` in place and returns its
        metrics as tensors of their own. ``pseudo_frequency`` defaults
        to the augment config's. Recorded as a ``train.step`` span
        around the phases' spans (``_bank_step``'s); in memory only,
        since as a profiler range it would be the outermost host range
        at every idle gap of a capture, and hide the phases.

        On a CUDA device with one rank the step is its CUDA graph's
        (``_graph_step``), except under a ``TorchDispatchMode`` such as
        ``FlopCounterMode``, which sees only the operators that run
        eagerly."""
        with span("train.step", state.step, profiler_range=False):
            if self._uses_graph():
                return self._graph_step(state, pseudo_frequency)
            return self._bank_step(state, pseudo_frequency)

    def _uses_graph(self) -> bool:
        """Whether ``train_step`` goes through the CUDA graph: on a CUDA
        device, one rank (a step over W ranks runs collectives and stays
        eager), no failed capture, and no ``TorchDispatchMode`` watching
        the operators."""
        return (self.device.type == "cuda" and self.mesh.size == 1
                and self.graph_error is None
                and not torch._C._len_torch_dispatch_stack())

    def _bank_step(self, state: TrainState,
                   pseudo_frequency: Optional[float],
                   ) -> Dict[str, torch.Tensor]:
        """The bank path's step body: what an eager step runs and what
        a capture records."""
        with span("train.draw"):
            d = self.draw_batch(pseudo_frequency)
        with span("train.build"):
            x = self.build_batch(d)
        return self._update_step(state, x, shard_batch(d.labels, self.mesh))

    def graph_key(self, state: TrainState,
                  pseudo_frequency: Optional[float] = None) -> tuple:
        """What a captured bank step bakes in, as a tuple that stays
        equal only while a replay redoes the eager step: the host values
        (the pseudo frequency, the batch size, the augmentation, the
        compute dtype, the partitions' and the background's sizes, and
        each param group's hyperparameters, the learning rate among
        them), the trainer's generator, the state, its model and its
        optimizer by ``id``, and the address of every tensor the step
        reads or writes: parameters, their gradients, buffers,
        optimizer state, the bank, the background and the partitions'
        index tensors."""
        if pseudo_frequency is None:
            pseudo_frequency = self.augment.pseudo_frequency
        model, opt, ds = state.model, state.optimizer, self.dataset
        tensors = []
        for m in model.modules():       # one walk: a key is made each step
            for p in m._parameters.values():
                if p is not None:
                    tensors += (p, p.grad)
            tensors += m._buffers.values()
        tensors += [*(v for s in opt.state.values() for v in s.values()
                      if torch.is_tensor(v)),
                    ds.wav_bank, self._bg_flat,
                    *(t for p in ds.partitions.values()
                      for t in (p.file_ids, p.labels, p.is_silence))]
        bg = ds.background
        if bg is not None:
            tensors += [bg.starts, bg.lengths]
        groups = tuple(
            tuple((k, v.data_ptr() if torch.is_tensor(v) else v)
                  for k, v in group.items() if k != "params")
            for group in opt.param_groups)
        sizes = (tuple((k, p.size) for k, p in ds.partitions.items()),
                 None if bg is None else bg.num_clips)
        return (pseudo_frequency, self.batch_size, self.augment,
                self.compute_dtype, sizes, groups, id(self.generator),
                id(state), id(model), id(opt),
                tuple(None if t is None else t.data_ptr() for t in tensors))

    def _graph_step(self, state: TrainState,
                    pseudo_frequency: Optional[float],
                    ) -> Dict[str, torch.Tensor]:
        """The bank step through the trainer's one CUDA graph. Under a
        key (``graph_key``) the graph does not hold, the graph is freed
        and the step runs eagerly: the state's first step, a new
        learning rate or pseudo frequency, a loaded optimizer state.
        That step also makes the optimizer's state and the libraries'
        handles, so the next call under its key captures the step body
        and replays it; later calls replay it. A replay writes every
        tensor the eager step writes, each parameter's ``.grad`` among
        them, and advances the generator as the eager step does."""
        key = self.graph_key(state, pseudo_frequency)
        g = self._graph
        if g is None or g.key != key:
            self._graph = None
            out = self._bank_step(state, pseudo_frequency)
            self._graph = _StepGraph(
                self.graph_key(state, pseudo_frequency), state)
            return out
        if g.graph is None and not self._capture(g, state,
                                                 pseudo_frequency):
            return self._bank_step(state, pseudo_frequency)
        with span("train.replay"):
            launch.replay(g.graph)
        if not state.model.training:     # as the eager step leaves it
            state.model.train()
        state.step += 1
        return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, g: _StepGraph, state: TrainState,
                 pseudo_frequency: Optional[float]) -> bool:
        """Capture the step body into ``g``; the capture runs nothing
        and leaves ``state.step`` as it was. On a failure (a host sync
        in a model's forward, say) print the error, keep it in
        ``graph_error`` and return False: the trainer stays eager."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        generators = (self.generator, torch.cuda.default_generators[index])
        before = [gen.get_state() for gen in generators]
        stream, step = torch.cuda.current_stream(self.device), state.step
        try:
            with span("train.capture"), launch.capture(graph):
                outputs = self._bank_step(state, pseudo_frequency)
        except RuntimeError as e:
            # torch leaves the stream and the capture's generators (the
            # trainer's and the device's default) in capture mode: each
            # generator takes a new state object at its state before
            torch.cuda.set_stream(stream)
            for gen, saved in zip(generators, before):
                fresh = torch.Generator(device=self.device)
                fresh.set_state(saved)
                gen.graphsafe_set_state(fresh.graphsafe_get_state())
            self._graph, self.graph_error = None, repr(e)
            print(f"train step: the CUDA graph capture of "
                  f"{self.model_name}'s step failed, its steps stay "
                  f"eager: {e!r}")
            return False
        finally:
            state.step = step
        g.graph, g.outputs = graph, outputs
        g.key = self.graph_key(state, pseudo_frequency)
        return True

    def train_many(self, state: TrainState, steps: int,
                   pseudo_frequency: Optional[float] = None,
                   ) -> Dict[str, torch.Tensor]:
        """``steps`` train steps; each metric stacked to shape [steps].

        The JAX ``train_many`` is one ``lax.scan`` program; here it is
        ``steps`` calls of ``train_step``, the same updates, each one
        replay of the step's CUDA graph on one card. A graph of K steps
        would hold K steps' activations, and a replay's host time hides
        behind a step's device time already.
        """
        out = [self.train_step(state, pseudo_frequency)
               for _ in range(steps)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    def recalibrate_batch_stats(self, state: TrainState,
                                num_batches: int = 16,
                                generator: Optional[torch.Generator] = None,
                                pseudo_frequency: Optional[float] = None,
                                ) -> TrainState:
        """Set every BatchNorm's running statistics to the average of the
        exact batch statistics of ``num_batches`` fresh training batches
        (loop.py:518-576): the mean of the batch means and the mean of
        the *biased* batch variances, as flax keeps them.

        Each batch is drawn from ``generator`` (default: a fresh one
        seeded with ``seed + 7``, so the training stream is untouched),
        built as a train step builds it, and run through the model in
        train mode in float32 (float64 if the model is), whatever the
        compute dtype; the statistics are read straight from the
        BatchNorm layers (``collect_batch_stats``), so no momentum update
        is undone. Short schedules need this: at momentum 0.99 the
        running statistics lag the data by ~100s of steps, and eval-mode
        BN on them can collapse a deep trunk. Returns ``state``, updated
        in place.
        """
        if generator is None:
            generator = self._generator(7)
        return self._recalibrate(
            state, num_batches, generator, lambda: self.build_batch(
                self.draw_batch(pseudo_frequency, generator)))

    def recalibrate_batch_stats_stream(self, state: TrainState, loader,
                                       num_batches: int = 16,
                                       generator: Optional[
                                           torch.Generator] = None,
                                       ) -> TrainState:
        """``recalibrate_batch_stats`` over ``num_batches`` batches of
        ``loader`` (a ``HostPrefetchLoader``), each augmented as a
        streamed step augments it, from ``generator`` (default: a fresh
        one seeded with ``seed + 9``, as the JAX trainer's key)."""
        if generator is None:
            generator = self._generator(9)

        def streamed():
            wav, labels, silence = next(loader)
            return self.build_stream_batch(
                wav, self.draw_stream(labels, silence, generator))

        return self._recalibrate(state, num_batches, generator, streamed)

    def _generator(self, offset: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + offset)
        return g

    def _recalibrate(self, state: TrainState, num_batches: int,
                     generator: torch.Generator,
                     next_input: Callable[[], Any]) -> TrainState:
        model = state.model
        model.train()
        dtype = at_least_float32(next(model.parameters())).dtype
        with torch.no_grad(), collect_batch_stats(model) as stats:
            if not stats:
                return state
            for _ in range(num_batches):
                x = next_input()
                model(tuple(t.to(dtype) for t in x) if isinstance(x, tuple)
                      else x.to(dtype), generator)
        for bn, batches in stats.items():
            means, variances = zip(*batches)
            bn.running_mean.copy_(torch.stack(means).mean(0))
            bn.running_var.copy_(torch.stack(variances).mean(0))
        return state

    # -- streaming ------------------------------------------------------

    def draw_stream(self, labels: torch.Tensor, is_silence: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> Draws:
        """The augmentation draws of a streamed batch of ``len(labels)``
        clips, from ``generator`` (default: the trainer's). The batch is
        its own bank: ``file_ids`` is ``arange(B)``.

        With W ranks, ``labels`` and ``is_silence`` are this rank's rows
        (every rank passes as many): the silence flags are gathered into
        the global batch's (``all_gather_rows``), the augmentation of all
        its rows is drawn, and this rank keeps its rows of it, with
        ``file_ids`` ``arange(B/W)`` into its own rows."""
        g = self.generator if generator is None else generator
        rows = labels.shape[0]
        silence = all_gather_rows(is_silence, self.mesh)
        params = draw_augment_params(
            g, silence, self.augment, self.dataset.background,
            silence.shape[0], self.settings.desired_samples)
        return Draws(torch.arange(rows, device=self.device), labels,
                     is_silence, *shard_batch(params, self.mesh))

    def build_stream_batch(self, wav: torch.Tensor, d: Draws):
        """Augment + featurize a streamed batch on the device: int16
        [B, T] through the decode+augment kernel with the batch as its
        bank (one launch). A float32 batch already scaled (int16 clips
        over 32768, as the JAX step accepts) goes back to int16 first,
        exactly, since the scale is a power of two, and takes the same
        kernel with the same draws; one off the int16 grid raises. With
        W ranks, ``wav`` and ``d`` are this rank's rows."""
        if wav.dtype != torch.int16:
            scaled = wav.float() * INT16_DECODE_SCALE
            grid = scaled.round().clamp(-32768, 32767)
            if not torch.equal(grid, scaled):
                raise ValueError("a float32 streamed batch must be int16 "
                                 "clips divided by 32768")
            wav = grid.to(torch.int16)
        wav = decode_augment(wav, self._bg_flat, d.file_ids, d.shifts,
                             d.fg_vol, d.bg_pos, d.bg_vol)
        return self.frontend.features(wav, self.spec.representation)

    def train_step_stream(self, state: TrainState, wav: torch.Tensor,
                          labels: torch.Tensor, is_silence: torch.Tensor,
                          ) -> Dict[str, torch.Tensor]:
        """One update from a streamed batch (loop.py:331-353); updates
        ``state`` in place. With W ranks each passes its B/W rows, and
        the metrics are the global batch's. Its spans are
        ``train_step``'s."""
        with span("train.step", state.step, profiler_range=False):
            with span("train.draw"):
                d = self.draw_stream(labels, is_silence)
            with span("train.build"):
                x = self.build_stream_batch(wav, d)
            return self._update_step(state, x, labels)

    def train_many_stream(self, state: TrainState, wavs, labels,
                          is_silence) -> Dict[str, torch.Tensor]:
        """K streamed updates from K batches (``wavs`` [K, B, T] or a
        sequence of K [B, T], ``labels`` and ``is_silence`` likewise): a
        loop of ``train_step_stream``, as ``train_many`` is of
        ``train_step``; each metric stacked to shape [K]."""
        out = [self.train_step_stream(state, w, y, s)
               for w, y, s in zip(wavs, labels, is_silence)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    def fit_streaming(self, state: TrainState, loader, steps: int,
                      log_every: int = 0, steps_per_dispatch: int = 1,
                      ) -> Tuple[TrainState, Dict[str, list]]:
        """``steps`` updates from ``loader`` (a ``HostPrefetchLoader``,
        whose producer decodes and copies while the card trains), one
        ``train_step_stream`` per batch. ``steps_per_dispatch`` is the JAX
        trainer's streamed steps per XLA dispatch; here it changes
        nothing: a streamed step takes a new host batch and stays eager,
        one dispatch of its own. Returns the state and the history:
        the last step's ``loss`` and ``categorical_accuracy`` (and every
        ``log_every`` steps'), and ``clips_per_sec`` over the whole call,
        timed to the read of the last step's metrics, which waits for
        the device."""
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        history: Dict[str, list] = {}
        t0 = time.perf_counter()
        metrics = None
        for step in range(1, steps + 1):
            metrics = self.train_step_stream(state, *next(loader))
            if log_every and step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"  stream step {step}/{steps}: {m}")
                for k, v in m.items():
                    history.setdefault(k, []).append(v)
        if metrics is not None:
            for k, v in metrics.items():
                history.setdefault(k, []).append(float(v))
        history["clips_per_sec"] = [
            steps * self.batch_size / max(time.perf_counter() - t0, 1e-9)]
        return state, history

    @torch.no_grad()
    def _eval_step(self, state: TrainState, fids: torch.Tensor,
                   labels: torch.Tensor, silence: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode, neutral eval augmentation, logits -> (confusion, loss sum)."""
        model = state.model
        model.eval()
        wav = augment_batch(self.dataset.decode(fids), silence)
        with self._autocast():
            logits = at_least_float32(
                model(self.frontend.features(wav, self.spec.representation)))
        conf = M.confusion_matrix(labels, logits.argmax(-1),
                                  self.settings.label_count)
        loss_sum = -torch.log_softmax(logits, dim=-1).gather(
            1, labels.long()[:, None]).sum()
        return conf, loss_sum

    def evaluate(self, state: TrainState, mode: str = "validation",
                 ) -> Tuple[np.ndarray, float]:
        """Deterministic sweep; returns (confusion matrix, mean log loss).

        Like the reference, trailing samples beyond a full batch are
        dropped (steps = set_size // batch_size, train.py:58,70); a set
        smaller than one batch is evaluated as one batch. With W ranks
        the batch shrinks to a multiple of W (as the JAX trainer's does,
        loop.py:646-653), each rank sweeps its rows of every batch, and
        the confusion matrix and loss sum are all-reduced.
        """
        ds = self.dataset
        set_size = ds.set_size(mode)
        if set_size == 0:
            raise ValueError(f"partition {mode!r} is empty")
        w = self.mesh.size
        batch = min(self.batch_size, set_size) // w * w
        if batch == 0:
            raise ValueError(f"partition {mode!r} has {set_size} samples, "
                             f"fewer than the {w} ranks can split")
        steps = set_size // batch
        rows = self.mesh.rows(batch)
        c = self.settings.label_count
        conf = torch.zeros((c, c), dtype=torch.int64, device=self.device)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(steps):
            fids, labels, silence = ds.eval_ids(
                mode, i * batch + rows.start, rows.stop - rows.start)
            cb, lb = self._eval_step(state, fids, labels, silence)
            conf += cb
            loss_sum += lb
        if w > 1:
            all_reduce_(conf, self.mesh)
            all_reduce_(loss_sum, self.mesh)
        return conf.cpu().numpy(), float(loss_sum) / (steps * batch)

    def fit(self, state: TrainState, epochs: int,
            steps_per_epoch: Optional[int] = None,
            callbacks: Iterable[Any] = (),
            pseudo_schedule: Optional[Callable[[int], float]] = None,
            log_every: int = 0,
            bn_recalibration_batches: int = 0,
            steps_per_dispatch: int = 1,
            ) -> Tuple[TrainState, Dict[str, list]]:
        """Epoch loop with a validation sweep after each epoch
        (loop.py:667-745).

        ``steps_per_epoch`` defaults to the training set over the batch
        (at least 1). ``callbacks`` get ``on_epoch_end(epoch, state,
        logs)``; one that returns a ``TrainState`` replaces the state.
        ``pseudo_schedule`` maps the epoch to the pseudo frequency (see
        ``reference_pseudo_schedule``). ``log_every`` > 0 prints the
        metrics every that many steps. ``bn_recalibration_batches`` > 0
        re-estimates the BatchNorm statistics before each sweep
        (``recalibrate_batch_stats``, on a generator of its own per
        epoch). ``steps_per_dispatch`` is the JAX trainer's steps per XLA
        dispatch: here it runs that many steps per ``train_many`` call,
        the same updates; on one card each step is one replay of its
        CUDA graph, and a new learning rate (``ReduceLROnPlateau``) or
        pseudo frequency makes ``train_step`` capture it again.

        Returns the state and the history: per epoch ``loss`` and
        ``categorical_accuracy`` (of the epoch's last step),
        ``epoch_time_s`` and ``clips_per_sec`` (the training steps alone,
        up to the read of the last step's metrics, which waits for the
        device), ``val_loss``, ``val_categorical_accuracy`` and
        ``confusion``.
        """
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self._require_training()
        if steps_per_epoch is None:
            steps_per_epoch = max(
                1, self.dataset.set_size("training") // self.batch_size)
        history: Dict[str, list] = {}
        for epoch in range(epochs):
            t0 = time.perf_counter()
            pf = (pseudo_schedule(epoch) if pseudo_schedule
                  else self.augment.pseudo_frequency)
            step = 0
            while step < steps_per_epoch:
                chunk = min(steps_per_dispatch, steps_per_epoch - step)
                ms = self.train_many(state, chunk, pf)
                running = {k: v[-1] for k, v in ms.items()}
                step += chunk
                if log_every and (step % log_every < chunk):
                    m = {k: float(v) for k, v in running.items()}
                    print(f"  step {step}/{steps_per_epoch}: {m}")
            logs: Dict[str, Any] = {k: float(v) for k, v in running.items()}
            train_time = time.perf_counter() - t0
            logs["epoch_time_s"] = train_time
            logs["clips_per_sec"] = (steps_per_epoch * self.batch_size
                                     / train_time)
            if bn_recalibration_batches > 0:
                state = self.recalibrate_batch_stats(
                    state, bn_recalibration_batches,
                    self._generator(100_000 + epoch), pf)
            conf, val_loss = self.evaluate(state)
            logs["val_loss"] = val_loss
            logs["val_categorical_accuracy"] = M.accuracy(conf)
            logs["confusion"] = conf
            for cb in callbacks:
                result = cb.on_epoch_end(epoch, state, logs)
                if isinstance(result, TrainState):
                    state = result
            for k, v in logs.items():
                history.setdefault(k, []).append(v)
        return state, history


def reference_pseudo_schedule(epoch: int) -> float:
    """The pseudo-ratio schedule sketched in the reference (utils.py:41-49):
    heavy pseudo mixing early, tapering as the model matures."""
    if epoch <= 20:
        return 1.0
    if epoch <= 30:
        return 0.7
    if epoch <= 40:
        return 0.4
    return 0.2
