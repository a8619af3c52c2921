"""Training loop (port of speech_recognition_tpu/train/loop.py).

One train step: draw the batch (sample ids and augmentation parameters)
from the trainer's ``torch.Generator``, build it (fused decode+augment
kernel -> features), then forward, backward and the Keras RMSprop update.
Everything stays on the dataset's device, and nothing in a step waits
for the device: losses come back as device tensors.

Ported: ``init_state``, the two halves of ``_sample_batch``
(``draw_batch``/``build_batch``, so tests can inject draws),
``_update_step``, ``train_step``, ``train_many`` (a plain loop),
``_eval_step`` and ``evaluate``. BN re-estimation, ``fit``, checkpoints
and streaming come with ROADMAP A5/A10/A12.

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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from speech_recognition_tpu_torch.config import AugmentConfig, ModelSettings
from speech_recognition_tpu_torch.data.device_bank import DeviceDataset
from speech_recognition_tpu_torch.models.layers import (
    at_least_float32, use_mesh,
)
from speech_recognition_tpu_torch.models.zoo import build_model, get_spec
from speech_recognition_tpu_torch.ops.augment import (
    augment_batch, draw_augment_params,
)
from speech_recognition_tpu_torch.ops.frontend import features
from speech_recognition_tpu_torch.ops.kernels.decode_augment import (
    decode_augment,
)
from speech_recognition_tpu_torch.ops.kernels.sharded import (
    decode_augment_sharded,
)
from speech_recognition_tpu_torch.parallel.collectives import (
    all_reduce_, average_gradients,
)
from speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, replicated, shard_batch,
)
from speech_recognition_tpu_torch.train import metrics as M
from speech_recognition_tpu_torch.train.optim import (
    build_optimizer, l2_kernel_penalty, smooth_cross_entropy,
)


@dataclasses.dataclass
class TrainState:
    """The model (f32 master weights + BN running statistics), its
    optimizer and the step count; train steps update it in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


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
    ``seed`` seeds the weight init and the trainer's generator, which
    draws batches, augmentation and dropout masks. ``batch_size`` is the
    global batch; with a ``mesh`` of W ranks (the dataset on this rank's
    device, the same seed on every rank) each rank computes B/W rows of
    it, and ``B % W != 0`` raises.
    """

    model_name: str
    settings: ModelSettings
    dataset: DeviceDataset
    augment: AugmentConfig = AugmentConfig()
    batch_size: int = 384
    seed: int = 0
    compute_dtype: str = "auto"
    mesh: Optional[Mesh] = None

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
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed + 1)
        bg = self.dataset.background
        t = self.settings.desired_samples
        self._bg_flat = (bg.flat if bg is not None else
                         torch.zeros(t, dtype=torch.float32,
                                     device=self.device))

    # -- setup ------------------------------------------------------------

    def init_state(self) -> TrainState:
        model, _ = build_model(
            self.model_name, num_classes=self.settings.label_count,
            generator=torch.Generator().manual_seed(self.seed))
        model.to(self.device)
        if self.mesh.size > 1:
            use_mesh(model, self.mesh)
            replicated(model, self.mesh)
        optimizer = build_optimizer(self.spec.optimizer, model.parameters(),
                                    self.spec.learning_rate)
        return TrainState(model=model, optimizer=optimizer)

    def _autocast(self):
        return torch.autocast(device_type=self.device.type,
                              dtype=torch.bfloat16,
                              enabled=self.compute_dtype == "bfloat16")

    # -- steps ------------------------------------------------------------

    def draw_batch(self) -> Draws:
        """Sample ids and augmentation parameters for one training batch."""
        ds = self.dataset
        fids, labels, silence = ds.sample_train_ids(
            self.generator, self.batch_size, self.augment.pseudo_frequency)
        shifts, fg_vol, bg_pos, bg_vol = draw_augment_params(
            self.generator, silence, self.augment, ds.background,
            self.batch_size, ds.desired_samples)
        return Draws(fids, labels, silence, shifts, fg_vol, bg_pos, bg_vol)

    def build_batch(self, d: Draws) -> torch.Tensor:
        """Decode + augment (one kernel launch) + featurize this rank's
        rows of the (global) draws."""
        args = (self.dataset.wav_bank, self._bg_flat, d.file_ids, d.shifts,
                d.fg_vol, d.bg_pos, d.bg_vol)
        if self.mesh.size > 1:
            wav = decode_augment_sharded(self.mesh, *args)
        else:
            wav = decode_augment(*args)
        return features(wav, self.spec.representation)

    def _update_step(self, state: TrainState, x: torch.Tensor,
                     labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Forward/backward/optimizer update on featurized inputs (this
        rank's rows, and their labels). After it, each parameter's
        ``.grad`` holds this step's gradient (of the global batch), and
        the metrics are means over the global batch."""
        model = state.model
        model.train()
        with self._autocast():
            logits = at_least_float32(model(x, self.generator))
        loss = smooth_cross_entropy(logits, labels, self.spec.label_smoothing)
        loss = loss + l2_kernel_penalty(model, self.spec.l2_reg)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh.size > 1:
            average_gradients(model.parameters(), self.mesh)
        state.optimizer.step()
        state.step += 1
        acc = (logits.argmax(-1) == labels).float().mean()
        if self.mesh.size > 1:
            both = all_reduce_(torch.stack([loss.detach(), acc.to(loss.dtype)]),
                               self.mesh) / self.mesh.size
            return {"loss": both[0], "categorical_accuracy": both[1]}
        return {"loss": loss.detach(), "categorical_accuracy": acc}

    def train_step(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """One training step; updates ``state`` in place."""
        d = self.draw_batch()
        return self._update_step(state, self.build_batch(d),
                                 shard_batch(d.labels, self.mesh))

    def train_many(self, state: TrainState,
                   steps: int) -> Dict[str, torch.Tensor]:
        """``steps`` train steps; each metric stacked to shape [steps]."""
        out = [self.train_step(state) for _ in range(steps)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

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
                model(features(wav, self.spec.representation)))
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
