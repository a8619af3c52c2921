"""Batched test-time-augmentation inference (port of
speech_recognition_tpu/infer/tta.py).

Parity with make_submission.py:118-155: probabilities are the mean of the
identity, roll(-1500) and 1.2x-volume variants (1/3 each); the optional
speed-TTA path adds three variants of a 0.9x time-stretched clip (the
clip, ``clip(1.1 x, -1, 1)`` and 0.9 x) and divides the 6-term sum by 10
(make_submission.py:131-140: the reference's deliberate down-weighting,
kept as it is).

The variants are folded into the batch, so the model runs once on
[num_variants * B, ...] rather than once per variant. TTA transforms
apply to the waveform and features are recomputed per variant, for every
representation, as in the JAX package.

Over a ``mesh`` of W ranks (the JAX Predictor's mesh, one process per
rank here) each rank predicts its own B/W rows of every batch, variants
folded, and the probabilities of all B rows are gathered in rank order
on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from speech_recognition_tpu_torch.config import ModelSettings
from speech_recognition_tpu_torch.data.wav import INT16_DECODE_SCALE
from speech_recognition_tpu_torch.device import require_cuda
from speech_recognition_tpu_torch.ops.frontend import Frontend
from speech_recognition_tpu_torch.parallel.collectives import all_gather_rows
from speech_recognition_tpu_torch.parallel.mesh import Mesh

Waveforms = Union[torch.Tensor, np.ndarray]


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for cuDNN and for matmuls inside (PyTorch's default lets
    cuDNN's convolutions take TF32); the previous flags come back on
    exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


@dataclasses.dataclass(frozen=True)
class TTAConfig:
    use_tta: bool = True
    roll: int = -1500            # make_submission.py:126
    loud: float = 1.2            # make_submission.py:128
    use_speed_tta: bool = False
    slow_loud: float = 1.1       # make_submission.py:135 (clipped)
    slow_silent: float = 0.9     # make_submission.py:136
    speed_denominator: float = 10.0  # make_submission.py:137-140


class Predictor:
    """Softmax predictor for a trained zoo model, on ``device`` (default:
    the card; ``require_cuda`` raises without one).

    The model runs in eval mode, in float32 without autocast and with
    TF32 off for cuDNN's convolutions and for matmuls, with the frontend
    at 'highest': the JAX Predictor's f32 variables. Waveforms
    come as float [B, T] in [-1, 1] or as packed int16 PCM, which is
    decoded on the device (x / 32768), so the host ships half the bytes.

    ``mesh``: a ``Mesh`` of W ranks (one process each, the model's
    weights the same on every rank): ``predict`` then takes this rank's
    rows of a batch and returns the probabilities of the whole batch, the
    ranks' rows gathered in rank order (``all_gather_rows``, exact).
    """

    def __init__(self, model: nn.Module, settings: ModelSettings,
                 representation: str, tta: TTAConfig = TTAConfig(),
                 device: Optional[torch.device] = None,
                 mesh: Optional[Mesh] = None):
        self.device = require_cuda() if device is None else torch.device(
            device)
        self.mesh = mesh or Mesh(device=self.device)
        self.model = model.to(self.device).eval()
        self.settings = settings
        self.representation = representation
        self.tta = tta
        self.frontend = Frontend(settings, "highest")

    def _decode(self, wav: Waveforms) -> torch.Tensor:
        wav = torch.as_tensor(wav).to(self.device, non_blocking=True)
        if wav.dtype == torch.int16:
            return wav.float() / INT16_DECODE_SCALE
        return wav.float()

    def _apply(self, wav: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        with torch.no_grad(), torch.autocast(self.device.type,
                                             enabled=False), _no_tf32():
            logits = self.model(self.frontend.features(wav,
                                                       self.representation))
            return torch.softmax(logits, dim=-1)

    def _probs_tta(self, wav: torch.Tensor,
                   slow_wav: Optional[torch.Tensor]) -> torch.Tensor:
        t = self.tta
        variants = [wav, torch.roll(wav, t.roll, dims=1), t.loud * wav]
        speed = t.use_speed_tta and slow_wav is not None
        if speed:
            variants += [slow_wav,
                         torch.clamp(t.slow_loud * slow_wav, -1.0, 1.0),
                         t.slow_silent * slow_wav]
        probs = self._apply(torch.cat(variants, dim=0))
        probs = probs.reshape(len(variants), wav.shape[0], -1)
        if speed:
            return probs.sum(dim=0) / t.speed_denominator
        return probs.mean(dim=0)

    def predict(self, wav: Waveforms,
                slow_wav: Optional[Waveforms] = None) -> torch.Tensor:
        """Averaged class probabilities [B, num_classes] on the device;
        ``slow_wav`` (the 0.9x clips) is used only with speed TTA on.
        Over W ranks ``wav`` (and ``slow_wav``) are this rank's B/W rows
        and the result is all B rows' probabilities."""
        wav = self._decode(wav)
        if not self.tta.use_tta:
            return all_gather_rows(self._apply(wav), self.mesh)
        if slow_wav is not None:
            slow_wav = self._decode(slow_wav)
        return all_gather_rows(self._probs_tta(wav, slow_wav), self.mesh)


def model_from_state(state) -> nn.Module:
    """The model of a ``TrainState``, in eval mode (the counterpart of the
    JAX ``variables_from_state``: the port's variables are the module's
    parameters and BatchNorm running statistics)."""
    return state.model.eval()
