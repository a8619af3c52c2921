"""Model zoo and registry (port of speech_recognition_tpu/models/zoo.py).

Ported: the flagship, ``conv_1d_time_sliced_with_attention``, and
``conv_1d_spec``, the accuracy signal's model; every other zoo name
raises ``NotImplementedError`` (ROADMAP A8). Models emit logits, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.framing import overlapping_frames


class Conv1DTimeSlicedWithAttention(nn.Module):
    """The train.py flagship (zoo.py Conv1DTimeSlicedWithAttention):
    128-wide framed depthwise ladder, learned softmax attention over the
    9 remaining frames, max+avg-pool fusion. Input [B, 16000] raw clips.
    """

    def __init__(self, num_classes: int):
        super().__init__()
        self.stem = L.ConvBN(40, 128, 3, stride=2, padding="valid")
        blocks = [L.DepthwiseConvBlock(128, 128, 3, padding="valid")]
        c = 128
        for w in (192, 256, 320, 384, 512):
            blocks.append(L.DepthwiseConvBlock(c, w, 3, padding="same",
                                               stride=2))
            blocks.append(L.DepthwiseConvBlock(w, w, 3, padding="valid"))
            c = w
        self.blocks = nn.ModuleList(blocks)
        self.frames = 9  # time steps left by the ladder at T = 16000
        self.attention_dropout = L.Dropout(0.4)
        self.attention = L.Dense(self.frames * c, self.frames)
        self.head_dropout = L.Dropout(0.4)
        self.head = L.Dense(2 * c, num_classes, use_bias=False)

    def attention_weights(self, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          ) -> torch.Tensor:
        """Softmax attention over time for NCW ``x`` [B, C, 9] -> [B, 1, 9].

        The Dense(9) kernel was laid out by flax for a time-major,
        channel-minor flatten of NWC [B, 9, C]; the transpose restores
        that order before the reshape.
        """
        flat = x.transpose(1, 2).reshape(x.shape[0], -1)
        att = self.attention(self.attention_dropout(flat, generator))
        return torch.softmax(att, dim=-1)[:, None, :]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = overlapping_frames(x, 40, 20, "SAME").transpose(1, 2)  # NCW
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        attended = x * self.attention_weights(x, generator)
        x = torch.cat([L.global_max_pool(attended), L.global_avg_pool(x)],
                      dim=-1)
        return self.head(self.head_dropout(x, generator))


class Conv1DSpec(nn.Module):
    """Grouped conv ladder on the linear spectrogram (zoo.py Conv1DSpec,
    reference model.py:1249-1323).

    Input: flat [B, time_size * frequency_size] spectrogram, frames-major
    (``Frontend.features(wav, 'spec')``). The 257 bins are sliced to 252
    for the 4-way grouping, as the reference does (model.py:1306); they
    are the channels of the time convolutions. Four pairs of VALID
    ``ConvBN``, widths 300/360/420/480, k 3, stride 2 with groups 4 then
    stride 1 with groups 3 (98 frames go 48, 46, 22, 20, 9, 7, 3, 1),
    then Dropout 0.3 and a Dense head with bias.
    """

    def __init__(self, num_classes: int, time_size: int = 98,
                 frequency_size: int = 257):
        super().__init__()
        self.time_size = time_size
        self.frequency_size = frequency_size
        c = 252 if frequency_size == 257 else frequency_size
        t = time_size
        blocks = []
        for w in (300, 360, 420, 480):
            for groups, stride in ((4, 2), (3, 1)):
                blocks.append(L.ConvBN(c // groups * groups, w, 3, stride,
                                       "valid", groups))
                c, t = w, (t - 3) // stride + 1
        self.blocks = nn.ModuleList(blocks)
        self.dropout = L.Dropout(0.3)
        self.head = L.Dense(c * t, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = x.shape[0]
        x = x.reshape(b, self.time_size, self.frequency_size)
        if self.frequency_size == 257:
            x = x[..., :252]
        x = x.transpose(1, 2)                       # NCW: bins are channels
        for block in self.blocks:
            x = block(L.truncate_to_groups(x, block.conv.groups))
        # flax flattens NWC [B, t, C] time-major, channel-minor
        x = x.transpose(1, 2).reshape(b, -1)
        return self.head(self.dropout(x, generator))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything the trainer needs for one zoo entry: the module factory,
    its input representation, and the reference's compile recipe."""

    name: str
    build: Callable[..., nn.Module]
    representation: str            # raw | spec | mfcc | mfcc_and_raw
    optimizer: str                 # sgd | adam | rmsprop
    learning_rate: float
    momentum: float = 0.0
    label_smoothing: float = 0.0
    l2_reg: float = 1e-5           # kernel regularizer strength


MODEL_REGISTRY: Dict[str, ModelSpec] = {s.name: s for s in [
    ModelSpec("conv_1d_time_sliced_with_attention",
              Conv1DTimeSlicedWithAttention, "raw", "rmsprop", 1e-3,
              label_smoothing=0.1),
    ModelSpec("conv_1d_spec", Conv1DSpec, "spec", "rmsprop", 2e-3),
]}


def get_spec(model_type: str) -> ModelSpec:
    spec = MODEL_REGISTRY.get(model_type)
    if spec is None:
        raise NotImplementedError(
            f"model {model_type!r} is not ported to PyTorch yet "
            f"(ROADMAP A8); ported: {sorted(MODEL_REGISTRY)}")
    return spec


def build_model(model_type: str, num_classes: int = 11,
                generator: Optional[torch.Generator] = None,
                **settings: Any) -> Tuple[nn.Module, ModelSpec]:
    """Instantiate a zoo model with initialised parameters on the CPU.

    ``generator`` seeds the glorot-uniform init (default: seed 0), so one
    seed gives the same weights whatever device the caller moves the
    model to. ``settings`` carries the feature geometry that the JAX
    ``build_model`` threads through (``spectrogram_length``,
    ``spectrogram_frequencies``; zoo.py:777-811); models that need none
    ignore it.
    """
    spec = get_spec(model_type)
    kwargs: Dict[str, Any] = {"num_classes": num_classes}
    if model_type == "conv_1d_spec":
        kwargs.update(time_size=settings.get("spectrogram_length") or 98,
                      frequency_size=settings.get(
                          "spectrogram_frequencies", 257))
    module = spec.build(**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    L.init_parameters(module, generator)
    return module, spec
