"""Model zoo and registry (port of speech_recognition_tpu/models/zoo.py).

All 25 models of the JAX registry, with its recipes: the flagship,
``conv_1d_time_sliced_with_attention``; ``conv_1d_spec``, the accuracy
signal's model; the 1-D ladders, the grouped models and the Inceptions
on raw clips; the residual family (``conv_1d_residual``, ``steffeNet``,
``conv_1d_log_mfcc``, ``conv_1d_spectrogram``,
``conv_1d_mfcc_and_raw``); the MFCC MLPs (``simple``, ``snn``) and 2-D
convs (``conv_2d``, ``conv_2d_mobile``, ``conv_2d_fast``); and the
Keras-v1 BiGRU models (``conv_1d_simple``, ``xception_with_attention``).
Models emit logits, as in the JAX package.

Inputs are the JAX models': flat [B, 16000] clips, flat frames-major
features [B, frames * bins], or the tuple (mfcc_flat, raw). The JAX
models are channels-last and the port's NCW (NCHW for the 2-D models),
so a reshape to [B, T, C] becomes the same reshape and a transpose, and
every flatten before a Dense moves the channels last first (flax
flattens channel-minor). Every model but the flagship and
``conv_1d_spec`` registers its layers under flax's auto-names
(``layers.FlaxNamed``), in the order its flax ``__call__`` creates them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.framing import overlapping_frames


def _out_len(t: int, kernel: int, stride: int = 1,
             padding: str = "valid") -> int:
    """Length of a conv or pool's output over ``t`` samples."""
    if padding == "same":
        return -(-t // stride)
    return (t - kernel) // stride + 1


def _nwc_flat(x: torch.Tensor) -> torch.Tensor:
    """NCW [B, C, T] -> [B, T * C], flax's time-major flatten of NWC; and
    NCHW [B, C, H, W] -> [B, H * W * C], its flatten of NHWC."""
    return x.movedim(1, -1).reshape(x.shape[0], -1)


def _stacked(x: torch.Tensor, time: int, channels: int) -> torch.Tensor:
    """Flat clips [B, time * channels] -> NCW [B, channels, time], the
    JAX models' ``x.reshape(b, time, channels)``."""
    return x.reshape(x.shape[0], time, channels).transpose(1, 2)


def _frames(x: torch.Tensor, length: int, step: int,
            padding: str) -> torch.Tensor:
    """Clips [B, T] -> NCW frames [B, length, frames]."""
    return overlapping_frames(x, length, step, padding).transpose(1, 2)


def _run(layers, x: torch.Tensor,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply ``layers`` in turn; each random one (``L.RANDOM_LAYERS``:
    dropout, the GRUs) draws its masks from ``generator``."""
    for layer in layers:
        x = (layer(x, generator) if isinstance(layer, L.RANDOM_LAYERS)
             else layer(x))
    return x


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
        att = self.attention(self.attention_dropout(_nwc_flat(x), generator))
        return torch.softmax(att, dim=-1)[:, None, :]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(_frames(x, 40, 20, "SAME"))
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
        return self.head(self.dropout(_nwc_flat(x), generator))


class Conv1DTimeSliced(L.FlaxNamed):
    """Framed depthwise reduce ladder + GAP head (zoo.py Conv1DTimeSliced,
    model.py:716-772): frames of 40 at hop 20, ConvBN k3 s2, 13
    depthwise blocks, global average pooling, two Dense layers."""

    def __init__(self, num_classes: int, filter_mult: int = 1):
        super().__init__()
        fm = filter_mult
        c = 64 * fm
        self.trunk = [self.add(L.ConvBN(40, 32 * fm, 3, 2, "valid")),
                      self.add(L.DepthwiseConvBlock(32 * fm, c, 3, "valid"))]
        for w in (128, 192, 256, 320, 384, 512):
            self.trunk += [
                self.add(L.DepthwiseConvBlock(c, w * fm, 3, "same", 2)),
                self.add(L.DepthwiseConvBlock(w * fm, w * fm, 3, "valid"))]
            c = w * fm
        self.head = [self.add(L.Dropout(0.4)),
                     self.add(L.Dense(c, 256 * fm, use_bias=False)), L.relu6,
                     self.add(L.Dropout(0.3)),
                     self.add(L.Dense(256 * fm, num_classes, use_bias=False))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _frames(x, 40, 20, "SAME"))
        return _run(self.head, L.global_avg_pool(x), generator)


class _StackedLadder(L.FlaxNamed):
    """ConvBN + max-pool ladder of ``conv_1d_time_stacked`` and
    ``conv_1d_heavy`` (zoo.py _StackedLadder, model.py:257-309,409-467):
    the clip stacked to [time, channels], ConvBN k1, then per width a
    VALID ConvBN k3, a VALID max pool 3/2 and a ConvBN k3; Dropout, then
    a VALID conv head that leaves one time step (with bias), or the heavy
    head: ConvBN, Dropout and a bias-free 1x1 conv."""

    def __init__(self, num_classes: int, stack_shape: Tuple[int, int],
                 widths: List[int], heavy_head: bool = False,
                 head_kernel: int = 5, dropout: float = 0.3):
        super().__init__()
        self.stack_shape = stack_shape
        c = 32
        self.stem = [self.add(L.ConvBN(stack_shape[1], c, 1,
                                       padding="valid"))]
        self.ladder = []
        for w in widths:
            self.ladder.append((
                self.add(L.ConvBN(c, w, 3, padding="valid")),
                self.add(L.ConvBN(w, w, 3, padding="valid"))))
            c = w
        self.head = [self.add(L.Dropout(dropout))]
        if heavy_head:
            self.head += [self.add(L.ConvBN(c, 128, head_kernel,
                                            padding="valid")),
                          self.add(L.Dropout(0.1)),
                          self.add(L.Conv(128, num_classes, 1))]
        else:
            self.head.append(self.add(L.Conv(c, num_classes, head_kernel,
                                             use_bias=True)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.stem, _stacked(x, *self.stack_shape))
        for reduce, context in self.ladder:
            x = context(L.max_pool_1d(reduce(x), 3, 2, "valid"))
        return _nwc_flat(_run(self.head, x, generator))


def conv_1d_time_stacked(num_classes: int) -> _StackedLadder:
    return _StackedLadder(num_classes, (800, 20),
                          [48, 96, 128, 160, 192, 256])


def conv_1d_heavy(num_classes: int) -> _StackedLadder:
    return _StackedLadder(num_classes, (1600, 10),
                          [48, 96, 128, 160, 192, 256, 320], heavy_head=True)


class Conv1DGru(L.FlaxNamed):
    """Strided depthwise stem -> dense head (zoo.py Conv1DGru,
    model.py:470-512; no GRU in it): five SAME depthwise blocks at
    strides 16/4/4/4/2, a VALID k8 block down to one step, then
    Dropout, Dense 256 + relu6, Dropout, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        c, self.trunk = 1, []
        for f, k, s in [(128, 63, 16), (256, 31, 4), (384, 15, 4),
                        (448, 7, 4), (512, 5, 2)]:
            self.trunk.append(self.add(L.DepthwiseConvBlock(c, f, k, "same",
                                                            s)))
            c = f
        self.trunk.append(self.add(L.DepthwiseConvBlock(c, 512, 8, "valid")))
        t = 16000
        for s in (16, 4, 4, 4, 2):
            t = _out_len(t, 0, s, "same")
        t = _out_len(t, 8)
        self.head = [self.add(L.Dropout(0.3)),
                     self.add(L.Dense(512 * t, 256)), L.relu6,
                     self.add(L.Dropout(0.3)),
                     self.add(L.Dense(256, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, x[:, None, :])
        return _run(self.head, _nwc_flat(x), generator)


class Conv1DFast(L.FlaxNamed):
    """Learned-filterbank stem + grouped convs (zoo.py Conv1DFast,
    model.py:642-713): a bias-free conv of 252 filters of 479 samples at
    hop 160, ConvBN groups 6 and 5 (VALID, stride 2), Dropout, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.trunk = [self.add(L.Conv(1, 252, 479, 160)),
                      self.add(L.ConvBN(252, 300, 15, 2, "valid", 6)),
                      self.add(L.ConvBN(300, 360, 7, 2, "valid", 5))]
        t = _out_len(_out_len(_out_len(16000, 479, 160), 15, 2), 7, 2)
        self.head = [self.add(L.Dropout(0.3)),
                     self.add(L.Dense(360 * t, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, x[:, None, :])
        return _run(self.head, _nwc_flat(x), generator)


class Conv1DLearnedSpec(L.FlaxNamed):
    """Six learned filterbanks -> grouped conv ladder (zoo.py
    Conv1DLearnedSpec, model.py:1159-1246): SAME bias-free convs of 40
    filters of 479/383/319/255/191/161 samples at hop 160, concatenated
    to [B, 240, 100]; per width a VALID ConvBN s2 in 3 groups and one in
    2, each on the channels truncated to a multiple of its groups;
    Dropout, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.banks = [self.add(L.Conv(1, 40, k, 160, "same"))
                      for k in (479, 383, 319, 255, 191, 161)]
        c, t, self.ladder = 240, _out_len(16000, 0, 160, "same"), []
        for w in (300, 360, 420, 480):
            for groups, stride in ((3, 2), (2, 1)):
                self.ladder.append(self.add(L.ConvBN(
                    c // groups * groups, w, 3, stride, "valid", groups)))
                c, t = w, _out_len(t, 3, stride)
        self.head = [self.add(L.Dropout(0.3)),
                     self.add(L.Dense(c * t, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x[:, None, :]
        x = torch.cat([bank(x) for bank in self.banks], dim=1)
        for layer in self.ladder:
            x = layer(L.truncate_to_groups(x, layer.conv.groups))
        return _run(self.head, _nwc_flat(x), generator)


class Conv1DMultiTimeSliced(L.FlaxNamed):
    """Three polyphase stackings of the clip (4000x4, 3200x5, 640x25),
    each a ladder of VALID depthwise blocks and SAME max pools 3/2 with
    taps of one step each (zoo.py Conv1DMultiTimeSliced,
    model.py:1080-1156), concatenated over channels; Dropout, a 1x1
    depthwise block, Dropout, a 1x1 conv head with bias."""

    def __init__(self, num_classes: int):
        super().__init__()

        def block(c, f, k):
            return self.add(L.DepthwiseConvBlock(c, f, k, "valid"))

        def reduces(c, widths):
            out = []
            for f in widths:
                out.append(block(c, f, 3))
                c = f
            return out, c

        self.branches = []
        for stack, tap_a, tap_b in (((4000, 4), 28, 11), ((3200, 5), 22, 8)):
            pre, c = reduces(stack[1], (16, 32, 48, 64, 96, 128, 160))
            ctx = block(c, 160, 3)
            tap0 = block(160, 64, tap_a)
            red, ctx2 = block(160, 192, 3), block(192, 192, 3)
            tap1 = block(192, 64, tap_b)
            self.branches.append((stack, pre, ctx, tap0, red, ctx2, tap1))
        self.pre25, c = reduces(25, (32, 48, 64, 96, 128))
        self.ctx25 = [block(c, 128, 3), block(128, 64, 17)]
        self.head = [self.add(L.Dropout(0.1)), block(320, 128, 1),
                     self.add(L.Dropout(0.1)),
                     self.add(L.Conv(128, num_classes, 1, use_bias=True))]

    @staticmethod
    def _reduce(x, blocks):
        for b in blocks:
            x = L.max_pool_1d(b(x), 3, 2, "same")
        return x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        taps = []
        for stack, pre, ctx, tap0, red, ctx2, tap1 in self.branches:
            h = ctx(self._reduce(_stacked(x, *stack), pre))
            taps.append(tap0(h))
            taps.append(tap1(ctx2(self._reduce(h, [red]))))
        h = _run(self.ctx25, self._reduce(_stacked(x, 640, 25), self.pre25))
        return _nwc_flat(_run(self.head, torch.cat(taps + [h], dim=1),
                              generator))


class Conv1DTimeSlicedGroup(L.FlaxNamed):
    """Two stackings of the clip (500x32 and 400x40), each a ladder of
    grouped depthwise blocks (VALID; stride 2 in 4 groups, then stride 1
    in 2; the 500 branch one block more), the 400 branch zero-padded by
    one step on the left, concatenated over channels (zoo.py
    Conv1DTimeSlicedGroup, model.py:986-1077); Dropout, a VALID k8 conv
    with bias down to one step, Dropout, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.branches = []
        for stack, extra in (((500, 32), True), ((400, 40), False)):
            c, blocks = stack[1], []
            for w in (64, 128, 160, 192, 224):
                blocks.append(self.add(L.GroupedDepthwiseBlock(
                    c // 4 * 4, w, 3, 4, "valid", 2)))
                blocks.append(self.add(L.GroupedDepthwiseBlock(
                    w // 2 * 2, w, 3, 2, "valid")))
                c = w
            if extra:
                blocks.append(self.add(L.GroupedDepthwiseBlock(
                    c // 2 * 2, 224, 3, 2, "valid")))
            self.branches.append((stack, blocks))
        self.head = [self.add(L.Dropout(0.15)),
                     self.add(L.Conv(448, 128, 8, use_bias=True)), _nwc_flat,
                     self.add(L.Dropout(0.05)),
                     self.add(L.Dense(128, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        outs = []
        for stack, blocks in self.branches:
            h = _stacked(x, *stack)
            for b in blocks:
                h = b(L.truncate_to_groups(h, b.pointwise.groups))
            outs.append(h)
        outs[1] = F.pad(outs[1], (1, 0))        # ZeroPadding1D((1, 0))
        return _run(self.head, torch.cat(outs, dim=1), generator)


class Conv1DTopDown(L.FlaxNamed):
    """Wide stem, decreasing-width grouped depthwise ladder (zoo.py
    Conv1DTopDown, model.py:1326-1397): a conv of 480 filters of 479
    samples at hop 160 with bias, then per width a VALID grouped block
    at stride 2 in 3 groups and one in 2; Dropout, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.stem = [self.add(L.Conv(1, 480, 479, 160, use_bias=True))]
        c, t, self.ladder = 480, _out_len(16000, 479, 160), []
        for w in (420, 360, 300, 240):
            for groups, stride in ((3, 2), (2, 1)):
                self.ladder.append(self.add(L.GroupedDepthwiseBlock(
                    c // groups * groups, w, 3, groups, "valid", stride)))
                c, t = w, _out_len(t, 3, stride)
        self.head = [self.add(L.Dropout(0.05)),
                     self.add(L.Dense(c * t, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.stem, x[:, None, :])
        for b in self.ladder:
            x = b(L.truncate_to_groups(x, b.pointwise.groups))
        return _run(self.head, _nwc_flat(x), generator)


class _InceptionBase(L.FlaxNamed):
    """The branches shared by the two Inception models (zoo.py
    Conv1DInception and InceptionD1): an inception block of four
    branches (1x1; 1x1 -> k; 1x1 -> 3 -> 3; 3/1 SAME average pool -> 1x1)
    concatenated to 8 x base channels, and a reduction block of three
    (a strided k3; 1x1 -> 3 -> a strided k3; a max pool 3 at the
    stride) concatenated to 7.5 x base + C channels."""

    def _inception(self, c: int, base: int, b5_kernel: int,
                   b5_dilation: int, b3_dilation: int):
        conv = lambda *a, **k: self.add(L.ConvBN(*a, **k))  # noqa: E731
        b1 = [conv(c, 2 * base, 1)]
        b5 = [conv(c, int(1.5 * base), 1),
              conv(int(1.5 * base), 2 * base, b5_kernel,
                   dilation=b5_dilation)]
        b3 = [conv(c, 2 * base, 1),
              conv(2 * base, 3 * base, 3, dilation=b3_dilation),
              conv(3 * base, 3 * base, 3, dilation=b3_dilation)]
        bp = [conv(c, base, 1)]
        return ("inception", b1, b5, b3, bp), 8 * base

    @staticmethod
    def _block(x: torch.Tensor, block) -> torch.Tensor:
        kind, *branches = block
        if kind == "inception":
            b1, b5, b3, bp = branches
            return torch.cat([_run(b1, x), _run(b5, x), _run(b3, x),
                              _run(bp, L.avg_pool_1d(x, 3, 1, "same"))],
                             dim=1)
        b3, bd, pool = branches
        return torch.cat([_run(b3, x), _run(bd, x), pool(x)], dim=1)


class Conv1DInception(_InceptionBase):
    """1-D Inception trunk on raw audio (zoo.py Conv1DInception,
    model.py:159-254): a VALID stem of six strided ConvBN pairs down to
    120 steps, eight inception and three reduction blocks (strided VALID
    convs and pools), Dropout, a VALID k14 conv head with bias."""

    def __init__(self, num_classes: int):
        super().__init__()
        c, self.stem = 1, []
        for f, k, s in [(32, 5, 4), (64, 3, 2), (128, 3, 2), (256, 3, 2),
                        (384, 3, 2), (512, 3, 2)]:
            self.stem += [self.add(L.ConvBN(c, f, k, s, "valid")),
                          self.add(L.ConvBN(f, f, 3, padding="valid"))]
            c = f
        self.blocks = []
        for kind, base in [("i", 32), ("i", 16), ("r", 32), ("i", 32),
                           ("i", 32), ("r", 64), ("i", 64), ("i", 64),
                           ("r", 96), ("i", 96), ("i", 96)]:
            if kind == "i":
                block, c = self._inception(c, base, 5, 1, 1)
            else:
                block, c = self._reduce_inception(c, base), \
                    c + int(7.5 * base)
            self.blocks.append(block)
        self.head = [self.add(L.Dropout(0.15)),
                     self.add(L.Conv(c, num_classes, 14, use_bias=True))]

    def _reduce_inception(self, c: int, base: int):
        conv = lambda *a, **k: self.add(L.ConvBN(*a, **k))  # noqa: E731
        b3 = [conv(c, 6 * base, 3, 2, "valid")]
        bd = [conv(c, base, 1), conv(base, int(1.5 * base), 3),
              conv(int(1.5 * base), int(1.5 * base), 3, 2, "valid")]
        return ("reduce", b3, bd,
                functools.partial(L.max_pool_1d, pool=3, stride=2))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.stem, x[:, None, :])
        for block in self.blocks:
            x = self._block(x, block)
        return _nwc_flat(_run(self.head, x, generator))


class InceptionD1(_InceptionBase):
    """Dilated Inception on the clip stacked to [800, 20] (zoo.py
    InceptionD1, model.py:312-406): ConvBN k1, three VALID ConvBN + max
    pool 3/2 + ConvBN steps, eleven inception blocks (dilation 2 on the
    k3 of the second branch, and on the third in the first three) and
    four SAME reduction blocks, Dropout, a VALID k6 conv head with
    bias."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.stem = [self.add(L.ConvBN(20, 32, 1))]
        c, self.ladder = 32, []
        for f in (64, 128, 256):
            self.ladder.append((self.add(L.ConvBN(c, f, 3, padding="valid")),
                                self.add(L.ConvBN(f, f, 3, padding="valid"))))
            c = f
        self.blocks = []
        for kind, dilation in [("i", 2), ("i", 2), ("r", 0), ("i", 2),
                               ("i", 1), ("r", 0), ("i", 1), ("i", 1),
                               ("r", 0), ("i", 1), ("i", 1), ("r", 0)]:
            if kind == "i":
                block, c = self._inception(c, 32, 3, 2, dilation)
            else:
                block, c = self._reduce_inception(c, 32), c + 240
            self.blocks.append(block)
        self.head = [self.add(L.Dropout(0.2)),
                     self.add(L.Conv(c, num_classes, 6, use_bias=True))]

    def _reduce_inception(self, c: int, base: int):
        conv = lambda *a, **k: self.add(L.ConvBN(*a, **k))  # noqa: E731
        pool = functools.partial(L.max_pool_1d, pool=3, stride=2,
                                 padding="same")
        b3 = [conv(c, 6 * base, 3), pool]
        bd = [conv(c, base, 1), conv(base, int(1.5 * base), 3),
              conv(int(1.5 * base), int(1.5 * base), 3), pool]
        return ("reduce", b3, bd, pool)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.stem, _stacked(x, 800, 20))
        for reduce, context in self.ladder:
            x = context(L.max_pool_1d(reduce(x), 3, 2, "valid"))
        for block in self.blocks:
            x = self._block(x, block)
        return _nwc_flat(_run(self.head, x, generator))


class Conv1DResidual(L.FlaxNamed):
    """Deep residual depthwise trunk (zoo.py Conv1DResidual,
    model.py:841-908): frames of 40 at hop 20, ConvBN k3 s2, twelve
    ``Residual1D`` blocks (pool 3 at the stride), a strided SAME and a
    VALID depthwise block of 1024 (created after the trunk, as in flax),
    global average pooling, Dropout, Dense."""

    def __init__(self, num_classes: int, filter_mult: int = 1):
        super().__init__()
        fm = filter_mult
        c = 64 * fm
        self.trunk = [self.add(L.ConvBN(40, c, 3, 2, "valid"))]
        for w, s in [(128, 2), (256, 2)] + [(256, 1)] * 8 + [
                (512, 2), (728, 2), (728, 2)]:
            self.trunk.append(self.add(L.Residual1D(c, w * fm, 3, s)))
            c = w * fm
        self.trunk += [
            self.add(L.DepthwiseConvBlock(c, 1024 * fm, 3, "same", 2)),
            self.add(L.DepthwiseConvBlock(1024 * fm, 1024 * fm, 3, "valid"))]
        self.head = [self.add(L.Dropout(0.5)),
                     self.add(L.Dense(1024 * fm, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _frames(x, 40, 20, "SAME"))
        return _run(self.head, L.global_avg_pool(x), generator)


def _time_attention(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` weighted by a softmax over time of a 1-channel depthwise
    block's output (model.py:971, 1440-1450)."""
    return x * torch.softmax(block(x), dim=2)


class XceptionWithAttention(L.FlaxNamed):
    """Residual trunk + softmax-over-time attention + BiGRU(192) (zoo.py
    XceptionWithAttention, model.py:911-983): frames of 40 at hop 20,
    ConvBN k3 s2, eleven ``Residual1D`` blocks down to 50 steps of 384
    channels, weighted by a softmax over time of a 1-channel
    ``DepthwiseConvBlock`` k5, a BiGRU of 192 units with variational
    dropout 0.2 (input and recurrent), Dense."""

    def __init__(self, num_classes: int, filter_mult: int = 1):
        super().__init__()
        fm = filter_mult
        c = 64 * fm
        self.trunk = [self.add(L.ConvBN(40, c, 3, 2, "valid"))]
        for w, s in [(128, 2), (256, 2)] + [(256, 1)] * 8 + [(384, 2)]:
            self.trunk.append(self.add(L.Residual1D(c, w * fm, 3, s)))
            c = w * fm
        self.attention = [self.add(L.DepthwiseConvBlock(c, 1, 5, "same"))]
        self.head = [self.add(L.BiGRU(c, 192, dropout=0.2,
                                      recurrent_dropout=0.2)),
                     self.add(L.Dense(2 * 192, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _frames(x, 40, 20, "SAME"))
        return _run(self.head, _time_attention(self.attention[0], x),
                    generator)


class Conv1DSimple(L.FlaxNamed):
    """Depthwise reduce/context stack -> BiGRU(128) (zoo.py Conv1DSimple,
    model.py:116-156): a VALID depthwise block k31 at stride 16 and one
    k3 on the raw clip, then per width 64..224 a VALID block at stride 2
    and one at stride 1 (10 steps left), a BiGRU of 128 units with
    variational dropout 0.2, Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.trunk = [self.add(L.DepthwiseConvBlock(1, 32, 31, "valid", 16)),
                      self.add(L.DepthwiseConvBlock(32, 32, 3, "valid"))]
        c = 32
        for w in (64, 96, 128, 160, 192, 224):
            self.trunk += [
                self.add(L.DepthwiseConvBlock(c, w, 3, "valid", 2)),
                self.add(L.DepthwiseConvBlock(w, w, 3, "valid"))]
            c = w
        self.head = [self.add(L.BiGRU(c, 128, dropout=0.2,
                                      recurrent_dropout=0.2)),
                     self.add(L.Dense(2 * 128, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _run(self.head, _run(self.trunk, x[:, None, :]), generator)


class SteffeNet(L.FlaxNamed):
    """Conv stem + strided residual pairs + max/avg fusion (zoo.py
    SteffeNet, model.py:1663-1726): a SAME ConvBN of 256 filters of 75
    samples at stride 50 on the raw clip, a SAME depthwise block, six
    pairs of ``Residual1D`` with the stride on the first conv and no pool
    (widths 320..1536, the first of each pair at stride 2), global max
    and average pooling concatenated, Dropout, a bias-free Dense."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.trunk = [self.add(L.ConvBN(1, 256, 75, 50, "same")),
                      self.add(L.DepthwiseConvBlock(256, 256, 3, "same"))]
        c = 256
        for w in (320, 384, 512, 768, 1024, 1536):
            self.trunk += [
                self.add(L.Residual1D(c, w, 3, 2, "stride_on_first_conv")),
                self.add(L.Residual1D(w, w, 3, 1, "stride_on_first_conv"))]
            c = w
        self.head = [self.add(L.Dropout(0.5)),
                     self.add(L.Dense(2 * c, num_classes, use_bias=False))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, x[:, None, :])
        x = torch.cat([L.global_max_pool(x), L.global_avg_pool(x)], dim=1)
        return _run(self.head, x, generator)


class _ResidualFeatureTrunk(L.FlaxNamed):
    """The trunk of ``conv_1d_log_mfcc`` and ``conv_1d_spectrogram``
    (zoo.py _ResidualFeatureTrunk, model.py:1400-1561): the flat features
    [B, time_size * frequency_size] (frames-major) as NCW with the
    frequencies for channels, a VALID ConvBN k3 of 64, ten ``Residual1D``
    blocks that pool at their stride (64..256), a softmax over time of a
    1-channel ``DepthwiseConvBlock`` k3 weighting the trunk, global
    average pooling, Dropout, Dense."""

    def __init__(self, num_classes: int, time_size: int,
                 frequency_size: int, dropout: float = 0.2):
        super().__init__()
        self.shape = (time_size, frequency_size)
        self.trunk = [self.add(L.ConvBN(frequency_size, 64, 3,
                                        padding="valid"))]
        c = 64
        for w, s in [(64, 1), (64, 1), (128, 2), (128, 1), (192, 2),
                     (192, 1), (192, 1), (256, 2), (256, 1), (256, 1)]:
            self.trunk.append(self.add(L.Residual1D(
                c, w, 3, s, "pool_eq_stride")))
            c = w
        self.attention = [self.add(L.DepthwiseConvBlock(c, 1, 3, "same"))]
        self.head = [self.add(L.Dropout(dropout)),
                     self.add(L.Dense(c, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _stacked(x, *self.shape))
        x = L.global_avg_pool(_time_attention(self.attention[0], x))
        return _run(self.head, x, generator)


class Conv1DMfccAndRaw(L.FlaxNamed):
    """Two-input fusion model (zoo.py Conv1DMfccAndRaw,
    model.py:1564-1660), called with the tuple (mfcc_flat, raw): the
    MFCCs as NCW with the coefficients for channels and a VALID ConvBN k3
    of 64; the raw clip framed VALID at ``frame_length``/``frame_step``
    and a VALID ConvBN k3 of 96; the two concatenated over channels, ten
    ``Residual1D`` blocks (pool 3 at the stride, 160..384), global
    average pooling, Dropout, Dense."""

    def __init__(self, num_classes: int, time_size: int = 98,
                 frequency_size: int = 60, frame_length: int = 480,
                 frame_step: int = 160):
        super().__init__()
        self.shape = (time_size, frequency_size)
        self.framing = (frame_length, frame_step)
        self.mfcc = [self.add(L.ConvBN(frequency_size, 64, 3,
                                       padding="valid"))]
        self.raw = [self.add(L.ConvBN(frame_length, 96, 3, padding="valid"))]
        c, self.trunk = 160, []
        for w, s in [(160, 1), (160, 1), (192, 2), (192, 1), (256, 2),
                     (256, 1), (320, 2), (320, 1), (384, 2), (384, 1)]:
            self.trunk.append(self.add(L.Residual1D(c, w, 3, s, "pool")))
            c = w
        self.head = [self.add(L.Dropout(0.3)),
                     self.add(L.Dense(c, num_classes))]

    def forward(self, inputs: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_mfcc, x_raw = inputs
        x = torch.cat([_run(self.mfcc, _stacked(x_mfcc, *self.shape)),
                       _run(self.raw, _frames(x_raw, *self.framing,
                                              "VALID"))], dim=1)
        x = L.global_avg_pool(_run(self.trunk, x))
        return _run(self.head, x, generator)


class SimpleModel(L.FlaxNamed):
    """``preprocess_mfcc`` -> Dense (zoo.py SimpleModel,
    model.py:102-113). flax infers the Dense's input width from the
    input; here it is ``input_size``, the flat MFCCs' frames x
    coefficients (98 x 40 = 3920 at the goldens' geometry)."""

    def __init__(self, num_classes: int, input_size: int = 98 * 40):
        super().__init__()
        self.head = [L.preprocess_mfcc,
                     self.add(L.Dense(input_size, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _run(self.head, x, generator)


class SNNModel(L.FlaxNamed):
    """Self-normalising MLP (zoo.py SNNModel, model.py:79-99):
    ``preprocess_mfcc``, then Dense layers of 512, 256, 128 and 64 with
    lecun-normal kernels, each followed by SELU and AlphaDropout (0.1,
    0.1, 0.1, 0.05), and a lecun-normal Dense head. ``input_size`` as in
    ``SimpleModel``."""

    def __init__(self, num_classes: int, input_size: int = 98 * 40):
        super().__init__()
        self.layers = [L.preprocess_mfcc]
        c = input_size
        for hidden, rate in [(512, 0.1), (256, 0.1), (128, 0.1), (64, 0.05)]:
            self.layers += [self.add(L.Dense(c, hidden, init="lecun_normal")),
                            L.selu, self.add(L.AlphaDropout(rate))]
            c = hidden
        self.layers.append(self.add(L.Dense(c, num_classes,
                                            init="lecun_normal")))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _run(self.layers, x, generator)


def _mfcc_image(x: torch.Tensor, time_size: int,
                frequency_size: int) -> torch.Tensor:
    """Flat MFCCs [B, time * freq] -> NCHW [B, 1, time, freq], normalised
    by ``preprocess_mfcc`` (the JAX models' reshape to [B, T, F, 1])."""
    return L.preprocess_mfcc(x.reshape(x.shape[0], 1, time_size,
                                       frequency_size))


class Conv2DModel(L.FlaxNamed):
    """The TF tutorial's 2-D conv on MFCC fingerprints (zoo.py
    Conv2DModel, model.py:515-544): a SAME conv of 64 filters 20x8 with
    bias, relu, max pool 2x2, a SAME conv of 128 filters 10x4, relu, max
    pool 2x2, the NHWC flatten and a Dense head."""

    def __init__(self, num_classes: int, time_size: int = 98,
                 frequency_size: int = 40):
        super().__init__()
        self.shape = (time_size, frequency_size)
        pool = functools.partial(L.max_pool_2d, pool=(2, 2))
        self.trunk = [self.add(L.Conv(1, 64, (20, 8), padding="same",
                                      use_bias=True)), F.relu, pool,
                      self.add(L.Conv(64, 128, (10, 4), padding="same",
                                      use_bias=True)), F.relu, pool]
        t, f = time_size // 2 // 2, frequency_size // 2 // 2
        self.head = [self.add(L.Dense(128 * t * f, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _mfcc_image(x, *self.shape))
        return _run(self.head, _nwc_flat(x), generator)


class Conv2DMobile(L.FlaxNamed):
    """Strided conv-BN-relu6 pairs + GAP (zoo.py Conv2DMobile,
    model.py:547-594): per width 32..256 a SAME 3x3 ConvBN with bias at
    stride 2 and one at stride 1, then Dropout 0.05; global average
    pooling, Dropout, Dense."""

    def __init__(self, num_classes: int, time_size: int = 98,
                 frequency_size: int = 40):
        super().__init__()
        self.shape = (time_size, frequency_size)
        c, self.trunk = 1, []
        for f in (32, 64, 128, 256):
            self.trunk += [
                self.add(L.ConvBN(c, f, (3, 3), (2, 2), "same",
                                  use_bias=True)),
                self.add(L.ConvBN(f, f, (3, 3), padding="same",
                                  use_bias=True)),
                self.add(L.Dropout(0.05))]
            c = f
        self.head = [self.add(L.Dropout(0.1)),
                     self.add(L.Dense(c, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _mfcc_image(x, *self.shape), generator)
        return _run(self.head, L.global_avg_pool(x), generator)


class Conv2DFast(L.FlaxNamed):
    """Dilated conv + pool x4, GAP (zoo.py Conv2DFast,
    model.py:597-639): SAME ConvBN with bias and relu, each followed by
    a max pool 2x2: 16 of 11x5 and 32 of 5x3, both dilated (2, 1)
    (effective 21x5 and 9x3), then 64 and 128 of 3x3; a Dense head on the
    global average (``head='gap'``, the reference's) or on the NHWC
    flatten of the 6x2 grid (``head='flatten'``, the JAX package's
    ablation field, passed as ``model_kwargs``)."""

    def __init__(self, num_classes: int, time_size: int = 98,
                 frequency_size: int = 40, head: str = "gap"):
        super().__init__()
        if head not in ("gap", "flatten"):
            raise ValueError(f"head {head!r}")
        self.shape = (time_size, frequency_size)
        self.head_kind = head
        pool = functools.partial(L.max_pool_2d, pool=(2, 2))
        c, t, fr, self.trunk = 1, time_size, frequency_size, []
        for f, k, d in [(16, (11, 5), (2, 1)), (32, (5, 3), (2, 1)),
                        (64, (3, 3), (1, 1)), (128, (3, 3), (1, 1))]:
            self.trunk += [self.add(L.ConvBN(c, f, k, padding="same",
                                             dilation=d, use_bias=True,
                                             activation=F.relu)), pool]
            c, t, fr = f, t // 2, fr // 2
        width = c * t * fr if head == "flatten" else c
        self.head = [self.add(L.Dense(width, num_classes))]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _run(self.trunk, _mfcc_image(x, *self.shape))
        x = _nwc_flat(x) if self.head_kind == "flatten" \
            else L.global_avg_pool(x)
        return _run(self.head, x, generator)


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


# the JAX registry's 25 names, recipes and order (zoo.py:742-774)
MODEL_REGISTRY: Dict[str, ModelSpec] = {s.name: s for s in [
    ModelSpec("simple", SimpleModel, "mfcc", "sgd", 0.01, momentum=0.9),
    ModelSpec("snn", SNNModel, "mfcc", "sgd", 0.01, momentum=0.9),
    ModelSpec("conv_1d_simple", Conv1DSimple, "raw", "adam", 1e-3),
    ModelSpec("inception", Conv1DInception, "raw", "adam", 1e-3),
    ModelSpec("conv_1d_time_stacked", conv_1d_time_stacked, "raw", "adam",
              3e-4),
    ModelSpec("inception_d1", InceptionD1, "raw", "adam", 1e-3),
    ModelSpec("conv_1d_heavy", conv_1d_heavy, "raw", "adam", 3e-4),
    ModelSpec("conv_1d_gru", Conv1DGru, "raw", "rmsprop", 1e-3),
    ModelSpec("conv_2d", Conv2DModel, "mfcc", "sgd", 1e-3, momentum=0.9),
    ModelSpec("conv_2d_mobile", Conv2DMobile, "mfcc", "sgd", 1e-3,
              momentum=0.95),
    ModelSpec("conv_2d_fast", Conv2DFast, "mfcc", "sgd", 1e-3, momentum=0.9),
    ModelSpec("conv_1d_fast", Conv1DFast, "raw", "rmsprop", 3e-3),
    ModelSpec("conv_1d_time_sliced", Conv1DTimeSliced, "raw", "rmsprop",
              1e-3),
    ModelSpec("conv_1d_time_sliced_with_attention",
              Conv1DTimeSlicedWithAttention, "raw", "rmsprop", 1e-3,
              label_smoothing=0.1),
    ModelSpec("conv_1d_residual", Conv1DResidual, "raw", "rmsprop", 1e-4),
    ModelSpec("xception_with_attention", XceptionWithAttention, "raw",
              "rmsprop", 5e-4),
    ModelSpec("conv_1d_time_sliced_group", Conv1DTimeSlicedGroup, "raw",
              "rmsprop", 1e-3),
    ModelSpec("conv_1d_multi_time_sliced", Conv1DMultiTimeSliced, "raw",
              "rmsprop", 3e-3),
    ModelSpec("conv_1d_learned_spec", Conv1DLearnedSpec, "raw", "rmsprop",
              2e-3),
    ModelSpec("conv_1d_spec", Conv1DSpec, "spec", "rmsprop", 2e-3),
    ModelSpec("conv_1d_top_down", Conv1DTopDown, "raw", "rmsprop", 3e-3),
    ModelSpec("conv_1d_log_mfcc", _ResidualFeatureTrunk, "mfcc", "rmsprop",
              6e-4),
    ModelSpec("conv_1d_spectrogram", _ResidualFeatureTrunk, "spec",
              "rmsprop", 3e-4),
    ModelSpec("conv_1d_mfcc_and_raw", Conv1DMfccAndRaw, "mfcc_and_raw",
              "rmsprop", 5e-4),
    ModelSpec("steffeNet", SteffeNet, "raw", "rmsprop", 1e-3,
              label_smoothing=0.1),
]}


def get_spec(model_type: str) -> ModelSpec:
    spec = MODEL_REGISTRY.get(model_type)
    if spec is None:
        raise ValueError(f"Invalid model: {model_type}")
    return spec


def _geometry(model_type: str, settings: Dict[str, Any]) -> Dict[str, Any]:
    """The constructor's feature geometry from ``settings``, with the JAX
    ``build_model``'s defaults (zoo.py:792-814): the time and frequency
    sizes of the feature models and ``conv_1d_mfcc_and_raw``'s framing.
    ``simple`` and ``snn`` take ``input_size``, frames x coefficients
    (98 x 40 by default), the width flax infers from their input."""
    t = settings.get("spectrogram_length")
    mels = settings.get("num_log_mel_features", 40)
    bins = settings.get("spectrogram_frequencies", 257)
    if model_type == "conv_1d_log_mfcc":
        return dict(time_size=t or 65, frequency_size=mels)
    if model_type == "conv_1d_spectrogram":
        return dict(time_size=t or 65, frequency_size=bins)
    if model_type == "conv_1d_spec":
        return dict(time_size=t or 98, frequency_size=bins)
    if model_type in ("conv_2d", "conv_2d_mobile", "conv_2d_fast"):
        return dict(time_size=t or 98, frequency_size=mels)
    if model_type == "conv_1d_mfcc_and_raw":
        return dict(time_size=t or 65, frequency_size=mels,
                    frame_length=settings.get("window_size_samples", 480),
                    frame_step=settings.get("window_stride_samples", 160))
    if model_type in ("simple", "snn"):
        return dict(input_size=(t or 98) * mels)
    return {}


def settings_geometry(settings) -> Dict[str, Any]:
    """The feature geometry of a ``ModelSettings`` as ``build_model``
    takes it (what the JAX Trainer threads through, loop.py:157-164)."""
    return dict(spectrogram_length=settings.spectrogram_length,
                num_log_mel_features=settings.num_log_mel_features,
                spectrogram_frequencies=settings.spectrogram_frequencies,
                desired_samples=settings.desired_samples,
                window_size_samples=settings.window_size_samples,
                window_stride_samples=settings.window_stride_samples)


def build_model(model_type: str, num_classes: int = 11,
                generator: Optional[torch.Generator] = None,
                **settings: Any) -> Tuple[nn.Module, ModelSpec]:
    """Instantiate a zoo model with initialised parameters on the CPU.

    ``generator`` seeds the init (default: seed 0), so one seed gives the
    same weights whatever device the caller moves the model to.
    ``settings`` carries the feature geometry that the JAX
    ``build_model`` threads through (``spectrogram_length``,
    ``num_log_mel_features``, ``spectrogram_frequencies``,
    ``desired_samples``, ``window_size_samples``,
    ``window_stride_samples``; ``_geometry``); models that need none
    ignore it. ``model_kwargs`` (a dict inside ``settings``) goes to the
    module's constructor last, as in the JAX package (e.g.
    ``{"filter_mult": 2}`` for ``conv_1d_time_sliced``, ``{"head":
    "flatten"}`` for ``conv_2d_fast``).
    """
    spec = get_spec(model_type)
    kwargs: Dict[str, Any] = {"num_classes": num_classes,
                              **_geometry(model_type, settings)}
    kwargs.update(settings.get("model_kwargs") or {})
    module = spec.build(**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    L.init_parameters(module, generator)
    return module, spec
