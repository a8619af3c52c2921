"""Model zoo and registry (port of speech_recognition_tpu/models/zoo.py).

Ported: the flagship, ``conv_1d_time_sliced_with_attention``;
``conv_1d_spec``, the accuracy signal's model; and eleven raw-waveform
models: the 1-D ladders (``conv_1d_time_sliced``,
``conv_1d_time_stacked``, ``conv_1d_heavy``, ``conv_1d_gru``,
``conv_1d_fast``, ``conv_1d_learned_spec``,
``conv_1d_multi_time_sliced``), the grouped ones
(``conv_1d_time_sliced_group``, ``conv_1d_top_down``) and the Inceptions
(``inception``, ``inception_d1``). Every other zoo name raises
``NotImplementedError`` (ROADMAP A8). Models emit logits, as in the JAX
package.

Inputs are flat [B, 16000] clips. The JAX models are NWC and the port's
NCW, so a reshape of the clip to [B, T, C] becomes the same reshape and a
transpose, and every flatten before a Dense transposes back to NWC
first (flax flattens time-major, channel-minor).
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
    """NCW [B, C, T] -> [B, T * C], flax's time-major flatten of NWC."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def _stacked(x: torch.Tensor, time: int, channels: int) -> torch.Tensor:
    """Flat clips [B, time * channels] -> NCW [B, channels, time], the
    JAX models' ``x.reshape(b, time, channels)``."""
    return x.reshape(x.shape[0], time, channels).transpose(1, 2)


def _run(layers, x: torch.Tensor,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply ``layers`` in turn; each ``Dropout`` draws from ``generator``."""
    for layer in layers:
        x = layer(x, generator) if isinstance(layer, L.Dropout) else layer(x)
    return x


class _FlaxNamed(nn.Module):
    """A zoo model whose layers carry the names flax gives the JAX
    model's: ``<Class>_<i>``, counted per class in creation order.
    ``add`` registers a layer under its name and returns it, so each
    model creates its layers in the order its flax ``__call__`` does, and
    ``models/convert.py`` moves the weights with no table of its own. The
    models keep their layers in plain lists (attributes that hold a
    module would register it a second time)."""

    def __init__(self):
        super().__init__()
        self._counts: Dict[str, int] = {}

    def add(self, layer: nn.Module) -> nn.Module:
        kind = type(layer).__name__
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", layer)
        return layer


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
        return self.head(self.dropout(_nwc_flat(x), generator))


class Conv1DTimeSliced(_FlaxNamed):
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
        x = _run(self.trunk,
                 overlapping_frames(x, 40, 20, "SAME").transpose(1, 2))
        return _run(self.head, L.global_avg_pool(x), generator)


class _StackedLadder(_FlaxNamed):
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


class Conv1DGru(_FlaxNamed):
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


class Conv1DFast(_FlaxNamed):
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


class Conv1DLearnedSpec(_FlaxNamed):
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


class Conv1DMultiTimeSliced(_FlaxNamed):
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


class Conv1DTimeSlicedGroup(_FlaxNamed):
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


class Conv1DTopDown(_FlaxNamed):
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


class _InceptionBase(_FlaxNamed):
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
    ModelSpec("conv_1d_time_sliced", Conv1DTimeSliced, "raw", "rmsprop",
              1e-3),
    ModelSpec("conv_1d_time_stacked", conv_1d_time_stacked, "raw", "adam",
              3e-4),
    ModelSpec("conv_1d_heavy", conv_1d_heavy, "raw", "adam", 3e-4),
    ModelSpec("conv_1d_gru", Conv1DGru, "raw", "rmsprop", 1e-3),
    ModelSpec("conv_1d_fast", Conv1DFast, "raw", "rmsprop", 3e-3),
    ModelSpec("conv_1d_learned_spec", Conv1DLearnedSpec, "raw", "rmsprop",
              2e-3),
    ModelSpec("conv_1d_multi_time_sliced", Conv1DMultiTimeSliced, "raw",
              "rmsprop", 3e-3),
    ModelSpec("conv_1d_time_sliced_group", Conv1DTimeSlicedGroup, "raw",
              "rmsprop", 1e-3),
    ModelSpec("conv_1d_top_down", Conv1DTopDown, "raw", "rmsprop", 3e-3),
    ModelSpec("inception", Conv1DInception, "raw", "adam", 1e-3),
    ModelSpec("inception_d1", InceptionD1, "raw", "adam", 1e-3),
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
    ignore it. ``model_kwargs`` (a dict inside ``settings``) goes to the
    module's constructor last, as in the JAX package (e.g.
    ``{"filter_mult": 2}`` for ``conv_1d_time_sliced``).
    """
    spec = get_spec(model_type)
    kwargs: Dict[str, Any] = {"num_classes": num_classes}
    if model_type == "conv_1d_spec":
        kwargs.update(time_size=settings.get("spectrogram_length") or 98,
                      frequency_size=settings.get(
                          "spectrogram_frequencies", 257))
    kwargs.update(settings.get("model_kwargs") or {})
    module = spec.build(**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    L.init_parameters(module, generator)
    return module, spec
