"""Plain reference of ``xception_with_attention`` (see--/speech_recognition
model.py:911-983): frames of 40 samples at a hop of 20 (SAME), a VALID
conv of 64 filters of 3 at stride 2 with BatchNorm and relu6 (800 frames
to 399), eleven residual blocks of widths 128, 256, 256 x 8 and 384 (399
steps to 50), a softmax over time of a 1-channel depthwise-separable
block of 5 that weighs the trunk's output, a bidirectional Keras-v1 GRU
of 192 units with input and recurrent dropout 0.2 (``recurrent.py``),
its two last states side by side, and a Dense to the classes with a
bias.

A residual block at stride s (the published ``pool`` mode): two SAME
separable blocks of 3 (depthwise, pointwise, BatchNorm, relu6), a SAME
max pool of 3 at stride s, plus the shortcut, which is the input at
stride 1 and a SAME 1x1 conv at stride s with BatchNorm (no activation)
at stride 2.

Parameter names are the port's checkpoint keys. Departures from the
Keras model: the max pool's gradient goes to one of tied maxima (Keras's
too; the port splits it between them, which differs only where the
maxima are relu6's clipped values, whose gradient is 0 either way); the
GRU's departures are in ``recurrent.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kws_bench.reference import layers as L
from kws_bench.reference import recurrent as R

STEM = 64
# (width, stride) of the eleven residual blocks
RESIDUALS = ((128, 2), (256, 2)) + ((256, 1),) * 8 + ((384, 2),)
UNITS = 192
DROPOUT = 0.2
GRUS = ("BiGRU_0.GRU_0", "BiGRU_0.GRU_1")      # forward, reverse


def _residuals():
    """(name, cin, cout, stride) of the residual blocks."""
    out, c = [], STEM
    for i, (w, s) in enumerate(RESIDUALS):
        out.append((f"Residual1D_{i}", c, w, s))
        c = w
    return out


def param_shapes(num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic;
    kind: kernel (the L2 penalty's), bias, bn_scale, bn_shift,
    running_mean, running_var."""
    out = [("ConvBN_0.conv.weight", (STEM, 40, 3), "kernel")]
    out += L.bn_shapes("ConvBN_0.bn", STEM)
    for name, cin, cout, stride in _residuals():
        if stride != 1:
            out += [(f"{name}.Conv_0.weight", (cout, cin, 1), "kernel")]
            out += L.bn_shapes(f"{name}.BatchNorm_0", cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_0", cin, cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_1", cout, cout)
    c = RESIDUALS[-1][0]
    out += L.separable_shapes("DepthwiseConvBlock_0", c, 1, k=5)
    for prefix in GRUS:
        out += R.gru_shapes(prefix, c, UNITS)
    out += [("Dense_0.weight", (num_classes, 2 * UNITS), "kernel"),
            ("Dense_0.bias", (num_classes,), "bias")]
    return out


def dropout_shapes(batch: int) -> List[Tuple[Tuple[int, ...], float]]:
    """The masks in the program's draw order: the forward GRU's input
    masks (3, B, 1, 384) and recurrent masks (3, B, 192), then the
    reverse GRU's."""
    c = RESIDUALS[-1][0]
    return 2 * R.dropout_shapes(batch, c, UNITS, DROPOUT)


def max_pool(x: torch.Tensor, pool: int, stride: int) -> torch.Tensor:
    """SAME max pooling over time (padding at -inf)."""
    x = F.pad(x, L.same_pads(x.shape[-1], pool, stride),
              value=float("-inf"))
    return F.max_pool1d(x, pool, stride)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            keep: Optional[Sequence[torch.Tensor]] = None,
            q: L.Quant = L.identity) -> torch.Tensor:
    """Logits [B, classes] of clips ``x`` [B, 16000]; ``keep``: the four
    GRU mask sets of ``dropout_shapes`` (train mode)."""
    x = L.frames(x, 40, 20)
    x = L.conv1d(x, p["ConvBN_0.conv.weight"], stride=2, q=q)
    x = L.relu6(L.bn(p, "ConvBN_0.bn", x, train))
    for name, _, _, stride in _residuals():
        shortcut = x
        if stride != 1:
            shortcut = L.bn(p, f"{name}.BatchNorm_0", L.conv1d(
                x, p[f"{name}.Conv_0.weight"], stride, "same", q=q), train)
        y = L.separable(p, f"{name}.DepthwiseConvBlock_0", x, 1, "same",
                        train, q)
        y = L.separable(p, f"{name}.DepthwiseConvBlock_1", y, 1, "same",
                        train, q)
        x = max_pool(y, 3, stride) + shortcut
    att = L.separable(p, "DepthwiseConvBlock_0", x, 1, "same", train, q)
    x = x * torch.softmax(att, dim=2)
    masks = (keep[0:2], keep[2:4]) if train else (None, None)
    h = torch.cat([R.gru(p, prefix, x, reverse, m, DROPOUT, q)
                   for prefix, reverse, m in zip(GRUS, (False, True),
                                                 masks)], dim=1)
    return L.dense(h, p["Dense_0.weight"], p["Dense_0.bias"], q)
