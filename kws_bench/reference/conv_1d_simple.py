"""Plain reference of ``conv_1d_simple`` (see--/speech_recognition
model.py:116-156): the raw clip as one channel, a VALID separable block
of 31 at stride 16 (depthwise, pointwise to 32, BatchNorm, relu6;
16,000 samples to 999 steps), a VALID separable block of 3 to 32, then
for each width of ``WIDTHS`` a VALID block of 3 at stride 2 and one at
stride 1 (997 steps to 10), a bidirectional Keras-v1 GRU of 128 units
with input and recurrent dropout 0.2 (``recurrent.py``), its two last
states side by side, and a Dense to the classes with a bias.

Parameter names are the port's checkpoint keys. Departures from the
Keras model: the weights are the benchmark's seeded draws, the GRU's
recurrent weights uniform too, not Keras's orthogonal init; the GRU's
departures are in ``recurrent.py`` (its input products before the loop,
its masks from the caller in the program's draw order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kws_bench.reference import layers as L
from kws_bench.reference import recurrent as R

# (width, kernel, stride) of the two blocks on the clip
STEM = ((32, 31, 16), (32, 3, 1))
# widths of the pairs of blocks that follow, the first of each at stride 2
WIDTHS = (64, 96, 128, 160, 192, 224)
UNITS = 128
DROPOUT = 0.2
GRUS = ("BiGRU_0.GRU_0", "BiGRU_0.GRU_1")      # forward, reverse


def _blocks():
    """(name, cin, cout, kernel, stride) of the separable blocks."""
    shapes = list(STEM) + [(w, 3, s) for w in WIDTHS for s in (2, 1)]
    out, c = [], 1
    for i, (w, k, s) in enumerate(shapes):
        out.append((f"DepthwiseConvBlock_{i}", c, w, k, s))
        c = w
    return out


def param_shapes(num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic;
    kind: kernel (the L2 penalty's), bias, bn_scale, bn_shift,
    running_mean, running_var."""
    out = []
    for name, cin, cout, k, _ in _blocks():
        out += L.separable_shapes(name, cin, cout, k)
    for prefix in GRUS:
        out += R.gru_shapes(prefix, WIDTHS[-1], UNITS)
    out += [("Dense_0.weight", (num_classes, 2 * UNITS), "kernel"),
            ("Dense_0.bias", (num_classes,), "bias")]
    return out


def dropout_shapes(batch: int) -> List[Tuple[Tuple[int, ...], float]]:
    """The masks in the program's draw order: the forward GRU's input
    masks (3, B, 1, 224) and recurrent masks (3, B, 128), then the
    reverse GRU's."""
    return 2 * R.dropout_shapes(batch, WIDTHS[-1], UNITS, DROPOUT)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            keep: Optional[Sequence[torch.Tensor]] = None,
            q: L.Quant = L.identity) -> torch.Tensor:
    """Logits [B, classes] of clips ``x`` [B, 16000]; ``keep``: the four
    GRU mask sets of ``dropout_shapes`` (train mode)."""
    x = x[:, None, :]
    for name, _, _, _, stride in _blocks():
        x = L.separable(p, name, x, stride, "valid", train, q)
    masks = (keep[0:2], keep[2:4]) if train else (None, None)
    h = torch.cat([R.gru(p, prefix, x, reverse, m, DROPOUT, q)
                   for prefix, reverse, m in zip(GRUS, (False, True),
                                                 masks)], dim=1)
    return L.dense(h, p["Dense_0.weight"], p["Dense_0.bias"], q)
