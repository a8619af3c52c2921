"""Plain reference of ``steffeNet`` (see--/speech_recognition
model.py:1663-1726): a SAME conv of 256 filters of 75 samples at stride
50 on the raw clip with BatchNorm and relu6, a SAME separable block,
six pairs of residual blocks (widths 320, 384, 512, 768, 1024, 1536),
the first of each pair at stride 2 on its first separable block with a
strided 1x1 conv and BatchNorm on the shortcut, the second with the
identity shortcut, then global max and mean pooling side by side, a
Dropout of 0.5 and a bias-free Dense to the classes.

Parameter names are the port's checkpoint keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kws_bench.reference import layers as L

WIDTHS = (320, 384, 512, 768, 1024, 1536)
DROPOUT = 0.5


def _residuals():
    """(name, cin, cout, stride) of the twelve residual blocks."""
    out, c = [], 256
    for i, w in enumerate(WIDTHS):
        out += [(f"Residual1D_{2 * i}", c, w, 2),
                (f"Residual1D_{2 * i + 1}", w, w, 1)]
        c = w
    return out


def param_shapes(num_classes: int) -> List[Tuple[str, tuple, str]]:
    out = [("ConvBN_0.conv.weight", (256, 1, 75), "kernel")]
    out += L.bn_shapes("ConvBN_0.bn", 256)
    out += L.separable_shapes("DepthwiseConvBlock_0", 256, 256)
    for name, cin, cout, stride in _residuals():
        if stride != 1:
            out += [(f"{name}.Conv_0.weight", (cout, cin, 1), "kernel")]
            out += L.bn_shapes(f"{name}.BatchNorm_0", cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_0", cin, cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_1", cout, cout)
    out += [("Dense_0.weight", (num_classes, 2 * WIDTHS[-1]), "kernel")]
    return out


def dropout_shapes(batch: int) -> List[Tuple[Tuple[int, ...], float]]:
    return [((batch, 2 * WIDTHS[-1]), DROPOUT)]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            keep: Optional[Sequence[torch.Tensor]] = None,
            q: L.Quant = L.identity) -> torch.Tensor:
    x = L.conv1d(x[:, None, :], p["ConvBN_0.conv.weight"], 50, "same", q=q)
    x = L.relu6(L.bn(p, "ConvBN_0.bn", x, train))
    x = L.separable(p, "DepthwiseConvBlock_0", x, 1, "same", train, q)
    for name, _, _, stride in _residuals():
        shortcut = x
        if stride != 1:
            shortcut = L.conv1d(x, p[f"{name}.Conv_0.weight"], stride,
                                "same", q=q)
            shortcut = L.bn(p, f"{name}.BatchNorm_0", shortcut, train)
        y = L.separable(p, f"{name}.DepthwiseConvBlock_0", x, stride,
                        "same", train, q)
        x = L.separable(p, f"{name}.DepthwiseConvBlock_1", y, 1, "same",
                        train, q) + shortcut
    pooled = torch.cat([x.amax(dim=2), x.mean(dim=2)], dim=1)
    pooled = L.dropout(pooled, keep[0] if train else None, DROPOUT)
    return L.dense(pooled, p["Dense_0.weight"], None, q)
