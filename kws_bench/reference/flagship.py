"""Plain reference of ``conv_1d_time_sliced_with_attention``, the
flagship (see--/speech_recognition model.py:775-838): frames of 40
samples at a hop of 20 (SAME), a VALID conv of 128 filters of 3 at
stride 2 with BatchNorm and relu6, eleven separable blocks (depthwise 3,
pointwise, BatchNorm, relu6) that halve the time five times, a softmax
over the 9 frames left from a Dense over the flattened frames (after a
Dropout of 0.4), the attended frames' max beside the frames' mean, a
Dropout of 0.4 and a bias-free Dense to the classes.

Parameter names are the port's checkpoint keys (its ``state_dict``), so
that one set of weights made by the benchmark loads into both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kws_bench.reference import layers as L

WIDTHS = (192, 256, 320, 384, 512)
FRAMES_LEFT = 9
DROPOUT = (0.4, 0.4)


def param_shapes(num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic,
    in a fixed order; kind: kernel, bias, bn_scale, bn_shift,
    running_mean, running_var."""
    out = [("stem.conv.weight", (128, 40, 3), "kernel")]
    out += L.bn_shapes("stem.bn", 128)
    blocks = [(128, 128)]
    c = 128
    for w in WIDTHS:
        blocks += [(c, w), (w, w)]
        c = w
    for i, (cin, cout) in enumerate(blocks):
        out += L.separable_shapes(f"blocks.{i}", cin, cout)
    out += [("attention.weight", (FRAMES_LEFT, FRAMES_LEFT * c), "kernel"),
            ("attention.bias", (FRAMES_LEFT,), "bias"),
            ("head.weight", (num_classes, 2 * c), "kernel")]
    return out


def dropout_shapes(batch: int) -> List[Tuple[Tuple[int, ...], float]]:
    """The shapes and rates of the train-mode dropout masks, in the order
    the forward pass draws them."""
    c = WIDTHS[-1]
    return [((batch, FRAMES_LEFT * c), DROPOUT[0]),
            ((batch, 2 * c), DROPOUT[1])]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            keep: Optional[Sequence[torch.Tensor]] = None,
            q: L.Quant = L.identity) -> torch.Tensor:
    """Logits [B, classes] of clips ``x`` [B, 16000]; ``keep``: the two
    dropout masks (train mode)."""
    keep = keep if train else (None, None)
    x = L.frames(x, 40, 20)
    x = L.conv1d(x, p["stem.conv.weight"], stride=2, q=q)
    x = L.relu6(L.bn(p, "stem.bn", x, train))
    x = L.separable(p, "blocks.0", x, 1, "valid", train, q)
    for i in range(len(WIDTHS)):
        x = L.separable(p, f"blocks.{2 * i + 1}", x, 2, "same", train, q)
        x = L.separable(p, f"blocks.{2 * i + 2}", x, 1, "valid", train, q)
    b = x.shape[0]
    flat = x.transpose(1, 2).reshape(b, -1)          # time-major flatten
    att = L.dense(L.dropout(flat, keep[0], DROPOUT[0]),
                  p["attention.weight"], p["attention.bias"], q)
    weights = torch.softmax(att, dim=-1)[:, None, :]
    pooled = torch.cat([(x * weights).amax(dim=2), x.mean(dim=2)], dim=1)
    return L.dense(L.dropout(pooled, keep[1], DROPOUT[1]),
                   p["head.weight"], None, q)
