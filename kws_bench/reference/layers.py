"""Plain layers of the reference models, in functional form.

Every function takes its parameters explicitly and computes in the dtype
of its input (float32 for the references). ``q`` is applied to both
operands of each convolution and product: the identity for the
reference, a rounding to a narrower type for the precision control
(``fp8_e4m3``).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3          # Keras BatchNormalization's epsilon
BN_MOMENTUM = 0.99     # Keras: r <- 0.99 r + 0.01 batch statistic

Quant = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to an 8-bit float ``dtype`` under one per-tensor
    scale (its largest magnitude onto ``top``, the type's largest finite
    value), back in ``x``'s dtype."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: the operand in e4m3 on the way
    forward, its gradient in e5m2 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """The precision control's rounding of a product's operand (see
    ``_Fp8``)."""
    return _Fp8.apply(x)


def same_pads(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's SAME padding of one axis: (left, right), the smaller
    half on the left."""
    out = math.ceil(length / stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv1d(x, w, stride: int = 1, padding: str = "valid", groups: int = 1,
           q: Quant = identity):
    """NCW convolution, no bias; ``w`` [out, in / groups, k]."""
    if padding == "same":
        x = F.pad(x, same_pads(x.shape[-1], w.shape[-1], stride))
    return F.conv1d(q(x), q(w), stride=stride, groups=groups)


def dense(x, w, b=None, q: Quant = identity):
    """``x @ w.T + b``; ``w`` [out, in]."""
    y = q(x) @ q(w).t()
    return y if b is None else y + b


def batch_norm(x, gamma, beta, train: bool, running_mean=None,
               running_var=None):
    """Per channel (axis 1) over the batch and time; in train mode with
    the batch mean and biased batch variance."""
    if train:
        mean = x.mean(dim=(0, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2), keepdim=True)
    else:
        mean = running_mean[None, :, None]
        var = running_var[None, :, None]
    return (x - mean) / torch.sqrt(var + BN_EPS) * gamma[None, :, None] \
        + beta[None, :, None]


def relu6(x):
    return x.clamp(0.0, 6.0)


def frames(x, length: int, step: int):
    """Clips [B, T] -> NCW frames [B, length, n] under SAME padding."""
    x = F.pad(x, same_pads(x.shape[-1], length, step))
    n = (x.shape[-1] - length) // step + 1
    idx = torch.arange(length, device=x.device)[:, None] \
        + step * torch.arange(n, device=x.device)[None, :]
    return x[:, idx]


def separable(p, prefix: str, x, stride: int, padding: str, train: bool,
              q: Quant = identity):
    """Depthwise conv (the stride and padding) -> pointwise conv ->
    BatchNorm -> relu6; parameters ``<prefix>.depthwise.weight``,
    ``<prefix>.pointwise.weight`` and ``<prefix>.bn.*``."""
    x = conv1d(x, p[f"{prefix}.depthwise.weight"], stride, padding,
               groups=x.shape[1], q=q)
    x = conv1d(x, p[f"{prefix}.pointwise.weight"], q=q)
    return relu6(bn(p, f"{prefix}.bn", x, train))


class Recorder(dict):
    """Parameters by name that also keep, by layer, the batch mean and
    biased batch variance each train-mode BatchNorm normalised with in
    the last forward pass (``stats``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stats = {}


def bn(p, prefix: str, x, train: bool):
    if train and isinstance(p, Recorder):
        mean = x.detach().mean(dim=(0, 2))
        var = (x.detach() - mean[None, :, None]).square().mean(dim=(0, 2))
        p.stats[prefix] = (mean, var)
    return batch_norm(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"], train,
                      p.get(f"{prefix}.running_mean"),
                      p.get(f"{prefix}.running_var"))


def dropout(x, keep, rate: float):
    """Inverted dropout under a given boolean keep mask (None: eval)."""
    return x if keep is None else x * keep / (1.0 - rate)


def separable_shapes(prefix: str, cin: int, cout: int, k: int = 3):
    return [(f"{prefix}.depthwise.weight", (cin, 1, k), "kernel"),
            (f"{prefix}.pointwise.weight", (cout, cin, 1), "kernel")] \
        + bn_shapes(f"{prefix}.bn", cout)


def bn_shapes(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_scale"),
            (f"{prefix}.bias", (c,), "bn_shift"),
            (f"{prefix}.running_mean", (c,), "running_mean"),
            (f"{prefix}.running_var", (c,), "running_var")]
