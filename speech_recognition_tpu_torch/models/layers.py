"""Model blocks (port of speech_recognition_tpu/models/layers.py).

Layout: activations are NCW ([batch, channels, time]) inside the port,
torch's convolution layout; the JAX package is NWC. ``models/convert.py``
moves weights between the two.

Parameters are created empty and filled by ``init_parameters`` from an
explicit ``torch.Generator`` (glorot-uniform kernels, zero biases, BN
scale 1 / bias 0), so no layer draws from torch's global RNG.

Under data parallelism (``use_mesh``) BatchNorm takes its statistics over
the global batch and Dropout draws its masks at the global batch's shape,
so that a step on W ranks is the one-device step on the same batch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.parallel.collectives import all_reduce_sum

# Keras defaults, as in the JAX package. Flax's momentum 0.99 weighs the
# old running value (torch's convention would call this momentum 0.01).
BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is if its dtype is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """K.relu(x, max_value=6)."""
    return F.relu6(x)


class Conv(nn.Module):
    """1-D convolution with TF padding semantics and a glorot-uniform
    kernel (flax ``nn.Conv`` as the JAX package's ``Conv`` uses it).

    ``weight`` is [out, in/groups, k]; ``bias`` [out] with ``use_bias``
    (off by default: every conv of the flagship is bias-free; heads and
    stems of other zoo models take one). ``padding='same'`` pads
    asymmetrically (TF SAME, left = total // 2) over the dilated span
    ``(k - 1) * dilation + 1``, which torch's own ``padding='same'``
    cannot do at stride > 1.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: str = "valid", groups: int = 1,
                 dilation: int = 1, use_bias: bool = False):
        super().__init__()
        if padding.lower() not in ("valid", "same"):
            raise ValueError(f"padding must be 'valid' or 'same', got "
                             f"{padding!r}")
        self.kernel = kernel
        self.stride = stride
        self.padding = padding.lower()
        self.groups = groups
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel))
        self.bias = (nn.Parameter(torch.empty(out_channels))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "same":
            span = (self.kernel - 1) * self.dilation + 1
            x = F.pad(x, same_pad_amount(x.shape[-1], span, self.stride))
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)


class Dense(nn.Module):
    """Linear layer with a glorot-uniform kernel; ``weight`` is [out, in]."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over NCW with flax/Keras semantics.

    Train mode normalises with the batch mean and *biased* batch variance
    and updates ``running_mean``/``running_var`` as
    ``r <- 0.99 * r + 0.01 * batch_stat`` with the biased variance, as
    flax does (torch's own BatchNorm folds in the unbiased variance).
    Statistics are taken in at least float32 whatever the activation dtype.

    With a ``mesh`` of more than one rank (``use_mesh``) the statistics are
    those of the global batch, as the JAX package's SPMD step takes them:
    the per-channel sum and the count are all-reduced to the global mean,
    then the sum of squared deviations to the biased variance (two passes,
    like ``var_mean``), and the input is normalised by hand with them. The
    all-reduces are differentiable, so the gradient is the global batch's
    too. ``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors
    and folds the unbiased variance into ``running_var``.
    """

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.mesh = None
        self.batch_stats = None
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        del generator  # deterministic init
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        if self.mesh is not None and self.mesh.size > 1:
            return self._global_batch_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(at_least_float32(x), dim=(0, 2),
                                       correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.batch_stats is not None:    # inside ``collect_batch_stats``
            self.batch_stats.append((mean, var))
            return
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_float32(x)
        count = xf.new_full((1,), x.shape[0] * x.shape[2])
        stats = all_reduce_sum(torch.cat([xf.sum((0, 2)), count]), self.mesh)
        mean = stats[:-1] / stats[-1]
        d = xf - mean[:, None]
        var = all_reduce_sum(d.square().sum((0, 2)), self.mesh) / stats[-1]
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (d * scale[:, None] + self.bias[:, None]).to(x.dtype)


class Dropout(nn.Module):
    """Dropout that draws its mask from an explicit ``torch.Generator``.

    Inverted dropout as flax does it: kept values are scaled by 1/(1-p).
    Identity in eval mode or at p = 0. With a ``mesh`` (``use_mesh``) the
    mask is drawn at the global batch's shape and this rank keeps its
    rows of it, so every rank's generator stays in step and W ranks draw
    the one-device mask.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.mesh = None

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit "
                             "torch.Generator")
        shape, rows = x.shape, slice(None)
        if self.mesh is not None and self.mesh.size > 1:
            shape = (x.shape[0] * self.mesh.size, *x.shape[1:])
            rows = self.mesh.rows(shape[0])
        keep = torch.rand(shape, generator=generator,
                          device=x.device)[rows] >= self.p
        return x * keep / (1.0 - self.p)


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> relu6 (layers.py ConvBN, bias-free); ``groups``
    > 1 gives a grouped convolution, group j making output channels
    [j Cout/g, (j+1) Cout/g) from input channels [j Cin/g, (j+1) Cin/g),
    as flax's ``feature_group_count`` does."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, padding: str = "same", groups: int = 1,
                 dilation: int = 1):
        super().__init__()
        if in_channels % groups or features % groups:
            raise ValueError(f"{in_channels} -> {features} channels do not "
                             f"split into {groups} groups")
        self.conv = Conv(in_channels, features, kernel, stride, padding,
                         groups, dilation)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bn(self.conv(x)))


class DepthwiseConvBlock(nn.Module):
    """Depthwise conv -> 1x1 pointwise conv -> BatchNorm -> relu6.

    The depthwise step carries the stride and padding (layers.py
    DepthwiseConvBlock with its defaults: no bias, no intermediate BN).
    """

    def __init__(self, in_channels: int, features: int, kernel: int,
                 padding: str = "same", stride: int = 1):
        super().__init__()
        self.depthwise = Conv(in_channels, in_channels, kernel, stride,
                              padding, groups=in_channels)
        self.pointwise = Conv(in_channels, features, 1)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bn(self.pointwise(self.depthwise(x))))


class GroupedDepthwiseBlock(nn.Module):
    """Depthwise conv over all channels -> 1x1 pointwise conv in
    ``groups`` groups -> BatchNorm -> relu6 (layers.py
    GroupedDepthwiseBlock). These are the block's intended grouped
    semantics, as the JAX block has them, not the reference's, which
    convolves the full tensor for every group."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 groups: int, padding: str = "same", stride: int = 1):
        super().__init__()
        if in_channels % groups or features % groups:
            raise ValueError(f"{in_channels} -> {features} channels do not "
                             f"split into {groups} groups")
        self.depthwise = Conv(in_channels, in_channels, kernel, stride,
                              padding, groups=in_channels)
        self.pointwise = Conv(in_channels, features, 1, groups=groups)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bn(self.pointwise(self.depthwise(x))))


def max_pool_1d(x: torch.Tensor, pool: int = 3, stride: int = 2,
                padding: str = "valid") -> torch.Tensor:
    """Max pooling over the time axis of NCW ``x`` as a chain of
    ``torch.maximum`` over strided slices (layers.py ``_max_pool_axis``).

    SAME pads with -inf, left = total // 2. The chain's gradient splits
    the cotangent between tied maxima, as the JAX pool's ``jnp.maximum``
    chain does; ``F.max_pool1d`` would give it all to the first.
    """
    t = x.shape[-1]
    if padding.lower() == "same":
        out = -(-t // stride)
        x = F.pad(x, same_pad_amount(t, pool, stride), value=float("-inf"))
    else:
        out = (t - pool) // stride + 1
    last = (out - 1) * stride + 1
    y = x[..., :last:stride]
    for i in range(1, pool):
        y = torch.maximum(y, x[..., i:i + last:stride])
    return y


def avg_pool_1d(x: torch.Tensor, pool: int = 3, stride: int = 1,
                padding: str = "same") -> torch.Tensor:
    """Average pooling over the time axis of NCW ``x`` (layers.py
    avg_pool_1d): SAME divides each window by its count of samples that
    are not padding, as TF's AveragePooling1D does. Takes SAME only where
    its pad is symmetric (pool 3 at stride 1, as the zoo uses it)."""
    left, right = (same_pad_amount(x.shape[-1], pool, stride)
                   if padding.lower() == "same" else (0, 0))
    if left != right:
        raise ValueError(f"SAME average pooling {pool}/{stride} at length "
                         f"{x.shape[-1]} pads asymmetrically")
    return F.avg_pool1d(x, pool, stride, padding=left,
                        count_include_pad=False)


def truncate_to_groups(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Drop trailing channels of NCW ``x`` so that channels % groups == 0
    (zoo.py _truncate_to_groups; the reference's slicing, model.py:1306)."""
    keep = x.shape[1] // groups * groups
    return x[:, :keep] if keep != x.shape[1] else x


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis after the channel axis: [B, C, ...] -> [B, C]."""
    return x.mean(dim=tuple(range(2, x.ndim)))


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=tuple(range(2, x.ndim)))


@contextlib.contextmanager
def collect_batch_stats(module: nn.Module):
    """Inside, each train-mode BatchNorm of ``module`` appends the (mean,
    biased variance) it normalised with, in at least float32, to its
    list in the yielded ``{BatchNorm: list}``, and leaves its running
    statistics alone."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    stats = {m: [] for m in layers}
    for m in layers:
        m.batch_stats = stats[m]
    try:
        yield stats
    finally:
        for m in layers:
            m.batch_stats = None


def use_mesh(module: nn.Module, mesh) -> None:
    """Hand a data-parallel ``Mesh`` (or None) to every BatchNorm and
    Dropout of ``module``."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every layer of ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense, BatchNorm)):
            m.reset_parameters(generator)
