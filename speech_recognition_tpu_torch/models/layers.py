"""Model blocks (port of speech_recognition_tpu/models/layers.py).

Layout: activations are NCW ([batch, channels, time]) inside the port,
or NCHW for the 2-D models, torch's convolution layout; the JAX package
is channels-last. ``models/convert.py`` moves weights between the two.

Parameters are created empty and filled by ``init_parameters`` from an
explicit ``torch.Generator`` (glorot-uniform kernels, or lecun-normal
where the JAX layer asks for it; orthogonal recurrent kernels; zero
biases; BN scale 1 / bias 0), so no layer draws from torch's global RNG.
Every random mask (Dropout, AlphaDropout, the GRU's) is drawn by
``keep_mask`` from the caller's generator.

Under data parallelism (``use_mesh``) BatchNorm takes its statistics over
the global batch and every mask is drawn at the global batch's shape,
so that a step on W ranks is the one-device step on the same batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

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


def preprocess_mfcc(x: torch.Tensor) -> torch.Tensor:
    """(x + 0.8) / 7 clipped to [-5, 5] (layers.py preprocess_mfcc, the
    reference's MFCC normalisation, model.py:13-16)."""
    return torch.clamp((x + 0.8) / 7.0, -5.0, 5.0)


SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


def selu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.selu``: scale * (x if x > 0 else alpha * expm1(x))."""
    return SELU_SCALE * torch.where(x > 0, x, SELU_ALPHA * torch.expm1(x))


Size = Union[int, Sequence[int]]


def _tuple(v: Size, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class Conv(nn.Module):
    """1-D or 2-D convolution with TF padding semantics and a
    glorot-uniform kernel (flax ``nn.Conv`` as the JAX package's ``Conv``
    uses it).

    ``kernel`` is an int (1-D, NCW) or a pair (2-D, NCHW); ``stride`` and
    ``dilation`` follow it. ``weight`` is [out, in/groups, *kernel];
    ``bias`` [out] with ``use_bias`` (off by default: every conv of the
    flagship is bias-free; heads, stems and the 2-D models take one).
    ``padding='same'`` pads each axis asymmetrically (TF SAME, left =
    total // 2) over its dilated span ``(k - 1) * dilation + 1``, which
    torch's own ``padding='same'`` cannot do at stride > 1.
    """

    KERNELS = ("weight",)      # the tensors flax names ``kernel``

    def __init__(self, in_channels: int, out_channels: int, kernel: Size,
                 stride: Size = 1, padding: str = "valid", groups: int = 1,
                 dilation: Size = 1, use_bias: bool = False):
        super().__init__()
        if padding.lower() not in ("valid", "same"):
            raise ValueError(f"padding must be 'valid' or 'same', got "
                             f"{padding!r}")
        kernel = _tuple(kernel, 1)
        if len(kernel) not in (1, 2):
            raise ValueError(f"kernel {kernel}: 1-D or 2-D only")
        self.kernel = kernel
        self.stride = _tuple(stride, len(kernel))
        self.dilation = _tuple(dilation, len(kernel))
        self.padding = padding.lower()
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *kernel))
        self.bias = (nn.Parameter(torch.empty(out_channels))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "same":
            pads = []               # F.pad takes the last axis first
            for axis in reversed(range(len(self.kernel))):
                span = (self.kernel[axis] - 1) * self.dilation[axis] + 1
                pads += same_pad_amount(x.shape[2 + axis], span,
                                        self.stride[axis])
            x = F.pad(x, pads)
        conv = F.conv1d if len(self.kernel) == 1 else F.conv2d
        return conv(x, self.weight, self.bias, stride=self.stride,
                    dilation=self.dilation, groups=self.groups)


class Dense(nn.Module):
    """Linear layer; ``weight`` is [out, in]. Its kernel is glorot-uniform,
    or flax's ``lecun_normal`` (a normal of variance 1/fan_in truncated
    at two standard deviations, rescaled to keep that variance) with
    ``init='lecun_normal'``, as the SNN's layers ask."""

    KERNELS = ("weight",)

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, init: str = "glorot_uniform"):
        super().__init__()
        if init not in ("glorot_uniform", "lecun_normal"):
            raise ValueError(f"unknown init {init!r}")
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init == "lecun_normal":
            # flax's truncated_normal stddev correction for [-2, 2]
            std = math.sqrt(1.0 / self.weight.shape[1]) / .87962566103423978
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        else:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over NCW or NCHW with flax/Keras semantics: statistics
    per channel (axis 1) over every other axis.

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
            var, mean = torch.var_mean(at_least_float32(x),
                                       dim=_non_channel_dims(x),
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
        dims = _non_channel_dims(x)
        per_channel = (-1,) + (1,) * (x.ndim - 2)
        count = xf.new_full((1,), x.numel() // x.shape[1])
        stats = all_reduce_sum(torch.cat([xf.sum(dims), count]), self.mesh)
        mean = stats[:-1] / stats[-1]
        d = xf - mean.reshape(per_channel)
        var = all_reduce_sum(d.square().sum(dims), self.mesh) / stats[-1]
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (d * scale.reshape(per_channel)
                + self.bias.reshape(per_channel)).to(x.dtype)


def _non_channel_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.ndim))


def keep_mask(shape: Sequence[int], rate: float,
              generator: torch.Generator, device: torch.device,
              mesh=None, batch_axis: int = 0) -> torch.Tensor:
    """A boolean mask of ``shape``, True with probability 1 - ``rate``,
    drawn from ``generator`` (flax's ``bernoulli(1 - rate)`` keep mask).

    With a ``mesh`` of more than one rank the mask is drawn at the global
    batch's shape (the batch on ``batch_axis``) and this rank keeps its
    rows of it, so every rank's generator stays in step and W ranks draw
    the one-device mask.
    """
    index = [slice(None)] * len(shape)
    if mesh is not None and mesh.size > 1:
        shape = list(shape)
        shape[batch_axis] *= mesh.size
        index[batch_axis] = mesh.rows(shape[batch_axis])
    keep = torch.rand(shape, generator=generator, device=device) >= rate
    return keep[tuple(index)]


class Dropout(nn.Module):
    """Dropout that draws its mask from an explicit ``torch.Generator``
    (``keep_mask``, at the global batch's shape under a ``mesh``).

    Inverted dropout as flax does it: kept values are scaled by 1/(1-p).
    Identity in eval mode or at p = 0.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.mesh = None

    def _keep(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit "
                             "torch.Generator")
        return keep_mask(x.shape, self.p, generator, x.device, self.mesh)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return x * self._keep(x, generator) / (1.0 - self.p)


class AlphaDropout(Dropout):
    """SELU-preserving dropout (layers.py AlphaDropout, Klambauer et al.
    2017; keras AlphaDropout as the SNN uses it, model.py:89): a dropped
    value becomes -alpha * scale, then a * x + b restores the mean and
    variance of a SELU activation."""

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        alpha_p = -SELU_ALPHA * SELU_SCALE
        a = 1.0 / math.sqrt((1.0 - self.p) * (1.0 + self.p * alpha_p ** 2))
        b = -a * alpha_p * self.p
        return a * torch.where(self._keep(x, generator), x, alpha_p) + b


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> activation (layers.py ConvBN), 1-D or 2-D as
    ``Conv`` is; bias-free unless ``use_bias``, relu6 unless another
    ``activation`` is given (``F.relu``, say). ``groups`` > 1 gives a
    grouped convolution, group j making output channels [j Cout/g,
    (j+1) Cout/g) from input channels [j Cin/g, (j+1) Cin/g), as flax's
    ``feature_group_count`` does."""

    def __init__(self, in_channels: int, features: int, kernel: Size,
                 stride: Size = 1, padding: str = "same", groups: int = 1,
                 dilation: Size = 1, use_bias: bool = False,
                 activation: Callable[[torch.Tensor], torch.Tensor] = relu6):
        super().__init__()
        if in_channels % groups or features % groups:
            raise ValueError(f"{in_channels} -> {features} channels do not "
                             f"split into {groups} groups")
        self.conv = Conv(in_channels, features, kernel, stride, padding,
                         groups, dilation, use_bias)
        self.bn = BatchNorm(features)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.bn(self.conv(x)))


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


def _max_pool_axis(x: torch.Tensor, pool: int, stride: int, padding: str,
                   dim: int) -> torch.Tensor:
    """Max pooling along axis ``dim`` of ``x`` as a chain of
    ``torch.maximum`` over strided slices (layers.py ``_max_pool_axis``).

    SAME pads with -inf, left = total // 2. The chain's gradient splits
    the cotangent between tied maxima, as the JAX pool's ``jnp.maximum``
    chain does; ``F.max_pool1d`` would give it all to the first.
    """
    dim %= x.ndim
    t = x.shape[dim]
    if padding.lower() == "same":
        out = -(-t // stride)
        pads = [0, 0] * (x.ndim - 1 - dim) + list(
            same_pad_amount(t, pool, stride))
        x = F.pad(x, pads, value=float("-inf"))
    else:
        out = (t - pool) // stride + 1
    last = (out - 1) * stride + 1

    def tap(i):
        return x[(slice(None),) * dim + (slice(i, i + last, stride),)]

    y = tap(0)
    for i in range(1, pool):
        y = torch.maximum(y, tap(i))
    return y


def max_pool_1d(x: torch.Tensor, pool: int = 3, stride: int = 2,
                padding: str = "valid") -> torch.Tensor:
    """Max pooling over the time axis of NCW ``x`` (``_max_pool_axis``)."""
    return _max_pool_axis(x, pool, stride, padding, -1)


def max_pool_2d(x: torch.Tensor, pool: Tuple[int, int] = (2, 2),
                stride: Optional[Tuple[int, int]] = None,
                padding: str = "valid") -> torch.Tensor:
    """Max pooling over H and W of NCHW ``x``, separably as layers.py
    ``max_pool_2d`` does it (the max over a rectangle is the max over its
    rows, then its columns): H, then W, each by ``_max_pool_axis``, so
    that ties split the gradient as JAX's do."""
    stride = stride or pool
    x = _max_pool_axis(x, pool[0], stride[0], padding, 2)
    return _max_pool_axis(x, pool[1], stride[1], padding, 3)


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


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard_sigmoid: clip(0.2 * x + 0.5, 0, 1) (not torch's
    ``hardsigmoid``, which is x / 6 + 1/2)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class GRU(nn.Module):
    """The Keras v1 GRU cell (layers.py GRU): ``reset_after=False``,
    hard_sigmoid gates, z and r from the input and the state, the
    candidate from the input and r * state, new state z * h + (1 - z) * hh.

    Input NCW [B, C, T]. Returns the last state [B, units], or with
    ``return_sequences`` every state as NCW [B, units, T]. ``reverse``
    runs from the last step to the first; its last state is the one after
    the first step, and its sequence is given back in the input's order.

    Parameters, in torch's [out, in] layout (flax's transposed):
    ``weight`` [3u, C] and ``bias`` [3u] (the z, r, h input projections),
    ``recurrent_weight_zr`` [2u, u] and ``recurrent_weight_h`` [u, u]
    (orthogonal at init, as Keras's).

    Train-mode ``dropout`` and ``recurrent_dropout`` are Keras 2.1's
    variational masks: three per-gate input masks (3, B, 1, C) and three
    recurrent masks (3, B, u), each drawn once per call from the caller's
    generator (input first, then recurrent) and held over every step.
    The input projection of all steps is one product per gate; the
    recurrence is a loop over time, since cuDNN's GRU has neither this
    cell nor these masks. Under bf16 autocast the projections come out
    in bf16, so the recurrent state is bf16 too, as the JAX bf16 recipe
    runs its whole scan in bf16.
    """

    KERNELS = ("weight", "recurrent_weight_zr", "recurrent_weight_h")

    def __init__(self, in_features: int, units: int,
                 return_sequences: bool = False, reverse: bool = False,
                 dropout: float = 0.0, recurrent_dropout: float = 0.0):
        super().__init__()
        self.units = units
        self.return_sequences = return_sequences
        self.reverse = reverse
        self.dropout = dropout
        self.recurrent_dropout = recurrent_dropout
        self.mesh = None
        self.weight = nn.Parameter(torch.empty(3 * units, in_features))
        self.bias = nn.Parameter(torch.empty(3 * units))
        self.recurrent_weight_zr = nn.Parameter(torch.empty(2 * units, units))
        self.recurrent_weight_h = nn.Parameter(torch.empty(units, units))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)
        nn.init.orthogonal_(self.recurrent_weight_zr, generator=generator)
        nn.init.orthogonal_(self.recurrent_weight_h, generator=generator)

    def _masks(self, shape, rate: float, generator, like: torch.Tensor):
        if generator is None:
            raise ValueError("train-mode GRU dropout needs an explicit "
                             "torch.Generator")
        keep = keep_mask(shape, rate, generator, like.device, self.mesh,
                         batch_axis=1)
        return keep.to(like.dtype) / (1.0 - rate)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        u = self.units
        x = x.transpose(1, 2)                          # [B, T, C]
        b, t, c = x.shape
        if self.training and self.dropout > 0.0:
            m = self._masks((3, b, 1, c), self.dropout, generator, x)
            xw = torch.cat([F.linear(x * m[i], self.weight[i * u:(i + 1) * u])
                            for i in range(3)], dim=-1) + self.bias
        else:
            xw = F.linear(x, self.weight, self.bias)   # [B, T, 3u]
        rm = None
        if self.training and self.recurrent_dropout > 0.0:
            rm = self._masks((3, b, u), self.recurrent_dropout, generator, x)
        w_z, w_r = self.recurrent_weight_zr[:u], self.recurrent_weight_zr[u:]
        h = xw.new_zeros(b, u)
        hs = []
        for step in (reversed(range(t)) if self.reverse else range(t)):
            xs = xw[:, step]
            hz, hr, hh = (h, h, h) if rm is None else (h * rm[0], h * rm[1],
                                                       h * rm[2])
            z = hard_sigmoid(xs[:, :u] + F.linear(hz, w_z))
            r = hard_sigmoid(xs[:, u:2 * u] + F.linear(hr, w_r))
            hh = torch.tanh(xs[:, 2 * u:]
                            + F.linear(r * hh, self.recurrent_weight_h))
            h = z * h + (1.0 - z) * hh
            hs.append(h)
        if not self.return_sequences:
            return h
        if self.reverse:
            hs.reverse()
        return torch.stack(hs, dim=2)                  # NCW [B, u, T]


class FlaxNamed(nn.Module):
    """A module whose layers carry the names flax gives the JAX module's:
    ``<Class>_<i>``, counted per class in creation order. ``add``
    registers a layer under its name and returns it, so each model or
    block creates its layers in the order its flax ``__call__`` does,
    and ``models/convert.py`` moves the weights with no table of its own.
    Subclasses keep their layers in plain lists (attributes that hold a
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


class BiGRU(FlaxNamed):
    """Bidirectional GRU, concat merge (layers.py BiGRU; model.py:148):
    ``GRU_0`` forward and ``GRU_1`` reverse, their outputs concatenated
    [forward, backward] on the channel axis."""

    def __init__(self, in_features: int, units: int,
                 return_sequences: bool = False, dropout: float = 0.0,
                 recurrent_dropout: float = 0.0):
        super().__init__()
        self.directions = [
            self.add(GRU(in_features, units, return_sequences, reverse,
                         dropout, recurrent_dropout))
            for reverse in (False, True)]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        return torch.cat([gru(x, generator) for gru in self.directions],
                         dim=1)


class Residual1D(FlaxNamed):
    """The reference's residual block (layers.py Residual1D,
    model.py:866-878) on NCW input: a strided ``Conv`` 1x1 SAME +
    ``BatchNorm`` shortcut when ``strides`` > 1 (created first, as in
    flax), two SAME ``DepthwiseConvBlock``s, a SAME max pool, and the add.

    ``pool_mode``: 'pool' pools 3 at the stride (raw-waveform trunks),
    'pool_eq_stride' pools ``strides`` at the stride (the log-mfcc
    trunk), 'stride_on_first_conv' puts the stride on the first block
    and does not pool (steffeNet).
    """

    POOL_MODES = ("pool", "pool_eq_stride", "stride_on_first_conv")

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 strides: int = 1, pool_mode: str = "pool"):
        super().__init__()
        if pool_mode not in self.POOL_MODES:
            raise ValueError(f"pool_mode {pool_mode!r}")
        if strides == 1 and in_channels != features:
            raise ValueError(f"an identity shortcut cannot take "
                             f"{in_channels} -> {features} channels")
        self.strides = strides
        self.pool_mode = pool_mode
        self.shortcut = []
        if strides != 1:
            self.shortcut = [
                self.add(Conv(in_channels, features, 1, strides, "same")),
                self.add(BatchNorm(features))]
        first = strides if pool_mode == "stride_on_first_conv" else 1
        self.blocks = [
            self.add(DepthwiseConvBlock(in_channels, features, kernel,
                                        "same", first)),
            self.add(DepthwiseConvBlock(features, features, kernel, "same"))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        for layer in self.shortcut:
            residual = layer(residual)
        for block in self.blocks:
            x = block(x)
        if self.pool_mode == "pool":
            x = max_pool_1d(x, 3, self.strides, "same")
        elif self.pool_mode == "pool_eq_stride":
            x = max_pool_1d(x, self.strides, self.strides, "same")
        return x + residual


# layers whose ``forward`` takes the caller's generator for its masks
RANDOM_LAYERS = (Dropout, GRU, BiGRU)


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
    """Hand a data-parallel ``Mesh`` (or None) to every BatchNorm,
    Dropout and GRU of ``module``."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, Dropout, GRU)):
            m.mesh = mesh


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every layer of ``module`` in registration order."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense, BatchNorm, GRU)):
            m.reset_parameters(generator)
