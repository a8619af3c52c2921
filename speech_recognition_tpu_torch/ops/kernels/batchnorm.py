"""Train-mode BatchNorm in hand-written CUDA kernels: the wrapper, its
plain twin and the autograd function.

Replaces no TPU kernel: the JAX package's BatchNorm is flax's, which XLA
fuses. On one rank the port's ``models/layers.py::BatchNorm`` took the
batch statistics twice on a card, ``torch.var_mean`` over an f32 copy of
the activation for the running statistics and again inside ATen's
``F.batch_norm``. The kernels (``csrc/batchnorm.cu``) take them once, in
f32, from the activation in its own dtype, and serve both the
normalisation and the running statistics; two launches a direction.

For x [B, C, *spatial] (T = the spatial elements, 1 for [B, C]), per
channel c over the N = B T elements of its batch and steps, with the
pivot K = x[0, c, 0...]::

    S1 = sum (x - K),  S2 = sum (x - K)^2              (f32)
    mean = K + S1 / N,  var = max(S2 / N - (S1 / N)^2, 0)   (biased)
    invstd = 1 / sqrt(var + eps)
    y = (x - mean) invstd gamma + beta                  (in x's dtype)

    dbeta = sum dy,  dgamma = invstd sum dy (x - mean)
    dx = gamma invstd (dy - dbeta / N - (x - mean) invstd dgamma / N)

``bn_forward`` and ``bn_backward`` launch the kernels for CUDA tensors
and run their plain versions (``bn_forward_plain``, ``bn_backward_plain``:
the same arithmetic in PyTorch, on any device) only for CPU tensors; on a
card they never fall back. Every launch is on the current stream, with
outputs and scratch from ``torch.empty`` and no host sync, so a CUDA
graph captures it. Runs count as ``bn_fw_stats``, ``bn_fw_apply``,
``bn_bw_reduce`` and ``bn_bw_dx`` in ``launch.runs()``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from speech_recognition_tpu_torch.ops.kernels.launch import (
    I, I64, P, aligned, launch, library, ptr,
)

# row groups of the kernels' partial sums, [min(ROW_GROUPS, B), 2, C]
ROW_GROUPS = 8
# x's dtypes on a card, by the kernels' code for them (weight and bias are
# float32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPES)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The statistics' dtype: float32, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 2))


def _dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.ndim))


def bn_forward_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """Plain PyTorch version of the forward kernels: ``(y, mean, var,
    invstd)``, the statistics in at least float32 from shifted sums."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    n = x.numel() // x.shape[1]
    pivot = xf[(0, slice(None)) + (0,) * (x.ndim - 2)]
    d = xf - _per_channel(pivot, x.ndim)
    m1 = d.sum(_dims(x)) / n
    mean = pivot + m1
    var = torch.clamp(d.square().sum(_dims(x)) / n - m1 * m1, min=0.0)
    invstd = 1.0 / torch.sqrt(var + eps)
    scale = invstd * weight.to(acc)
    y = ((xf - _per_channel(mean, x.ndim)) * _per_channel(scale, x.ndim)
         + _per_channel(bias.to(acc), x.ndim))
    return y.to(x.dtype), mean, var, invstd


def bn_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor, mean: torch.Tensor,
                      invstd: torch.Tensor):
    """Plain PyTorch version of the backward kernels: ``(dx, dweight,
    dbias)``, dx in x's dtype, the others in the statistics' dtype."""
    acc = mean.dtype
    xm = x.to(acc) - _per_channel(mean, x.ndim)
    g = dy.to(acc)
    n = x.numel() // x.shape[1]
    dbias = g.sum(_dims(x))
    dweight = (g * xm).sum(_dims(x)) * invstd
    a = weight.to(acc) * invstd
    k = invstd * (dweight / n)
    dx = _per_channel(a, x.ndim) * (
        g - _per_channel(dbias / n, x.ndim) - xm * _per_channel(k, x.ndim))
    return dx.to(x.dtype), dweight, dbias


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """(B, C, T) of x; raises ValueError on what the kernels (on a card)
    or the plain versions (on the CPU) do not take."""
    if x.ndim < 2 or 0 in x.shape:
        raise ValueError(f"x must be [B, C, ...] with no empty axis, got "
                         f"{tuple(x.shape)}")
    b, c = x.shape[:2]
    t = x.numel() // (b * c)
    for name, v in (("weight", weight), ("bias", bias)):
        if v is None:
            continue
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cuda":
        if x.dtype not in _DTYPES:
            raise ValueError(f"the kernels take x in {list(_DTYPES)}, got "
                             f"{x.dtype}")
        for name, v in (("weight", weight), ("bias", bias)):
            if v is not None and (v.dtype != torch.float32
                                  or not v.is_contiguous()):
                raise ValueError(f"{name} must be contiguous float32")
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
    elif x.device.type == "cpu":
        if not x.is_floating_point():
            raise ValueError(f"x must be floating point, got {x.dtype}")
    else:
        raise ValueError(f"the BatchNorm kernels run on cuda or cpu, not "
                         f"{x.device}")
    return b, c, t


def bn_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float):
    """Train-mode BatchNorm of x [B, C, ...] with weight and bias [C]:
    ``(y, mean, var, invstd)``, y in x's dtype, the batch statistics
    (biased variance) and 1 / sqrt(var + eps) in float32 (float64 for a
    float64 x on the CPU)."""
    b, c, t = _check(x, weight, bias)
    if x.device.type == "cpu":
        return bn_forward_plain(x, weight, bias, eps)
    rg = min(ROW_GROUPS, b)
    part = torch.empty((rg, 2, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    mean, var, invstd = (torch.empty(c, dtype=torch.float32, device=x.device)
                         for _ in range(3))
    _launch("bn_fw_stats", x, ptr(x), ptr(part), b, c, t, rg)
    _launch("bn_fw_apply", x, ptr(x), ptr(part), ptr(weight), ptr(bias),
            ptr(y), ptr(mean), ptr(var), ptr(invstd), b, c, t, rg,
            float(eps))
    return y, mean, var, invstd


def bn_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                mean: torch.Tensor, invstd: torch.Tensor):
    """The gradients of ``bn_forward``'s y: ``(dx, dweight, dbias)``, dx
    in x's dtype (dy is taken in it), the others in the statistics'
    dtype."""
    b, c, t = _check(x, weight, None)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    if x.device.type == "cpu":
        return bn_backward_plain(dy, x, weight, mean, invstd)
    dy = aligned(dy.to(x.dtype))
    rg = min(ROW_GROUPS, b)
    part = torch.empty((rg, 2, c), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dweight, dbias = (torch.empty(c, dtype=torch.float32, device=x.device)
                      for _ in range(2))
    _launch("bn_bw_reduce", x, ptr(x), ptr(dy), ptr(mean), ptr(part), b, c,
            t, rg)
    _launch("bn_bw_dx", x, ptr(x), ptr(dy), ptr(part), ptr(mean),
            ptr(invstd), ptr(weight), ptr(dx), ptr(dweight), ptr(dbias), b,
            c, t, rg)
    return dx, dweight, dbias


class BatchNormFunction(torch.autograd.Function):
    """``apply(x, weight, bias, eps, plain=False) -> (y, mean, var)``:
    ``bn_forward``, or with ``plain`` its plain version on any device,
    differentiable in x, weight and bias through ``bn_backward`` (or its
    plain version); mean and var carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, plain=False):
        fwd = bn_forward_plain if plain else bn_forward
        y, mean, var, invstd = fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.plain = plain
        ctx.mark_non_differentiable(mean, var)
        # no zero gradients made for mean and var: only y's reaches here
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        bwd = bn_backward_plain if ctx.plain else bn_backward
        dx, dweight, dbias = bwd(dy, x, weight, mean, invstd)
        return (dx, dweight.to(weight.dtype), dbias.to(weight.dtype), None,
                None)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """Train-mode BatchNorm through the kernels (the plain versions for a
    CPU tensor): ``(y, mean, var)``, differentiable in x, weight and
    bias."""
    return BatchNormFunction.apply(x, weight, bias, eps)


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float):
    """``batch_norm_train``'s plain twin on any device: the same
    arithmetic in PyTorch, forward and backward."""
    return BatchNormFunction.apply(x, weight, bias, eps, True)


def _launch(entry: str, x: torch.Tensor, *args) -> None:
    """Launch ``csrc/batchnorm.cu``'s ``entry`` for x's dtype."""
    lib = library("batchnorm", _ENTRIES, error="bn_error_string")
    launch(lib, entry, x.device, _DTYPES[x.dtype], *args, kernel=entry)


_ENTRIES = {
    "bn_fw_stats": [I, P, P] + [I64] * 4 + [P],
    "bn_fw_apply": [I] + [P] * 8 + [I64] * 4 + [ctypes.c_double, P],
    "bn_bw_reduce": [I] + [P] * 4 + [I64] * 4 + [P],
    "bn_bw_dx": [I] + [P] * 9 + [I64] * 4 + [P],
}
