"""The 1-D depthwise convolution in hand-written CUDA kernels: the
wrapper, its plain twin and the autograd function.

Replaces no TPU kernel: the JAX package's depthwise conv is flax's
``nn.Conv`` with ``feature_group_count`` = C, which XLA compiles. The port
ran ATen's on a card (``models/layers.py::Conv``, still its path on the
CPU): an ``F.pad`` copy for SAME, then ``conv_depthwise2d``'s forward,
input-gradient and weight-gradient kernels. The kernels
(``csrc/dwconv1d.cu``) apply the pad themselves, and give both gradients
from one read of x and dy.

For x [B, C, T], w [C, 1, K] and zero pads (left, right), with x_pad the
padded row and T_out = (T + left + right - K) // s + 1 outputs::

    y[b, c, o]  = sum_j w[c, 0, j] x_pad[b, c, o s + j]
    dx[b, c, p] = sum of w[c, 0, j] dy[b, c, o] over o s + j = p + left
    dw[c, 0, j] = sum_b sum_o dy[b, c, o] x_pad[b, c, o s + j]

Sums in at least float32; y and dx in x's dtype, dw in w's (float32: the
master weights are read as they are).

``dwconv1d_forward`` and ``dwconv1d_backward`` launch the kernels for CUDA
tensors and run their plain twin (``dwconv1d_forward_plain``,
``dwconv1d_backward_plain``: explicit taps over the padded row, in
PyTorch, on any device) only for CPU tensors; on a card they never fall
back. The kernels take up to ``MAX_TAPS`` taps, any stride, and a float32
weight. Every launch is on the current stream, with outputs and the weight
gradient's partial sums from ``torch.empty`` and no host sync, so a CUDA
graph captures it. Runs count as ``dwconv1d_fw`` and ``dwconv1d_bw`` (the
backward's launch and its fixed-order merge of the partial sums) in
``launch.runs()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.ops.kernels.launch import (
    I, I64, P, aligned, launch, library, ptr,
)

# x's dtypes on a card, by the kernels' code for them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPES)
# the most taps the kernels take (csrc/dwconv1d.cu kMaxTaps)
MAX_TAPS = 5
# the most elements of x or y the kernels take (their positions are 32-bit)
MAX_ELEMENTS = 2 ** 31 - 1
# a tile: at most SLOTS outputs (kSlots); its x and dy runs of one batch
# row, each with room for a 16-byte vector either side, within STAGE_BYTES
# (kStageBytes)
SLOTS = 1024
STAGE_BYTES = 8192
# the backward's blocks: at most four on each of the H100's 132 SMs (what
# one wave holds: csrc/dwconv1d.cu kBwBlocks)
BACKWARD_BLOCKS = 4 * 132


def outputs(steps: int, taps: int, stride: int, left: int,
            right: int) -> int:
    """T_out of a row of ``steps`` padded by (left, right)."""
    return (steps + left + right - taps) // stride + 1


def plan(batch: int, channels: int, steps: int, outs: int, taps: int,
         stride: int, itemsize: int) -> Tuple[int, int, int, int]:
    """The kernels' tiling of a conv, from its shape alone: (cb, tt, per,
    parts): a tile is ``cb`` channels of an output slice of ``tt`` steps
    (a whole row, as many channels as fit in ``SLOTS`` outputs and in
    ``STAGE_BYTES`` of x and dy; a longer row cut into slices of one
    channel), a block takes ``per`` batch rows, so that at most
    ``BACKWARD_BLOCKS`` blocks fill the card in one wave, and the weight
    gradient comes in ``parts`` partial sums."""
    room = STAGE_BYTES // itemsize - 6 * (16 // itemsize)
    tt_max = min(SLOTS, (room - 3 * taps) // (stride + 1))
    if tt_max < 1:
        raise ValueError(f"the kernels take a stride of at most "
                         f"{room - 3 * taps - 1}, got {stride}")
    if outs <= tt_max:
        tt = outs
        cb = max(1, min(channels, SLOTS // outs, room // (steps + outs)))
        slices = 1
    else:
        tt, cb = tt_max, 1
        slices = -(-outs // tt)
    tiles = -(-channels // cb) * slices
    splits = min(batch, max(1, BACKWARD_BLOCKS // tiles))
    per = -(-batch // splits)
    return cb, tt, per, -(-batch // per) * slices


def _check(x: torch.Tensor, weight: torch.Tensor, stride: int, left: int,
           right: int, kernels: bool) -> Tuple[int, int, int, int, int]:
    """(B, C, T, K, T_out); raises ValueError on what the kernels (with
    ``kernels``, for a CUDA x) or the plain versions do not take."""
    if x.ndim != 3 or x.numel() == 0:
        raise ValueError(f"x must be [B, C, T] with no empty axis, got "
                         f"{tuple(x.shape)}")
    b, c, t = x.shape
    if weight.ndim != 3 or weight.shape[:2] != (c, 1):
        raise ValueError(f"the weight must be [{c}, 1, K], got "
                         f"{tuple(weight.shape)}")
    k = weight.shape[2]
    if stride < 1 or left < 0 or right < 0 or k < 1:
        raise ValueError(f"stride {stride}, pads ({left}, {right}), taps {k}")
    out = outputs(t, k, stride, left, right)
    if out < 1:
        raise ValueError(f"{k} taps are longer than the {t} steps of x and "
                         f"the pads ({left}, {right})")
    if x.device != weight.device:
        raise ValueError(f"x on {x.device}, the weight on {weight.device}")
    if not x.is_floating_point() or not weight.is_floating_point():
        raise ValueError(f"x and the weight must be floating point, got "
                         f"{x.dtype} and {weight.dtype}")
    if kernels and x.device.type == "cuda":
        if x.dtype not in _DTYPES:
            raise ValueError(f"the kernels take x in {list(_DTYPES)}, got "
                             f"{x.dtype}")
        if weight.dtype != torch.float32:
            raise ValueError(f"the kernels take a float32 weight, got "
                             f"{weight.dtype}")
        if k > MAX_TAPS:
            raise ValueError(f"the kernels take at most {MAX_TAPS} taps, "
                             f"got {k}")
        if left >= k or (out - 1) * stride - left >= t:
            raise ValueError(f"the kernels take pads that leave every "
                             f"window a tap in the row, got ({left}, "
                             f"{right}) for {k} taps over {t} steps")
        if b * c * t > MAX_ELEMENTS or b * c * out > MAX_ELEMENTS:
            raise ValueError(f"the kernels take at most {MAX_ELEMENTS} "
                             f"elements, x has {b * c * t}")
    elif kernels and x.device.type != "cpu":
        raise ValueError(f"the depthwise kernels run on cuda or cpu, not "
                         f"{x.device}")
    return b, c, t, k, out


def _taps(x: torch.Tensor, k: int, stride: int, left: int, right: int,
          out: int):
    """The padded row of x and the strided view of its tap j, for each j."""
    xp = F.pad(x, (left, right))
    span = (out - 1) * stride + 1
    return xp, [xp[..., j:j + span:stride] for j in range(k)]


def dwconv1d_forward_plain(x: torch.Tensor, weight: torch.Tensor,
                           stride: int, left: int,
                           right: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: y [B, C, T_out] in
    x's dtype, the taps summed in order in at least float32."""
    _, _, _, k, out = _check(x, weight, stride, left, right, False)
    acc = torch.promote_types(x.dtype, torch.float32)
    w = weight.to(acc)[:, 0, :, None]
    _, taps = _taps(x.to(acc), k, stride, left, right, out)
    y = torch.zeros_like(taps[0])
    for j, tap in enumerate(taps):
        y = y + w[:, j] * tap
    return y.to(x.dtype)


def dwconv1d_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                            weight: torch.Tensor, stride: int, left: int,
                            right: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: (dx in x's dtype,
    dw in the weight's), sums in at least float32."""
    b, c, t, k, out = _check(x, weight, stride, left, right, False)
    if tuple(dy.shape) != (b, c, out):
        raise ValueError(f"dy must be {(b, c, out)}, got {tuple(dy.shape)}")
    acc = torch.promote_types(x.dtype, torch.float32)
    w = weight.to(acc)[:, 0, :, None]
    g = dy.to(acc)
    xp, taps = _taps(x.to(acc), k, stride, left, right, out)
    dxp = torch.zeros_like(xp)
    span = (out - 1) * stride + 1
    dw = torch.empty((c, 1, k), dtype=acc, device=x.device)
    for j, tap in enumerate(taps):
        dxp[..., j:j + span:stride] += w[:, j] * g
        dw[:, 0, j] = (g * tap).sum(dim=(0, 2))
    return (dxp[..., left:left + t].to(x.dtype), dw.to(weight.dtype))


def dwconv1d_forward(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     left: int, right: int) -> torch.Tensor:
    """The depthwise conv of x [B, C, T] by weight [C, 1, K] at ``stride``
    over x padded by (left, right) zeros: y [B, C, T_out] in x's dtype."""
    b, c, t, k, out = _check(x, weight, stride, left, right, True)
    if x.device.type == "cpu":
        return dwconv1d_forward_plain(x, weight, stride, left, right)
    x = aligned(x)
    y = torch.empty((b, c, out), dtype=x.dtype, device=x.device)
    cb, tt, per, _ = plan(b, c, t, out, k, stride, x.element_size())
    _launch("dwconv1d_fw", x, ptr(x), ptr(weight.contiguous()), ptr(y), b, c,
            t, out, k, stride, left, cb, tt, per)
    return y


def dwconv1d_backward(dy: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor, stride: int, left: int,
                      right: int, input_grad: bool = True
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The gradients of ``dwconv1d_forward``'s y: (dx in x's dtype, or
    None without ``input_grad``; dw in the weight's float32). dy is taken
    in x's dtype. On a card one run is two launches, counted as one run
    of ``dwconv1d_bw`` by ``launch.runs``: the backward kernel, then
    ``dwconv1d_merge_kernel``, which sums the blocks' partial dw in a
    fixed order."""
    b, c, t, k, out = _check(x, weight, stride, left, right, True)
    if tuple(dy.shape) != (b, c, out):
        raise ValueError(f"dy must be {(b, c, out)}, got {tuple(dy.shape)}")
    if x.device.type == "cpu":
        dx, dw = dwconv1d_backward_plain(dy, x, weight, stride, left, right)
        return (dx if input_grad else None), dw
    x = aligned(x)
    dy = aligned(dy.to(x.dtype))
    dx = torch.empty_like(x) if input_grad else None
    cb, tt, per, parts = plan(b, c, t, out, k, stride, x.element_size())
    partial = torch.empty((parts, c, k), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((c, 1, k), dtype=torch.float32, device=x.device)
    _launch("dwconv1d_bw", x, ptr(x), ptr(dy), ptr(weight.contiguous()),
            ptr(dx), ptr(partial), ptr(dw), b, c, t, out, k, stride, left,
            cb, tt, per)
    return dx, dw


class DepthwiseConv1dFunction(torch.autograd.Function):
    """``apply(x, weight, stride, left, right) -> y``: ``dwconv1d_forward``,
    differentiable in x and the weight through ``dwconv1d_backward``."""

    @staticmethod
    def forward(ctx, x, weight, stride, left, right):
        y = dwconv1d_forward(x, weight, stride, left, right)
        ctx.save_for_backward(x, weight)
        ctx.args = (stride, left, right)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = dwconv1d_backward(dy, x, weight, *ctx.args,
                                   input_grad=ctx.needs_input_grad[0])
        return dx, (dw if ctx.needs_input_grad[1] else None), None, None, None


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     left: int, right: int) -> torch.Tensor:
    """The depthwise conv through the kernels (the plain twin for a CPU
    tensor), differentiable in x and the weight."""
    return DepthwiseConv1dFunction.apply(x, weight, stride, left, right)


def _launch(entry: str, x: torch.Tensor, *args) -> None:
    """Launch ``csrc/dwconv1d.cu``'s ``entry`` for x's dtype."""
    lib = library("dwconv1d", _ENTRIES, error="dwconv1d_error_string")
    launch(lib, entry, x.device, _DTYPES[x.dtype], *args, kernel=entry)


_ENTRIES = {
    "dwconv1d_fw": [I, P, P, P] + [I64] * 10 + [P],
    "dwconv1d_bw": [I, P, P, P, P, P, P] + [I64] * 10 + [P],
}
