"""Max pooling along a tensor's last axis in hand-written CUDA kernels:
the wrapper, its plain twin and the autograd function.

Replaces no TPU kernel: the JAX package pools with a chain of
``jnp.maximum`` over strided slices, which XLA fuses. The port ran the
same chain eagerly on a card (``models/layers.py::_max_pool_axis``, still
its path on the CPU): a -inf pad, ``pool - 1`` ``torch.maximum`` over
strided views and autograd's derivative of each, 33 device activities a
pool and step. The kernels (``csrc/maxpool.cu``) give the chain's values
and its gradient in one launch a direction.

For x [..., T] (the leading axes flattened into R rows), window o of a
row covers the taps v_j = x[..., o s - left + j], j < pool, a tap outside
the row being -inf; SAME takes left = total // 2 (``same_pad_amount``)
and ceil(T / s) windows, VALID no pad::

    m_0 = v_0,  m_j = maximum(m_{j-1}, v_j),  y[..., o] = m_{pool-1}

where a NaN on either side wins. The gradient is the chain's: from the
last tap back, v_j gets the cotangent g reaching m_j where v_j >
m_{j-1}, g/2 where they are equal, 0 where it is less, and m_{j-1} the
rest likewise (both get g where either is NaN); tap 0 gets what reaches
m_0. So a tap gets w dy[..., o], w a product of 1, 1/2 and 0 (a
three-way tie in a window of 3 gives 1/4, 1/4, 1/2), and dx sums those
in at least float32 over the windows that cover it, in the order of its
tap index in them, and rounds once to x's dtype. A pad tap's share is
dropped.

``maxpool_forward`` and ``maxpool_backward`` launch the kernels for CUDA
tensors and run their plain twin (``maxpool_forward_plain``,
``maxpool_backward_plain``: the same gather arithmetic in PyTorch, on any
device) only for CPU tensors; on a card they never fall back. The kernels
take windows of at most ``MAX_POOL`` taps. Every launch is on the current
stream, with outputs from ``torch.empty`` and no host sync, so a CUDA
graph captures it. Runs count as ``maxpool1d_fw`` and ``maxpool1d_bw`` in
``launch.runs()``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels.launch import (
    I, I64, P, launch, library, ptr,
)

# x's dtypes on a card, by the kernels' code for them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPES)
# the most elements of x or y the kernels take (their positions are 32-bit)
MAX_ELEMENTS = 2 ** 31 - 1024
# the longest window the kernels take (csrc/maxpool.cu kMaxPool)
MAX_POOL = 5


def window(steps: int, pool: int, stride: int,
           padding: str) -> Tuple[int, int, int]:
    """(windows, left pad, right pad) of a row of ``steps`` pooled by
    ``pool`` at ``stride`` with ``padding`` ('same', or else 'valid', any
    case)."""
    if padding.lower() == "same":
        return (-(-steps // stride),) + same_pad_amount(steps, pool, stride)
    return (steps - pool) // stride + 1, 0, 0


def _check(x: torch.Tensor, pool: int, stride: int,
           padding: str) -> Tuple[int, int, int, int]:
    """(R, T, windows, left) of x; raises ValueError on what the kernels
    (on a card) or the plain versions (on the CPU) do not take."""
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"x must have a last axis to pool and no empty "
                         f"axis, got {tuple(x.shape)}")
    if padding.lower() not in ("same", "valid"):
        raise ValueError(f"padding must be 'same' or 'valid', got "
                         f"{padding!r}")
    if pool < 1 or stride < 1:
        raise ValueError(f"pool {pool} and stride {stride} must be >= 1")
    t = x.shape[-1]
    out, left, _ = window(t, pool, stride, padding)
    if out < 1:
        raise ValueError(f"a VALID window of {pool} is longer than the "
                         f"{t} steps of x")
    rows = x.numel() // t
    if x.device.type == "cuda":
        if x.dtype not in _DTYPES:
            raise ValueError(f"the kernels take x in {list(_DTYPES)}, got "
                             f"{x.dtype}")
        if pool > MAX_POOL:
            raise ValueError(f"the kernels take windows of at most "
                             f"{MAX_POOL} taps, got {pool}")
        if rows * t > MAX_ELEMENTS or rows * out > MAX_ELEMENTS:
            raise ValueError(f"the kernels take at most {MAX_ELEMENTS} "
                             f"elements, x has {rows * t}")
    elif x.device.type == "cpu":
        if not x.is_floating_point():
            raise ValueError(f"x must be floating point, got {x.dtype}")
    else:
        raise ValueError(f"the max-pool kernels run on cuda or cpu, not "
                         f"{x.device}")
    return rows, t, out, left


def _taps(x: torch.Tensor, pool: int, stride: int,
          padding: str) -> torch.Tensor:
    """The windows' taps of x [R, T] as [R, out, pool], -inf outside the
    row."""
    out, left, right = window(x.shape[-1], pool, stride, padding)
    xp = F.pad(x, (left, right), value=float("-inf"))
    return xp.unfold(-1, pool, stride)[:, :out]


def _maximum(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``torch.maximum(m, v)``'s value: a NaN wins, m's before v's."""
    return torch.where(torch.isnan(m) | ~(torch.isnan(v) | (v > m)), m, v)


def maxpool_forward_plain(x: torch.Tensor, pool: int, stride: int,
                          padding: str) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: y [..., windows] in
    x's dtype."""
    rows, t, out, _ = _check(x, pool, stride, padding)
    taps = _taps(x.reshape(rows, t), pool, stride, padding)
    m = taps[..., 0]
    for j in range(1, pool):
        m = _maximum(m, taps[..., j])
    return m.reshape(x.shape[:-1] + (out,))


def maxpool_backward_plain(dy: torch.Tensor, x: torch.Tensor, pool: int,
                           stride: int, padding: str) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dx in x's dtype from
    dy [..., windows], each tap's weight from the chain's derivative, the
    sums over windows in at least float32."""
    rows, t, out, left = _check(x, pool, stride, padding)
    acc = torch.promote_types(x.dtype, torch.float32)
    taps = _taps(x.reshape(rows, t), pool, stride, padding).to(acc)
    g = dy.reshape(rows, out).to(acc)
    # each step's factors: f_m for the running maximum, f_v for the tap
    m, f_m, f_v = taps[..., 0], [], []
    for j in range(1, pool):
        v = taps[..., j]
        tie = m == v
        f_m.append(torch.where(tie, 0.5, torch.where(m < v, 0.0, 1.0)))
        f_v.append(torch.where(tie, 0.5, torch.where(m > v, 0.0, 1.0)))
        m = _maximum(m, v)
    # tap i's weight: f_v of its step (1 for tap 0) times f_m of every
    # later step
    weights, later = [None] * pool, torch.ones_like(g)
    for i in range(pool - 1, 0, -1):
        weights[i] = f_v[i - 1] * later
        later = later * f_m[i - 1]
    weights[0] = later
    length = max(left + t, (out - 1) * stride + pool)
    dxp = torch.zeros((rows, length), dtype=acc, device=x.device)
    span = (out - 1) * stride + 1
    for i, w in enumerate(weights):
        dxp[:, i:i + span:stride] += torch.where(w == 0, 0.0, w * g)
    return dxp[:, left:left + t].to(x.dtype).reshape(x.shape)


def maxpool_forward(x: torch.Tensor, pool: int, stride: int,
                    padding: str) -> torch.Tensor:
    """Max pooling of x's last axis: y [..., windows] in x's dtype."""
    rows, t, out, left = _check(x, pool, stride, padding)
    if x.device.type == "cpu":
        return maxpool_forward_plain(x, pool, stride, padding)
    x = x.contiguous()
    y = torch.empty(x.shape[:-1] + (out,), dtype=x.dtype, device=x.device)
    _launch("maxpool1d_fw", x, ptr(x), ptr(y), rows, t, out, pool, stride,
            left)
    return y


def maxpool_backward(dy: torch.Tensor, x: torch.Tensor, pool: int,
                     stride: int, padding: str) -> torch.Tensor:
    """The gradient of ``maxpool_forward``'s y: dx in x's dtype (dy is
    taken in it)."""
    rows, t, out, left = _check(x, pool, stride, padding)
    if tuple(dy.shape) != tuple(x.shape[:-1]) + (out,):
        raise ValueError(f"dy must be {tuple(x.shape[:-1]) + (out,)}, got "
                         f"{tuple(dy.shape)}")
    if x.device.type == "cpu":
        return maxpool_backward_plain(dy, x, pool, stride, padding)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    _launch("maxpool1d_bw", x, ptr(x), ptr(dy), ptr(dx), rows, t, out,
            pool, stride, left)
    return dx


class MaxPoolFunction(torch.autograd.Function):
    """``apply(x, pool, stride, padding) -> y``: ``maxpool_forward``,
    differentiable in x through ``maxpool_backward``."""

    @staticmethod
    def forward(ctx, x, pool, stride, padding):
        y = maxpool_forward(x, pool, stride, padding)
        ctx.save_for_backward(x)
        ctx.args = (pool, stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return maxpool_backward(dy, x, *ctx.args), None, None, None


def max_pool_last(x: torch.Tensor, pool: int, stride: int,
                  padding: str) -> torch.Tensor:
    """Max pooling of x's last axis through the kernels (the plain twin
    for a CPU tensor), differentiable in x."""
    return MaxPoolFunction.apply(x, pool, stride, padding)


def _launch(entry: str, x: torch.Tensor, *args) -> None:
    """Launch ``csrc/maxpool.cu``'s ``entry`` for x's dtype."""
    lib = library("maxpool", _ENTRIES, error="maxpool_error_string")
    launch(lib, entry, x.device, _DTYPES[x.dtype], *args, kernel=entry)


_ENTRIES = {
    "maxpool1d_fw": [I, P, P] + [I64] * 6 + [P],
    "maxpool1d_bw": [I, P, P, P] + [I64] * 6 + [P],
}
