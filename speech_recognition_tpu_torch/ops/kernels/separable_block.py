"""Fused separable block, forward and backward: the CUDA kernels'
wrappers, their plain versions, the autograd function and the ATen
baseline.

Replaces, in ``speech_recognition_tpu/ops/pallas/experiments/
separable_kernel.py``, ``fused_separable_block`` (kernel source
``csrc/separable_block.cu``), ``_fused_block_bwd_pallas`` (source
``csrc/separable_block_bwd.cu``) and ``fused_separable_block_vjp``
(``SeparableBlockFunction``). One DepthwiseConvBlock's convolutions in
one pass::

    xin = relu6(x * a + b)            # optional prologue: the previous BN
    y   = pointwise(depthwise(xin))   # k taps, stride 1 or 2, SAME or VALID
    s1, s2 = sum(y), sum(y * y)       # per channel: this block's BN stats

The public functions keep the JAX layouts: x [B, T, Cin], w_dw [k, 1,
Cin], w_pw [1, Cin, Cout]. ``fused_separable_block`` and
``separable_block_bwd`` launch their kernels for CUDA tensors and use
their plain versions only for CPU tensors; on a card they never fall
back. ``reference_block`` is what the port's ``DepthwiseConvBlock`` runs
today (ATen / cuDNN convolutions), the benchmark's baseline. The plain
versions also take float64 on the CPU (for ``gradcheck``); the wrappers
take bfloat16 and float32 only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels import build

# Kernel launches in this process: ``fused_separable_block`` by variant,
# "fold" (``fold_weights=True``) and "fuse"; ``separable_block_bwd`` as
# "bwd".
LAUNCHES = {"fuse": 0, "fold": 0, "bwd": 0}

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
MAX_FWD_TAPS = 1024           # csrc/separable_block.cu: kMaxTaps
MAX_BWD_TAPS = 8              # csrc/separable_block_bwd.cu: kMaxTaps
_MAX_NUMEL = 2 ** 31 - 1      # the kernels' offsets are 32-bit


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Type of the sums and products the kernels take in f32: float32,
    or float64 for float64 inputs (plain versions only)."""
    return torch.promote_types(dtype, torch.float32)


def _in_compute(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to f32 (as the kernels take a and b), then to
    ``dtype``."""
    return v.to(_acc(dtype)).to(dtype)


def out_len(t: int, k: int, stride: int, padding: str) -> Tuple[int, int]:
    """(output length, low pad) of a k-tap conv under lax padding rules."""
    if padding == "SAME":
        return -(-t // stride), same_pad_amount(t, k, stride)[0]
    if padding == "VALID":
        return (t - k) // stride + 1, 0
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def fold_weights_of(w_dw: torch.Tensor, w_pw: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``W_i = diag(w_dw[i]) @ w_pw``: [k, Cin, Cout], products in f32,
    rounded once to ``dtype``."""
    k, _, cin = w_dw.shape
    if w_dw.dtype == w_pw.dtype == dtype:
        # one elementwise op: PyTorch multiplies in f32 (or dtype, if
        # wider) and rounds once to dtype, and a product of two bf16
        # values is exact in f32, so this is the same rounding
        return w_dw.reshape(k, cin, 1) * w_pw.reshape(1, cin, -1)
    acc = _acc(dtype)
    return (w_dw.reshape(k, cin, 1).to(acc)
            * w_pw.reshape(1, cin, -1).to(acc)).to(dtype)


def reference_block(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
                    a: Optional[torch.Tensor] = None,
                    b: Optional[torch.Tensor] = None, *, stride: int = 1,
                    padding: str = "VALID"):
    """ATen twin of JAX ``reference_block``: the prologue in f32, then a
    grouped ``conv1d`` and the pointwise ``conv1d`` in x's dtype.
    Returns ``(y, s1, s2)``, the sums taken in f32."""
    if a is not None:
        x = torch.clamp(x.float() * a + b, 0.0, 6.0).to(x.dtype)
    k, _, cin = w_dw.shape
    xc = x.transpose(1, 2)                                   # [B, Cin, T]
    if padding == "SAME":
        xc = F.pad(xc, same_pad_amount(x.shape[1], k, stride))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    dw = F.conv1d(xc, w_dw.to(x.dtype).permute(2, 1, 0), stride=stride,
                  groups=cin)
    y = F.conv1d(dw, w_pw.to(x.dtype).permute(2, 1, 0)).transpose(1, 2)
    yf = y.float()
    return y, yf.sum((0, 1)), (yf * yf).sum((0, 1))


def separable_block_plain(x: torch.Tensor, w_dw: torch.Tensor,
                          w_pw: torch.Tensor,
                          a: Optional[torch.Tensor] = None,
                          b: Optional[torch.Tensor] = None, *,
                          stride: int = 1, padding: str = "VALID",
                          emit_stats: bool = True,
                          fold_weights: bool = True):
    """Plain PyTorch version of the kernel, in its order of operations and
    with its rounding points (see ``csrc/separable_block.cu``)."""
    cdt, acc = x.dtype, _acc(x.dtype)
    y = _pointwise_sum(x, w_dw, w_pw, a, b, stride, padding,
                       fold_weights).to(cdt)
    if not emit_stats:
        return y
    return y, y.to(acc).sum((0, 1)), (y * y).to(acc).sum((0, 1))


def _pointwise_sum(x, w_dw, w_pw, a, b, stride, padding, fold_weights,
                   absolute: bool = False,
                   acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version's y before its last rounding: the sum over
    (tap, Cin) of the folded products (``fold``) or over Cin of dw x w_pw
    (``fuse``), in the accumulation type (or ``acc``). ``absolute`` sums
    the same terms' absolute values instead."""
    cdt, acc = x.dtype, acc or _acc(x.dtype)
    _, t, cin = x.shape
    k = w_dw.shape[0]
    t_out, pad_lo = out_len(t, k, stride, padding)
    mag = torch.abs if absolute else (lambda v: v)
    if a is not None:
        x = torch.clamp(x * _in_compute(a, cdt) + _in_compute(b, cdt), 0, 6)
    if fold_weights:
        taps = _taps(x, k, stride, pad_lo, t_out)            # [B, To, Cin]
        w = mag(fold_weights_of(w_dw, w_pw, cdt).to(acc))
        y = mag(taps[0].to(acc)) @ w[0]
        for i in range(1, k):
            y = y + mag(taps[i].to(acc)) @ w[i]
        return y
    dw = _depthwise_fuse(x, w_dw, stride, pad_lo, t_out)
    return mag(dw.to(acc)) @ mag(w_pw.reshape(cin, -1).to(cdt).to(acc))


def sum_terms(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
              a: Optional[torch.Tensor] = None,
              b: Optional[torch.Tensor] = None, *, stride: int = 1,
              padding: str = "VALID", fold_weights: bool = True):
    """The plain version's last sum, for the report of an element where
    the kernel's y disagrees: ``(y before its rounding, the sum of its
    terms' absolute values, the sum in float64, the number of terms n)``,
    each [B, To, Cout], the first two in the accumulation type. The terms
    are products of two values of x's dtype, exact in f32 for bf16
    inputs, so the float64 sum stands for the exact one."""
    k, _, cin = w_dw.shape
    args = (x, w_dw, w_pw, a, b, stride, padding, fold_weights)
    return (_pointwise_sum(*args), _pointwise_sum(*args, absolute=True),
            _pointwise_sum(*args, acc=torch.float64),
            k * cin if fold_weights else cin)


def _taps(xin: torch.Tensor, k: int, stride: int, pad_lo: int,
          t_out: int):
    """The k tap views ``xp[:, t * stride + i]`` [B, To, Cin] of the
    zero-padded ``xin``: padding after the prologue, so a padded row is
    0, not relu6(b)."""
    hi = max((t_out - 1) * stride + k - xin.shape[1] - pad_lo, 0)
    xp = F.pad(xin, (0, 0, pad_lo, hi))
    span = (t_out - 1) * stride + 1
    return [xp[:, i:i + span:stride] for i in range(k)]


def _depthwise_fuse(xin, w_dw, stride, pad_lo, t_out):
    """The depthwise output in the compute type, each tap product and
    each running sum rounded to it (the ``fuse`` chain)."""
    k, _, cin = w_dw.shape
    wdw = w_dw.reshape(k, cin).to(xin.dtype)
    taps = _taps(xin, k, stride, pad_lo, t_out)
    dw = taps[0] * wdw[0]
    for i in range(1, k):
        dw = dw + taps[i] * wdw[i]
    return dw


def separable_block_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                              dy: torch.Tensor, ds1: torch.Tensor,
                              ds2: torch.Tensor, w_dw: torch.Tensor,
                              w_pw: torch.Tensor,
                              a: Optional[torch.Tensor] = None,
                              b: Optional[torch.Tensor] = None, *,
                              stride: int, padding: str):
    """Plain PyTorch version of the backward kernel, in its order of
    operations and with its rounding points (see
    ``csrc/separable_block_bwd.cu``).

    ``y`` is the block's rounded output (the forward's residual); ``dy``,
    ``ds1``, ``ds2`` are the cotangents of y, s1 and s2. Returns ``(dx,
    dw_dw [k, Cin], dw_pw [Cin, Cout], da, db)``: dx in x's dtype, the
    rest float32 (float64 for float64 inputs); da and db are None
    without the prologue. The depthwise output is recomputed with the
    ``fuse`` chain whatever variant ran forward, as the TPU kernel does.
    """
    cdt, acc = x.dtype, _acc(x.dtype)
    bsz, t, cin = x.shape
    k, cout = w_dw.shape[0], w_pw.shape[2]
    t_out, pad_lo = out_len(t, k, stride, padding)
    wdw = w_dw.reshape(k, cin).to(cdt)
    wpw = w_pw.reshape(cin, cout).to(cdt)
    xin = x
    if a is not None:
        a_s = _in_compute(a, cdt)
        pre = x * a_s + _in_compute(b, cdt)
        xin = torch.clamp(pre, 0, 6)
    taps = _taps(xin, k, stride, pad_lo, t_out)
    dw = _depthwise_fuse(xin, w_dw, stride, pad_lo, t_out)
    # the cotangent of y with the statistics' parts: s1 = sum(y) and
    # s2 = sum(y^2) give dy + ds1 + 2 y ds2, in f32, rounded once
    dyt = (dy.to(acc) + ds1.to(acc) + 2 * y.to(acc) * ds2.to(acc)).to(cdt)
    dw_pw = dw.reshape(-1, cin).to(acc).T @ dyt.reshape(-1, cout).to(acc)
    ddw = (dyt.to(acc) @ wpw.to(acc).T).to(cdt)               # [B, To, Cin]
    dw_dw = torch.stack([(tap * ddw).to(acc).sum((0, 1)) for tap in taps])
    # transposed depthwise conv: padded row t * stride + i takes
    # ddw[t] * w_dw[i], taps added in ascending order, each rounded; the
    # rows no tap reads (VALID with T - k odd at stride 2) stay 0
    span = (t_out - 1) * stride + 1
    dxp = x.new_zeros((bsz, max(span + k - 1, pad_lo + t), cin))
    for i in range(k):
        dxp[:, i:i + span:stride] += ddw * wdw[i]
    dxin = dxp[:, pad_lo:pad_lo + t]
    if a is None:
        return dxin.contiguous(), dw_dw, dw_pw, None, None
    # relu6's gradient with a strict mask: 0 where pre is exactly 0 or 6
    dpre = torch.where((pre > 0) & (pre < 6), dxin, torch.zeros_like(dxin))
    return (dpre * a_s, dw_dw, dw_pw, (dpre * x).to(acc).sum((0, 1)),
            dpre.to(acc).sum((0, 1)))


def _check(x, w_dw, w_pw, a, b, stride, padding, grads=None) -> None:
    if x.ndim != 3 or x.dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"x must be [B, T, Cin] bfloat16 or float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    _, t, cin = x.shape
    if w_dw.ndim != 3 or w_dw.shape[1:] != (1, cin):
        raise ValueError(f"w_dw must be [k, 1, {cin}], got "
                         f"{tuple(w_dw.shape)}")
    if w_pw.ndim != 3 or w_pw.shape[:2] != (1, cin):
        raise ValueError(f"w_pw must be [1, {cin}, Cout], got "
                         f"{tuple(w_pw.shape)}")
    if (a is None) != (b is None):
        raise ValueError("a and b are given together or not at all")
    named = [("w_dw", w_dw), ("w_pw", w_pw)]
    if a is not None:
        named += [("a", a), ("b", b)]
        for name, v in (("a", a), ("b", b)):
            if v.shape != (cin,):
                raise ValueError(f"{name} must be [{cin}], got "
                                 f"{tuple(v.shape)}")
    for name, v in named:
        if not v.is_floating_point():
            raise ValueError(f"{name} must be floating point, got {v.dtype}")
    for name, v in [("x", x)] + named:
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")
    t_out, _ = out_len(t, w_dw.shape[0], stride, padding)
    if t_out < 1:
        raise ValueError(f"no output: T={t}, k={w_dw.shape[0]}, "
                         f"stride={stride}, {padding}")
    cout = w_pw.shape[2]
    if grads is not None:
        y, dy, ds1, ds2 = grads
        out = (x.shape[0], t_out, cout)
        if y.shape != out or y.dtype != x.dtype:
            raise ValueError(f"y must be {x.dtype} {out}, got {y.dtype} "
                             f"{tuple(y.shape)}")
        for name, v, shape in (("dy", dy, out), ("ds1", ds1, (cout,)),
                               ("ds2", ds2, (cout,))):
            if v.shape != shape or not v.is_floating_point():
                raise ValueError(f"{name} must be floating point {shape}, "
                                 f"got {v.dtype} {tuple(v.shape)}")
        for name, v in (("y", y), ("dy", dy), ("ds1", ds1), ("ds2", ds2)):
            if v.device != x.device:
                raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    for size in (x.numel(), x.shape[0] * t_out * cout,
                 w_dw.shape[0] * cin * cout):
        if size > _MAX_NUMEL:
            raise ValueError(f"a tensor of {size} elements exceeds the "
                             f"kernel's 32-bit offsets")


def fused_separable_block(x: torch.Tensor, w_dw: torch.Tensor,
                          w_pw: torch.Tensor,
                          a: Optional[torch.Tensor] = None,
                          b: Optional[torch.Tensor] = None, *,
                          stride: int = 1, padding: str = "VALID",
                          emit_stats: bool = True, fold_weights: bool = True):
    """relu6(a*x+b) -> depthwise k-tap conv -> 1x1 pointwise, one pass.

    Returns ``(y, s1, s2)``: y [B, To, Cout] in x's dtype (bfloat16 or
    float32), s1 and s2 [Cout] float32 the per-channel sum and sum of
    squares of the rounded y. With ``emit_stats=False`` returns y alone.
    Without ``a`` and ``b`` the prologue is the identity. ``fold_weights``
    runs the taps as k products with ``W_i = diag(w_dw[i]) @ w_pw``
    (never rounding the depthwise intermediate); otherwise the depthwise
    sum is rounded to x's dtype tap by tap, then multiplied by w_pw. The
    kernel takes at most ``MAX_FWD_TAPS`` taps.
    """
    _check(x, w_dw, w_pw, a, b, stride, padding)
    kw = dict(stride=stride, padding=padding, emit_stats=emit_stats,
              fold_weights=fold_weights)
    if x.device.type == "cpu":
        return separable_block_plain(x, w_dw, w_pw, a, b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_separable_block runs on cuda or cpu, not "
                         f"{x.device}")
    cdt = x.dtype
    batch, t, cin = x.shape
    k, cout = w_dw.shape[0], w_pw.shape[2]
    if k > MAX_FWD_TAPS:
        raise ValueError(f"the forward kernel takes at most {MAX_FWD_TAPS} "
                         f"taps, got {k}")
    t_out, pad_lo = out_len(t, k, stride, padding)
    # the weights in the compute dtype, built outside the kernel as JAX
    # builds them outside its pallas_call; the kernel reads x, the weights
    # and y 4 to 16 bytes at a time
    x = _aligned(x)
    wdw = _aligned(w_dw.reshape(k, cin).to(cdt).contiguous())
    w = _aligned((fold_weights_of(w_dw, w_pw, cdt) if fold_weights
                  else w_pw.reshape(cin, cout).to(cdt)).contiguous())
    if a is not None:
        a = a.float().contiguous()
        b = b.float().contiguous()
    y = torch.empty((batch, t_out, cout), dtype=cdt, device=x.device)
    # the kernel's entry zeroes the statistics before it adds into them
    stats = (torch.empty((2, cout), dtype=torch.float32, device=x.device)
             if emit_stats else None)
    _launch("separable_block", x, x.data_ptr(), _ptr(a), _ptr(b),
            wdw.data_ptr(), w.data_ptr(), y.data_ptr(), _ptr(stats), batch,
            t, cin, cout, k, stride, pad_lo, t_out, int(fold_weights))
    LAUNCHES["fold" if fold_weights else "fuse"] += 1
    if not emit_stats:
        return y
    return y, stats[0], stats[1]


def separable_block_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                        ds1: torch.Tensor, ds2: torch.Tensor,
                        w_dw: torch.Tensor, w_pw: torch.Tensor,
                        a: Optional[torch.Tensor] = None,
                        b: Optional[torch.Tensor] = None, *,
                        stride: int, padding: str):
    """Backward of ``fused_separable_block``: ``(dx, dw_dw [k, Cin],
    dw_pw [Cin, Cout], da, db)`` from the inputs, the rounded output y
    and the cotangents dy, ds1, ds2 of (y, s1, s2).

    dx is in x's dtype (bfloat16 or float32), the rest float32; da and db
    are None without the prologue. See ``separable_block_bwd_plain`` for
    the arithmetic, which the kernel follows rounding for rounding. The
    kernel takes at most ``MAX_BWD_TAPS`` taps.
    """
    _check(x, w_dw, w_pw, a, b, stride, padding, grads=(y, dy, ds1, ds2))
    dy = dy.contiguous()       # autograd may pass strided or expanded ones
    kw = dict(stride=stride, padding=padding)
    if x.device.type == "cpu":
        return separable_block_bwd_plain(x, y, dy, ds1, ds2, w_dw, w_pw, a,
                                         b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"separable_block_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    cdt = x.dtype
    batch, t, cin = x.shape
    k, cout = w_dw.shape[0], w_pw.shape[2]
    if k > MAX_BWD_TAPS:
        raise ValueError(f"the backward kernel takes at most {MAX_BWD_TAPS} "
                         f"taps, got {k}")
    t_out, pad_lo = out_len(t, k, stride, padding)
    if a is not None:
        a = a.float().contiguous()
        b = b.float().contiguous()
    # dy is read in the compute type or in f32, never rounded on the way
    if dy.dtype != cdt:
        dy = dy.float()
    # the kernels read these 4 to 16 bytes at a time
    x, wdw, wpw, y, dy, ds1, ds2 = (_aligned(v.contiguous()) for v in (
        x, w_dw.reshape(k, cin).to(cdt), w_pw.reshape(cin, cout).to(cdt), y,
        dy, ds1.float(), ds2.float()))
    dx = torch.empty_like(x)
    # the depthwise output and dyt, which the first kernel writes for the
    # second (ddw itself stays on chip)
    dw = torch.empty((batch * t_out, cin), dtype=cdt, device=x.device)
    dyt = torch.empty((batch * t_out, cout), dtype=cdt, device=x.device)
    # dw_dw, dw_pw, da, db: f32 sums the kernels add into with atomics
    sums = torch.zeros(k * cin + cin * cout + 2 * cin, dtype=torch.float32,
                       device=x.device)
    _launch("separable_block_bwd", x, x.data_ptr(), _ptr(a), _ptr(b),
            wdw.data_ptr(), wpw.data_ptr(), y.data_ptr(), dy.data_ptr(),
            int(dy.dtype != cdt), ds1.data_ptr(), ds2.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dyt.data_ptr(), sums.data_ptr(),
            batch, t, cin,
            cout, k, stride, pad_lo, t_out)
    LAUNCHES["bwd"] += 1
    dw_dw, dw_pw, da, db = sums.split([k * cin, cin * cout, cin, cin])
    if a is None:
        da = db = None
    return dx, dw_dw.view(k, cin), dw_pw.view(cin, cout), da, db


class SeparableBlockFunction(torch.autograd.Function):
    """The fused block with the backward kernel: ``apply(x, a, b, w_dw,
    w_pw, stride, padding) -> (y, s1, s2)``, the forward ``fold`` with
    the prologue and the statistics on."""

    @staticmethod
    def forward(ctx, x, a, b, w_dw, w_pw, stride, padding):
        y, s1, s2 = fused_separable_block(x, w_dw, w_pw, a, b, stride=stride,
                                          padding=padding, emit_stats=True,
                                          fold_weights=True)
        ctx.save_for_backward(x, a, b, w_dw, w_pw, y)
        ctx.conv = dict(stride=stride, padding=padding)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, a, b, w_dw, w_pw, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if ds1 is None or ds2 is None:
            zeros = y.new_zeros(y.shape[2], dtype=torch.float32)
            ds1 = zeros if ds1 is None else ds1
            ds2 = zeros if ds2 is None else ds2
        dx, dw_dw, dw_pw, da, db = separable_block_bwd(
            x, y, dy, ds1, ds2, w_dw, w_pw, a, b, **ctx.conv)
        return (dx, da.to(a.dtype), db.to(b.dtype),
                dw_dw.reshape(w_dw.shape).to(w_dw.dtype),
                dw_pw.reshape(w_pw.shape).to(w_pw.dtype), None, None)


def fused_separable_block_vjp(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, w_dw: torch.Tensor,
                              w_pw: torch.Tensor, stride: int, padding: str):
    """Differentiable fused block in the JAX argument order: ``(y, s1,
    s2)``, with gradients to all five tensors through
    ``separable_block_bwd``. The prologue is always on."""
    if a is None or b is None:
        raise ValueError("fused_separable_block_vjp needs a and b")
    return SeparableBlockFunction.apply(x, a, b, w_dw, w_pw, stride, padding)


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """``v``, or a copy of it if its data does not start on a 16-byte
    boundary (a view at an offset)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _ptr(v: Optional[torch.Tensor]) -> Optional[int]:
    return None if v is None else v.data_ptr()


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Call ``csrc/<name>.cu``'s entry for x's dtype on the current
    stream of x's device; raise if the launch was refused."""
    lib = _library(name)
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_{suffix}")(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the argument types of each source's bf16 and f32 entries
_ENTRY_ARGS = {
    "separable_block": [_P] * 7 + [_I64] * 8 + [ctypes.c_int, _P],
    "separable_block_bwd": [_P] * 7 + [ctypes.c_int] + [_P] * 6 + [_I64] * 8
    + [_P],
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``; one load per
    process."""
    lib = ctypes.CDLL(str(build.build(name)))
    for suffix in ("bf16", "f32"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _ENTRY_ARGS[name]
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib
