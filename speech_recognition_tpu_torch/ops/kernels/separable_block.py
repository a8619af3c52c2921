"""Fused separable block forward: the CUDA kernel's wrapper, its plain
version and the ATen baseline.

Replaces ``speech_recognition_tpu/ops/pallas/experiments/
separable_kernel.py::fused_separable_block`` (kernel source:
``csrc/separable_block.cu``). One DepthwiseConvBlock's convolutions in
one pass::

    xin = relu6(x * a + b)            # optional prologue: the previous BN
    y   = pointwise(depthwise(xin))   # k taps, stride 1 or 2, SAME or VALID
    s1, s2 = sum(y), sum(y * y)       # per channel: this block's BN stats

The public functions keep the JAX layouts: x [B, T, Cin], w_dw [k, 1,
Cin], w_pw [1, Cin, Cout]. ``fused_separable_block`` launches the kernel
for CUDA tensors and uses ``separable_block_plain`` only for CPU tensors;
on a card it never falls back. ``reference_block`` is what the port's
``DepthwiseConvBlock`` runs today (ATen / cuDNN convolutions), the
benchmark's baseline.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels import build

# Kernel launches made by ``fused_separable_block`` in this process, by
# variant: "fold" (``fold_weights=True``) and "fuse".
LAUNCHES = {"fuse": 0, "fold": 0}

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
_MAX_NUMEL = 2 ** 31 - 1      # the kernel's offsets are 32-bit


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
    return (w_dw.reshape(k, cin, 1).float()
            * w_pw.reshape(1, cin, -1).float()).to(dtype)


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
    cdt = x.dtype
    _, t, cin = x.shape
    k = w_dw.shape[0]
    t_out, pad_lo = out_len(t, k, stride, padding)
    if a is not None:
        x = torch.clamp(x * a.float().to(cdt) + b.float().to(cdt), 0, 6)
    # padding after the prologue: a padded row is 0, not relu6(b)
    hi = max((t_out - 1) * stride + k - t - pad_lo, 0)
    xp = F.pad(x, (0, 0, pad_lo, hi))
    span = (t_out - 1) * stride + 1
    taps = [xp[:, i:i + span:stride] for i in range(k)]     # [B, To, Cin]
    if fold_weights:
        w = fold_weights_of(w_dw, w_pw, cdt).float()
        y = taps[0].float() @ w[0]
        for i in range(1, k):
            y = y + taps[i].float() @ w[i]
    else:
        wdw = w_dw.reshape(k, cin).to(cdt)
        dw = taps[0] * wdw[0]
        for i in range(1, k):
            dw = dw + taps[i] * wdw[i]
        y = dw.float() @ w_pw.reshape(cin, -1).to(cdt).float()
    y = y.to(cdt)
    if not emit_stats:
        return y
    return y, y.float().sum((0, 1)), (y * y).float().sum((0, 1))


def _check(x, w_dw, w_pw, a, b, stride, padding) -> None:
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
    sum is rounded to x's dtype tap by tap, then multiplied by w_pw.
    """
    _check(x, w_dw, w_pw, a, b, stride, padding)
    kw = dict(stride=stride, padding=padding, emit_stats=emit_stats,
              fold_weights=fold_weights)
    if x.device.type == "cpu":
        return separable_block_plain(x, w_dw, w_pw, a, b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_separable_block runs on cuda or cpu, not "
                         f"{x.device}")
    lib = _library()
    cdt = x.dtype
    batch, t, cin = x.shape
    k, cout = w_dw.shape[0], w_pw.shape[2]
    t_out, pad_lo = out_len(t, k, stride, padding)
    # the weights in the compute dtype, built outside the kernel as JAX
    # builds them outside its pallas_call
    wdw = w_dw.reshape(k, cin).to(cdt).contiguous()
    w = (fold_weights_of(w_dw, w_pw, cdt) if fold_weights
         else w_pw.reshape(cin, cout).to(cdt)).contiguous()
    if a is not None:
        a = a.float().contiguous()
        b = b.float().contiguous()
    y = torch.empty((batch, t_out, cout), dtype=cdt, device=x.device)
    stats = (torch.zeros((2, cout), dtype=torch.float32, device=x.device)
             if emit_stats else None)
    entry = (lib.separable_block_bf16 if cdt == torch.bfloat16
             else lib.separable_block_f32)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), ptr(a), ptr(b), wdw.data_ptr(),
                    w.data_ptr(), y.data_ptr(), ptr(stats), batch, t, cin,
                    cout, k, stride, pad_lo, t_out, int(fold_weights),
                    stream)
    if err != 0:
        msg = lib.separable_block_error_string(err).decode()
        raise RuntimeError(f"separable_block launch failed: {msg} ({err})")
    LAUNCHES["fold" if fold_weights else "fuse"] += 1
    if not emit_stats:
        return y
    return y, stats[0], stats[1]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel; one load per process."""
    lib = ctypes.CDLL(str(build.build("separable_block")))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in (lib.separable_block_bf16, lib.separable_block_f32):
        fn.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64,
                       i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    lib.separable_block_error_string.argtypes = [ctypes.c_int]
    lib.separable_block_error_string.restype = ctypes.c_char_p
    return lib
