"""The Keras-v1 GRU's recurrence in one CUDA kernel a pass: the wrapper,
its plain twin and the autograd function.

Replaces no TPU kernel: the JAX package's GRU is a ``lax.scan``
(``speech_recognition_tpu/models/layers.py`` GRU), which XLA compiles into
one loop. The port's ``models/layers.py::GRU`` ran it as a Python loop
over time, ~20 ATen kernels a step and direction forward and ~60
backward: the chain of dependent small products, launched one by one,
bounded it. The kernels (``csrc/gru_recurrence.cu``) keep the chain on
chip: each block runs every step of 16 batch rows of one direction, the
recurrent weights in shared memory and registers, the state in f32
registers, the gates fused into the products' epilogues. Their floor is
then the bytes of the forward's saves, which the backward reads.

One direction, step by step (``reverse`` from the last step), with the
recurrent masks ``rm`` (3, B, u) or none::

    yz = 0.2 * (xz + (h * m0) @ W_z.T) + 0.5;   z = clip(yz, 0, 1)
    yr = 0.2 * (xr + (h * m1) @ W_r.T) + 0.5;   r = clip(yr, 0, 1)
    q  = r * (h * m2)
    hh = tanh(xh + q @ W_h.T)
    h  = z * h + (1 - z) * hh

The products' operands (the masked states and the weights) are in the
weights' dtype, bfloat16 under autocast (``mma.sync``, f32 sums) or
float32 (FFMA); the state, the gates and the sums are f32 whatever the
input projections' dtype. ``gru_forward`` and ``gru_backward`` launch the
kernels for CUDA tensors and run their plain versions
(``gru_forward_plain``, ``gru_backward_plain``: the same steps in PyTorch,
the backward written out) only for CPU tensors; on a card they never fall
back. Their runs count as ``gru_forward`` and ``gru_backward`` in
``launch.runs()``. The plain versions also take float64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from speech_recognition_tpu_torch.ops.kernels.launch import (
    I, I64, P, aligned, launch, library, ptr,
)

UNITS = (128, 192)                    # csrc/gru_recurrence.cu's builds
# (operand dtype, input projections' dtype) the kernels take
_DTYPES = ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.float32))


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The state's and the sums' dtype: float32, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _op(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to the operand dtype, held in its own."""
    return v.to(dtype).to(v.dtype)


def _time(s: int, steps: int, reverse: bool) -> int:
    return steps - 1 - s if reverse else s


def _hard_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The hard_sigmoid's gradient at its pre-activation y = 0.2 a + 0.5:
    0.2 where 0 <= y <= 1, both ends inclusive (``torch.clamp``'s)."""
    return torch.where((y >= 0) & (y <= 1), dy * 0.2, torch.zeros_like(dy))


def gru_forward_plain(xws: Sequence[torch.Tensor], wzr: torch.Tensor,
                      wh: torch.Tensor, rm: Optional[torch.Tensor],
                      reverse: Sequence[bool]):
    """Plain PyTorch version of the forward kernel, in its order of
    operations. Returns ``(last, hseq, (yz, yr, hh, ops))``: see
    ``gru_forward``."""
    dirs, (b, steps, u3) = len(xws), xws[0].shape
    u, io, op = u3 // 3, xws[0].dtype, wzr.dtype
    acc = _acc(io)
    last = xws[0].new_empty(b, dirs * u)
    hseq = xws[0].new_empty((dirs, b, steps, u), dtype=acc)
    yz, yr, hh = (torch.empty_like(hseq) for _ in range(3))
    ops = xws[0].new_empty((dirs, 3, b, steps, u), dtype=op)
    for d in range(dirs):
        w_z, w_r, w_h = wzr[d, :u].to(acc), wzr[d, u:].to(acc), wh[d].to(acc)
        m = None if rm is None else rm[d].to(acc)
        h = hseq.new_zeros(b, u)
        for s in range(steps):
            tau = _time(s, steps, reverse[d])
            x = xws[d][:, tau].to(acc)
            a_z = _op(h if m is None else h * m[0], op)
            a_r = _op(h if m is None else h * m[1], op)
            yz[d, :, tau] = 0.2 * (x[:, :u] + a_z @ w_z.T) + 0.5
            yr[d, :, tau] = 0.2 * (x[:, u:2 * u] + a_r @ w_r.T) + 0.5
            z = yz[d, :, tau].clamp(0.0, 1.0)
            q = _op(yr[d, :, tau].clamp(0.0, 1.0)
                    * (h if m is None else h * m[2]), op)
            hh[d, :, tau] = torch.tanh(x[:, 2 * u:] + q @ w_h.T)
            h = z * h + (1.0 - z) * hh[d, :, tau]
            hseq[d, :, tau] = h
            ops[d, 0, :, tau], ops[d, 1, :, tau], ops[d, 2, :, tau] = (
                a_z, a_r, q)
        last[:, d * u:(d + 1) * u] = h
    return last, hseq, (yz, yr, hh, ops)


def gru_backward_plain(dlast: Optional[torch.Tensor],
                       dhseq: Optional[torch.Tensor], wzr: torch.Tensor,
                       wh: torch.Tensor, rm: Optional[torch.Tensor],
                       reverse: Sequence[bool], hseq: torch.Tensor,
                       yz: torch.Tensor, yr: torch.Tensor, hh: torch.Tensor,
                       io: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (BPTT, in its order of
    operations): the input projections' gradient [D, B, T, 3u] in ``io``.
    See ``gru_backward``."""
    dirs, b, steps, u = hseq.shape
    acc, op = hseq.dtype, wzr.dtype
    dxw = hseq.new_empty((dirs, b, steps, 3 * u), dtype=io)
    for d in range(dirs):
        w_z, w_r, w_h = wzr[d, :u].to(acc), wzr[d, u:].to(acc), wh[d].to(acc)
        m = None if rm is None else rm[d].to(acc)
        dh = (hseq.new_zeros(b, u) if dlast is None
              else dlast[:, d * u:(d + 1) * u].to(acc))
        for s in reversed(range(steps)):
            tau = _time(s, steps, reverse[d])
            if dhseq is not None:
                dh = dh + dhseq[d, :, tau]
            hp = (hseq[d, :, _time(s - 1, steps, reverse[d])] if s > 0
                  else torch.zeros_like(dh))
            y_z, y_r, hh_ = yz[d, :, tau], yr[d, :, tau], hh[d, :, tau]
            z = y_z.clamp(0.0, 1.0)
            dz = dh * (hp - hh_)
            dhh = dh * (1.0 - z)
            da_h = _op(dhh * (1.0 - hh_ * hh_), io)
            da_z = _op(_hard_grad(dz, y_z), io)
            dq = _op(da_h, op) @ w_h
            hm2 = hp if m is None else hp * m[2]
            da_r = _op(_hard_grad(dq * hm2, y_r), io)
            dqr = dq * y_r.clamp(0.0, 1.0)
            dh = dh * z + (dqr if m is None else dqr * m[2])
            g_z, g_r = _op(da_z, op) @ w_z, _op(da_r, op) @ w_r
            dh = (dh + (g_z if m is None else g_z * m[0])
                  + (g_r if m is None else g_r * m[1]))
            dxw[d, :, tau] = torch.cat([da_z, da_r, da_h], dim=-1).to(io)
    return dxw


def _check(xws, wzr, wh, rm, reverse) -> Tuple[int, int, int, int]:
    dirs = len(xws)
    if dirs not in (1, 2) or len(reverse) != dirs:
        raise ValueError(f"one or two directions, each with its reverse "
                         f"flag: {dirs} inputs, {len(reverse)} flags")
    x0 = xws[0]
    if x0.ndim != 3 or x0.shape[2] % 3 or 0 in x0.shape:
        raise ValueError(f"xw must be [B, T, 3u], got {tuple(x0.shape)}")
    b, steps, u = x0.shape[0], x0.shape[1], x0.shape[2] // 3
    shapes = [("wzr", wzr, (dirs, 2 * u, u)), ("wh", wh, (dirs, u, u))]
    shapes += [("xw", x, tuple(x0.shape)) for x in xws]
    if rm is not None:
        shapes.append(("rm", rm, (dirs, 3, b, u)))
    for name, v, shape in shapes:
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(v.shape)}")
        if v.device != x0.device:
            raise ValueError(f"{name} is on {v.device}, xw on {x0.device}")
    if any(x.dtype != x0.dtype for x in xws) or wh.dtype != wzr.dtype:
        raise ValueError("the directions' xw must share one dtype, and "
                         "wzr and wh another")
    if x0.device.type == "cuda":
        if (wzr.dtype, x0.dtype) not in _DTYPES:
            raise ValueError(f"the kernel takes (weights, xw) dtypes "
                             f"{_DTYPES}, got ({wzr.dtype}, {x0.dtype})")
        if u not in UNITS:
            raise ValueError(f"the kernel is built for units {UNITS}, "
                             f"not {u}")
        if rm is not None and rm.dtype != torch.float32:
            raise ValueError(f"rm must be float32, got {rm.dtype}")
        for name, v in [("xw", x) for x in xws] + [
                ("wzr", wzr), ("wh", wh), ("rm", rm)]:
            if v is not None and (not v.is_contiguous()
                                  or v.data_ptr() % 16):
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 f"aligned")
    elif x0.device.type != "cpu":
        raise ValueError(f"the GRU recurrence runs on cuda or cpu, not "
                         f"{x0.device}")
    return dirs, b, steps, u


def _reverse_bits(reverse: Sequence[bool]) -> int:
    return sum(1 << d for d, r in enumerate(reverse) if r)


def gru_forward(xws: Sequence[torch.Tensor], wzr: torch.Tensor,
                wh: torch.Tensor, rm: Optional[torch.Tensor],
                reverse: Sequence[bool], save: bool = True,
                states: bool = True):
    """The recurrence of one or two directions in one launch.

    ``xws``: each direction's input projections [B, T, 3u] (z, r, h);
    ``wzr`` [D, 2u, u] and ``wh`` [D, u, u]: the recurrent weights in the
    products' operand dtype; ``rm`` [D, 3, B, u] float32: the recurrent
    masks, or None; ``reverse[d]``: direction d runs from the last step.

    Returns ``(last, hseq, saves)``: ``last`` [B, D u] in xw's dtype, each
    direction's last state; ``hseq`` [D, B, T, u] f32, the state after
    each time step (None unless ``save`` or ``states``); ``saves`` for
    ``gru_backward`` (None unless ``save``): the gates' pre-activations
    ``yz``, ``yr`` and the candidate ``hh`` (f32, [D, B, T, u] each) and
    the products' A operands ``ops`` [D, 3, B, T, u] (h m0, h m1, r h m2
    in the operand dtype, for the weights' gradients).
    """
    dirs, b, steps, u = _check(xws, wzr, wh, rm, reverse)
    if xws[0].device.type == "cpu":
        with torch.autocast("cpu", enabled=False):
            last, hseq, saves = gru_forward_plain(xws, wzr, wh, rm, reverse)
        return (last, hseq if save or states else None,
                saves if save else None)
    dev = xws[0].device
    last = torch.empty((b, dirs * u), dtype=xws[0].dtype, device=dev)
    hseq = yz = yr = hh = ops = None
    if save or states:
        hseq = torch.empty((dirs, b, steps, u), dtype=torch.float32,
                           device=dev)
    if save:
        yz, yr, hh = (torch.empty_like(hseq) for _ in range(3))
        ops = torch.empty((dirs, 3, b, steps, u), dtype=wzr.dtype,
                          device=dev)
    xw1 = xws[1] if dirs == 2 else None
    _launch("gru_forward", dev, wzr.dtype, xws[0].dtype, u, ptr(xws[0]),
            ptr(xw1), ptr(wzr), ptr(wh), ptr(rm), ptr(last), ptr(hseq),
            ptr(yz), ptr(yr), ptr(hh), ptr(ops), b, steps, dirs,
            _reverse_bits(reverse))
    return last, hseq, (yz, yr, hh, ops) if save else None


def gru_backward(dlast: Optional[torch.Tensor], dhseq: Optional[torch.Tensor],
                 wzr: torch.Tensor, wh: torch.Tensor,
                 rm: Optional[torch.Tensor], reverse: Sequence[bool],
                 hseq: torch.Tensor, yz: torch.Tensor, yr: torch.Tensor,
                 hh: torch.Tensor, io: torch.dtype) -> torch.Tensor:
    """BPTT of ``gru_forward`` in one launch, from the gradients of its
    ``last`` (``dlast``) and ``hseq`` (``dhseq``), either None for none,
    and its saves: the input projections' gradient [D, B, T, 3u] in
    ``io``, the xw dtype. The weights' gradients are ``weight_grads`` of
    it."""
    dirs, b, steps, u = hseq.shape
    if hseq.device.type == "cpu":
        return gru_backward_plain(dlast, dhseq, wzr, wh, rm, reverse, hseq,
                                  yz, yr, hh, io)
    dev = hseq.device
    # the kernel's products are the forward's on W^T: [W_z^T; W_r^T], W_h^T
    wzr_t = wzr.view(dirs, 2, u, u).transpose(-1, -2).reshape(
        dirs, 2 * u, u)
    wh_t = wh.transpose(-1, -2).contiguous()
    dlast = None if dlast is None else aligned(dlast.to(io))
    dhseq = aligned(dhseq)
    dxw = torch.empty((dirs, b, steps, 3 * u), dtype=io, device=dev)
    _launch("gru_backward", dev, wzr.dtype, io, u, ptr(wzr_t), ptr(wh_t),
            ptr(rm), ptr(hseq), ptr(yz), ptr(yr), ptr(hh), ptr(dlast),
            ptr(dhseq), ptr(dxw), b, steps, dirs, _reverse_bits(reverse))
    return dxw


def weight_grads(dxw: torch.Tensor, ops: torch.Tensor):
    """The recurrent weights' gradients from the input projections'
    gradient dxw [D, B, T, 3u] and the products' A operands ops [D, 3, B,
    T, u]: one product over all B T rows a direction (three gates as a
    batch). Returns (d wzr [D, 2u, u], d wh [D, u, u]) in ops' dtype."""
    dirs, b, steps, u3 = dxw.shape
    u, n = u3 // 3, b * steps
    dw = torch.stack([
        torch.bmm(dxw[d].reshape(n, 3, u).permute(1, 2, 0).to(ops.dtype),
                  ops[d].reshape(3, n, u)) for d in range(dirs)])
    return dw[:, :2].reshape(dirs, 2 * u, u), dw[:, 2]


class GRURecurrence(torch.autograd.Function):
    """``apply(reverse, wzr, wh, rm, *xws) -> (last, hseq)`` of
    ``gru_forward``, differentiable in the weights and the input
    projections through ``gru_backward`` and ``weight_grads``."""

    @staticmethod
    def forward(ctx, reverse, wzr, wh, rm, *xws):
        last, hseq, saves = gru_forward(xws, wzr, wh, rm, reverse)
        ctx.save_for_backward(wzr, wh, rm, hseq, *saves)
        ctx.reverse, ctx.io = reverse, xws[0].dtype
        ctx.set_materialize_grads(False)
        return last, hseq

    @staticmethod
    def backward(ctx, dlast, dhseq):
        wzr, wh, rm, hseq, yz, yr, hh, ops = ctx.saved_tensors
        dxw = gru_backward(dlast, dhseq, wzr, wh, rm, ctx.reverse, hseq, yz,
                           yr, hh, ctx.io)
        dwzr, dwh = weight_grads(dxw, ops)
        return (None, dwzr, dwh, None, *dxw.unbind(0))


def gru_recurrence(xws: Sequence[torch.Tensor], wzr: torch.Tensor,
                   wh: torch.Tensor, rm: Optional[torch.Tensor],
                   reverse: Sequence[bool],
                   return_sequences: bool = False) -> torch.Tensor:
    """One or two GRU directions over their input projections (see
    ``gru_forward`` for the arguments), differentiable where a tensor
    requires a gradient. Returns the last states [B, D u], or with
    ``return_sequences`` every state as NCW [B, D u, T] in the input's
    order, in xw's dtype: the directions' outputs concatenated on the
    channel axis."""
    reverse = tuple(bool(r) for r in reverse)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (wzr, wh, *xws)):
        last, hseq = GRURecurrence.apply(reverse, wzr, wh, rm, *xws)
    else:
        last, hseq, _ = gru_forward(xws, wzr, wh, rm, reverse, save=False,
                                    states=return_sequences)
    if not return_sequences:
        return last
    dirs, b, steps, u = hseq.shape
    return hseq.permute(1, 0, 3, 2).reshape(b, dirs * u, steps).to(
        xws[0].dtype)


def _launch(entry: str, device: torch.device, op: torch.dtype,
            io: torch.dtype, *args) -> None:
    """Launch ``csrc/gru_recurrence.cu``'s ``entry`` for operand dtype
    ``op`` and xw dtype ``io``."""
    lib = library("gru_recurrence", _ENTRIES, error="gru_error_string")
    launch(lib, entry, device, int(op == torch.bfloat16),
           int(io == torch.bfloat16), *args, kernel=entry)


_ENTRIES = {
    "gru_forward": [I, I, I64] + [P] * 11 + [I64] * 4 + [P],
    "gru_backward": [I, I, I64] + [P] * 10 + [I64] * 4 + [P],
}
