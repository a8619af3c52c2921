"""Operations of a forward and backward pass, counted from shapes.

``count_flops`` runs a reference model's forward on the meta device
under a ``TorchFunctionMode`` that sees each ``F.conv1d``, ``F.conv2d``,
``F.linear`` and matrix product with its operands, so it knows which of
them need a gradient: a product's forward costs 2 x its multiply-adds,
and its backward the same again for the weights' gradient and once more
for the input's gradient where the input needs one (the first layer's
does not).
``torch.utils.flop_counter.FlopCounterMode`` is not used for the
backward: it counts a grouped convolution's weight gradient as if the
convolution were dense, C times too high for a depthwise one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def conv_flops(out_shape, w_shape) -> int:
    """2 x multiply-adds of an NCW or NCHW convolution: each of the B x
    Cout x Tout (x Wout) outputs sums Cin / groups x k (x kw) products
    (``w_shape`` [Cout, Cin / groups, k(, kw)])."""
    return 2 * math.prod(out_shape) * math.prod(w_shape[1:])


def matmul_flops(a_shape, b_shape) -> int:
    """2 x multiply-adds of [..., M, K] @ [K, N]."""
    return 2 * math.prod(a_shape[:-1]) * a_shape[-1] * b_shape[-1]


def linear_flops(x_shape, w_shape) -> int:
    """2 x multiply-adds of ``F.linear``: [..., K] by ``w_shape`` [N, K]
    (its bias's additions left out, as a product's are)."""
    return 2 * math.prod(x_shape[:-1]) * x_shape[-1] * w_shape[0]


class _Counter(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.forward = 0
        self.backward = 0

    def _add(self, flops: int, x: torch.Tensor, w: torch.Tensor) -> None:
        self.forward += flops
        self.backward += flops * (int(w.requires_grad)
                                  + int(x.requires_grad))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (F.conv1d, F.conv2d):
            self._add(conv_flops(out.shape, args[1].shape), args[0],
                      args[1])
        elif func is F.linear:
            self._add(linear_flops(args[0].shape, args[1].shape), args[0],
                      args[1])
        elif getattr(func, "__name__", "") in ("matmul", "__matmul__",
                                               "mm"):
            self._add(matmul_flops(args[0].shape, args[1].shape),
                      args[0], args[1])
        elif func in (torch.bmm, torch.addmm):
            raise NotImplementedError(f"no count for {func.__name__}")
        return out


def count_flops(forward: Callable, params: Dict[str, tuple],
                trainable: Dict[str, bool], batch: int,
                samples: int) -> Dict[str, int]:
    """{"forward", "backward", "step"} FLOPs of ``forward(p, x)`` on a
    batch of ``batch`` clips of ``samples``, the parameters of
    ``params`` (name -> shape) needing a gradient where ``trainable``
    says so. Runs on the meta device: no memory, no arithmetic."""
    p = {n: torch.empty(s, device="meta").requires_grad_(trainable[n])
         for n, s in params.items()}
    x = torch.empty(batch, samples, device="meta")
    with _Counter() as c:
        forward(p, x)
    return {"forward": c.forward, "backward": c.backward,
            "step": c.forward + c.backward}
