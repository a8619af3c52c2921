"""The collectives of data-parallel training.

XLA places these itself under SPMD (a ``psum`` of the gradients, and the
cross-shard reductions of every BatchNorm's statistics); here they are
explicit calls on the mesh's process group:

- ``all_reduce_sum``: differentiable sum over ranks (forward all-reduce,
  backward all-reduce of the cotangent), for the global-batch
  BatchNorm statistics;
- ``average_gradients``: the gradients averaged over ranks in one
  flattened bucket, after the backward pass;
- ``all_reduce_``: an in-place sum of a metric;
- ``all_gather_rows``: the ranks' rows of a batch, concatenated in rank
  order (a streamed batch's silence flags, the Predictor's
  probabilities).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from speech_recognition_tpu_torch.parallel.mesh import Mesh


class AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank.

    Every rank's loss depends on y, so the cotangent of x on a rank is
    the sum over ranks of y's cotangents: the backward is the same
    all-reduce. All ranks must run the same forward and backward.
    """

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``mesh``."""
    return AllReduceSum.apply(x, mesh.group)


def all_reduce_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``mesh`` in place; returns ``x``."""
    dist.all_reduce(x, group=mesh.group)
    return x


@torch.no_grad()
def average_gradients(parameters: Iterable[torch.nn.Parameter],
                      mesh: Mesh) -> None:
    """Replace each ``.grad`` by its mean over ranks: one all-reduce of
    one flattened bucket. Each rank's loss is the mean over its own rows,
    so the mean over ranks is the gradient of the global batch's loss.
    The all-reduce leaves the same bits on every rank."""
    grads = [p.grad for p in parameters if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh).div_(mesh.size)
    for g, new in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(new.view_as(g))


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] concatenated in rank order, [W n, ...],
    on every rank (the global batch that ``jax.
    make_array_from_process_local_data`` assembles). Every rank passes
    the same shape.

    Each rank writes its rows into zeros and one all-reduce sums them:
    every element is one rank's value plus zeros, so the result is exact
    (booleans go as int32). It is an all-reduce rather than an
    ``all_gather`` because gloo gathers no CUDA tensors, and ranks that
    share a card run on gloo. A one-rank mesh returns ``x``.
    """
    if mesh.size == 1:
        return x
    dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    out = x.new_zeros((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=dtype)
    out[mesh.rows(out.shape[0])] = x.to(dtype)
    all_reduce_(out, mesh)
    return out.bool() if x.dtype == torch.bool else out
