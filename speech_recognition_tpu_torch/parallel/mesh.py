"""The data-parallel mesh (port of speech_recognition_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D ``data`` mesh: batches
sharded on axis 0, parameters, optimizer state and banks replicated, and
XLA inserts the collectives. The port runs one process per rank instead
(``torch.distributed``), so what XLA did implicitly is written out:

- every rank draws the *global* batch from an identically seeded
  ``torch.Generator`` and keeps its rows (``shard_batch``), the port's
  form of "one key, then shard";
- rank 0's tensors are broadcast to the others (``replicated``);
- the collectives themselves live in ``parallel/collectives.py``.

A ``Mesh`` with ``group=None`` is one rank's view without a process
group: enough to compute that rank's rows (``shard_batch``,
``decode_augment_sharded``), not to communicate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from speech_recognition_tpu_torch.device import require_cuda

# the name of the mesh's one axis, as in the JAX package
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D data-parallel mesh of ``size`` ranks.

    ``device`` is where this rank computes (None: not bound to one);
    ``group`` is the process group its collectives run on (None: the
    default group, or no communication at all when none is initialised).
    """

    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None
    group: Optional[Any] = None

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    def rows(self, batch: int) -> slice:
        """This rank's rows ``[r * B/W, (r + 1) * B/W)`` of a global batch
        of ``batch``; raises when ``batch`` does not divide by the size
        (the JAX path requires it too, and nothing pads)."""
        if batch % self.size:
            raise ValueError(f"batch {batch} does not split over the "
                             f"{self.size} ranks of the {DATA_AXIS!r} axis")
        n = batch // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def rank_device(rank: int) -> torch.device:
    """``cuda:{rank % device_count}``: one card per rank where there are
    enough, else ranks share cards round-robin. Raises without a card."""
    require_cuda()
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(device: Optional[torch.device | str] = None,
              group: Optional[Any] = None) -> Mesh:
    """The mesh of the initialised process group, or the one-rank mesh
    when none is initialised. ``device`` defaults to this rank's card
    (``rank_device``); pass a CPU device explicitly for the CPU."""
    if not dist.is_initialized():
        rank, size = 0, 1
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    device = rank_device(rank) if device is None else torch.device(device)
    return Mesh(rank, size, device, group)


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of every tensor in ``tree`` (a tensor, or a
    tuple, list or dict of them), cut on axis 0. Slices are views."""
    if isinstance(tree, torch.Tensor):
        return tree[mesh.rows(tree.shape[0])]
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    raise TypeError(f"shard_batch takes tensors, tuples, lists and dicts, "
                    f"not {type(tree).__name__}")


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@torch.no_grad()
def replicated(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of ``tree`` from rank 0, in place, and
    return ``tree``: afterwards every rank holds rank 0's values.

    ``tree`` may be a tensor, an ``nn.Module`` (its parameters and
    buffers), a dataclass (a ``DeviceDataset``: bank, partitions,
    background) or a dict, tuple or list of these. Tensors go as their
    bytes, which keeps them bit-exact whatever their dtype (gloo has no
    int16). A one-rank mesh returns it untouched.
    """
    if mesh.size == 1:
        return tree
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for t in _tensors(tree):
        if not t.is_contiguous():
            raise ValueError("replicated broadcasts contiguous tensors only")
        if t.numel():
            dist.broadcast(t.data.reshape(-1).view(torch.uint8), src=src,
                           group=mesh.group)
    return tree
