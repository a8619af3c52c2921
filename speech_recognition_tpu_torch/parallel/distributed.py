"""Process-group setup (port of speech_recognition_tpu/parallel/distributed.py).

JAX's ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group`` with an explicit backend and
rendezvous: nothing on a machine tells a program of a cluster, so the
caller names the address (``tcp://localhost:<port>`` or
``file://<path>``), the world size and the rank.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

from speech_recognition_tpu_torch.parallel.mesh import replicated

T = TypeVar("T")

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(world_size: int) -> str:
    """``nccl`` when each of ``world_size`` ranks has a card of its own;
    ``gloo`` on the CPU, and when ranks share a card (NCCL refuses two
    ranks on one device). Gloo moves CUDA tensors through the host: the
    compute stays on the card either way."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: str) -> None:
    """Join the process group of ``world_size`` ranks as ``rank``."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def process_shard(items: Sequence[T],
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List[T]:
    """This process's strided shard of a work list (a copy of the JAX
    package's: ``items[index::count]``); defaults to the process group's
    rank and size, or the whole list without a group."""
    initialised = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if initialised else 0
    if process_count is None:
        process_count = dist.get_world_size() if initialised else 1
    return list(items[process_index::process_count])


# Every process stages the same data from the same seed; broadcasting it
# from rank 0 then makes "every rank holds rank 0's bank and parameters"
# true by construction (JAX: make_array_from_callback of a replicated
# sharding).
host_replicated = replicated
