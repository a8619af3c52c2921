"""Process-group setup (port of speech_recognition_tpu/parallel/distributed.py).

JAX's ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group`` with an explicit backend and
rendezvous: nothing on a machine tells a program of a cluster, so the
caller names the address (``tcp://localhost:<port>`` or
``file://<path>``), the world size and the rank; or ``torchrun`` names
them in the environment (``join_from_env``).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple, TypeVar

import torch
import torch.distributed as dist

from speech_recognition_tpu_torch.device import require_cuda
from speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, replicated,
)

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


def join_from_env(device: str = "cuda") -> Tuple[torch.device, Mesh]:
    """This process's device and mesh, for an entry point's ``--device``.

    Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment, with
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) it
    joins the process group by ``init_method="env://"`` on
    ``default_backend``'s backend (gloo for ``--device cpu``); on the
    card, the rank takes ``cuda:{LOCAL_RANK % device_count}``, so ranks
    share the cards round-robin. Without that environment it is one
    rank on ``device`` (``cuda`` raises without a card)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device == "cuda":
        require_cuda()
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if world > 1 and not dist.is_initialized():
        backend = default_backend(world) if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend=backend, init_method="env://",
                                timeout=TIMEOUT)
    return dev, make_mesh(dev)


def leave() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


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
