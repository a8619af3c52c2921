"""Fused decode+augment over a data-parallel mesh: the wrapper and its
plain version.

Replaces ``speech_recognition_tpu/ops/pallas/sharded.py::
fused_decode_augment_sharded``, a ``shard_map`` over
``fused_decode_augment_flat`` that computes nothing of its own: banks
replicated, the per-sample vectors and the output sharded on the batch
axis, no collectives. So it needs no CUDA source of its own. Its
counterpart is the decode+augment kernel (``csrc/decode_augment.cu``,
through ``ops/kernels/decode_augment.py::decode_augment``) launched by
each rank on its own rows of the global batch.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.kernels.decode_augment import (
    decode_augment, decode_augment_reference,
)
from speech_recognition_tpu_torch.parallel.mesh import Mesh, shard_batch


def decode_augment_sharded(mesh: Mesh, bank: torch.Tensor,
                           bg_flat: torch.Tensor, file_ids: torch.Tensor,
                           shifts: torch.Tensor, fg_vol: torch.Tensor,
                           bg_pos: torch.Tensor,
                           bg_vol: torch.Tensor) -> torch.Tensor:
    """This rank's ``[B/W, T]`` rows of the global batch's decode+augment.

    ``bank`` [N, T] int16 and ``bg_flat`` [M] float32 are replicated;
    ``file_ids``, ``shifts``, ``fg_vol``, ``bg_pos`` and ``bg_vol`` are the
    global ``[B]`` draws, the same on every rank. One kernel launch on the
    rank's rows for CUDA tensors, the plain version for CPU tensors;
    ``B % W != 0`` raises.
    """
    rows = shard_batch((file_ids, shifts, fg_vol, bg_pos, bg_vol), mesh)
    return decode_augment(bank, bg_flat, *rows)


def decode_augment_sharded_reference(mesh: Mesh, bank: torch.Tensor,
                                     bg_flat: torch.Tensor,
                                     file_ids: torch.Tensor,
                                     shifts: torch.Tensor,
                                     fg_vol: torch.Tensor,
                                     bg_pos: torch.Tensor,
                                     bg_vol: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``decode_augment_reference`` on the same
    rows."""
    rows = shard_batch((file_ids, shifts, fg_vol, bg_pos, bg_vol), mesh)
    return decode_augment_reference(bank, bg_flat, *rows)
