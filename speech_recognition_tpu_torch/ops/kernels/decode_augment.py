"""Fused decode+augment: the CUDA kernel's wrapper and its plain twin.

Replaces ``speech_recognition_tpu/ops/pallas/augment_kernel.py::
fused_decode_augment_flat`` (kernel source: ``csrc/decode_augment.cu``).
For each row b and sample i::

    out[b, i] = bank[f[b], (i - shift[b]) mod T] * (fg_vol[b] / 32768)
              + bg_flat[bg_pos[b] + i] * bg_vol[b]

``decode_augment`` launches the kernel for CUDA tensors and uses
``decode_augment_reference`` only for CPU tensors. On a card it never
falls back: a launch that fails raises. The kernel rounds as the plain
version does and equals it bit for bit, but for the sign of an exact
zero: it reads no bank for a row with fg_vol 0 and no background for a
row with bg_vol 0, and takes the skipped term as +0.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.kernels.launch import (
    I64, P, launch, library,
)

_INDEX_DTYPES = (torch.int32, torch.int64)
_MAX_GRID_Y = 65535


def decode_augment_reference(bank: torch.Tensor, bg_flat: torch.Tensor,
                             file_ids: torch.Tensor, shifts: torch.Tensor,
                             fg_vol: torch.Tensor, bg_pos: torch.Tensor,
                             bg_vol: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (port of ``ops/augment.py::
    rolled_decode_augment``): gather + roll + decode + background mix,
    in the kernel's order of operations. [B, T] float32."""
    t = bank.shape[1]
    ar = torch.arange(t, device=bank.device)
    idx = (ar[None, :] - shifts.long()[:, None]) % t     # np.roll
    rolled = torch.gather(bank[file_ids.long()], 1, idx)
    out = rolled.float() * (fg_vol / 32768.0)[:, None]
    crop = bg_flat[bg_pos.long()[:, None] + ar[None, :]]
    return out + crop * bg_vol[:, None]


def _check(bank, bg_flat, file_ids, shifts, fg_vol, bg_pos, bg_vol) -> None:
    device = bank.device
    if bank.dtype != torch.int16 or bank.ndim != 2:
        raise ValueError(f"bank must be [N, T] int16, got {bank.dtype} "
                         f"{tuple(bank.shape)}")
    if bg_flat.dtype != torch.float32 or bg_flat.ndim != 1:
        raise ValueError(f"bg_flat must be [M] float32, got {bg_flat.dtype} "
                         f"{tuple(bg_flat.shape)}")
    batch = file_ids.shape[0]
    index_dtype = file_ids.dtype
    for name, v, dtypes in (("file_ids", file_ids, _INDEX_DTYPES),
                            ("shifts", shifts, _INDEX_DTYPES),
                            ("bg_pos", bg_pos, _INDEX_DTYPES),
                            ("fg_vol", fg_vol, (torch.float32,)),
                            ("bg_vol", bg_vol, (torch.float32,))):
        if v.ndim != 1 or v.shape[0] != batch:
            raise ValueError(f"{name} must be [{batch}], got "
                             f"{tuple(v.shape)}")
        if v.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {v.dtype}")
    if shifts.dtype != index_dtype or bg_pos.dtype != index_dtype:
        raise ValueError("file_ids, shifts and bg_pos must share one dtype")
    for name, v in (("bank", bank), ("bg_flat", bg_flat),
                    ("file_ids", file_ids), ("shifts", shifts),
                    ("fg_vol", fg_vol), ("bg_pos", bg_pos),
                    ("bg_vol", bg_vol)):
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, bank on {device}")
        if device.type == "cuda" and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bg_flat.shape[0] < bank.shape[1]:
        raise ValueError("bg_flat is shorter than one clip")
    if batch > _MAX_GRID_Y:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_Y}")


def decode_augment(bank: torch.Tensor, bg_flat: torch.Tensor,
                   file_ids: torch.Tensor, shifts: torch.Tensor,
                   fg_vol: torch.Tensor, bg_pos: torch.Tensor,
                   bg_vol: torch.Tensor) -> torch.Tensor:
    """One-pass decode+augment. [B, T] float32 on the bank's device.

    bank [N, T] int16; bg_flat [M] float32; file_ids, shifts, bg_pos [B]
    int32 or int64 (one dtype); fg_vol, bg_vol [B] float32. Shifts follow
    np.roll; ``0 <= bg_pos <= M - T`` and ``0 <= file_ids < N`` (the
    kernel writes a row outside these bounds as NaN). Its runs count as
    ``decode_augment`` in ``launch.runs()``.
    """
    _check(bank, bg_flat, file_ids, shifts, fg_vol, bg_pos, bg_vol)
    if bank.device.type == "cpu":
        return decode_augment_reference(bank, bg_flat, file_ids, shifts,
                                         fg_vol, bg_pos, bg_vol)
    if bank.device.type != "cuda":
        raise ValueError(f"decode_augment runs on cuda or cpu, not "
                         f"{bank.device}")
    batch, t = file_ids.shape[0], bank.shape[1]
    out = torch.empty((batch, t), dtype=torch.float32, device=bank.device)
    suffix = "i32" if file_ids.dtype == torch.int32 else "i64"
    lib = library("decode_augment", _ENTRIES,
                  error="decode_augment_error_string")
    launch(lib, f"decode_augment_{suffix}", bank.device,
           bank.data_ptr(), bank.shape[0], t, bg_flat.data_ptr(),
           bg_flat.shape[0], file_ids.data_ptr(), shifts.data_ptr(),
           fg_vol.data_ptr(), bg_pos.data_ptr(), bg_vol.data_ptr(),
           out.data_ptr(), batch, kernel="decode_augment")
    return out


_ARGS = [P, I64, I64, P, I64, P, P, P, P, P, P, I64, P]
# csrc/decode_augment.cu's entries, for int32 and int64 file ids
_ENTRIES = {"decode_augment_i32": _ARGS, "decode_augment_i64": _ARGS}
