"""Device-resident dataset bank + batched sample selection (port of
speech_recognition_tpu/data/device_bank.py, flat layout only).

The whole corpus lives on the device as one [num_files, T] int16 tensor
(Speech Commands: ~75k clips, 2.4 GB); each train step gathers, decodes
and augments a batch on the device. The TPU package's chunked/doubled
bank layout exists only for Mosaic's DMA rules and is not ported.

Training draws are uniform over the partition, with probability
``pseudo_frequency`` of drawing from the pseudo partition instead;
validation/testing walk the partition in order (input_data.py:459-468).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.config import ModelSettings
from speech_recognition_tpu_torch.data.index import DatasetIndex
from speech_recognition_tpu_torch.data.wav import (
    INT16_DECODE_SCALE, decode_batch_int16, decode_files_variable,
)
from speech_recognition_tpu_torch.ops.augment import BackgroundBank


@dataclasses.dataclass
class Partition:
    """Per-partition index tensors into the shared wav bank."""

    file_ids: torch.Tensor    # [n] int64 -> row in wav bank
    labels: torch.Tensor      # [n] int64 class index
    is_silence: torch.Tensor  # [n] bool

    @property
    def size(self) -> int:
        return int(self.file_ids.shape[0])


@dataclasses.dataclass
class DeviceDataset:
    """Packed dataset living in device memory (flat [N, T] int16 bank)."""

    wav_bank: torch.Tensor
    partitions: Dict[str, Partition]
    background: Optional[BackgroundBank]
    num_classes: int
    desired_samples: int

    @property
    def device(self) -> torch.device:
        return self.wav_bank.device

    @property
    def num_clips(self) -> int:
        return int(self.wav_bank.shape[0])

    def set_size(self, mode: str) -> int:
        return self.partitions[mode].size

    def decode(self, file_ids: torch.Tensor) -> torch.Tensor:
        """Gather + int16 -> float32 decode (decode_wav scaling, 1/32768)."""
        return self.wav_bank[file_ids].float() / INT16_DECODE_SCALE

    def sample_train_ids(self, generator: torch.Generator, batch_size: int,
                         pseudo_frequency: float = 0.0,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Random (file_ids, labels, is_silence) for a training batch."""
        dev = self.device
        train = self.partitions["training"]
        pseudo = self.partitions.get("pseudo")
        idx_c = torch.randint(0, train.size, (batch_size,),
                              generator=generator, device=dev)
        file_ids = train.file_ids[idx_c]
        labels = train.labels[idx_c]
        silence = train.is_silence[idx_c]
        if pseudo is not None and pseudo.size > 0:
            use_pseudo = torch.rand(batch_size, generator=generator,
                                    device=dev) < pseudo_frequency
            idx_p = torch.randint(0, pseudo.size, (batch_size,),
                                  generator=generator, device=dev)
            file_ids = torch.where(use_pseudo, pseudo.file_ids[idx_p],
                                   file_ids)
            labels = torch.where(use_pseudo, pseudo.labels[idx_p], labels)
            silence = torch.where(use_pseudo, pseudo.is_silence[idx_p],
                                  silence)
        return file_ids, labels, silence

    def eval_ids(self, mode: str, offset: int, batch_size: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Deterministic sequential batch (input_data.py:454,459-461)."""
        part = self.partitions[mode]
        sl = slice(offset, offset + batch_size)
        return part.file_ids[sl], part.labels[sl], part.is_silence[sl]

    def get_unprocessed_data(self, mode: str, how_many: int = -1,
                             offset: int = 0,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw decoded clips + labels, silence muted, no augmentation
        (parity: input_data.py:543-589)."""
        part = self.partitions[mode]
        count = part.size if how_many == -1 else how_many
        sl = slice(offset, offset + count)
        wav = self.decode(part.file_ids[sl])
        wav = wav * (~part.is_silence[sl]).float()[:, None]
        return wav, part.labels[sl]


def build_device_dataset(index: DatasetIndex,
                         settings: ModelSettings,
                         device: torch.device,
                         include_pseudo: bool = True,
                         modes: Optional[Sequence[str]] = None,
                         ) -> DeviceDataset:
    """Decode every referenced file once and put the packed bank on
    ``device``.

    Duplicate references (the silence entries all point at one file,
    input_data.py:244-254) share one bank row; rows are in order of first
    reference over ``modes``. ``modes`` restricts which partitions are
    staged. Background clips longer than one clip make the background
    bank (none if there are no such clips).
    """
    desired = settings.desired_samples
    if modes is None:
        modes = ["training", "validation", "testing"]
        if include_pseudo:
            modes.append("pseudo")
    modes = list(modes)

    path_to_row: Dict[str, int] = {}
    ordered_paths = []
    for mode in modes:
        for e in index.data_index[mode]:
            if e.file not in path_to_row:
                path_to_row[e.file] = len(ordered_paths)
                ordered_paths.append(e.file)
    bank = decode_batch_int16(ordered_paths, desired)

    partitions = {}
    for mode in modes:
        entries = index.data_index[mode]
        file_ids = np.array([path_to_row[e.file] for e in entries],
                            dtype=np.int64)
        partitions[mode] = Partition(
            file_ids=torch.from_numpy(file_ids).to(device),
            labels=torch.from_numpy(
                index.labels_array(mode).astype(np.int64)).to(device),
            is_silence=torch.from_numpy(
                index.is_silence_array(mode)).to(device))

    background = None
    if index.background_files:
        clips = [c.astype(np.float32) / INT16_DECODE_SCALE
                 for c in decode_files_variable(index.background_files)]
        if any(len(c) > desired for c in clips):
            background = BackgroundBank.from_arrays(clips, desired, device)

    return DeviceDataset(
        wav_bank=torch.from_numpy(bank).to(device),
        partitions=partitions,
        background=background,
        num_classes=max(index.word_to_index.values()) + 1,
        desired_samples=desired)


def synthetic_device_dataset(device: torch.device,
                             num_train: int = 64,
                             num_val: int = 16,
                             num_pseudo: int = 8,
                             num_classes: int = 12,
                             desired_samples: int = 16000,
                             num_background: int = 2,
                             background_len: int = 48000,
                             seed: int = 0) -> DeviceDataset:
    """Random dataset for tests and benchmarks (no files involved).

    Makes the same numpy draws in the same order as the JAX package's
    ``synthetic_device_dataset``, so one seed gives the same bank, labels
    and background on both sides.
    """
    rng = np.random.default_rng(seed)
    n = num_train + num_val + num_pseudo
    bank = rng.integers(-2000, 2000, size=(n, desired_samples),
                        dtype=np.int16)
    parts = {}
    start = 0
    for mode, size in (("training", num_train), ("validation", num_val),
                       ("pseudo", num_pseudo)):
        labels = rng.integers(0, num_classes, size=size).astype(np.int64)
        if size:
            labels[0] = 0  # ensure at least one silence entry
        labels_t = torch.from_numpy(labels).to(device)
        parts[mode] = Partition(
            file_ids=torch.arange(start, start + size, device=device),
            labels=labels_t,
            is_silence=labels_t == 0)
        start += size
    parts["testing"] = Partition(
        file_ids=torch.zeros(0, dtype=torch.int64, device=device),
        labels=torch.zeros(0, dtype=torch.int64, device=device),
        is_silence=torch.zeros(0, dtype=torch.bool, device=device))
    bg = [rng.uniform(-0.1, 0.1, size=background_len).astype(np.float32)
          for _ in range(num_background)]
    background = BackgroundBank.from_arrays(bg, desired_samples, device)
    return DeviceDataset(
        wav_bank=torch.from_numpy(bank).to(device),
        partitions=parts,
        background=background,
        num_classes=num_classes,
        desired_samples=desired_samples)
