"""The random draws of a training step, worked out again.

The program draws each batch from its trainer's ``torch.Generator``: the
clip ids (uniform over the training partition, or, with probability
``pseudo_frequency``, over the pseudo partition), then the augmentation
(time shift, background and foreground volumes, background crop
positions; the policy of see--/speech_recognition input_data.py:457-514)
and then, in the forward pass, the dropout masks. This module makes the
same calls on a generator seeded as the trainer's (seed + 1), in that
order and at those shapes, so that it reaches the same numbers without
reading any of the program's state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch


@dataclass
class Draws:
    file_ids: torch.Tensor
    labels: torch.Tensor
    is_silence: torch.Tensor
    shifts: torch.Tensor
    fg_vol: torch.Tensor
    bg_pos: torch.Tensor
    bg_vol: torch.Tensor


def trainer_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    return g


def _rand(g, n, dev):
    return torch.rand(n, generator=g, device=dev)


def augmentation(g: torch.Generator, is_silence: torch.Tensor,
                 aug: Dict, bg_starts: torch.Tensor,
                 bg_lengths: torch.Tensor, samples: int,
                 ) -> Tuple[torch.Tensor, ...]:
    """(shifts, fg_vol, bg_pos, bg_vol) of a batch (a background bank is
    always present in the benchmark's traffic)."""
    dev = is_silence.device
    b = is_silence.shape[0]
    lo, hi = aug["time_shift_range"]
    shift = torch.zeros(b, dtype=torch.int64, device=dev)
    if aug["time_shift_frequency"] > 0.0 and (lo, hi) != (0, 0):
        do_shift = _rand(g, b, dev) < aug["time_shift_frequency"]
        drawn = torch.randint(lo, hi + 1, (b,), generator=g, device=dev)
        shift = torch.where(do_shift, drawn, shift)
    zero = torch.zeros(b, device=dev)
    bg_hit = _rand(g, b, dev) < aug["background_frequency"]
    bg_vol = torch.where(bg_hit, _rand(g, b, dev)
                         * aug["background_volume_range"], zero)
    sil_hit = (~bg_hit) & is_silence & (
        _rand(g, b, dev) < aug["silence_background_frequency"])
    bg_vol = torch.where(sil_hit, _rand(g, b, dev)
                         * aug["silence_volume_range"], bg_vol)
    r = aug["foreground_volume_range"]
    fg_hit = _rand(g, b, dev) < aug["foreground_frequency"]
    fg_vol = torch.where(fg_hit, 1.0 + (2.0 * _rand(g, b, dev) - 1.0) * r,
                         torch.ones(b, device=dev))
    flip = _rand(g, b, dev) < aug["flip_frequency"]
    fg_vol = torch.where(flip, -fg_vol, fg_vol)
    fg_vol = torch.where(is_silence, zero, fg_vol)
    clip = torch.randint(0, bg_starts.shape[0], (b,), generator=g,
                         device=dev)
    max_off = (bg_lengths[clip] - samples).float()
    offsets = torch.floor(_rand(g, b, dev) * max_off).long()
    return shift, fg_vol, bg_starts[clip] + offsets, bg_vol


def bank_batch(g: torch.Generator, parts: Dict[str, Tuple[torch.Tensor, ...]],
               batch: int, aug: Dict, bg_starts, bg_lengths,
               samples: int) -> Draws:
    """A bank step's draws; ``parts``: {"training"/"pseudo": (file_ids,
    labels, is_silence)}."""
    fids, labels, sil = parts["training"]
    dev = fids.device
    idx = torch.randint(0, fids.shape[0], (batch,), generator=g, device=dev)
    f, y, s = fids[idx], labels[idx], sil[idx]
    pseudo = parts.get("pseudo")
    if pseudo is not None and pseudo[0].shape[0] > 0:
        use = _rand(g, batch, dev) < aug["pseudo_frequency"]
        ip = torch.randint(0, pseudo[0].shape[0], (batch,), generator=g,
                           device=dev)
        f = torch.where(use, pseudo[0][ip], f)
        y = torch.where(use, pseudo[1][ip], y)
        s = torch.where(use, pseudo[2][ip], s)
    return Draws(f, y, s, *augmentation(g, s, aug, bg_starts, bg_lengths,
                                        samples))


def dropout_masks(g: torch.Generator, shapes: Sequence[Tuple[tuple, float]],
                  device: torch.device) -> List[torch.Tensor]:
    """Keep masks (True with probability 1 - rate), in forward order."""
    return [torch.rand(shape, generator=g, device=device) >= rate
            for shape, rate in shapes]


def decode_augment(bank: torch.Tensor, bg_flat: torch.Tensor,
                   d: Draws) -> torch.Tensor:
    """out[b, i] = bank[f_b, (i - shift_b) mod T] * fg_b / 32768
    + bg[pos_b + i] * bgv_b, in float32."""
    t = bank.shape[1]
    i = torch.arange(t, device=bank.device)
    rolled = bank[d.file_ids][torch.arange(d.file_ids.shape[0],
                                           device=bank.device)[:, None],
                              (i[None, :] - d.shifts[:, None]) % t]
    crop = bg_flat[d.bg_pos[:, None] + i[None, :]]
    return rolled.float() * (d.fg_vol / 32768.0)[:, None] \
        + crop * d.bg_vol[:, None]


def decode_augment_bytes(d: Draws, samples: int) -> int:
    """Bytes the decode+augment of a batch must move: each int16 clip
    row read once where its foreground volume is not 0, each float32
    background crop where its volume is not 0, each float32 output row
    written once."""
    rows = d.file_ids.shape[0]
    fg = int((d.fg_vol != 0).sum())
    bg = int((d.bg_vol != 0).sum())
    return samples * (2 * fg + 4 * bg + 4 * rows)
