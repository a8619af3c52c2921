"""Batched, device-resident augmentation draws (port of
speech_recognition_tpu/ops/augment.py).

The per-sample policy is the reference's (input_data.py:457-514), drawn
for a whole batch at once from an explicit ``torch.Generator`` that lives
on the batch's device:

  * time shift   — w.p. ``time_shift_frequency`` a circular np.roll by
                   randint[min, max], else 0
  * background   — volume ~ U(0, background_volume_range) w.p.
                   ``background_frequency`` else 0, except silence clips,
                   which w.p. 0.9 get U(0, silence_volume_range)
  * foreground   — silence -> 0; else 1, w.p. ``foreground_frequency``
                   1 + U(-r, r); sign-flipped w.p. ``flip_frequency``

A torch.Generator cannot replay ``jax.random`` streams: the draws match
the JAX package in distribution, not bit for bit. The training
composition itself (gather + decode + roll + background mix) is the
fused kernel in ``ops/kernels/decode_augment.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.config import AugmentConfig


@dataclasses.dataclass
class BackgroundBank:
    """Flattened background-noise bank for random-crop reads.

    ``flat`` concatenates every background clip; ``starts`` and
    ``lengths`` delimit each clip.
    """

    flat: torch.Tensor      # [total_samples] float32
    starts: torch.Tensor    # [num_clips] int64
    lengths: torch.Tensor   # [num_clips] int64

    @property
    def num_clips(self) -> int:
        return self.starts.shape[0]

    @staticmethod
    def from_arrays(clips: Sequence[np.ndarray], min_length: int,
                    device: torch.device) -> "BackgroundBank":
        """Keep clips longer than ``min_length`` (the reference requires
        background files longer than one second, input_data.py:484-487)."""
        clips = [np.asarray(c, dtype=np.float32) for c in clips
                 if len(c) > min_length]
        if not clips:
            raise ValueError("no background clip longer than %d" % min_length)
        lengths = np.array([len(c) for c in clips], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        return BackgroundBank(
            flat=torch.from_numpy(np.concatenate(clips)).to(device),
            starts=torch.from_numpy(starts.astype(np.int64)).to(device),
            lengths=torch.from_numpy(lengths).to(device))


def _uniform(generator: torch.Generator, batch: int,
             device: torch.device) -> torch.Tensor:
    return torch.rand(batch, generator=generator, device=device)


def sample_background_positions(generator: torch.Generator,
                                bank: BackgroundBank, batch_size: int,
                                num_samples: int) -> torch.Tensor:
    """Random crop start positions into the flat bank: a uniform clip,
    then a uniform offset in [0, len - num_samples] (input_data.py:481-487)."""
    device = bank.flat.device
    clip_idx = torch.randint(0, bank.num_clips, (batch_size,),
                             generator=generator, device=device)
    max_off = (bank.lengths[clip_idx] - num_samples).float()
    u = _uniform(generator, batch_size, device)
    offsets = torch.floor(u * max_off).long()
    return bank.starts[clip_idx] + offsets


def draw_volumes(generator: torch.Generator, is_silence: torch.Tensor,
                 cfg: AugmentConfig, batch_size: int,
                 use_background: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (foreground_volume, background_volume) per sample."""
    dev = is_silence.device

    def u():
        return _uniform(generator, batch_size, dev)

    zero = torch.zeros(batch_size, device=dev)
    if use_background:
        bg_hit = u() < cfg.background_frequency
        bg_vol = torch.where(bg_hit, u() * cfg.background_volume_range, zero)
        # silence-0.9 quirk: silence clips that missed the background
        # draw still get background (input_data.py:493-496)
        sil_hit = (~bg_hit) & is_silence & (
            u() < cfg.silence_background_frequency)
        bg_vol = torch.where(sil_hit, u() * cfg.silence_volume_range, bg_vol)
    else:
        bg_vol = zero
    r = cfg.foreground_volume_range
    fg_hit = u() < cfg.foreground_frequency
    fg_vol = torch.where(fg_hit, 1.0 + (2.0 * u() - 1.0) * r,
                         torch.ones(batch_size, device=dev))
    flip = u() < cfg.flip_frequency
    fg_vol = torch.where(flip, -fg_vol, fg_vol)
    fg_vol = torch.where(is_silence, zero, fg_vol)
    return fg_vol, bg_vol


def draw_augment_params(generator: torch.Generator,
                        is_silence: torch.Tensor, cfg: AugmentConfig,
                        background: Optional[BackgroundBank],
                        batch: int, num_samples: int,
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """All per-sample draws: (shifts, fg_vol, bg_pos, bg_vol), the inputs
    of the fused decode+augment kernel. ``bg_pos`` is zeros without a
    background bank."""
    dev = is_silence.device
    lo, hi = cfg.time_shift_range
    shift = torch.zeros(batch, dtype=torch.int64, device=dev)
    if cfg.time_shift_frequency > 0.0 and (lo, hi) != (0, 0):
        do_shift = _uniform(generator, batch, dev) < cfg.time_shift_frequency
        drawn = torch.randint(lo, hi + 1, (batch,), generator=generator,
                              device=dev)
        shift = torch.where(do_shift, drawn, shift)
    use_background = background is not None
    fg_vol, bg_vol = draw_volumes(generator, is_silence, cfg, batch,
                                  use_background)
    if use_background:
        bg_pos = sample_background_positions(generator, background, batch,
                                             num_samples)
    else:
        bg_pos = torch.zeros(batch, dtype=torch.int64, device=dev)
    return shift, fg_vol, bg_pos, bg_vol


def augment_batch(wav: torch.Tensor, is_silence: torch.Tensor) -> torch.Tensor:
    """The eval branch of the JAX ``augment_batch``: the reference's
    neutral feed (no shift, no background; foreground volume 1, or 0 for
    silence; make_submission.py:86-93). [B, T] float32 -> [B, T]."""
    return wav * (~is_silence).to(wav.dtype)[:, None]

