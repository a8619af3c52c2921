"""Shared-spectrum synthetic corpus: an accuracy benchmark that can fail
(port of the JAX package's tests/hard_corpus.py generator).

Every word is a sequence of three syllable tones from one shared
geometric inventory (ratio ``TONE_RATIO``), and six word pairs are shift
aliases (seq_B = seq_A + 1): word A at pitch ``p`` is exactly word B at
pitch ``p / TONE_RATIO``. Per-clip pitch is log-uniform with a span of
``pitch_span_l`` inventory steps, so a fraction (L-1)/L of clips is
genuinely ambiguous between the two members of a pair, and no model can
pass a Bayes accuracy ceiling of roughly 1 - (L-1)/(2L) on word clips
(about 0.86 at the default L = 1.4). Speaker-like variation (rate,
per-syllable jitter, harmonic timbre, random phase) and an SNR sweep sit
on top.

Numpy only; it writes through the port's ``save_wav_file``, and the same
arguments give files byte-identical to the JAX package's generator
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np

from speech_recognition_tpu_torch.data.wav import save_wav_file

SR = 16000

# Geometric tone inventory shared by EVERY word (Hz at pitch 1.0):
# f0 * TONE_RATIO**k. Geometric spacing is what makes index-shifted
# sequences exact pitch aliases of each other.
TONE_RATIO = 1.4
SHARED_TONES = [500.0 * TONE_RATIO ** k for k in range(4)]

# word -> sequence of tone indices. Six shift-aliased pairs (B = A+1):
#   yes->go, no->stop, up->off, right->on, down->cat, left->bed
# (cat/bed are the _unknown_ pool, so down/left alias against unknown).
WORD_SEQS = {
    "yes":   (0, 1, 2), "go":   (1, 2, 3),
    "no":    (0, 2, 1), "stop": (1, 3, 2),
    "up":    (1, 0, 2), "off":  (2, 1, 3),
    "right": (2, 1, 0), "on":   (3, 2, 1),
    "down":  (2, 0, 1), "cat":  (3, 1, 2),
    "left":  (1, 2, 0), "bed":  (2, 3, 1),
}

WANTED = ["yes", "no", "up", "down", "left", "right", "on", "off",
          "stop", "go"]


def _syllable(freq: float, length: int, amp: float,
              rng: np.random.Generator) -> np.ndarray:
    t = np.arange(length) / SR
    phase = rng.uniform(0, 2 * np.pi)
    # harmonic timbre: per-clip random 2nd/3rd harmonic mix ("voice")
    h2 = rng.uniform(0.1, 0.5)
    h3 = rng.uniform(0.0, 0.25)
    sig = (np.sin(2 * np.pi * freq * t + phase)
           + h2 * np.sin(4 * np.pi * freq * t)
           + h3 * np.sin(6 * np.pi * freq * t))
    env = np.hanning(max(length, 3))[:length]
    return (amp * sig * env).astype(np.float32)


def hard_clip(word: str, rng: np.random.Generator,
              snr_db_range=(2.0, 12.0),
              pitch_span_l: float = 1.4) -> np.ndarray:
    """One 1-second clip of ``word`` with speaker-like variation + noise.

    ``pitch_span_l`` is the log-uniform pitch span in inventory steps;
    values > 1 create genuine alias overlap (see module docstring).
    """
    seq = WORD_SEQS[word]
    half = 0.5 * pitch_span_l * np.log(TONE_RATIO)
    pitch = np.exp(rng.uniform(-half, half))
    rate = rng.uniform(0.78, 1.28)          # speaking rate
    amp = rng.uniform(0.25, 0.7)
    sig = np.zeros(SR, np.float32)
    # syllables ~180 ms nominal, per-syllable jitter, small gaps
    durs = [int(0.18 * SR * rate * rng.uniform(0.8, 1.25)) for _ in seq]
    gaps = [int(rng.uniform(0.0, 0.035) * SR) for _ in seq]
    total = sum(durs) + sum(gaps)
    onset = rng.integers(0, max(SR - total, 1))
    pos = onset
    for d, g, tone_idx in zip(durs, gaps, seq):
        f = SHARED_TONES[tone_idx] * pitch
        syl = _syllable(f, d, amp * rng.uniform(0.8, 1.2), rng)
        end = min(pos + d, SR)
        sig[pos:end] += syl[:end - pos]
        pos += d + g
        if pos >= SR:
            break
    # additive noise at a drawn SNR (the sweep that keeps this hard)
    snr_db = rng.uniform(*snr_db_range)
    sig_pow = float(np.mean(sig ** 2)) + 1e-12
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    sig = sig + rng.normal(0.0, np.sqrt(noise_pow), SR).astype(np.float32)
    return np.clip(sig, -1.0, 1.0).astype(np.float32)


def build_hard_corpus(root, clips_per_word: int = 60, seed: int = 0,
                      snr_db_range=(2.0, 12.0),
                      pitch_span_l: float = 1.4,
                      words=None) -> None:
    """Write WAVs under ``root/<word>/spkNNN_nohash_0.wav`` + noise bank."""
    rng = np.random.default_rng(seed)
    words = list(WORD_SEQS) if words is None else list(words)
    for word in words:
        d = root / word
        d.mkdir(parents=True, exist_ok=True)
        for i in range(clips_per_word):
            save_wav_file(str(d / f"spk{i:03d}_nohash_0.wav"),
                          hard_clip(word, rng, snr_db_range,
                                    pitch_span_l), SR)
    bg = root / "_background_noise_"
    bg.mkdir(exist_ok=True)
    save_wav_file(str(bg / "white_noise.wav"),
                  rng.normal(0, 0.06, SR * 10).astype(np.float32), SR)
    # babble-ish background: overlapping shared-inventory syllables
    babble = np.zeros(SR * 10, np.float32)
    for _ in range(120):
        f = SHARED_TONES[rng.integers(0, len(SHARED_TONES))] \
            * np.exp(rng.uniform(-0.2, 0.2))
        d = int(0.18 * SR * rng.uniform(0.7, 1.3))
        p = rng.integers(0, SR * 10 - d)
        babble[p:p + d] += 0.25 * _syllable(f, d, 0.5, rng)
    save_wav_file(str(bg / "babble.wav"),
                  np.clip(babble, -1, 1).astype(np.float32), SR)
