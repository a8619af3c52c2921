"""Plain reference of ``conv_1d_mfcc_and_raw`` (see--/speech_recognition
model.py:1564-1660) and of the features it takes (input_data.py:360-381,
437-448): a model of two inputs, the clip's MFCCs and the clip itself.

``features(wav)`` is the tf.signal pipeline, written from its
definition: the clip framed VALID (98 frames of 480 samples at a hop of
160), a periodic Hann window, ``torch.fft.rfft`` at 512 points, the
magnitude, an 80-bin HTK mel filterbank over 80-7600 Hz (1127 ln(1 +
f / 700), the DC row zeroed), ``log(mel + 1e-6)`` and a DCT-II scaled by
1 / sqrt(2 x 80), of which the first 60 coefficients are kept. The mel
and DCT matrices are built here in float64 and rounded once to the
clip's dtype. It returns ``(mfcc_flat [B, 98 x 60], wav)``, frames
first, as the reference flattens them.

``forward`` takes that pair: the MFCCs as NCW [B, 60, 98] into a VALID
conv of 64 filters of 3 with BatchNorm and relu6 (98 steps to 96); the
clip framed VALID as [B, 480, 98] into a VALID conv of 96 filters of 3
with BatchNorm and relu6; the two side by side (160 channels, 96 steps),
ten residual blocks in the published ``pool`` mode (xception's block,
``xception.py``) of widths and strides ``RESIDUALS`` (96 steps to 6),
the mean over time, Dropout 0.3 and a Dense to the classes with a bias.

FLOPs (``kws_bench/flops.py``, on the meta device, where ``rfft``
runs): the counter sees products, and the FFT is none, so ``train_mfu``
counts of the frontend its mel and DCT products (4,970,560 FLOPs a
clip, forward only: nothing before them needs a gradient) and not the
DFT, whatever the program computes it with.

Parameter names are the port's checkpoint keys. Departures from the
Keras model: tf.signal computes the mel matrix in float32 (here in
float64, rounded once); the max pool's gradient goes to one of tied
maxima (``xception.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kws_bench.reference import layers as L
from kws_bench.reference.xception import max_pool

SAMPLE_RATE = 16000
FRAME, HOP, FFT = 480, 160, 512           # 30 ms, 10 ms, next power of 2
MELS, MFCCS = 80, 60
LOWER_HZ, UPPER_HZ = 80.0, 7600.0
LOG_OFFSET = 1e-6
MFCC_STEM, RAW_STEM = 64, 96
# (width, stride) of the ten residual blocks
RESIDUALS = ((160, 1), (160, 1), (192, 2), (192, 1), (256, 2), (256, 1),
             (320, 2), (320, 1), (384, 2), (384, 1))
DROPOUT = 0.3


def valid_frames(x: torch.Tensor, length: int, step: int) -> torch.Tensor:
    """Clips [B, T] -> frames [B, n, length], no padding: n = 1 + (T -
    length) // step."""
    n = 1 + (x.shape[-1] - length) // step
    idx = step * torch.arange(n, device=x.device)[:, None] \
        + torch.arange(length, device=x.device)[None, :]
    return x[:, idx]


def mel_matrix(bins: int = FFT // 2 + 1) -> torch.Tensor:
    """tf.signal.linear_to_mel_weight_matrix in float64: [bins, MELS]
    triangles between MELS + 2 edges equally spaced in mel, each bin
    weighted by the lesser of its rising and falling slope, the DC bin a
    row of zeros."""
    freqs = torch.linspace(0.0, SAMPLE_RATE / 2.0, bins,
                           dtype=torch.float64)[1:]
    mel = 1127.0 * torch.log1p(freqs / 700.0)[:, None]
    edges = torch.linspace(1127.0 * math.log1p(LOWER_HZ / 700.0),
                           1127.0 * math.log1p(UPPER_HZ / 700.0), MELS + 2,
                           dtype=torch.float64)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    w = torch.minimum((mel - lower) / (center - lower),
                      (upper - mel) / (upper - center)).clamp_min(0.0)
    return torch.cat([torch.zeros(1, MELS, dtype=torch.float64), w])


def dct_matrix() -> torch.Tensor:
    """The unnormalised DCT-II, y_k = 2 sum_n x_n cos(pi k (2n + 1) /
    (2 MELS)), scaled by 1 / sqrt(2 MELS), its first MFCCS columns:
    [MELS, MFCCS] in float64."""
    n = torch.arange(MELS, dtype=torch.float64)[:, None]
    k = torch.arange(MFCCS, dtype=torch.float64)[None, :]
    return 2.0 * torch.cos(math.pi * k * (2.0 * n + 1.0) / (2.0 * MELS)) \
        / math.sqrt(2.0 * MELS)


def features(wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(MFCCs [B, 98 x 60] frames first, the clips [B, 16000]) of clips
    ``wav``, in the clips' dtype."""
    n = torch.arange(FRAME, dtype=torch.float64)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / FRAME)
    frames = valid_frames(wav, FRAME, HOP) \
        * hann.to(wav.dtype).to(wav.device)
    spec = torch.fft.rfft(frames, n=FFT).abs()
    mel = spec @ mel_matrix().to(wav.dtype).to(wav.device)
    mfcc = torch.log(mel + LOG_OFFSET) \
        @ dct_matrix().to(wav.dtype).to(wav.device)
    return mfcc.flatten(1), wav


def _residuals():
    """(name, cin, cout, stride) of the residual blocks."""
    out, c = [], MFCC_STEM + RAW_STEM
    for i, (w, s) in enumerate(RESIDUALS):
        out.append((f"Residual1D_{i}", c, w, s))
        c = w
    return out


def param_shapes(num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic;
    kind: kernel (the L2 penalty's), bias, bn_scale, bn_shift,
    running_mean, running_var."""
    out = [("ConvBN_0.conv.weight", (MFCC_STEM, MFCCS, 3), "kernel")]
    out += L.bn_shapes("ConvBN_0.bn", MFCC_STEM)
    out += [("ConvBN_1.conv.weight", (RAW_STEM, FRAME, 3), "kernel")]
    out += L.bn_shapes("ConvBN_1.bn", RAW_STEM)
    for name, cin, cout, stride in _residuals():
        if stride != 1:
            out += [(f"{name}.Conv_0.weight", (cout, cin, 1), "kernel")]
            out += L.bn_shapes(f"{name}.BatchNorm_0", cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_0", cin, cout)
        out += L.separable_shapes(f"{name}.DepthwiseConvBlock_1", cout, cout)
    c = RESIDUALS[-1][0]
    out += [("Dense_0.weight", (num_classes, c), "kernel"),
            ("Dense_0.bias", (num_classes,), "bias")]
    return out


def dropout_shapes(batch: int) -> List[Tuple[Tuple[int, ...], float]]:
    """The one mask, the head's Dropout on the pooled [B, 384]."""
    return [((batch, RESIDUALS[-1][0]), DROPOUT)]


def _conv_bn(p, prefix: str, x, train: bool, q: L.Quant):
    x = L.conv1d(x, p[f"{prefix}.conv.weight"], q=q)
    return L.relu6(L.bn(p, f"{prefix}.bn", x, train))


def forward(p: Dict[str, torch.Tensor],
            x: Tuple[torch.Tensor, torch.Tensor], train: bool,
            keep: Optional[Sequence[torch.Tensor]] = None,
            q: L.Quant = L.identity) -> torch.Tensor:
    """Logits [B, classes] of ``x`` = ``features(wav)``; ``keep``: the
    head's mask of ``dropout_shapes`` (train mode)."""
    mfcc, wav = x
    b, t = mfcc.shape[0], mfcc.shape[1] // MFCCS
    m = _conv_bn(p, "ConvBN_0", mfcc.reshape(b, t, MFCCS).transpose(1, 2),
                 train, q)
    r = _conv_bn(p, "ConvBN_1", valid_frames(wav, FRAME, HOP).transpose(1, 2),
                 train, q)
    x = torch.cat([m, r], dim=1)
    for name, _, _, stride in _residuals():
        shortcut = x
        if stride != 1:
            shortcut = L.bn(p, f"{name}.BatchNorm_0", L.conv1d(
                x, p[f"{name}.Conv_0.weight"], stride, "same", q=q), train)
        y = L.separable(p, f"{name}.DepthwiseConvBlock_0", x, 1, "same",
                        train, q)
        y = L.separable(p, f"{name}.DepthwiseConvBlock_1", y, 1, "same",
                        train, q)
        x = max_pool(y, 3, stride) + shortcut
    x = L.dropout(x.mean(dim=2), keep[0] if train else None, DROPOUT)
    return L.dense(x, p["Dense_0.weight"], p["Dense_0.bias"], q)
