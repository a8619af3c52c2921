"""FLOPs of the two configurations and decode+augment's bytes at the
cells' shapes, against values worked out by hand."""

import torch

from kws_bench import flops
from kws_bench.reference import draws as D
from kws_bench.reference import flagship, steffenet
from kws_bench.traffic import _train as T

B = 384


def _flagship_forward_by_hand(b):
    f = 2 * b * 128 * 399 * 40 * 3            # stem: 800 frames -> 399
    t, c = 399, 128
    f += 2 * b * c * 397 * 3 + 2 * b * 128 * 397 * c     # block 0
    t = 397
    for w in (192, 256, 320, 384, 512):
        t2 = -(-t // 2)                        # SAME stride 2
        f += 2 * b * c * t2 * 3 + 2 * b * w * t2 * c
        t3 = t2 - 2                            # VALID 3
        f += 2 * b * w * t3 * 3 + 2 * b * w * t3 * w
        t, c = t3, w
    assert t == 9
    f += 2 * b * 9 * 512 * 9 + 2 * b * 1024 * 12
    return f


def _steffenet_forward_by_hand(b):
    f = 2 * b * 256 * 320 * 75                # stem: 16000 / 50
    f += 2 * b * 256 * 320 * 3 + 2 * b * 256 * 320 * 256
    t, c = 320, 256
    for w in (320, 384, 512, 768, 1024, 1536):
        t //= 2
        f += 2 * b * w * t * c                 # shortcut 1x1 stride 2
        f += 2 * b * c * t * 3 + 2 * b * w * t * c
        f += 3 * (2 * b * w * t * 3 + 2 * b * w * t * w)
        c = w
    return f + 2 * b * 3072 * 12


def _count(model):
    shapes = model.param_shapes(12)
    keep = [torch.ones(s, dtype=torch.bool, device="meta")
            for s, _ in model.dropout_shapes(B)]
    return flops.count_flops(
        lambda p, x: model.forward(p, x, True, keep),
        {n: s for n, s, _ in shapes},
        {n: k not in ("running_mean", "running_var") for n, _, k in shapes},
        B, 16000)


def test_flagship_flops():
    c = _count(flagship)
    fwd = _flagship_forward_by_hand(B)
    assert c["forward"] == fwd == 112_472_448 * B
    stem = 2 * B * 128 * 399 * 40 * 3          # its input needs no grad
    assert c["backward"] == 2 * fwd - stem
    assert c["step"] == T.step_flops(flagship, {"num_classes": 12,
                                                "batch_size": B,
                                                "clip_samples": 16000})


def test_steffenet_flops():
    c = _count(steffenet)
    fwd = _steffenet_forward_by_hand(B)
    assert c["forward"] == fwd == 711_917_568 * B
    assert c["backward"] == 2 * fwd - 2 * B * 256 * 320 * 75


def test_decode_augment_bytes():
    b, t = 4, 16000
    d = D.Draws(file_ids=torch.arange(b), labels=torch.zeros(b),
                is_silence=torch.tensor([True, False, False, False]),
                shifts=torch.zeros(b, dtype=torch.int64),
                fg_vol=torch.tensor([0.0, 1.0, -0.9, 1.1]),
                bg_pos=torch.zeros(b, dtype=torch.int64),
                bg_vol=torch.tensor([0.2, 0.0, 0.1, 0.0]))
    # 3 clip rows of int16, 2 background crops and 4 output rows of f32
    assert D.decode_augment_bytes(d, t) == t * (3 * 2 + 2 * 4 + 4 * 4)
