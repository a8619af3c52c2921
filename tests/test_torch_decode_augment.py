"""Port's fused decode+augment vs the JAX Pallas kernel and jnp path.

The CUDA kernel runs only on a card; here the wrapper takes its plain
PyTorch version (CPU tensors), which is what the kernel is held against
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: atol 1e-6 on outputs of magnitude < 0.5 — both sides compute
the same products in float32 in the same order, so they agree to f32
rounding (~3e-8); the bound leaves room for a different rounding of the
fused forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops.augment import (
    BackgroundBank as JaxBackgroundBank, rolled_decode_augment,
)
from speech_recognition_tpu.ops.pallas.augment_kernel import (
    double_bank, fused_decode_augment,
)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs(batch, t, seed=0, num_clips=8):
    """Numpy inputs with negative and zero shifts, silence (fg 0), bg_vol
    0 and the largest legal background position."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(-3000, 3000, (num_clips, t), dtype=np.int16)
    bg_flat = rng.uniform(-0.2, 0.2, 4 * t).astype(np.float32)
    fids = rng.integers(0, num_clips, batch).astype(np.int32)
    fids[-1] = num_clips - 1
    shifts = rng.integers(-t // 32, 1, batch).astype(np.int32)
    shifts[0] = 0
    fg = rng.uniform(0.5, 1.5, batch).astype(np.float32)
    fg[1 % batch] = 0.0                       # silence row
    bg_pos = rng.integers(0, 3 * t, batch).astype(np.int32)
    bg_pos[-1] = bg_flat.shape[0] - t         # largest legal position
    bg_vol = rng.uniform(0, 0.3, batch).astype(np.float32)
    bg_vol[0] = 0.0
    return bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol


def _port(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol):
    args = [torch.from_numpy(a) for a in
            (bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol)]
    return K.decode_augment(*args).numpy()


def _numpy_reference(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol):
    t = bank.shape[1]
    rows = [np.roll(bank[f].astype(np.float32) * (fg[b] / np.float32(32768)),
                    shifts[b])
            + bg_flat[bg_pos[b]:bg_pos[b] + t] * bg_vol[b]
            for b, f in enumerate(fids)]
    return np.stack(rows)


@pytest.mark.parametrize("batch,t", [(4, 512), (3, 16000)])
def test_plain_matches_pallas_kernel_interpret(batch, t):
    ins = _inputs(batch, t)
    want = np.asarray(fused_decode_augment(
        *[jnp.asarray(a) for a in ins], interpret=True))
    np.testing.assert_allclose(_port(*ins), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch,t", [(4, 512), (3, 16000), (16, 1024)])
def test_plain_matches_rolled_decode_augment(batch, t):
    bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol = _inputs(batch, t, 1)
    background = JaxBackgroundBank.from_arrays([bg_flat], t)
    want = np.asarray(rolled_decode_augment(
        double_bank(jnp.asarray(bank)), background, jnp.asarray(fids),
        jnp.asarray(shifts), jnp.asarray(fg), jnp.asarray(bg_pos),
        jnp.asarray(bg_vol), num_samples=t))
    got = _port(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_plain_matches_numpy_roll(index_dtype):
    ins = list(_inputs(5, 640, 2))
    for i in (2, 3, 5):
        ins[i] = ins[i].astype(index_dtype)
    np.testing.assert_allclose(_port(*ins), _numpy_reference(*ins),
                               rtol=0, atol=ATOL)


def test_zero_shift_and_volume():
    bank = np.full((2, 256), 16384, dtype=np.int16)
    bg = np.zeros(512, np.float32)
    got = _port(bank, bg, np.array([0, 1], np.int32),
                np.zeros(2, np.int32), np.array([1.0, 0.0], np.float32),
                np.zeros(2, np.int32), np.zeros(2, np.float32))
    np.testing.assert_allclose(got[0], 0.5)
    np.testing.assert_allclose(got[1], 0.0)
    jax_got = np.asarray(fused_decode_augment(
        jnp.asarray(bank), jnp.asarray(bg), jnp.asarray([0, 1], jnp.int32),
        jnp.zeros(2, jnp.int32), jnp.asarray([1.0, 0.0], jnp.float32),
        jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.float32), interpret=True))
    np.testing.assert_array_equal(got, jax_got)


def test_full_shift_range_wraps_like_np_roll():
    # every shift in [-T, T] on one clip, including |s| = T (no-op)
    t = 64
    bank = np.arange(t, dtype=np.int16)[None, :] * 100
    shifts = np.arange(-t, t + 1, dtype=np.int64)
    b = shifts.shape[0]
    ins = (bank, np.zeros(t, np.float32), np.zeros(b, np.int64), shifts,
           np.ones(b, np.float32), np.zeros(b, np.int64),
           np.zeros(b, np.float32))
    np.testing.assert_array_equal(_port(*ins), _numpy_reference(*ins))


def test_cpu_path_does_not_count_launches():
    before = K.LAUNCHES
    _port(*_inputs(2, 256))
    assert K.LAUNCHES == before


@pytest.mark.parametrize("field,bad", [
    ("bank", lambda a: a.astype(np.int32)),
    ("bg_flat", lambda a: a.astype(np.float64)),
    ("fids", lambda a: a.astype(np.float32)),
    ("shifts", lambda a: a.astype(np.int64)),   # mixed index dtypes
    ("fg", lambda a: a[:-1]),
    ("bg_vol", lambda a: a.astype(np.float64)),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(field, bad):
    names = ["bank", "bg_flat", "fids", "shifts", "fg", "bg_pos", "bg_vol"]
    ins = list(_inputs(3, 256))
    i = names.index(field)
    ins[i] = bad(ins[i])
    with pytest.raises(ValueError):
        _port(*ins)


def test_wrapper_rejects_tensors_on_different_devices():
    ins = [torch.from_numpy(a) for a in _inputs(3, 256)]
    ins[1] = ins[1].to("meta")
    with pytest.raises(ValueError):
        K.decode_augment(*ins)
