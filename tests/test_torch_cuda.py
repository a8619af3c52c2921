"""Card-only tests of the port: the CUDA kernel against its plain version
and the train step on the card. Marked ``cuda``; without a CUDA device
they skip. This file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.ops.kernels import decode_augment as K

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

T = 16000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, batch, num_clips, index_dtype, seed=0):
    g = np.random.default_rng(seed)
    bank = torch.from_numpy(g.integers(-32768, 32767, (num_clips, T),
                                       dtype=np.int16)).to(device)
    bg = torch.from_numpy(g.uniform(-0.2, 0.2, 3 * T).astype(
        np.float32)).to(device)
    fids = g.integers(0, num_clips, batch)
    fids[-1] = num_clips - 1
    shifts = g.integers(-T, T, batch)
    shifts[0] = 0
    fg = g.uniform(-1.5, 1.5, batch).astype(np.float32)
    fg[1] = 0.0
    bg_pos = g.integers(0, 2 * T + 1, batch)
    bg_pos[-1] = 2 * T
    bg_vol = g.uniform(0, 0.3, batch).astype(np.float32)
    bg_vol[2] = 0.0

    def idx(a):
        return torch.from_numpy(a).to(device, index_dtype)

    return (bank, bg, idx(fids), idx(shifts),
            torch.from_numpy(fg).to(device), idx(bg_pos),
            torch.from_numpy(bg_vol).to(device))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch", [3, 7, 384])
def test_kernel_matches_plain_version(cuda, batch, index_dtype):
    args = _inputs(cuda, batch, 64, index_dtype)
    before = K.LAUNCHES
    got = K.decode_augment(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.decode_augment_reference(*args)
    assert got.shape == (batch, T) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_kernel_writes_out_of_range_rows_as_nan(cuda):
    bank, bg, fids, shifts, fg, bg_pos, bg_vol = _inputs(
        cuda, 4, 8, torch.int64)
    fids[1] = 8                         # past the bank
    bg_pos[2] = bg.shape[0] - T + 1     # window past the background
    out = K.decode_augment(bank, bg, fids, shifts, fg, bg_pos, bg_vol)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and torch.isnan(out[2]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[3]).all()


def test_wrapper_rejects_non_contiguous_inputs(cuda):
    args = list(_inputs(cuda, 8, 8, torch.int64))
    args[3] = torch.stack([args[3], args[3]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        K.decode_augment(*args)


def test_train_steps_launch_the_kernel(cuda):
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    ds = synthetic_device_dataset(cuda, num_train=64, num_val=40,
                                  num_pseudo=8)
    trainer = Trainer("conv_1d_time_sliced_with_attention",
                      prepare_model_settings(label_count=12), ds,
                      batch_size=16)
    assert trainer.compute_dtype == "bfloat16"
    state = trainer.init_state()
    before = K.LAUNCHES
    metrics = trainer.train_many(state, 3)
    assert K.LAUNCHES == before + 3
    assert torch.isfinite(metrics["loss"]).all()
    conf, loss = trainer.evaluate(state)
    assert conf.sum() == 32 and np.isfinite(loss)
