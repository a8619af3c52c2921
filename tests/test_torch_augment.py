"""Port's augmentation draws, sampler and dataset vs the JAX package.

A torch.Generator cannot replay jax.random streams, so the draws are held
by distribution (as tests/test_augment.py holds the JAX ones): each
frequency within ±0.05 of its target at 4096 draws (standard error
<= 0.008, so the band is > 6 sigma). What is deterministic — the
synthetic dataset, decode, eval augmentation, eval ids — is held
exactly against the JAX functions on the same seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu import config as jax_config
from speech_recognition_tpu.data.device_bank import (
    synthetic_device_dataset as jax_synthetic_device_dataset,
)
from speech_recognition_tpu.ops import augment as jax_aug
from speech_recognition_tpu_torch import config
from speech_recognition_tpu_torch.config import AugmentConfig
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.ops import augment as aug
from speech_recognition_tpu_torch.ops.frontend import Frontend

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 4096


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_training_distributions():
    silence = torch.zeros(N, dtype=torch.bool)
    cfg = AugmentConfig(background_frequency=0.5, background_volume_range=0.2,
                        foreground_frequency=0.5, foreground_volume_range=0.3,
                        time_shift_frequency=0.0, flip_frequency=0.25)
    fg, bg = aug.draw_volumes(_gen(2), silence, cfg, N, use_background=True)
    fg, bg = fg.numpy(), bg.numpy()
    assert 0.2 < (fg < 0).mean() < 0.3                  # flips
    assert 0.45 < (np.abs(fg) == 1.0).mean() < 0.55     # no volume draw
    assert np.abs(fg).max() <= 1.3 + 1e-6
    assert np.abs(fg).min() >= 0.7 - 1e-6
    assert 0.45 < (bg == 0).mean() < 0.55
    assert bg.max() < 0.2


def test_silence_background_quirk():
    # silence rows that miss the background draw still get background
    # w.p. 0.9 with silence_volume_range (input_data.py:493-496)
    silence = torch.ones(N, dtype=torch.bool)
    cfg = AugmentConfig(background_frequency=0.0, silence_volume_range=0.4,
                        silence_background_frequency=0.9)
    fg, bg = aug.draw_volumes(_gen(3), silence, cfg, N, use_background=True)
    fg, bg = fg.numpy(), bg.numpy()
    assert (fg == 0).all()
    assert 0.85 < (bg > 0).mean() < 0.95
    assert bg.max() < 0.4


def test_silence_quirk_matches_jax_rates():
    # half the rows silent, default policy: both packages give the same
    # rates of background on silent and on speech rows
    silence = np.arange(N) % 2 == 0
    cfg = AugmentConfig()
    _, bg = aug.draw_volumes(_gen(4), torch.from_numpy(silence), cfg, N,
                             use_background=True)
    _, jbg = jax_aug.draw_volumes(jax.random.PRNGKey(4),
                                  jnp.asarray(silence),
                                  jax_config.AugmentConfig(), N,
                                  use_background=True)
    bg, jbg = bg.numpy(), np.asarray(jbg)
    for rows in (silence, ~silence):
        assert abs((bg[rows] > 0).mean() - (jbg[rows] > 0).mean()) < 0.05


def test_no_background_means_zero_volume_and_position():
    cfg = AugmentConfig(background_frequency=1.0)
    shift, fg, bg_pos, bg_vol = aug.draw_augment_params(
        _gen(5), torch.zeros(64, dtype=torch.bool), cfg, None, 64, 16000)
    assert (bg_vol == 0).all() and (bg_pos == 0).all()
    assert shift.dtype == torch.int64 and bg_pos.dtype == torch.int64


def test_time_shift_draws():
    cfg = AugmentConfig(time_shift_frequency=0.3, time_shift_range=(-500, 0))
    shift, _, _, _ = aug.draw_augment_params(
        _gen(6), torch.zeros(N, dtype=torch.bool), cfg, None, N, 16000)
    shift = shift.numpy()
    assert shift.min() >= -500 and shift.max() <= 0
    assert 0.25 < (shift != 0).mean() < 0.35
    off = AugmentConfig(time_shift_frequency=0.0)
    shift, _, _, _ = aug.draw_augment_params(
        _gen(6), torch.zeros(8, dtype=torch.bool), off, None, 8, 16000)
    assert (shift == 0).all()


def test_background_positions_stay_inside_one_clip():
    bank = aug.BackgroundBank.from_arrays(
        [np.arange(30000, dtype=np.float32),
         np.arange(50000, dtype=np.float32) + 1e6], 16000, CPU)
    pos = aug.sample_background_positions(_gen(7), bank, N, 16000).numpy()
    first = pos < 30000
    assert 0.45 < first.mean() < 0.55                 # uniform clip choice
    assert (pos[first] + 16000 <= 30000).all()
    assert (pos[~first] >= 30000).all()
    assert (pos[~first] + 16000 <= 80000).all()


def test_background_bank_rejects_short_clips():
    with pytest.raises(ValueError):
        aug.BackgroundBank.from_arrays([np.zeros(100)], 16000, CPU)


def test_eval_augment_matches_jax():
    rng = np.random.default_rng(0)
    wav = rng.uniform(-1, 1, (4, 100)).astype(np.float32)
    silence = np.array([True, False, False, True])
    want = jax_aug.augment_batch(jax.random.PRNGKey(1), jnp.asarray(wav),
                                 jnp.asarray(silence),
                                 jax_config.AugmentConfig(),
                                 background=None, training=False)
    got = aug.augment_batch(torch.from_numpy(wav), torch.from_numpy(silence))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cls", ["ModelSettings", "AugmentConfig"])
def test_config_fields_match_jax(cls):
    def fields(module):
        return [(f.name, f.default) for f in
                dataclasses.fields(getattr(module, cls))]
    assert fields(config) == fields(jax_config)


@pytest.mark.parametrize("representation", config.OUTPUT_REPRESENTATIONS)
def test_prepare_model_settings_matches_jax(representation):
    kw = dict(label_count=12, window_size_ms=25.0,
              output_representation=representation)
    assert (dataclasses.asdict(config.prepare_model_settings(**kw))
            == dataclasses.asdict(jax_config.prepare_model_settings(**kw)))
    with pytest.raises(ValueError):
        config.prepare_model_settings(12, output_representation="wav")


def test_synthetic_dataset_matches_jax_on_one_seed():
    kw = dict(num_train=24, num_val=8, num_pseudo=4, desired_samples=512,
              background_len=2048, seed=11)
    ds = synthetic_device_dataset(CPU, **kw)
    jds = jax_synthetic_device_dataset(chunked=False, **kw)
    np.testing.assert_array_equal(ds.wav_bank.numpy(),
                                  np.asarray(jds.wav_bank))
    for mode in ("training", "validation", "pseudo", "testing"):
        p, jp = ds.partitions[mode], jds.partitions[mode]
        np.testing.assert_array_equal(p.file_ids.numpy(),
                                      np.asarray(jp.file_ids))
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(jp.labels))
        np.testing.assert_array_equal(p.is_silence.numpy(),
                                      np.asarray(jp.is_silence))
    for name in ("flat", "starts", "lengths"):
        np.testing.assert_array_equal(
            getattr(ds.background, name).numpy(),
            np.asarray(getattr(jds.background, name)))


def test_decode_and_unprocessed_data_match_jax():
    kw = dict(num_train=16, num_val=8, num_pseudo=4, desired_samples=256,
              background_len=1024, seed=12)
    ds = synthetic_device_dataset(CPU, **kw)
    jds = jax_synthetic_device_dataset(chunked=False, **kw)
    ids = np.array([0, 5, 17, 27])
    np.testing.assert_array_equal(
        ds.decode(torch.from_numpy(ids)).numpy(),
        np.asarray(jds.decode(jnp.asarray(ids, jnp.int32))))
    wav, labels = ds.get_unprocessed_data("validation", 6, offset=1)
    jwav, jlabels = jds.get_unprocessed_data("validation", 6, offset=1)
    np.testing.assert_array_equal(wav.numpy(), np.asarray(jwav))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_eval_ids_sequential():
    ds = synthetic_device_dataset(CPU, num_train=64, num_val=16)
    f0, _, _ = ds.eval_ids("validation", 0, 8)
    f1, _, _ = ds.eval_ids("validation", 8, 8)
    assert f0.tolist() == list(range(64, 72))
    assert f1.tolist() == list(range(72, 80))


def test_sampler_pseudo_frequency():
    ds = synthetic_device_dataset(CPU, num_train=64, num_pseudo=8,
                                  desired_samples=256, background_len=1024)
    fids, labels, sil = ds.sample_train_ids(_gen(5), N, pseudo_frequency=0.5)
    fids = fids.numpy()
    pseudo = (fids >= 64 + 16) & (fids < 64 + 16 + 8)   # pseudo rows
    assert 0.45 < pseudo.mean() < 0.55
    assert ((fids < 64) | pseudo).all()
    # labels and silence flags travel with the sampled rows
    all_labels = torch.cat([ds.partitions[m].labels for m in
                            ("training", "validation", "pseudo")])
    assert (labels == all_labels[fids]).all()
    assert (sil == (labels == 0)).all()
    none, _, _ = ds.sample_train_ids(_gen(5), N, pseudo_frequency=0.0)
    assert (none.numpy() < 64).all()


def test_frontend_raw_only():
    wav = torch.zeros(2, 16)
    front = Frontend(config.prepare_model_settings(12))
    assert front.features(wav) is wav
    assert front.features(wav, "raw") is wav
    with pytest.raises(ValueError, match="unknown representation"):
        front.features(wav, "wav")
