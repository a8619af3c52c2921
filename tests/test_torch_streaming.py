"""The port's streaming mode against the JAX package's: the host prefetch
loader (``data/prefetch.py``) and the trainer's streamed steps
(``train/loop.py``: ``train_step_stream``, ``train_many_stream``,
``fit_streaming``, ``recalibrate_batch_stats_stream``).

The loader is held against the JAX loader batch for batch. The streamed
step is held against the JAX ``Trainer._stream_step``, run eagerly, with
the same augmentation draws fed to both sides (the JAX side's
``draw_augment_params`` patched to return them) and with the update in
float64 as tests/test_torch_slice.py runs it (dropout off on both sides,
the same tolerances): the JAX trainer's ``_forward_batch`` casts the
logits to float32, so its ``_update_step`` is replaced by the slice
test's float64 composition of the same functions. The model there is
``conv_1d_fast``, a raw-waveform model of four layers: eager JAX compiles
each operation on its own, ~45 s for the flagship's step on one CPU
thread, and the flagship's update is already held by the slice test; the
streamed data path does not depend on the model. The rest mirrors
tests/test_streaming_train.py and tests/test_prefetch.py.
"""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    AugmentConfig as JaxAugmentConfig,
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.data.device_bank import (
    synthetic_device_dataset as jax_synthetic_device_dataset,
)
from speech_recognition_tpu.data.prefetch import (
    HostPrefetchLoader as JaxLoader,
)
from speech_recognition_tpu.ops import augment as JAUG
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from speech_recognition_tpu_torch.config import (
    AugmentConfig, prepare_model_settings,
)
from speech_recognition_tpu_torch.data.device_bank import (
    build_device_dataset, synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.index import build_dataset_index
from speech_recognition_tpu_torch.data.prefetch import HostPrefetchLoader
from speech_recognition_tpu_torch.data.wav import (
    INT16_DECODE_SCALE, save_wav_file,
)
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.layers import (
    BatchNorm, Dropout, collect_batch_stats,
)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K
from speech_recognition_tpu_torch.train.loop import Draws, Trainer

import torch_zoo_parity as Z
from synth_corpus import build_corpus

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
FLAGSHIP = "conv_1d_time_sliced_with_attention"
PARITY_MODEL = "conv_1d_fast"
T = 16000
WANTED = ["yes", "no", "up", "down", "left", "right", "on", "off", "stop",
          "go"]
DATA = dict(num_train=32, num_val=20, num_pseudo=8, seed=3)
B = 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_corpus") / "audio"
    build_corpus(root, clips_per_word=6, seed=11)
    return build_dataset_index(
        data_dirs=[str(root)], silence_percentage=10.0,
        unknown_percentage=30.0, wanted_words=WANTED,
        validation_percentage=20.0, testing_percentage=0.0)


def _mfcc_settings():
    return prepare_model_settings(
        label_count=12, output_representation="mfcc",
        dct_coefficient_count=40, num_log_mel_features=40)


def _loader(index, batch_size=16, seed=5, **kw):
    return HostPrefetchLoader(
        index.files("training"), index.labels_array("training"),
        index.is_silence_array("training"), batch_size=batch_size,
        desired_samples=T, seed=seed, device=CPU, **kw)


def _val_trainer(index, model="simple", seed=0):
    settings = _mfcc_settings()
    ds = build_device_dataset(index, settings, CPU, modes=["validation"])
    return Trainer(model, settings, ds, batch_size=16, seed=seed)


# -- the loader ------------------------------------------------------------

def test_loader_yields_the_jax_loaders_batches(corpus):
    paths = corpus.files("training")
    labels = corpus.labels_array("training")
    silence = corpus.is_silence_array("training")
    with JaxLoader(paths, labels, silence, batch_size=8,
                   desired_samples=T, seed=5,
                   device=jax.devices("cpu")[0]) as jl:
        want = [tuple(np.asarray(a) for a in next(jl)) for _ in range(4)]
    with _loader(corpus, batch_size=8) as loader:
        got = [next(loader) for _ in range(4)]
    for (wav, lab, sil), (jwav, jlab, jsil) in zip(got, want):
        assert wav.dtype == torch.int16 and wav.shape == (8, T)
        assert lab.dtype == torch.int64 and sil.dtype == torch.bool
        np.testing.assert_array_equal(wav.numpy(), jwav)
        np.testing.assert_array_equal(lab.numpy(), jlab)
        np.testing.assert_array_equal(sil.numpy(), jsil)
    assert (np.abs(got[0][0].numpy()) > 0).any()


def test_loader_pads_short_clips_and_times_its_parts(tmp_path):
    paths = []
    for i in range(10):
        p = str(tmp_path / f"{i}.wav")
        save_wav_file(p, np.full(100, (i + 1) / 20.0, np.float32), 16000)
        paths.append(p)
    labels = np.arange(10) % 3
    with HostPrefetchLoader(paths, labels, labels == 0, batch_size=4,
                            desired_samples=200, seed=1,
                            device=CPU) as loader:
        for _ in range(3):
            wav, lab, sil = next(loader)
            assert wav.shape == (4, 200) and wav.dtype == torch.int16
            assert (wav[:, :100] != 0).all() and (wav[:, 100:] == 0).all()
            np.testing.assert_array_equal(sil.numpy(), lab.numpy() == 0)
    assert loader.timings["decode_s"] > 0
    assert set(loader.timings) == {"decode_s", "copy_s", "wait_s"}
    assert len(loader._slots) == loader.prefetch + 1


def test_producer_error_reaches_the_consumer(tmp_path):
    good = str(tmp_path / "good.wav")
    save_wav_file(good, np.full(100, 0.5, np.float32), 16000)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav")
    labels = np.zeros(2, np.int64)
    with HostPrefetchLoader([bad, good], labels, labels == 1, batch_size=4,
                            desired_samples=200, seed=0,
                            device=CPU) as loader:
        with pytest.raises(RuntimeError, match="producer") as err:
            for _ in range(50):     # the first batches may miss the bad file
                next(loader)
        assert isinstance(err.value.__cause__, ValueError)
        assert "bad.wav" in str(err.value.__cause__)
        with pytest.raises(RuntimeError, match="producer"):
            next(loader)            # raised again, no hang


def test_loader_keeps_its_ranks_shard(corpus):
    paths = corpus.files("training")
    loader = _loader(corpus, rank=1, world=3)
    assert loader.paths == paths[1::3]
    np.testing.assert_array_equal(
        loader.labels, corpus.labels_array("training")[1::3])
    with pytest.raises(RuntimeError, match="context manager"):
        next(loader)


# -- the streamed step -----------------------------------------------------

def _draws(rng, part, silence_rows, bg_len):
    fids = part.file_ids.numpy()[rng.integers(0, part.size, B)]
    labels = rng.integers(0, 12, B)
    silence = np.zeros(B, bool)
    silence[silence_rows] = True
    shifts = rng.integers(-500, 501, B)
    fg = rng.uniform(0.85, 1.15, B).astype(np.float32)
    fg[silence] = 0.0
    bg_pos = rng.integers(0, bg_len - T + 1, B)
    bg_vol = rng.uniform(0.0, 0.15, B).astype(np.float32)
    return fids, labels, silence, shifts, fg, bg_pos, bg_vol


def _bank_trainer(model=FLAGSHIP, seed=0):
    ds = synthetic_device_dataset(CPU, **DATA)
    return Trainer(model, prepare_model_settings(label_count=12), ds,
                   batch_size=B, seed=seed, compute_dtype="float32")


def test_stream_batch_equals_bank_batch_when_the_bank_is_the_batch():
    trainer = _bank_trainer()
    ds = trainer.dataset
    rng = np.random.default_rng(1)
    fids, labels, sil, shifts, fg, pos, vol = (
        torch.from_numpy(a) for a in _draws(
            rng, ds.partitions["training"], [0, 3],
            ds.background.flat.shape[0]))
    bank = trainer.build_batch(Draws(fids, labels, sil, shifts, fg, pos,
                                     vol))
    streamed = trainer.build_stream_batch(
        ds.wav_bank[fids], Draws(torch.arange(B), labels, sil, shifts, fg,
                                 pos, vol))
    assert torch.equal(streamed, bank)
    # an f32 batch already scaled goes back to int16 exactly: the same bits
    scaled = ds.wav_bank[fids].float() / INT16_DECODE_SCALE
    assert torch.equal(trainer.build_stream_batch(
        scaled, Draws(torch.arange(B), labels, sil, shifts, fg, pos, vol)),
        bank)


@pytest.mark.parametrize("offset", [0.25 / INT16_DECODE_SCALE, 1.0])
def test_f32_stream_batch_off_the_int16_grid_is_refused(offset):
    trainer = _bank_trainer()
    ds = trainer.dataset
    wav = ds.wav_bank[:B].float() / INT16_DECODE_SCALE
    wav[0, 0] = offset        # between two int16 steps, or past 32767
    d = Draws(torch.arange(B), torch.zeros(B, dtype=torch.int64),
              torch.zeros(B, dtype=torch.bool),
              torch.zeros(B, dtype=torch.int64), torch.ones(B),
              torch.zeros(B, dtype=torch.int64), torch.zeros(B))
    with pytest.raises(ValueError, match="int16"):
        trainer.build_stream_batch(wav, d)


def test_stream_step_draws_from_the_trainers_generator():
    """train_step_stream = draw_stream from the trainer's generator, the
    batch built as its own bank, then the bank path's update."""
    a, b = _bank_trainer(seed=4), _bank_trainer(seed=4)
    sa, sb = a.init_state(), b.init_state()
    ds = a.dataset
    wav = ds.wav_bank[:B].clone()
    labels = ds.partitions["training"].labels[:B]
    sil = ds.partitions["training"].is_silence[:B]
    ma = a.train_step_stream(sa, wav, labels, sil)
    d = b.draw_stream(labels, sil)
    assert torch.equal(d.file_ids, torch.arange(B))
    mb = b._update_step(sb, b.build_batch(Draws(
        torch.arange(B), labels, sil, d.shifts, d.fg_vol, d.bg_pos,
        d.bg_vol)), labels)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, p), q in zip(sa.model.state_dict().items(),
                         sb.model.state_dict().values()):
        assert torch.equal(p, q), k
    assert sa.step == sb.step == 1
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def stream_parity():
    """One streamed step on both sides, in float64, from the same flax
    weights, int16 batch and augmentation draws."""
    trainer = _bank_trainer(PARITY_MODEL)
    ds = trainer.dataset
    jds = jax_synthetic_device_dataset(chunked=False, **DATA)
    state = trainer.init_state()
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    module, params, batch_stats = Z.flax_weights(PARITY_MODEL)
    state.model.load_state_dict(from_flax(params, batch_stats,
                                          model=PARITY_MODEL))
    state.model.double()

    rng = np.random.default_rng(7)
    fids, labels, sil, shifts, fg, pos, vol = _draws(
        rng, ds.partitions["training"], [2], ds.background.flat.shape[0])
    wav = ds.wav_bank[torch.from_numpy(fids)]
    d = Draws(torch.arange(B), *(torch.from_numpy(a) for a in (
        labels, sil, shifts, fg, pos, vol)))
    x = trainer.build_stream_batch(wav, d)
    metrics = trainer._update_step(state, x.double(), d.labels)
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}

    jtrainer = JaxTrainer(
        model_name=PARITY_MODEL, settings=jax_prepare_model_settings(
            label_count=12), dataset=None, background=jds.background,
        augment=JaxAugmentConfig(), batch_size=B, compute_dtype="float32")
    captured = {}

    def update_f64(jstate, jx, jlabels, k_drop):
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), params)
            stats = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), batch_stats)
            spec = jtrainer.spec

            def loss_fn(p):
                with fnn.intercept_methods(_no_dropout):
                    logits, _ = module.apply(
                        {"params": p, "batch_stats": stats},
                        jnp.asarray(jx, jnp.float64), train=True,
                        mutable=["batch_stats"])
                return (JO.smooth_cross_entropy(logits, jlabels,
                                                spec.label_smoothing)
                        + JO.l2_kernel_penalty(p, spec.l2_reg))

            loss, g = jax.value_and_grad(loss_fn)(p64)
            captured.update(x=np.asarray(jx), loss=float(loss),
                            grads=from_flax(jax.device_get(g), {},
                                            model=PARITY_MODEL))
        return jstate, {}

    def given_draws(key, is_silence, cfg, background, batch, num_samples):
        return (jnp.asarray(shifts, jnp.int32), jnp.asarray(fg),
                jnp.asarray(pos, jnp.int32), jnp.asarray(vol))

    with mock.patch.object(JAUG, "draw_augment_params", given_draws), \
            mock.patch.object(jtrainer, "_update_step", update_f64):
        jtrainer._stream_step(None, jax.random.PRNGKey(0),
                              jnp.asarray(wav.numpy()), jnp.asarray(labels),
                              jnp.asarray(sil), jtrainer.background)
    return dict(x=x.numpy(), loss=float(metrics["loss"]), grads=grads,
                **{f"j{k}": val for k, val in captured.items()})


def test_stream_batch_matches_jax(stream_parity):
    r = stream_parity
    np.testing.assert_allclose(r["x"], r["jx"], rtol=0, atol=1e-6)


def test_stream_loss_matches_jax(stream_parity):
    r = stream_parity
    assert abs(r["loss"] - r["jloss"]) < 1e-9


def test_stream_gradients_match_jax(stream_parity):
    r = stream_parity
    assert set(r["grads"]) == set(r["jgrads"])
    for k, g in r["jgrads"].items():
        np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_int16_wire_format_equals_an_f32_batch_already_scaled(corpus):
    t1, t2 = _val_trainer(corpus), _val_trainer(corpus)
    s1, s2 = t1.init_state(), t2.init_state()
    with _loader(corpus) as loader:
        wav, labels, silence = next(loader)
    m1 = t1.train_step_stream(s1, wav, labels, silence)
    m2 = t2.train_step_stream(s2, wav.float() / INT16_DECODE_SCALE, labels,
                              silence)
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(p, q)


def test_stream_step_launches_the_kernel_path_once(corpus):
    trainer = _val_trainer(corpus)
    state = trainer.init_state()
    calls = []
    plain = K.decode_augment_reference

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    with _loader(corpus) as loader, \
            mock.patch.object(K, "decode_augment_reference", counting):
        trainer.train_step_stream(state, *next(loader))
    assert calls == [(16, T)]        # the batch is the kernel's bank


# -- the streamed loops ----------------------------------------------------

def test_fit_streaming_trains_and_evaluates(corpus):
    trainer = _val_trainer(corpus)
    assert "training" not in trainer.dataset.partitions
    state = trainer.init_state()
    with _loader(corpus) as loader:
        state, hist = trainer.fit_streaming(state, loader, steps=5)
    assert state.step == 5
    assert np.isfinite(hist["loss"][-1])
    assert hist["clips_per_sec"][0] > 0
    conf, val_loss = trainer.evaluate(state)
    assert conf.sum() > 0 and np.isfinite(val_loss)
    # the bank path's APIs refuse a trainer with no training partition
    with pytest.raises(ValueError, match="streaming"):
        trainer.train_step(state)
    with pytest.raises(ValueError, match="streaming"):
        trainer.fit(state, epochs=1)


def test_fit_streaming_chunked_dispatch(corpus):
    trainer = _val_trainer(corpus)
    state = trainer.init_state()
    with _loader(corpus) as loader:
        state, hist = trainer.fit_streaming(state, loader, steps=5,
                                            steps_per_dispatch=2)
    assert state.step == 5 and np.isfinite(hist["loss"][-1])


def test_train_many_stream_equals_single_steps(corpus):
    t1, t2 = _val_trainer(corpus), _val_trainer(corpus)
    s1, s2 = t1.init_state(), t2.init_state()
    with _loader(corpus) as loader:
        batches = [next(loader) for _ in range(3)]
    singles = [t1.train_step_stream(s1, *b)["loss"] for b in batches]
    many = t2.train_many_stream(s2, *(torch.stack(x)
                                      for x in zip(*batches)))
    assert many["loss"].shape == (3,)
    assert torch.equal(many["loss"], torch.stack(singles))
    assert s1.step == s2.step == 3
    for p, q in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(p, q)


def test_recalibrate_batch_stats_stream(corpus):
    trainer = _val_trainer(corpus, model="conv_2d_fast")
    state = trainer.init_state()
    with _loader(corpus) as loader:
        trainer.recalibrate_batch_stats_stream(state, loader, 2)
    # the same two batches and draws by hand
    model = _val_trainer(corpus, model="conv_2d_fast").init_state().model
    model.train()
    g = torch.Generator().manual_seed(trainer.seed + 9)
    with _loader(corpus) as loader, torch.no_grad(), \
            collect_batch_stats(model) as stats:
        for _ in range(2):
            wav, labels, silence = next(loader)
            model(trainer.build_stream_batch(
                wav, trainer.draw_stream(labels, silence, g)), g)
    assert stats
    batchnorms = [(n, m) for n, m in state.model.named_modules()
                  if isinstance(m, BatchNorm)]
    assert len(batchnorms) == len(stats)
    for (name, bn), want in zip(batchnorms, stats.values()):
        means, variances = zip(*want)
        torch.testing.assert_close(bn.running_mean,
                                   torch.stack(means).mean(0),
                                   rtol=0, atol=0, msg=name)
        torch.testing.assert_close(bn.running_var,
                                   torch.stack(variances).mean(0),
                                   rtol=0, atol=0, msg=name)
    conf, val_loss = trainer.evaluate(state)
    assert np.isfinite(val_loss)

