"""The port's TTA ``Predictor`` and ``predict_directory`` against the JAX
package's, with the same flax weights moved by ``from_flax``.

* ``Predictor`` for both ported models (the flagship on raw waveforms,
  ``conv_1d_spec`` on the spectrogram), at batch 3, without TTA, with TTA,
  with speed TTA, and with speed TTA but no slow clip (the 3-variant
  mean), on float32 and int16 input: probabilities within 5e-5 absolute
  of the JAX Predictor's (measured worst 1.2e-6, conv_1d_spec without
  TTA; the flagship 1.9e-7);
* algebra inside the port: the TTA probabilities are the mean (or the
  6-term sum over 10) of the variants predicted one by one, within 1e-6,
  and int16 input gives the float result of x / 32768 bit for bit;
* the Predictor runs the model with TF32 off for cuDNN and matmuls (f32,
  where PyTorch's default lets convolutions take TF32) and puts the
  caller's flags back;
* ``predict_directory`` over a tree whose last batch is partial: the
  basenames are the JAX function's, the probabilities are the port's
  Predictor on the decoded, padded rows exactly, and the JAX
  ``predict_directory``'s within 5e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.infer import submission as JS
from speech_recognition_tpu.infer.tta import (
    Predictor as JaxPredictor, TTAConfig as JaxTTAConfig,
)
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.wav import (
    decode_batch_int16, save_wav_file,
)
from speech_recognition_tpu_torch.export.benchmark import (
    benchmark_inference, traced_inference_device_time,
)
from speech_recognition_tpu_torch.infer.submission import predict_directory
from speech_recognition_tpu_torch.infer.tta import (
    Predictor, TTAConfig, model_from_state,
)
from speech_recognition_tpu_torch.models.convert import (
    _LEAF, _module_name, from_flax,
)
from speech_recognition_tpu_torch.models.layers import BN_MOMENTUM, BatchNorm
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.ops.frontend import Frontend

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
B, T = 3, 16000
PROB_ATOL = 5e-5
ALGEBRA_ATOL = 1e-6
MODELS = {"conv_1d_time_sliced_with_attention": "raw", "conv_1d_spec": "spec"}
# mode -> (TTA flags, whether a slow clip is passed)
MODES = {
    "none": (dict(use_tta=False), False),
    "tta": (dict(), False),
    "speed": (dict(use_speed_tta=True), True),
    "speed_no_slow": (dict(use_speed_tta=True), False),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, representation, flax module, its variables, the port's model
    with the same weights). The 1-d parameters are moved off their
    constant init, and the BN statistics are the batch statistics of 8
    other clips (one train-mode pass of the port's model at momentum 0,
    moved back to flax), so eval-mode activations keep their scale and
    the probabilities depend on the input."""
    name = request.param
    rep = MODELS[name]
    module, _ = jax_build_model(name, num_classes=12)
    width = T if rep == "raw" else 98 * 257
    v = jax.device_get(jax.jit(lambda key: module.init(
        {"params": key}, jnp.zeros((2, width)), train=False))(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), v["params"])
    model, _ = build_model(name, num_classes=12)
    model.load_state_dict(from_flax(params, v["batch_stats"], model=name))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    calib = torch.from_numpy(
        rng.uniform(-0.6, 0.6, (8, T)).astype(np.float32))
    with torch.no_grad():
        model.train()(Frontend(prepare_model_settings(12)).features(
            calib, rep), torch.Generator())
    for bn in bns:
        bn.momentum = BN_MOMENTUM
    model.eval()
    port_state = model.state_dict()
    stats = {}
    for path, _ in _leaves(v["batch_stats"]):
        *mod, leaf = path
        key = f"{_module_name(tuple(mod), name)}.{_LEAF[leaf]}"
        node = stats
        for k in mod:
            node = node.setdefault(k, {})
        node[leaf] = port_state[key].numpy()
    return (name, rep, module, {"params": params, "batch_stats": stats},
            model)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _predictors(pair, mode):
    _, rep, module, _, model = pair
    flags, _ = MODES[mode]
    jax_pred = JaxPredictor(module, jax_prepare_model_settings(
        12, output_representation=rep), rep, JaxTTAConfig(**flags))
    pred = Predictor(model, prepare_model_settings(
        12, output_representation=rep), rep, TTAConfig(**flags), CPU)
    return jax_pred, pred


def _clips(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-20000, 20000, (B, T), dtype=np.int16)
    return rng.uniform(-0.6, 0.6, (B, T)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("mode", list(MODES))
def test_predictor_matches_jax(pair, mode, dtype):
    jax_pred, pred = _predictors(pair, mode)
    wav = _clips(1, dtype)
    slow = _clips(2, dtype) if MODES[mode][1] else None
    want = np.asarray(jax_pred.predict(pair[3], wav, slow))
    got = pred.predict(wav, slow).numpy()
    assert got.shape == want.shape == (B, 12)
    assert np.abs(got - want).max() <= PROB_ATOL
    # not a vacuous comparison: the probabilities depend on the clip
    assert np.ptp(want, axis=0).max() > 3e-3 and want.max() < 0.999


@pytest.mark.parametrize("mode", ["tta", "speed"])
def test_tta_is_the_stated_combination_of_single_variants(pair, mode):
    _, pred = _predictors(pair, mode)
    _, plain = _predictors(pair, "none")
    wav = torch.from_numpy(_clips(3))
    slow = torch.from_numpy(_clips(4))
    variants = [wav, torch.roll(wav, -1500, dims=1), 1.2 * wav]
    if mode == "speed":
        variants += [slow, torch.clamp(1.1 * slow, -1.0, 1.0), 0.9 * slow]
    singles = torch.stack([plain.predict(v) for v in variants])
    want = singles.sum(0) / 10.0 if mode == "speed" else singles.mean(0)
    got = pred.predict(wav, slow if mode == "speed" else None)
    assert (got - want).abs().max() <= ALGEBRA_ATOL


def test_speed_tta_without_a_slow_clip_is_the_three_variant_mean(pair):
    _, speed = _predictors(pair, "speed")
    _, tta = _predictors(pair, "tta")
    wav = _clips(5)
    assert torch.equal(speed.predict(wav), tta.predict(wav))


@pytest.mark.parametrize("mode", ["none", "speed"])
def test_int16_input_is_float_input_over_32768_bit_for_bit(pair, mode):
    _, pred = _predictors(pair, mode)
    ints, slow = _clips(6, np.int16), _clips(7, np.int16)
    got = pred.predict(ints, slow)
    want = pred.predict(ints.astype(np.float32) / np.float32(32768.0),
                        slow.astype(np.float32) / np.float32(32768.0))
    assert torch.equal(got, want)


def test_predictor_needs_a_card_unless_given_the_cpu(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(pair[4], prepare_model_settings(12), pair[1])


def test_model_from_state_is_the_model_in_eval_mode(pair):
    state = type("State", (), {"model": pair[4].train()})()
    assert model_from_state(state) is pair[4] and not pair[4].training


def test_inference_benchmarks_refuse_the_cpu(pair):
    _, pred = _predictors(pair, "none")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_inference(pred, batch_size=2, steps=1, warmup=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        traced_inference_device_time(pred, batch_size=2, steps=1, warmup=0)


def _tree(root, names, seed):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        n = T - 300 * i                    # some clips shorter than 1 s
        save_wav_file(os.path.join(root, name),
                      rng.uniform(-0.5, 0.5, n).astype(np.float32), T)


@pytest.mark.parametrize("mode", ["tta", "speed"])
def test_predict_directory_matches_jax(pair, mode, tmp_path):
    names = [f"clip_{i:03d}.wav" for i in (5, 0, 3, 1, 6, 2, 4)]
    test_dir, tta_dir = str(tmp_path / "test"), str(tmp_path / "tta")
    _tree(test_dir, names, 8)
    _tree(tta_dir, names, 9)
    tta = tta_dir if mode == "speed" else None
    jax_pred, pred = _predictors(pair, mode)
    batch = 3                              # 7 clips: the last batch has 1
    got_names, got = predict_directory(pred, test_dir, batch_size=batch,
                                       tta_dir=tta)
    want_names, want = JS.predict_directory(jax_pred, pair[3], test_dir,
                                            batch_size=batch, tta_dir=tta)
    assert got_names == want_names == sorted(names)
    assert got.shape == want.shape == (7, 12)
    assert np.abs(got - want).max() <= PROB_ATOL

    paths = [os.path.join(test_dir, n) for n in got_names]
    rows = np.zeros((9, T), np.int16)
    decode_batch_int16(paths, T, out=rows)
    slow_rows = np.zeros((9, T), np.int16)
    decode_batch_int16([os.path.join(tta_dir, n) for n in got_names], T,
                       out=slow_rows)
    direct = np.concatenate([
        pred.predict(rows[s:s + batch],
                     slow_rows[s:s + batch] if tta else None).numpy()
        for s in range(0, 9, batch)])[:7]
    assert np.array_equal(got, direct)


def test_predict_directory_decodes_through_the_native_library(
        pair, tmp_path, monkeypatch):
    """Each batch of clips, and of their slowed twins, is one call of the
    native decoder (``csrc/wavio.cc``), on the decode worker thread."""
    from speech_recognition_tpu_torch.data import wav as W

    lib, calls = W._library(), []

    class Counting:
        def wavio_decode_batch(self, *args):
            calls.append(args[1])
            return lib.wavio_decode_batch(*args)

    monkeypatch.setattr(W, "_library", Counting)
    names = [f"clip_{i:03d}.wav" for i in range(7)]
    test_dir, tta_dir = str(tmp_path / "test"), str(tmp_path / "tta")
    _tree(test_dir, names, 8)
    _tree(tta_dir, names, 9)
    _, pred = _predictors(pair, "speed")
    predict_directory(pred, test_dir, batch_size=3, tta_dir=tta_dir)
    assert sorted(calls) == [1, 1, 3, 3, 3, 3]


def test_predictor_runs_the_model_with_tf32_off_and_restores_the_flags(
        monkeypatch):
    """PyTorch lets cuDNN's convolutions take TF32 by default; the
    Predictor's float32 turns it off for cuDNN and matmuls around the
    model, and puts the caller's flags back."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return x.reshape(x.shape[0], -1)[:, :12]

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pred = Predictor(Probe(), prepare_model_settings(12), "raw",
                     TTAConfig(), CPU)
    probs = pred.predict(_clips(8, np.float32))
    assert probs.shape == (B, 12) and seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
