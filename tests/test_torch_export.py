"""The port's edge export (``export/aot.py``, ``tools.freeze``,
``tools.run_edge_inference``) against the JAX package's.

Both sides get the same weights: a flax tree drawn with numpy
(``tests/torch_zoo_parity.py::flax_weights``: random kernels; the
head's kernel scaled up and the BN statistics taken from the test clips,
so that the probabilities are far from uniform and differ by clip),
moved between the layouts with ``from_flax`` and ``to_flax``. The JAX artifact is the JAX package's
``export_inference`` + ``load_exported``; the port's archive runs on the
CPU. The budgets are those of tests/test_edge_budget.py.
"""

import copy
import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.export import aot as JA
from speech_recognition_tpu.ops.frontend import Frontend as JaxFrontend
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.wav import save_wav_file
from speech_recognition_tpu_torch.export import aot as A
from speech_recognition_tpu_torch.labels import get_int2label
from speech_recognition_tpu_torch.models.convert import (
    _LEAF, _module_name, _to_torch_layout, to_flax,
)
from speech_recognition_tpu_torch.models.layers import collect_batch_stats
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.ops.frontend import Frontend
from speech_recognition_tpu_torch.tools import (
    freeze, run_edge_inference,
)
from speech_recognition_tpu_torch.tools.convert import convert_32_to_12
from speech_recognition_tpu_torch.train.checkpoint import save_checkpoint
from speech_recognition_tpu_torch.train.loop import TrainState
from speech_recognition_tpu_torch.train.optim import build_optimizer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_zoo_parity as Z  # noqa: E402

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
FLAGSHIP = "conv_1d_time_sliced_with_attention"
REPRESENTATION = {FLAGSHIP: "raw", "conv_1d_spec": "spec"}
ARTIFACT_BYTE_BUDGET = 5_000_000   # README.md:14 "<5,000,000 bytes"
PARAM_BUDGET = 1_250_000           # README.md:14 "<1.25M weights"
CLIPS = 3
HEAD_GAIN = 20.0


def _signals():
    """Eight clips: noise, a tone and a chirp at several levels."""
    rng = np.random.default_rng(3)
    t = np.arange(16000) / 16000.0
    out = []
    for i in range(8):
        level = 0.05 + 0.12 * i
        out.append([rng.uniform(-level, level, 16000),
                    level * np.sin(2 * np.pi * (200 + 150 * i) * t),
                    level * np.sin(2 * np.pi * (100 + 900 * t) * t)][i % 3])
    return np.stack(out).astype(np.float32)


def _weights(name):
    """(JAX module, port model in eval mode, flax params, batch_stats):
    the drawn weights, the head's kernel scaled up and every BN's
    running statistics set to its batch statistics on ``_signals()``, so
    that the probabilities are far from uniform and differ by clip."""
    module, params, stats = Z.flax_weights(name)
    head = "Dense_1" if name == FLAGSHIP else "Dense_0"
    params[head]["kernel"] = params[head]["kernel"] * np.float32(HEAD_GAIN)
    model = Z.port(name, params, stats).train()
    x = Frontend(_settings(name), "highest").features(
        torch.from_numpy(_signals()), REPRESENTATION[name])
    with torch.no_grad(), collect_batch_stats(model) as batch_stats:
        model(x, torch.Generator().manual_seed(0))
    for bn, ((mean, var),) in batch_stats.items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
    params, stats = to_flax(model.state_dict(), name)
    return module, model.eval(), params, stats


def _settings(name):
    return prepare_model_settings(
        label_count=12, output_representation=REPRESENTATION[name])


@pytest.fixture(scope="module", params=[FLAGSHIP, "conv_1d_spec"])
def exported(request):
    """(name, port model, flax weights, port f32/int8 archives at batch 1,
    JAX f32 artifact's function at batch 1)."""
    name = request.param
    module, model, params, stats = _weights(name)
    rep = REPRESENTATION[name]
    archives = {dtype: A.export_inference(
        model, Frontend(_settings(name), "highest"), rep,
        weight_dtype=dtype) for dtype in ("float32", "int8")}
    jax_fn = JA.load_exported(JA.export_inference(
        module, JaxFrontend(jax_prepare_model_settings(
            label_count=12, output_representation=rep)), rep,
        {"params": params, "batch_stats": stats}, batch_size=1))
    return name, model, archives, jax_fn


def _clips():
    return torch.from_numpy(_signals()[1:1 + CLIPS])


def _per_clip(fn, wav):
    return np.concatenate([np.asarray(fn(wav[i:i + 1]))
                           for i in range(len(wav))])


@pytest.mark.parametrize("extend_reversed", [False, True])
def test_map_32_to_12_matches_jax_and_convert(extend_reversed):
    n = 49 if extend_reversed else 32
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(n), size=16).astype(np.float32)
    got = A.map_32_to_12_probs(torch.from_numpy(probs), extend_reversed)
    want = np.asarray(JA.map_32_to_12_probs(jnp.asarray(probs),
                                            extend_reversed))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    # the same function as the ensembling conversion, whose columns are
    # in AUDIO_NAMES order: permute ours into it
    from speech_recognition_tpu_torch.infer.submission import AUDIO_NAMES
    from speech_recognition_tpu_torch.labels import get_classes
    wanted = get_classes(wanted_only=True)
    names = ["silence", "unknown"] + [
        c for c in get_classes(wanted_only=False,
                               extend_reversed=extend_reversed)
        if c in wanted]
    conv = convert_32_to_12(probs, extend_reversed=extend_reversed)
    np.testing.assert_allclose(
        got.numpy()[:, [names.index(a) for a in AUDIO_NAMES]], conv,
        rtol=0, atol=1e-7)


def test_quantize_weights_int8_matches_jax():
    _, model, params, stats = _weights(FLAGSHIP)
    got = A.quantize_weights_int8(model.state_dict())
    variables = {"params": params, "batch_stats": stats}
    leaves, _ = JA.quantize_weights_int8(variables)
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(variables)[0]]
    assert len(paths) == len(leaves) == len(got)
    quantized = 0
    for path, (q, scale) in zip(paths, leaves):
        *mod, leaf = path[1:]
        key = f"{_module_name(tuple(mod), FLAGSHIP)}.{_LEAF[leaf]}"
        gq, gscale = got[key]
        if scale is None:
            assert gscale is None, key
            continue
        quantized += 1
        assert gq.dtype == torch.int8 and gscale.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), _to_torch_layout(leaf, q))
        np.testing.assert_array_equal(gscale.numpy().ravel(), scale.ravel())
    # the stem, 11 x (depthwise, pointwise), the attention and the head
    assert quantized == 25


def test_quantize_error_bound():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(64, 9, 7)).astype(np.float32))
    w[3] = 0.0
    out = A.quantize_weights_int8({"k": w, "bias": torch.zeros(64)},
                                  min_size=64)
    assert out["bias"][1] is None
    q, scale = out["k"]
    assert q.abs().max() <= 127 and float(scale[3]) == 1.0
    err = (q.float() * scale - w).abs().amax(dim=(1, 2))
    assert (err <= scale.ravel() / 2 + 1e-7).all()


def test_archive_matches_eager_and_jax(exported):
    name, model, archives, jax_fn = exported
    wav = _clips()
    fn = A.load_exported(archives["float32"], CPU)
    got = _per_clip(fn, wav)
    with torch.no_grad():
        eager = torch.softmax(model(Frontend(_settings(name), "highest")
                                    .features(wav, REPRESENTATION[name])),
                              dim=-1).numpy()
    want = _per_clip(jax_fn, jnp.asarray(wav.numpy()))
    assert got.shape == want.shape == (CLIPS, 12)
    assert want.max() > 0.2          # far from uniform
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_int8_archive_close_to_f32(exported):
    name, _, archives, _ = exported
    wav = _clips()
    f32 = _per_clip(A.load_exported(archives["float32"], CPU), wav)
    q = _per_clip(A.load_exported(archives["int8"], CPU), wav)
    np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(q, f32, atol=0.05)
    assert not np.array_equal(q, f32)   # the int8 weights are in use


def test_int8_archive_matches_its_dequantized_weights(exported):
    """The int8 archive computes the eager model on ``q * scale``."""
    name, model, archives, _ = exported
    wav = _clips()
    got = _per_clip(A.load_exported(archives["int8"], CPU), wav)
    deq = copy.deepcopy(model)
    deq.load_state_dict({
        k: w if scale is None else w.float() * scale
        for k, (w, scale) in A.quantize_weights_int8(
            model.state_dict()).items()})
    with torch.no_grad():
        eager = torch.softmax(deq(Frontend(_settings(name), "highest")
                                  .features(wav, REPRESENTATION[name])),
                              dim=-1).numpy()
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)


def test_archive_round_trip_is_deterministic(exported):
    _, _, archives, _ = exported
    wav = _clips()[:1]
    fn = A.load_exported(archives["float32"], CPU)
    np.testing.assert_array_equal(fn(wav).numpy(), fn(wav).numpy())
    again = A.load_exported(archives["float32"], CPU)
    np.testing.assert_array_equal(fn(wav).numpy(), again(wav).numpy())


def test_edge_budgets():
    model, _ = build_model(FLAGSHIP, num_classes=12)
    n = sum(p.numel() for p in model.parameters())
    assert n < PARAM_BUDGET, f"{n:,} parameters"
    settings = prepare_model_settings(label_count=12)
    f32, q = (len(A.export_inference(model, Frontend(settings, "highest"),
                                     "raw", weight_dtype=dtype))
              for dtype in ("float32", "int8"))
    print(f"flagship archives: float32 {f32:,} bytes, int8 {q:,} bytes")
    assert q < 2_000_000
    assert q < f32 / 2.5
    assert f32 < ARTIFACT_BYTE_BUDGET


def test_map_to_12_head_in_the_archive():
    model, _ = build_model(FLAGSHIP, num_classes=32)
    model.eval()
    settings = prepare_model_settings(label_count=32)
    fn = A.load_exported(A.export_inference(
        model, Frontend(settings, "highest"), "raw", batch_size=2,
        map_to_12=True), CPU)
    wav = _clips()[:2]
    with torch.no_grad():
        want = A.map_32_to_12_probs(torch.softmax(model(wav), -1))
    got = fn(wav)
    assert got.shape == (2, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["conv_1d_simple",
                                  "xception_with_attention"])
def test_gru_models_export(name):
    """The BiGRU models export as their Python loop unrolled over time
    (10 and 50 steps, both directions) and agree with the eager model."""
    model, spec = build_model(name, num_classes=12)
    model.eval()
    settings = prepare_model_settings(label_count=12)
    archive = A.export_inference(model, Frontend(settings, "highest"),
                                 spec.representation, batch_size=2)
    print(f"{name} archive: {len(archive):,} bytes (float32, batch 2)")
    wav = _clips()[:2]
    with torch.no_grad():
        want = torch.softmax(model(wav), dim=-1)
    got = A.load_exported(archive, CPU)(wav)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_freeze_then_edge_inference_matches_the_jax_artifact(tmp_path):
    module, model, params, stats = _weights(FLAGSHIP)
    ckpt = str(tmp_path / "ckpt.pt")
    save_checkpoint(ckpt, TrainState(model, build_optimizer(
        "rmsprop", model.parameters(), 1e-3)))
    test_dir = tmp_path / "test"
    test_dir.mkdir()
    for i, clip in enumerate(_signals()):
        save_wav_file(str(test_dir / f"clip_{i}.wav"), clip, 16000)
    frozen = str(tmp_path / "frozen.pt2")
    freeze.main(["--checkpoint_path", ckpt, "--frozen_path", frozen,
                 "--wanted_only", "--device", "cpu"])
    csv_path = str(tmp_path / "edge.csv")
    report = run_edge_inference.main([
        "--frozen_graph", frozen, "--test_data", str(test_dir),
        "--submission_fn", csv_path, "--benchmark", "--device", "cpu"])
    assert report["clips"] == 8
    assert report["artifact_bytes"] == os.path.getsize(frozen)
    assert report["size_budget_5000000"] is True
    assert "device_peak_bytes" not in report
    with open(csv_path) as f:
        rows = list(csv.reader(f))

    from speech_recognition_tpu.data.wav import load_wav_file
    jax_fn = JA.load_exported(JA.export_inference(
        module, JaxFrontend(jax_prepare_model_settings(label_count=12)),
        "raw", {"params": params, "batch_stats": stats}, batch_size=1))
    int2label = get_int2label(wanted_only=True)
    want = [["fname", "label"]]
    for p in sorted(test_dir.glob("*.wav")):
        probs = np.asarray(jax_fn(load_wav_file(str(p), 16000)[None]))
        want.append([p.name, int2label[int(probs.argmax())].strip("_")])
    assert rows == want
    assert len({r[1] for r in rows[1:]}) > 1      # not one constant label
