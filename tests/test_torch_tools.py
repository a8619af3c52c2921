"""The port's remaining tools against their JAX counterparts: profiling
(``utils/profiling.py``, ``tools.profile_step``), ``tools.model_info``,
``tools.bench_zoo``, colored noise (``data/noise.py``,
``tools.generate_noise``), the reference facade (``compat.py``),
``tools.prepare_dataset``, ``tools.seed_sweep`` and
``tools.zoo_calibration``, and the ``model_kwargs`` ablation hook.

- ``summarize_trace`` on synthetic Chrome traces whose totals are known,
  and against the JAX ``summarize_trace`` on a jax.profiler-style trace
  of the same intervals (the same keys, busy time and per-step time);
  ``trace_context`` on the CPU writes a trace that it reads back.
- ``model_info``: parameters and BatchNorm statistics (hence bytes and
  the Pi flag) equal to the JAX script's for all 25 models (the JAX
  counts from ``jax.eval_shape`` of the init at the script's settings, no
  program compiled); the FLOPs, which XLA counts otherwise, against the
  counts of two dense models derived by hand.
- ``colored_noise`` equal to the JAX function bit for bit for each color
  and two seeds, and the noise files byte for byte.
- ``AudioProcessor.get_data`` in validation mode against the JAX facade
  within the frontend's bounds (tests/test_torch_frontend.py: 1e-4 of
  max |value|); training mode by shape and distribution.
- ``prepare_dataset`` on a tiny tar and zip: its output and exit code
  are the JAX script's.
- ``seed_sweep`` and ``zoo_calibration`` resume a JSONL with a stub in
  place of the calibration, and print the JAX scripts' aggregate and
  table from the same records.
"""

import gzip
import io
import json
import os
import subprocess
import sys
import tarfile
import zipfile
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu import compat as JC
from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.data import noise as JN
from speech_recognition_tpu.models import (
    MODEL_REGISTRY as JAX_REGISTRY, build_model as jax_build_model,
)
from speech_recognition_tpu.ops.frontend import Frontend as JaxFrontend
from speech_recognition_tpu.utils import profiling as JP
from speech_recognition_tpu_torch import compat as C
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data import device_bank
from speech_recognition_tpu_torch.data import noise as N
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.wav import save_wav_file
from speech_recognition_tpu_torch.export import benchmark
from speech_recognition_tpu_torch.models.zoo import MODEL_REGISTRY
from speech_recognition_tpu_torch.tools import (
    bench_zoo, generate_noise, model_info, prepare_dataset, profile_step,
    seed_sweep, zoo_calibration,
)
from speech_recognition_tpu_torch.tools.calibrate_accuracy import (
    parse_args as calibrate_args,
)
from speech_recognition_tpu_torch.train.loop import Trainer
from speech_recognition_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
sys.path.insert(0, str(REPO / "scripts"))


def _jax_script(name):
    import importlib
    return importlib.import_module(name)


# -- profiling -----------------------------------------------------------

def _torch_trace():
    """A Chrome trace as torch.profiler writes it: two launching host
    operators, three kernels (two overlapping), a copy and a memset, and
    host-side events that are not device time. Busy: [0, 30] + [40, 50]
    + [60, 65] + [70, 72] us = 47 us."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": ts, "dur": dur, "args": args}
    return {"traceEvents": [
        x("aten::mm", "cpu_op", -5, 3, **{"External id": 11}),
        x("aten::add", "cpu_op", -1, 2, **{"External id": 12}),
        x("cudaLaunchKernel", "cuda_runtime", -4, 1, correlation=1),
        x("ampere_sgemm_128x64_nn", "kernel", 0, 20, **{"External id": 11}),
        x("vectorized_elementwise_kernel", "kernel", 10, 20,
          **{"External id": 12}),
        x("ampere_sgemm_128x64_nn", "kernel", 40, 10, **{"External id": 11}),
        x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 60, 5),
        x("Memset (Device)", "gpu_memset", 70, 2),
        x("step", "user_annotation", -10, 100),
        x("step", "gpu_user_annotation", 0, 72),
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "host"}},
    ]}


def _jax_trace():
    """The same device intervals as jax.profiler writes them (XLA
    Modules and XLA Ops tracks), without overlaps: modules of 30, 10, 5
    and 2 us."""
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
               "args": {"name": n}}
              for t, n in ((1, "XLA Modules"), (2, "XLA Ops"))]
    for i, (ts, dur) in enumerate([(0, 30), (40, 10), (60, 5), (70, 2)]):
        events.append({"ph": "X", "pid": 1, "tid": 1, "ts": ts, "dur": dur,
                       "name": f"jit_step.{i}"})
        events.append({"ph": "X", "pid": 1, "tid": 2, "ts": ts, "dur": dur,
                       "name": f"fusion.{i}", "args": {}})
    return {"traceEvents": events}


def _write(path, trace):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)


def test_summarize_trace_totals(tmp_path):
    _write(tmp_path / "a" / "h.1.1.pt.trace.json.gz", _torch_trace())
    s = P.summarize_trace(str(tmp_path / "a"), num_steps=2)
    assert s["device_busy_ms"] == pytest.approx(47e-3)
    assert s["ms_per_step"] == pytest.approx(23.5e-3)
    assert s["activities"] == 5
    assert s["memcpy_htod_ms"] == pytest.approx(5e-3)
    gemm = s["modules"]["ampere_sgemm_128x64_nn"]
    assert gemm == {"total_ms": pytest.approx(30e-3), "count": 2,
                    "ms_per_exec": pytest.approx(15e-3)}
    assert s["ops"] == {"matmul": pytest.approx(30e-3),
                        "elementwise": pytest.approx(20e-3),
                        "copy": pytest.approx(5e-3),
                        "memset": pytest.approx(2e-3)}
    top = s["detail"][0]
    assert top["op"] == "ampere_sgemm_128x64_nn"
    assert top["source"] == "aten::mm" and top["category"] == "matmul"
    assert s["detail"][1]["source"] == "aten::add"


def test_summarize_trace_with_kernels_that_tie(tmp_path):
    """Two kernels on two streams with the same start and duration."""
    trace = _torch_trace()
    tie = dict(trace["traceEvents"][3], tid=8)
    trace["traceEvents"].append(tie)
    _write(tmp_path / "h.1.1.pt.trace.json.gz", trace)
    s = P.summarize_trace(str(tmp_path), num_steps=2)
    assert s["activities"] == 6
    assert s["device_busy_ms"] == pytest.approx(47e-3)
    assert s["modules"]["ampere_sgemm_128x64_nn"]["count"] == 3


def test_summarize_trace_takes_the_newest_file(tmp_path):
    old = _torch_trace()
    old["traceEvents"] = old["traceEvents"][:4]
    _write(tmp_path / "h.1.1.pt.trace.json.gz", old)
    _write(tmp_path / "h.1.2.pt.trace.json.gz", _torch_trace())
    assert P.summarize_trace(str(tmp_path))["activities"] == 5
    plain = tmp_path / "one.trace.json"
    plain.write_text(json.dumps(old))
    assert P.summarize_trace(str(plain))["activities"] == 1
    with pytest.raises(FileNotFoundError):
        P.summarize_trace(str(tmp_path / "nothing"))


def test_summarize_trace_takes_the_newest_over_processes(tmp_path):
    # by the time in the name, not by name: pid 9's older trace sorts
    # after pid 10's newer one, and a host name may hold dots
    old = _torch_trace()
    old["traceEvents"] = old["traceEvents"][:4]
    _write(tmp_path / "a.b.9.200.pt.trace.json.gz", old)
    _write(tmp_path / "a.b.10.300.pt.trace.json.gz", _torch_trace())
    assert P.summarize_trace(str(tmp_path))["activities"] == 5
    _write(tmp_path / "a.b.9.400.pt.trace.json.gz", old)
    assert P.summarize_trace(str(tmp_path))["activities"] == 1


def test_summarize_trace_against_jax(tmp_path):
    # same intervals, without the overlap the JAX parser would add twice
    trace = _torch_trace()
    trace["traceEvents"][4]["ts"] = 30
    trace["traceEvents"][4]["dur"] = 0
    trace["traceEvents"][3]["dur"] = 30
    _write(tmp_path / "torch" / "h.1.1.pt.trace.json.gz", trace)
    _write(tmp_path / "jax" / "plugins" / "h.trace.json.gz", _jax_trace())
    got = P.summarize_trace(str(tmp_path / "torch"), num_steps=4)
    want = JP.summarize_trace(str(tmp_path / "jax"), num_steps=4)
    assert set(want) <= set(got)
    assert got["device_busy_ms"] == pytest.approx(want["device_busy_ms"])
    assert got["ms_per_step"] == pytest.approx(want["ms_per_step"])
    assert set(got["detail"][0]) == set(want["detail"][0])
    assert set(next(iter(got["modules"].values()))) == set(
        next(iter(want["modules"].values())))


def test_trace_context_on_the_cpu(tmp_path):
    with P.trace_context(str(tmp_path / "t")):
        torch.ones(8) @ torch.ones(8)
    files = list((tmp_path / "t").glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    s = P.summarize_trace(str(tmp_path / "t"), num_steps=1)
    assert s["activities"] == 0 and s["device_busy_ms"] == 0.0


def _small_dataset(device, **kw):
    return synthetic_device_dataset(device, num_train=16, num_val=8,
                                    num_pseudo=4)


def test_profile_step_on_the_cpu(tmp_path, capsys):
    with mock.patch.object(device_bank, "synthetic_device_dataset",
                           _small_dataset):
        s = profile_step.main(["--device", "cpu", "--batch_size", "4",
                               "--steps", "2", "--warmup", "1",
                               "--trace_dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    assert "device busy: 0.00 ms over 2 steps" in out
    assert {"modules", "ops", "detail", "device_busy_ms",
            "ms_per_step"} <= set(s)


# -- model_info ----------------------------------------------------------

SCRIPT_SETTINGS = dict(label_count=12, window_size_ms=30.0,
                       window_stride_ms=10.0, dct_coefficient_count=80,
                       num_log_mel_features=60, output_representation="raw")


def _jax_counts(name):
    """The JAX script's (params, batch_stats) counts, from the shapes of
    its init at the script's settings."""
    s = jax_prepare_model_settings(**SCRIPT_SETTINGS)
    module, spec = jax_build_model(
        name, num_classes=12, spectrogram_length=s.spectrogram_length,
        num_log_mel_features=s.num_log_mel_features,
        spectrogram_frequencies=s.spectrogram_frequencies,
        desired_samples=s.desired_samples,
        window_size_samples=s.window_size_samples,
        window_stride_samples=s.window_stride_samples)
    x = jax.eval_shape(lambda: JaxFrontend(s).features(
        jnp.zeros((1, s.desired_samples)), spec.representation))
    v = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)},
        jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), x),
        train=False))
    count = lambda tree: sum(int(np.prod(a.shape)) for a in
                             jax.tree_util.tree_leaves(tree))
    return count(v["params"]), count(v.get("batch_stats", {}))


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_model_info_counts_equal_the_jax_scripts(name):
    info = model_info.model_info(
        name, prepare_model_settings(**SCRIPT_SETTINGS))
    params, stats = _jax_counts(name)
    assert (info["params"], info["batch_stats"]) == (params, stats)
    assert info["f32_bytes"] == 4 * (params + stats)
    assert info["fits_pi_budget"] == (params < 1_250_000
                                      and 4 * (params + stats) < 5_000_000)
    spec = JAX_REGISTRY[name]
    assert (info["representation"], info["optimizer"]) == (
        spec.representation, spec.optimizer)
    assert info["forward_flops_per_clip"] > 0


def test_model_info_flops_are_the_products_by_hand():
    s = prepare_model_settings(**SCRIPT_SETTINGS)
    width = 98 * 60                         # the flat log-mel MFCCs
    simple = model_info.model_info("simple", s, batch_size=3)
    assert simple["forward_flops_per_clip"] == 2 * width * 12
    dims = [width, 512, 256, 128, 64, 12]
    snn = model_info.model_info("snn", s)
    assert snn["forward_flops_per_clip"] == 2 * sum(
        a * b for a, b in zip(dims, dims[1:]))
    assert "FlopCounterMode" in snn["flops_method"]


def test_model_info_cli(capsys):
    rows = model_info.main(["--device", "cpu", "--models", "simple",
                            "conv_2d_fast"])
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    assert [r["model"] for r in lines] == ["simple", "conv_2d_fast"]
    assert lines == rows
    assert "| simple | mfcc | 70,572 |" in err and "XLA" in err


# -- bench_zoo -----------------------------------------------------------

def test_bench_zoo_defaults_are_the_jax_scripts():
    jax_script = _jax_script("bench_zoo")
    assert bench_zoo.DEFAULT_MODELS == jax_script.DEFAULT_MODELS
    args = bench_zoo.parse_args([])
    assert (args.batch_size, args.steps, args.warmup,
            args.steps_per_dispatch, args.trace) == (384, 100, 10, 25, False)


def test_bench_zoo_times_the_card_only():
    with pytest.raises(SystemExit, match="--device cuda"):
        bench_zoo.main(["--device", "cpu"])


def test_bench_zoo_rows(capsys):
    def fake_bench(trainer, state, steps, warmup):
        return {"ms_per_step": 2.0, "clips_per_sec":
                trainer.batch_size * 500.0}

    def fake_trace(trainer, state, steps):
        return {"device_ms_per_step": 1.5}

    with mock.patch("speech_recognition_tpu_torch.device.require_cuda",
                    return_value=CPU), \
            mock.patch.object(device_bank, "synthetic_device_dataset",
                              _small_dataset), \
            mock.patch.object(benchmark, "benchmark_train", fake_bench), \
            mock.patch.object(benchmark, "traced_train_device_time",
                              fake_trace):
        rows = bench_zoo.main(["--models", "simple", "conv_2d_fast",
                               "--batch_size", "4", "--trace"])
    assert rows == [
        {"model": "simple", "params": 70_572, "representation": "mfcc",
         "ms_per_step": 2.0, "clips_per_sec": 2000.0, "vs_k80_450": 4.4,
         "traced_device_ms_per_step": 1.5},
        {"model": "conv_2d_fast", "params": 102_988,
         "representation": "mfcc", "ms_per_step": 2.0,
         "clips_per_sec": 2000.0, "vs_k80_450": 4.4,
         "traced_device_ms_per_step": 1.5}]
    assert "| simple | mfcc | 70,572 | 2.0 |" in capsys.readouterr().err


# -- noise ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("color", sorted(N.COLOR_EXPONENTS))
def test_colored_noise_equals_jax(color, seed):
    got = N.colored_noise(4001, color, np.random.default_rng(seed))
    want = JN.colored_noise(4001, color, np.random.default_rng(seed))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert abs(float(got.std()) - 1.0) < 1e-3


def test_unknown_color_raises():
    with pytest.raises(ValueError, match="unknown color"):
        N.colored_noise(10, "green")


def test_noise_files_equal_jax(tmp_path, capsys):
    got = generate_noise.main(["--noise_dir", str(tmp_path / "port"),
                               "--seconds", "1", "--seed", "3",
                               "--colors", "pink", "brown"])
    want = JN.generate_background_noise_files(
        str(tmp_path / "jax"), colors=["pink", "brown"], seconds=1, seed=3)
    assert [os.path.basename(p) for p in got] == [
        "custom_pink_noise.wav", "custom_brown_noise.wav"]
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert "Done!" in capsys.readouterr().out


# -- compat --------------------------------------------------------------

def _corpus(root):
    """tests/test_compat.py's corpus."""
    rng = np.random.default_rng(0)
    for word in ("stop", "go", "cat"):
        d = root / word
        d.mkdir(parents=True, exist_ok=True)
        for i in range(20):
            save_wav_file(str(d / f"{word}{i:03d}_nohash_0.wav"),
                          rng.uniform(-0.3, 0.3, 16000), 16000)
    bg = root / "_background_noise_"
    bg.mkdir()
    save_wav_file(str(bg / "n.wav"), rng.normal(0, 0.05, 48000), 16000)


@pytest.fixture(scope="module")
def processors(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat")
    _corpus(root)
    out = {}
    for rep in ("raw", "mfcc"):
        kw = dict(label_count=4, dct_coefficient_count=80,
                  num_log_mel_features=40, output_representation=rep)
        args = dict(data_dirs=[str(root)], silence_percentage=10.0,
                    unknown_percentage=30.0, wanted_words=["stop", "go"],
                    validation_percentage=30.0, testing_percentage=0.0,
                    output_representation=rep)
        out[rep] = (C.AudioProcessor(
            model_settings=prepare_model_settings(**kw), device=CPU,
            **args), JC.AudioProcessor(
            model_settings=jax_prepare_model_settings(**kw), **args))
    return out


@pytest.mark.parametrize("rep", ["raw", "mfcc"])
def test_get_data_validation_matches_jax(processors, rep):
    ap, jap = processors[rep]
    assert ap.set_size("validation") == jap.set_size("validation") > 4
    assert ap.word_to_index == jap.word_to_index
    for offset in (0, 4):
        x, y = ap.get_data(4, offset, 0, 0, 0, 0, 0, [0, 0], "validation")
        jx, jy = jap.get_data(4, offset, 0, 0, 0, 0, 0, [0, 0],
                              "validation")
        jx = np.asarray(jx)
        assert x.shape == jx.shape and np.array_equal(y, jy)
        assert np.abs(x - jx).max() <= 1e-4 * np.abs(jx).max()


def test_get_unprocessed_data_matches_jax(processors):
    ap, jap = processors["raw"]
    wav, names = ap.get_unprocessed_data(-1)
    jwav, jnames = jap.get_unprocessed_data(-1)
    assert names == jnames and np.array_equal(wav, np.asarray(jwav))


def test_get_data_training_shapes_and_distribution(processors):
    ap, _ = processors["raw"]
    kw = dict(background_frequency=0.8, background_volume_range=0.1,
              foreground_frequency=0.3, foreground_volume_range=0.15,
              time_shift_frequency=0.3, time_shift_range=[-500, 0],
              mode="training", silence_volume_range=0.3)
    x, y = ap.get_data(how_many=256, offset=0, **kw)
    assert x.shape == (256, 16000) and y.shape == (256, 4)
    np.testing.assert_allclose(y.sum(1), 1.0)
    # the index's mix: 10 % silence, 30 % unknown of the wanted count
    share = y.mean(0)
    assert 0.0 < share[0] < 0.2 and 0.05 < share[1] < 0.45
    assert np.abs(x).max() <= 1.2 * 0.3 + 0.1 * 0.05 * 6
    # silence rows hold background only: far quieter than the words
    silent = np.abs(x[y[:, 0] == 1]).mean()
    assert silent < 0.25 * np.abs(x[y[:, 0] == 0]).mean()
    x2, _ = ap.get_data(how_many=256, offset=0, **kw)
    assert not np.array_equal(x, x2)        # fresh draws


def test_dict_settings_and_data_gen(tmp_path):
    _corpus(tmp_path)
    settings_dict = {
        "label_count": 4, "sample_rate": 16000, "desired_samples": 16000,
        "window_size_samples": 480, "window_stride_samples": 160,
        "spectrogram_length": 98, "spectrogram_frequencies": 257,
        "dct_coefficient_count": 80, "num_log_mel_features": 40,
        "fingerprint_size": 16000,
    }
    ap = C.AudioProcessor(
        data_dirs=[str(tmp_path)], silence_percentage=10.0,
        unknown_percentage=30.0, wanted_words=["stop", "go"],
        validation_percentage=30.0, testing_percentage=0.0,
        model_settings=settings_dict, output_representation="raw",
        device=CPU)
    x, y = ap.get_data(4, 0, 0, 0, 0, 0, 0, [0, 0], "validation")
    assert x.shape == (4, 16000)
    gen = C.data_gen(ap, batch_size=4, mode="training", pseudo_frequency=0.0)
    a, _ = next(gen)
    b, _ = next(gen)
    assert a.shape == (4, 16000) and not np.allclose(a, b)
    vgen = C.data_gen(ap, batch_size=4, mode="validation")
    v = [next(vgen)[0] for _ in range(ap.set_size("validation") // 4 + 1)]
    assert np.array_equal(v[0], v[-1])      # wrapped to offset 0


# -- prepare_dataset -----------------------------------------------------

def _archives(tmp_path):
    from speech_recognition_tpu_torch.labels import get_classes
    src = tmp_path / "src"
    for w in get_classes(wanted_only=False)[:-1]:       # one word missing
        (src / "train" / "audio" / w).mkdir(parents=True)
        (src / "train" / "audio" / w / "a.wav").write_bytes(b"RIFF")
    bg = src / "train" / "audio" / "_background_noise_"
    bg.mkdir()
    (bg / "n.wav").write_bytes(b"RIFF")
    (src / "test" / "audio").mkdir(parents=True)
    (src / "test" / "audio" / "t.wav").write_bytes(b"RIFF")
    with tarfile.open(tmp_path / "train.tar.gz", "w:gz") as tf:
        tf.add(src / "train", arcname="train")
    with zipfile.ZipFile(tmp_path / "test.zip", "w") as zf:
        zf.write(src / "test" / "audio" / "t.wav", "test/audio/t.wav")
    return tmp_path / "train.tar.gz", tmp_path / "test.zip"


def test_prepare_dataset_matches_the_jax_script(tmp_path):
    train, test = _archives(tmp_path)
    argv = ["--train_archive", str(train), "--test_archive", str(test)]
    out = io.StringIO()
    with redirect_stdout(out):
        rc = prepare_dataset.main(argv + ["--data_root",
                                          str(tmp_path / "port")])
    jax_run = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "prepare_dataset.py"),
         *argv, "--data_root", str(tmp_path / "jax")],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert rc == jax_run.returncode == 1      # a word directory is missing
    assert out.getvalue().replace("port", "X") \
        == jax_run.stdout.replace("jax", "X")
    assert "train: 29 labeled wavs (+1 background)" in out.getvalue()
    from speech_recognition_tpu_torch.labels import get_classes
    last = get_classes(wanted_only=False)[-1]
    (tmp_path / "port" / "train" / "audio" / last).mkdir()
    with redirect_stdout(io.StringIO()):
        assert prepare_dataset.main(["--data_root",
                                     str(tmp_path / "port")]) == 0
    with pytest.raises(ValueError, match="unknown archive"):
        prepare_dataset.extract(str(tmp_path / "x.rar"), str(tmp_path))


# -- seed_sweep, zoo_calibration -----------------------------------------

def _record(model, dtype, seed, epochs, final, best, **kw):
    return dict(model=model, compute_dtype=dtype, seed=seed, epochs=epochs,
                val_acc_final=final, val_acc_best=best, extra=[], **kw)


class _StubCalibration:
    """Stands in for ``run_calibration``: answers each command with a
    record made from its flags, and keeps the commands."""

    def __init__(self):
        self.commands = []

    def __call__(self, cmd, timeout):
        self.commands.append(cmd)
        flag = lambda name, default=None: (
            cmd[cmd.index(name) + 1] if name in cmd else default)
        seed = int(flag("--seed", 0))
        rec = {"model": flag("--model"),
               "compute_dtype": flag("--compute_dtype", "bfloat16"),
               "epochs": int(flag("--epochs")),
               "representation": "raw",
               "val_acc_final": 0.8 + 0.01 * seed,
               "val_acc_best": 0.85 + 0.01 * seed}
        if "--clips_per_word" in cmd:
            rec["clips_per_word"] = int(flag("--clips_per_word"))
        if "--eval_int8" in cmd:
            rec["int8_delta"] = -0.001 * (seed + 1)
        return subprocess.CompletedProcess(cmd, 0, "log\n" + json.dumps(rec),
                                           "")


def test_seed_sweep_resumes_and_aggregates_as_jax(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    model = "conv_1d_spec"
    out.write_text(json.dumps(_record(model, "float32", 1, 3, 0.7, 0.75))
                   + "\n")
    stub = _StubCalibration()
    argv = ["--seeds", "0,1", "--epochs", "3", "--model", model,
            "--int8_seeds", "0", "--out", str(out), "--device", "cpu"]
    with mock.patch.object(seed_sweep, "run_calibration", stub):
        got = seed_sweep.main(argv)
    # three runs: the cached float32 seed 1 is skipped
    assert len(stub.commands) == 3
    assert all(c[1:3] == ["-m", seed_sweep.CALIBRATE] for c in stub.commands)
    assert all(c[c.index("--device") + 1] == "cpu" for c in stub.commands)
    assert sum("--eval_int8" in c for c in stub.commands) == 1
    assert len(out.read_text().splitlines()) == 4
    assert got["per_dtype"]["float32"]["final"] == [0.8, 0.7]
    # a second run finds everything cached
    with mock.patch.object(seed_sweep, "run_calibration", stub):
        again = seed_sweep.main(argv)
    assert len(stub.commands) == 3 and again == got
    capsys.readouterr()
    # the JAX script's aggregate of the same records
    jax_script = _jax_script("seed_sweep")
    with mock.patch.object(sys, "argv", ["seed_sweep.py", *argv[:-2]]):
        jax_script.main()
    assert json.loads(capsys.readouterr().out) == got


def test_zoo_calibration_resumes_and_tabulates_as_jax(tmp_path, capsys):
    out = tmp_path / "zoo.jsonl"
    models = ["simple", "conv_2d_fast", "snn"]
    out.write_text(json.dumps(dict(
        model="snn", epochs=2, clips_per_word=5, representation="mfcc",
        val_acc_final=0.5, val_acc_best=0.6)) + "\n")
    stub = _StubCalibration()
    argv = ["--models", *models, "--epochs", "2", "--clips_per_word", "5",
            "--out", str(out)]

    def failing(cmd, timeout):
        if "conv_2d_fast" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "boom")
        return stub(cmd, timeout)

    with mock.patch.object(zoo_calibration, "run_calibration", failing):
        got = zoo_calibration.main(argv)
    table = capsys.readouterr().out
    assert len(stub.commands) == 1                     # simple only
    assert "error" in got["conv_2d_fast"] and "boom" in \
        got["conv_2d_fast"]["error"]
    assert "| conv_2d_fast | — | error | error |" in table
    assert "| snn | mfcc | 0.5000 | 0.6000 |" in table
    assert len(out.read_text().splitlines()) == 3
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    jax_script = _jax_script("zoo_calibration")
    with mock.patch.object(sys, "argv", ["zoo_calibration.py", *argv]):
        jax_script.main()
    assert capsys.readouterr().out == table


# -- the ablation hook ---------------------------------------------------

def _mfcc40_trainer(**kw):
    settings = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=40,
        output_representation="mfcc")
    return Trainer("conv_2d_fast", settings,
                   synthetic_device_dataset(CPU, num_train=16, num_val=8,
                                            num_pseudo=4),
                   batch_size=4, **kw)


def test_absent_model_kwargs_change_nothing():
    a = _mfcc40_trainer().init_state().model.state_dict()
    b = _mfcc40_trainer(model_kwargs={}).init_state().model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_model_kwargs_reach_the_model_as_in_jax():
    count = lambda t: sum(p.numel() for p in
                          t.init_state().model.parameters())
    gap = count(_mfcc40_trainer())
    trainer = _mfcc40_trainer(model_kwargs={"head": "flatten"},
                              learning_rate=0.01)
    flat = count(trainer)
    # tests/test_ablation_hooks.py: the flatten head is 12x wider
    assert flat > gap and (flat - gap) % 12 == 0
    module, _ = jax_build_model(
        "conv_2d_fast", num_classes=12, model_kwargs={"head": "flatten"},
        spectrogram_length=98, num_log_mel_features=40)
    v = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 98 * 40)),
        train=False))
    assert flat == sum(int(np.prod(a.shape)) for a in
                       jax.tree_util.tree_leaves(v["params"]))
    state = trainer.init_state()
    assert state.optimizer.param_groups[0]["lr"] == 0.01
    assert np.isfinite(float(trainer.train_step(state)["loss"]))
    args = calibrate_args(["--model_kwargs", '{"head": "flatten"}'])
    assert json.loads(args.model_kwargs) == {"head": "flatten"}
