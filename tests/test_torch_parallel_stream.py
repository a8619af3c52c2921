"""Streamed training and TTA prediction of the port over two ranks.

Two real processes joined by a ``gloo`` process group on the CPU (a file
rendezvous, as ``tests/test_torch_parallel.py`` runs them): the module's
fixture starts both ranks once; each runs this file as a script
(``_rank_main``) and saves its results, which the tests hold against one
process on the concatenated batch, computed meanwhile in the parent, and
against the JAX package.

- The streamed step (``Trainer.draw_stream``, ``build_stream_batch``,
  ``_update_step``): each rank passes its 4 rows of a global batch of 8
  int16 clips; ``conv_2d_fast`` (MFCC, four global-batch BatchNorms, SGD
  with momentum, so an update is linear in its gradient) in float64 for
  two steps. Loss, every gradient, the BN running statistics and the
  parameters agree with one process on the concatenated batch to 1e-12
  of the largest |value| (of the loss; of all the gradients; of all the
  parameters and statistics); the augmented rows are the one process's
  rows bit for bit, and the ranks come out bit-identical, generators
  included.
- ``recalibrate_batch_stats_stream`` over the two ranks' rows of three
  batches against one process on the whole batches (1e-6 of max |value|:
  float32 sums in another order).
- ``train_step_stream`` and ``fit_streaming`` from two
  ``HostPrefetchLoader``s, each over its rank's ``process_shard`` of a
  tree of WAVs: finite, equal losses and bit-identical parameters.
- A rank that fails (its loader, say) before a collective: the other
  rank raises at once instead of waiting for the process group's 300 s
  timeout.
- The ``Predictor`` over the two ranks, each on its rows of a batch of 16
  in three TTA modes, and ``predict_directory`` over a tree of 13 WAVs
  at batch 8 (a tail of 5 padded to 8): against one process and against
  the JAX ``Predictor`` on an 8-device mesh (tests/test_infer_tools.py),
  1e-5 absolute (the JAX test's).
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.infer.tta import (
    Predictor as JaxPredictor, TTAConfig as JaxTTAConfig,
)
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.parallel.mesh import make_mesh as jax_make_mesh
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.prefetch import HostPrefetchLoader
from speech_recognition_tpu_torch.data.wav import (
    decode_batch_int16, save_wav_file,
)
from speech_recognition_tpu_torch.infer.submission import predict_directory
from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
from speech_recognition_tpu_torch.models.convert import to_flax
from speech_recognition_tpu_torch.models.layers import BatchNorm
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from speech_recognition_tpu_torch.parallel.mesh import make_mesh, shard_batch
from speech_recognition_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MODEL = "conv_2d_fast"
WORLD = 2
B, T = 8, 16000
STEPS = 2
RECAL_BATCHES = 3
DATA = dict(num_train=16, num_val=8, num_pseudo=0, seed=5)
PRED_BATCH = 16
TREE_FILES, TREE_BATCH = 13, 8
PROB_ATOL = 1e-5
# a failed rank must be noticed long before the group's 300 s timeout
FAIL_WAIT_S = 60
MODES = {"none": dict(use_tta=False), "tta": dict(),
         "speed_no_slow": dict(use_speed_tta=True)}


def _settings():
    return prepare_model_settings(
        label_count=12, output_representation="mfcc",
        dct_coefficient_count=40, num_log_mel_features=40)


def _predict_settings():
    """tests/test_infer_tools.py's settings."""
    return dict(label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
                dct_coefficient_count=80, num_log_mel_features=40,
                output_representation="mfcc")


def _trainer(mesh=None):
    return Trainer(MODEL, _settings(), synthetic_device_dataset(CPU, **DATA),
                   batch_size=B, compute_dtype="float32", mesh=mesh)


def _stream_batches(work):
    """The global batches: int16 clips, labels, silence flags."""
    z = np.load(work / "stream.npz")
    return [(torch.from_numpy(z[f"wav{i}"]), torch.from_numpy(z[f"lab{i}"]),
             torch.from_numpy(z[f"sil{i}"]))
            for i in range(STEPS + RECAL_BATCHES)]


def _stream_steps(trainer, batches):
    """The float64 streamed steps on this rank's rows of each batch: per
    step the features, loss, gradients and state after it."""
    state = trainer.init_state()
    state.model.double()
    out = []
    for wav, lab, sil in batches:
        wav, lab, sil = shard_batch((wav, lab, sil), trainer.mesh)
        d = trainer.draw_stream(lab, sil)
        x = trainer.build_stream_batch(wav, d)
        metrics = trainer._update_step(state, x.double(), lab)
        out.append(dict(
            x=x, loss=float(metrics["loss"]),
            acc=float(metrics["categorical_accuracy"]),
            grads={k: p.grad.clone()
                   for k, p in state.model.named_parameters()},
            state={k: t.clone()
                   for k, t in state.model.state_dict().items()},
            generator=trainer.generator.get_state()))
    return out


def _recalibrated(trainer, batches):
    state = trainer.init_state()
    loader = iter([shard_batch(b, trainer.mesh) for b in batches])
    trainer.recalibrate_batch_stats_stream(state, loader, len(batches))
    return {n: (m.running_mean.clone(), m.running_var.clone())
            for n, m in state.model.named_modules()
            if isinstance(m, BatchNorm)}


def _predictor_model():
    model, _ = build_model(MODEL, num_classes=12,
                           generator=torch.Generator().manual_seed(3),
                           spectrogram_length=98, num_log_mel_features=40)
    return model.eval()


def _predictions(mesh, batch, tree):
    """Each mode's probabilities of ``batch`` (this rank's rows of it
    under a mesh), and ``predict_directory`` over ``tree`` with TTA."""
    settings = prepare_model_settings(**_predict_settings())
    out = {}
    for mode, flags in MODES.items():
        p = Predictor(_predictor_model(), settings, "mfcc",
                      TTAConfig(**flags), CPU, mesh=mesh)
        rows = batch if mesh is None else shard_batch(batch, mesh)
        out[mode] = p.predict(rows)
    p = Predictor(_predictor_model(), settings, "mfcc", TTAConfig(), CPU,
                  mesh=mesh)
    out["directory"] = predict_directory(p, str(tree),
                                         batch_size=TREE_BATCH)
    return out


# -- one rank (run as a script) ------------------------------------------

def _rank_main(rank: int, init_method: str, work: Path, mode: str) -> None:
    if mode == "fail":
        initialize_distributed(init_method, WORLD, rank, "gloo")
        mesh = make_mesh(CPU)
        if rank == 1:
            raise RuntimeError("rank 1: the loader failed")
        trainer = _trainer(mesh)
        t0 = time.perf_counter()
        try:
            trainer.draw_stream(torch.zeros(B // WORLD, dtype=torch.int64),
                                torch.zeros(B // WORLD, dtype=torch.bool))
        finally:
            print(f"rank 0 waited {time.perf_counter() - t0:.1f} s",
                  flush=True)
        return
    initialize_distributed(init_method, WORLD, rank, "gloo")
    mesh = make_mesh(CPU)
    batches = _stream_batches(work)
    out = {"steps": _stream_steps(_trainer(mesh), batches[:STEPS]),
           "recal": _recalibrated(_trainer(mesh), batches[STEPS:])}

    # the real path: loaders over the rank's shard of the WAV tree
    trainer = Trainer(MODEL, _settings(),
                      synthetic_device_dataset(CPU, **DATA), batch_size=B,
                      mesh=mesh)
    state = trainer.init_state()
    paths = sorted(str(p) for p in (work / "tree").glob("*.wav"))
    labels = np.arange(len(paths)) % 12
    with HostPrefetchLoader(paths, labels, labels == 0,
                            batch_size=B // WORLD, seed=3,
                            device=CPU) as loader:
        out["loader_paths"] = loader.paths
        first = float(trainer.train_step_stream(state,
                                                *next(loader))["loss"])
        state, hist = trainer.fit_streaming(state, loader, steps=2)
    out["real"] = dict(first=first, loss=hist["loss"], step=state.step,
                       state={k: t.clone() for k, t in
                              state.model.state_dict().items()})
    out["predict"] = _predictions(mesh, torch.load(work / "predict.pt"),
                                  work / "tree")
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


# -- the fixture ---------------------------------------------------------

def _start(work, mode):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    init_method = f"file://{work / f'rendezvous_{mode}'}"
    return [subprocess.Popen(
        [sys.executable, __file__, str(rank), init_method, str(work), mode],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_stream")
    rng = np.random.default_rng(21)
    arrays = {}
    for i in range(STEPS + RECAL_BATCHES):
        arrays[f"wav{i}"] = rng.integers(-9000, 9000, (B, T), dtype=np.int16)
        arrays[f"lab{i}"] = rng.integers(0, 12, B)
        arrays[f"sil{i}"] = arrays[f"lab{i}"] == 0
        arrays[f"sil{i}"][1] = True
    np.savez(work / "stream.npz", **arrays)
    torch.save(torch.from_numpy(rng.uniform(
        -0.3, 0.3, (PRED_BATCH, T)).astype(np.float32)),
        work / "predict.pt")
    (work / "tree").mkdir()
    for i in range(TREE_FILES):
        save_wav_file(str(work / "tree" / f"clip_{i:02d}.wav"),
                      rng.uniform(-0.4, 0.4, T).astype(np.float32), T)

    main = _start(work, "main")
    fail = _start(work, "fail")
    try:
        batches = _stream_batches(work)
        one = {"steps": _stream_steps(_trainer(), batches[:STEPS]),
               "recal": _recalibrated(_trainer(), batches[STEPS:]),
               "predict": _predictions(None, torch.load(work / "predict.pt"),
                                       work / "tree")}
        logs = [p.communicate(timeout=600)[0].decode() for p in main]
        fail_logs = [p.communicate(timeout=400)[0].decode() for p in fail]
    finally:
        for p in main + fail:
            p.kill()
    for p, log in zip(main, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, one=one, work=work, fail=fail,
                fail_logs=fail_logs)


# -- the streamed step ---------------------------------------------------

def _close(got, want, rel, what):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()), msg=what)


@pytest.mark.parametrize("step", range(STEPS))
def test_stream_rows_are_the_one_process_rows(run, step):
    got = torch.cat([r["steps"][step]["x"] for r in run["ranks"]])
    assert torch.equal(got, run["one"]["steps"][step]["x"])


@pytest.mark.parametrize("step", range(STEPS))
def test_stream_loss_matches_one_process(run, step):
    s0, s1 = (r["steps"][step] for r in run["ranks"])
    assert s0["loss"] == s1["loss"] and s0["acc"] == s1["acc"]
    one = run["one"]["steps"][step]
    assert abs(s0["loss"] - one["loss"]) <= 1e-12 * abs(one["loss"])
    assert s0["acc"] == one["acc"]


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["grads", "state"])
def test_stream_gradients_and_state_match_one_process(run, step, what):
    # state: the parameters, the BN running statistics (and the count)
    # 1e-12 of the largest |value| of all the gradients (of all the
    # state's tensors): a conv bias before a BatchNorm has a gradient of 0
    # in exact arithmetic, so its own values are rounding noise (~1e-18)
    got = run["ranks"][0]["steps"][step][what]
    want = run["one"]["steps"][step][what]
    assert got.keys() == want.keys()
    scale = max(float(t.abs().max()) for t in want.values()
                if t.is_floating_point())
    for k, t in want.items():
        if t.is_floating_point():
            assert t.dtype == torch.float64, k
            torch.testing.assert_close(got[k], t, rtol=0,
                                       atol=1e-12 * scale, msg=k)
        else:
            assert torch.equal(got[k], t), k
    if what == "state":
        assert sum("running" in k for k in want) == 2 * 4


@pytest.mark.parametrize("step", range(STEPS))
def test_stream_ranks_are_bit_identical(run, step):
    s0, s1 = (r["steps"][step] for r in run["ranks"])
    for what in ("grads", "state"):
        for k, t in s0[what].items():
            assert torch.equal(t, s1[what][k]), (what, k)
    assert torch.equal(s0["generator"], s1["generator"])
    # every rank drew the global batch's augmentation: the generators
    # stand where one process's does
    assert torch.equal(s0["generator"],
                       run["one"]["steps"][step]["generator"])


def test_recalibrate_stream_matches_one_process(run):
    r0, r1 = (r["recal"] for r in run["ranks"])
    want = run["one"]["recal"]
    assert len(want) == 4 and r0.keys() == want.keys()
    for name, (mean, var) in want.items():
        assert torch.equal(r0[name][0], r1[name][0])
        assert torch.equal(r0[name][1], r1[name][1])
        _close(r0[name][0], mean, 1e-6, name)
        _close(r0[name][1], var, 1e-6, name)


def test_loaders_and_fit_streaming_over_ranks(run):
    paths = sorted(str(p) for p in (run["work"] / "tree").glob("*.wav"))
    r0, r1 = run["ranks"]
    assert r0["loader_paths"] == paths[0::2]
    assert r1["loader_paths"] == paths[1::2]
    a, b = r0["real"], r1["real"]
    assert a["step"] == b["step"] == 3
    assert np.isfinite(a["first"]) and a["first"] == b["first"]
    assert np.isfinite(a["loss"]).all() and a["loss"] == b["loss"]
    for k, t in a["state"].items():
        assert torch.equal(t, b["state"][k]), k


def test_a_failed_rank_raises_in_the_other(run):
    # rank 1 dies before the collective; rank 0 must raise, not hang
    p0, p1 = run["fail"]
    assert p1.returncode != 0 and "the loader failed" in run["fail_logs"][1]
    assert p0.returncode != 0, run["fail_logs"][0][-2000:]
    waited = re.search(r"rank 0 waited ([0-9.]+) s", run["fail_logs"][0])
    assert waited and float(waited.group(1)) < FAIL_WAIT_S


# -- the Predictor -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_probs():
    """The JAX Predictor on an 8-device mesh (tests/test_infer_tools.py)
    with the port model's weights, on the same batch."""
    model = _predictor_model()
    params, stats = to_flax(model.state_dict(), model=MODEL)
    module, _ = jax_build_model(MODEL, num_classes=12, spectrogram_length=98,
                                num_log_mel_features=40)
    variables = {"params": params, "batch_stats": stats}
    settings = jax_prepare_model_settings(**_predict_settings())
    mesh = jax_make_mesh(jax.devices("cpu")[:8])
    rng = np.random.default_rng(21)
    for i in range(STEPS + RECAL_BATCHES):      # the fixture's draws
        rng.integers(-9000, 9000, (B, T), dtype=np.int16)
        rng.integers(0, 12, B)
    batch = rng.uniform(-0.3, 0.3, (PRED_BATCH, T)).astype(np.float32)
    out = {}
    for mode, flags in MODES.items():
        p = JaxPredictor(module, settings, "mfcc", JaxTTAConfig(**flags),
                         mesh=mesh)
        out[mode] = np.asarray(p.predict(variables, jnp.asarray(batch)))
    return batch, out


@pytest.mark.parametrize("mode", list(MODES))
def test_predictor_over_ranks_matches_one_process_and_jax(
        run, jax_mesh_probs, mode):
    batch, jax_probs = jax_mesh_probs
    assert np.array_equal(torch.load(run["work"] / "predict.pt").numpy(),
                          batch)
    p0, p1 = (r["predict"][mode] for r in run["ranks"])
    assert p0.shape == (PRED_BATCH, 12) and torch.equal(p0, p1)
    np.testing.assert_allclose(p0.numpy(), run["one"]["predict"][mode],
                               rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(p0.numpy(), jax_probs[mode], rtol=0,
                               atol=PROB_ATOL)


def test_predict_directory_over_ranks_pads_the_tail(run):
    names0, probs0 = run["ranks"][0]["predict"]["directory"]
    names1, probs1 = run["ranks"][1]["predict"]["directory"]
    want_names, want = run["one"]["predict"]["directory"]
    assert names0 == names1 == want_names and len(want_names) == TREE_FILES
    assert probs0.shape == (TREE_FILES, 12) and np.array_equal(probs0, probs1)
    np.testing.assert_allclose(probs0, want, rtol=0, atol=PROB_ATOL)
    # the rows are the Predictor's on the decoded clips
    paths = sorted(str(p) for p in (run["work"] / "tree").glob("*.wav"))
    p = Predictor(_predictor_model(),
                  prepare_model_settings(**_predict_settings()), "mfcc",
                  TTAConfig(), CPU)
    direct = p.predict(decode_batch_int16(paths[8:], T)).numpy()
    np.testing.assert_allclose(probs0[8:], direct, rtol=0, atol=PROB_ATOL)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), sys.argv[4])
