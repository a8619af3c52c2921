"""The port's ``fit`` machinery against the JAX package's: BN
re-estimation, checkpoint and resume, the best-only checkpoint, the
confusion reports, ``fit`` itself on a small hard corpus, and the
calibration tool.

* ``recalibrate_batch_stats`` on injected batches against the mean of
  the JAX ``_stats_step`` over the same batches, in float64: <= 1e-10 of
  each statistic's max |value|;
* a run saved, restored into a fresh trainer and stepped K times equals
  K uninterrupted steps bit for bit;
* ``ConfusionReport``'s files and ``render_confusion``'s text are the
  JAX package's, character for character.
"""

import inspect
import json
import os
import re
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.data.device_bank import (
    synthetic_device_dataset as jax_synthetic_device_dataset,
)
from speech_recognition_tpu.train import metrics as JM
from speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    build_device_dataset, synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.hard_corpus import (
    WANTED, build_hard_corpus,
)
from speech_recognition_tpu_torch.data.index import build_dataset_index
from speech_recognition_tpu_torch.labels import prepare_words_list
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.train import metrics as M
from speech_recognition_tpu_torch.train.checkpoint import (
    BestCheckpoint, restore_checkpoint, save_checkpoint,
)
from speech_recognition_tpu_torch.train.loop import (
    Trainer, reference_pseudo_schedule,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NAME = "conv_1d_spec"
SPEC = dict(label_count=12, output_representation="spec")
DATA = dict(num_train=24, num_val=8, num_pseudo=4, seed=2)
# what the JAX ``_stats_step`` reads of its state, as a pytree
JaxStats = namedtuple("JaxStats", ["params", "batch_stats"])


def _spec_trainer(**kw):
    ds = synthetic_device_dataset(CPU, **DATA)
    return Trainer(NAME, prepare_model_settings(**SPEC), ds,
                   compute_dtype="float32", **kw)


def test_bn_recalibration_matches_jax_stats_step_in_float64():
    rng = np.random.default_rng(0)
    batches = [np.abs(rng.normal(0, 2, (4, 98 * 257))) for _ in range(3)]

    # JAX: the mean of _stats_step over the batches, which the injected
    # _sample_batch hands over through the bank_chunks argument
    jtrainer = JaxTrainer(NAME, jax_prepare_model_settings(**SPEC),
                          dataset=jax_synthetic_device_dataset(
                              chunked=False, **DATA),
                          batch_size=4, compute_dtype="float32",
                          use_fused_augment=False)
    jtrainer._sample_batch = lambda key, pf, ds, x, bg: (x, None, key)
    module = jtrainer.module
    v = jax.device_get(jax.jit(lambda k: module.init(
        {"params": k}, jnp.zeros((2, 98 * 257)), train=False))(
            jax.random.PRNGKey(5)))
    with jax.enable_x64(True):
        state = JaxStats(*[
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   v[k])
            for k in JaxStats._fields])
        stats_step = jax.jit(jtrainer._stats_step)
        per_batch = [jax.device_get(stats_step(
            state, jax.random.PRNGKey(i), 0.0, None, jnp.asarray(x), None))
            for i, x in enumerate(batches)]
    want = from_flax({}, jax.tree_util.tree_map(
        lambda *a: np.mean(a, axis=0), *per_batch), model=NAME)

    # the port: the same batches through build_batch
    trainer = _spec_trainer(batch_size=4)
    st = trainer.init_state()
    st.model.load_state_dict(from_flax(v["params"], v["batch_stats"],
                                       model=NAME))
    st.model.double()
    feed = iter(torch.from_numpy(x) for x in batches)
    trainer.build_batch = lambda d: next(feed)
    before = {k: t.clone() for k, t in st.model.state_dict().items()
              if "running" not in k}
    trainer.recalibrate_batch_stats(st, num_batches=len(batches))
    got = st.model.state_dict()
    assert len(want) == 16
    for k, w in want.items():
        err = (got[k] - w).abs().max() / w.abs().max()
        assert got[k].dtype == torch.float64 and err <= 1e-10, (k, err)
    for k, t in before.items():     # parameters untouched
        assert torch.equal(got[k], t), k


def test_bn_recalibration_takes_float32_statistics_under_bf16():
    trainer = _spec_trainer(batch_size=4)
    trainer.compute_dtype = "bfloat16"
    st = trainer.init_state()
    g = torch.Generator().manual_seed(0)
    trainer.recalibrate_batch_stats(st, 2, generator=g)
    bn = st.model.blocks[0].bn
    assert bn.running_mean.dtype == torch.float32
    assert (bn.running_var > 0).all() and bn.batch_stats is None
    # the same generator state gives the same statistics; the trainer's
    # own generator is not drawn from
    g2 = torch.Generator().manual_seed(0)
    before = trainer.generator.get_state()
    mean = bn.running_mean.clone()
    trainer.recalibrate_batch_stats(st, 2, generator=g2)
    assert torch.equal(bn.running_mean, mean)
    assert torch.equal(trainer.generator.get_state(), before)


def _run(trainer, state, steps):
    losses = [float(trainer.train_step(state)["loss"]) for _ in range(steps)]
    return losses, {k: t.clone() for k, t in state.model.state_dict().items()}


@pytest.mark.parametrize("name", [NAME, "conv_1d_time_sliced_with_attention"])
def test_checkpoint_resume_is_bit_exact(tmp_path, name):
    settings = prepare_model_settings(**(SPEC if name == NAME else
                                         dict(label_count=12)))

    def trainer():
        ds = synthetic_device_dataset(CPU, **DATA)
        return Trainer(name, settings, ds, batch_size=4, seed=3,
                       compute_dtype="float32")

    a = trainer()
    st = a.init_state()
    _run(a, st, 2)
    save_checkpoint(str(tmp_path / "ck.pt"), st, a.generator,
                    extra={"epoch": 0})
    want_losses, want_state = _run(a, st, 3)

    b = trainer()
    st_b = b.init_state()
    b.generator.manual_seed(99)
    restore_checkpoint(str(tmp_path / "ck.pt"), st_b, b.generator)
    assert st_b.step == 2
    got_losses, got_state = _run(b, st_b, 3)
    assert got_losses == want_losses
    for k, t in want_state.items():
        assert torch.equal(got_state[k], t), k
    assert st_b.step == st.step == 5


def test_a_card_checkpoint_resumes_on_the_cpu(tmp_path):
    """A checkpoint saved on a card holds ``capturable`` RMSprop groups
    (its step counters on the device); restored on the CPU the optimizer
    keeps its own flag, and the resumed steps are those of a CPU run."""
    def trainer():
        ds = synthetic_device_dataset(CPU, **DATA)
        return Trainer(NAME, prepare_model_settings(**SPEC), ds,
                       batch_size=4, seed=3, compute_dtype="float32")

    a = trainer()
    st = a.init_state()
    assert st.optimizer.param_groups[0]["capturable"] is False
    _run(a, st, 2)
    save_checkpoint(str(tmp_path / "ck.pt"), st, a.generator)
    tree = torch.load(tmp_path / "ck.pt", weights_only=True)
    for group in tree["optimizer"]["param_groups"]:
        group["capturable"] = True          # as the card's optimizer
    torch.save(tree, tmp_path / "card.pt")
    want_losses, want_state = _run(a, st, 2)

    b = trainer()
    st_b = restore_checkpoint(str(tmp_path / "card.pt"), b.init_state(),
                              b.generator)
    assert st_b.optimizer.param_groups[0]["capturable"] is False
    got_losses, got_state = _run(b, st_b, 2)
    assert got_losses == want_losses
    for k, t in want_state.items():
        assert torch.equal(got_state[k], t), k


def test_best_checkpoint_writes_only_on_improvement(tmp_path):
    trainer = _spec_trainer(batch_size=4)
    st = trainer.init_state()
    cb = BestCheckpoint(str(tmp_path), verbose=False,
                        generator=trainer.generator)
    for epoch, acc in enumerate([0.5, 0.4, 0.6, 0.6, 0.55]):
        cb.on_epoch_end(epoch, st, {"val_categorical_accuracy": acc,
                                    "val_loss": 1.0 - acc})
    files = sorted(p.name for p in tmp_path.glob("*.pt"))
    assert files == ["ep-000-vl-0.5000.pt", "ep-002-vl-0.4000.pt"]
    assert (tmp_path / "BEST").read_text() == str(tmp_path / files[-1])
    assert cb.best == 0.6
    low = BestCheckpoint(str(tmp_path / "min"), monitor="val_loss",
                         mode="min", verbose=False)
    for epoch, loss in enumerate([1.0, 1.2, 0.9]):
        low.on_epoch_end(epoch, st, {"val_loss": loss})
    assert len(list((tmp_path / "min").glob("*.pt"))) == 2


def test_confusion_report_and_render_match_jax(tmp_path):
    words = prepare_words_list(WANTED)
    int2label = dict(enumerate(words + ["bed", "cat"]))
    wanted = words
    rng = np.random.default_rng(3)
    confs = [rng.integers(0, 40, (14, 14)).astype(np.int64)
             for _ in range(2)]
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    mine = M.ConfusionReport(int2label, wanted, list(int2label.values()),
                             str(tmp_path / "port"))
    theirs = JM.ConfusionReport(int2label, wanted, list(int2label.values()),
                                str(tmp_path / "jax"))
    for epoch, conf in enumerate(confs):
        assert mine.write(epoch, conf, 0.25 * epoch) \
            == theirs.write(epoch, conf, 0.25 * epoch)
    for name in ("confusion_matrix.txt", "wanted_confusion_matrix.txt"):
        assert (tmp_path / "port" / name).read_text() \
            == (tmp_path / "jax" / name).read_text()
    names = list(int2label.values())
    assert M.render_confusion(confs[0], names) \
        == JM.render_confusion(confs[0], names)
    np.testing.assert_array_equal(
        M.collapse_to_wanted(confs[1], int2label, wanted),
        JM.collapse_to_wanted(confs[1], int2label, wanted))
    np.testing.assert_array_equal(M.per_class_accuracies(confs[0]),
                                  JM.per_class_accuracies(confs[0]))
    assert M.accuracy(confs[0]) == JM.accuracy(confs[0])
    logits = rng.normal(size=(6, 12)).astype(np.float32)
    labels = rng.integers(0, 12, 6)
    assert abs(float(M.log_loss_from_logits(torch.from_numpy(logits),
                                            torch.from_numpy(labels)))
               - float(JM.log_loss_from_logits(jnp.asarray(logits),
                                               jnp.asarray(labels)))) < 1e-6


def _jax_fit_keys():
    """The keys of the JAX ``fit``'s history: ``_update_step``'s metrics
    and the ``logs`` entries ``fit`` adds (read from their source)."""
    update = inspect.getsource(JaxTrainer._update_step)
    metrics = re.findall(r'"(\w+)": (?:loss|acc)', update)
    fit = inspect.getsource(JaxTrainer.fit)
    return set(metrics) | set(re.findall(r'logs\["(\w+)"\] =', fit))


def test_fit_on_a_small_hard_corpus(tmp_path):
    root = tmp_path / "audio"
    build_hard_corpus(root, clips_per_word=8, seed=0)
    settings = prepare_model_settings(
        len(prepare_words_list(WANTED)), output_representation="spec")
    index = build_dataset_index([str(root)], 13.0, 60.0, WANTED, 20.0, 0.0)
    ds = build_device_dataset(index, settings, CPU)
    trainer = Trainer(NAME, settings, ds, batch_size=16, seed=0,
                      compute_dtype="float32")
    state = trainer.init_state()
    seen = []

    class Seen:
        def on_epoch_end(self, epoch, st, logs):
            seen.append((epoch, set(logs)))
            return st if epoch == 0 else None

    launch.reset_runs()
    state, history = trainer.fit(state, epochs=2, callbacks=[Seen()],
                                 bn_recalibration_batches=2,
                                 steps_per_dispatch=3,
                                 pseudo_schedule=reference_pseudo_schedule)
    assert launch.runs() == {}      # the CPU runs the plain version
    keys = _jax_fit_keys()
    assert keys == {"loss", "categorical_accuracy", "epoch_time_s",
                    "clips_per_sec", "val_loss", "val_categorical_accuracy",
                    "confusion"}
    assert set(history) == keys
    assert [e for e, _ in seen] == [0, 1] and seen[0][1] == keys
    steps = ds.set_size("training") // 16
    assert state.step == 2 * steps
    n_val = ds.set_size("validation")
    for k, values in history.items():
        assert len(values) == 2
        if k == "confusion":
            assert all(c.sum() == n_val // 16 * 16 for c in values)
        else:
            assert np.isfinite(values).all(), k


def _calibration_keys():
    """The keys of the JAX calibration record, less the optional and the
    int8 ones (read from scripts/calibrate_accuracy.py)."""
    src = (REPO / "scripts" / "calibrate_accuracy.py").read_text()
    body = src[src.index("record = {"):src.index("\n    }\n")]
    return set(re.findall(r'^        "(\w+)":', body, re.M))


def test_calibrate_accuracy_prints_the_jax_record(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m",
         "speech_recognition_tpu_torch.tools.calibrate_accuracy",
         "--device", "cpu", "--epochs", "1", "--clips_per_word", "6",
         "--model", NAME, "--batch_size", "16",
         "--bn_recalibration_batches", "2", "--seed", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    keys = _calibration_keys()
    assert "val_acc_best" in keys and "aot_int8_acc" not in keys
    assert set(record) == keys
    assert record["model"] == NAME and record["representation"] == "spec"
    assert record["epochs"] == 1 and record["pallas_augment"] is False
    assert 0.0 <= record["val_acc_best"] <= 1.0
    assert "[ep 00] val_acc=" in proc.stderr
    assert list(tmp_path.glob("srt_torch_hard_corpus_*/audio/yes/*.wav"))
