"""The port's flagship train step and eval step vs the JAX package.

Both sides start from the same flax-initialised weights (moved with
``from_flax``), see the same injected batches (numpy draws fed to both
data paths) and train with dropout off: flax through
``intercept_methods`` making ``Dropout`` the identity, the port with
``p = 0``. The JAX side composes ``build_model``, ``smooth_cross_entropy``,
``l2_kernel_penalty`` and ``build_optimizer("rmsprop", 1e-3)`` as
``Trainer._update_step`` does.

The model runs in float64 on both sides. In float32 the JAX side's own
gradients move by ~1% between float32 and float64 on these batches (flax
BatchNorm's one-pass variance, E[x^2] - E[x]^2, cancels), while the
port's move by ~2e-6: a float32 comparison would measure that, not the
port. In float64 the two agree to ~3e-8. (JAX's *jitted* gradient of this
train-mode forward differs from its eager one by ~0.2 on CPU, in float32
and float64 alike, so the JAX side runs eagerly; ROADMAP C records it.)
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tpu.data.device_bank import (
    synthetic_device_dataset as jax_synthetic_device_dataset,
)
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.ops.augment import rolled_decode_augment
from speech_recognition_tpu.ops.pallas.augment_kernel import double_bank
from speech_recognition_tpu.train import metrics as JM
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.config import (
    AugmentConfig, prepare_model_settings,
)
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.export.benchmark import benchmark_train
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.layers import Dropout
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.train import metrics as M
from speech_recognition_tpu_torch.train import optim as O
from speech_recognition_tpu_torch.train.loop import Draws, Trainer

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
NAME = "conv_1d_time_sliced_with_attention"
LR = 1e-3
BATCH = 8
T = 16000
DATA = dict(num_train=32, num_val=20, num_pseudo=8, seed=3)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _draws(rng, part, bg_len):
    """One batch of injected draws (numpy), silence rows muted as the
    JAX policy does."""
    idx = rng.integers(0, part.size, BATCH)
    fids = part.file_ids.numpy()[idx]
    labels = part.labels.numpy()[idx]
    silence = labels == 0
    shifts = rng.integers(-500, 1, BATCH)
    fg = rng.uniform(0.85, 1.15, BATCH).astype(np.float32)
    fg[silence] = 0.0
    bg_pos = rng.integers(0, bg_len - T + 1, BATCH)
    bg_vol = rng.uniform(0.0, 0.15, BATCH).astype(np.float32)
    return fids, labels, silence, shifts, fg, bg_pos, bg_vol


@pytest.fixture(scope="module")
def run():
    """Three injected train steps on both sides, then one eval step."""
    settings = prepare_model_settings(label_count=12)
    ds = synthetic_device_dataset(CPU, **DATA)
    jds = jax_synthetic_device_dataset(chunked=False, **DATA)
    trainer = Trainer(NAME, settings, ds, batch_size=BATCH,
                      compute_dtype="float32")
    state = trainer.init_state()
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0

    module, _ = jax_build_model(NAME, num_classes=12)
    v = jax.device_get(module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, T)), train=False))
    state.model.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    state.model.double()
    bank2 = double_bank(jds.wav_bank)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        draws = _draws(rng, ds.partitions["training"],
                       ds.background.flat.shape[0])
        fids, _, _, shifts, fg, bg_pos, bg_vol = draws
        jwav = rolled_decode_augment(
            bank2, jds.background, jnp.asarray(fids, jnp.int32),
            jnp.asarray(shifts, jnp.int32), jnp.asarray(fg),
            jnp.asarray(bg_pos, jnp.int32), jnp.asarray(bg_vol),
            num_samples=T)
        batches.append((draws, np.asarray(jwav)))
    out = {"steps": []}
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), v["params"])
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), v["batch_stats"])
        tx = JO.build_optimizer("rmsprop", LR)
        opt_state = tx.init(params)

        def loss_fn(p, bs, x, y):
            with fnn.intercept_methods(_no_dropout):
                logits, upd = module.apply(
                    {"params": p, "batch_stats": bs}, x, train=True,
                    mutable=["batch_stats"])
            loss = JO.smooth_cross_entropy(logits, y, 0.1)
            loss = loss + JO.l2_kernel_penalty(p, 1e-5)
            return loss, upd["batch_stats"]

        for draws, jwav in batches:
            d = Draws(*[torch.from_numpy(np.asarray(a)) for a in draws])
            wav = trainer.build_batch(d)
            metrics = trainer._update_step(state, wav.double(), d.labels)
            (jloss, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, stats,
                                       jnp.asarray(jwav, jnp.float64),
                                       jnp.asarray(draws[1]))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            out["steps"].append(dict(
                wav=wav.numpy(), jwav=jwav,
                loss=float(metrics["loss"]), jloss=float(jloss),
                grads={k: p.grad.clone()
                       for k, p in state.model.named_parameters()},
                jgrads=from_flax(jax.device_get(grads), {}),
                state={k: t.clone()
                       for k, t in state.model.state_dict().items()},
                jstate=from_flax(jax.device_get(params),
                                 jax.device_get(stats))))

        params, stats = jax.device_get((params, stats))

    # one eval step on the validation partition, in float32 on both
    # sides, from each side's weights after the three steps
    state.model.float()
    fids, labels, sil = ds.eval_ids("validation", 0, 16)
    conf, loss_sum = trainer._eval_step(state, fids, labels, sil)
    jfids, jlabels, jsil = jds.eval_ids("validation", 0, 16)
    wav = jds.decode(jfids) * jnp.where(jsil, 0.0, 1.0)[:, None]
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        {"params": params, "batch_stats": stats})
    logits = module.apply(variables, wav, train=False)
    out["eval"] = (conf.numpy(), float(loss_sum),
                   np.asarray(JM.confusion_matrix(
                       jlabels, logits.argmax(-1), 12)),
                   float(-jnp.take_along_axis(
                       jax.nn.log_softmax(logits), jlabels[:, None],
                       axis=1).sum()))
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
def test_wave_batch_matches_jax(run, step):
    s = run["steps"][step]
    np.testing.assert_allclose(s["wav"], s["jwav"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loss_matches_jax(run, step):
    s = run["steps"][step]
    assert abs(s["loss"] - s["jloss"]) < 1e-9


@pytest.mark.parametrize("step", [0, 1, 2])
def test_gradients_match_jax(run, step):
    # float64 on both sides: measured agreement ~3e-8 on gradients of
    # magnitude ~1 (the XLA and ATen convolutions sum in other orders)
    s = run["steps"][step]
    assert set(s["grads"]) == set(s["jgrads"])
    for k, g in s["jgrads"].items():
        np.testing.assert_allclose(s["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_bn_running_stats_match_jax(run, step):
    s = run["steps"][step]
    keys = [k for k in s["jstate"] if "running" in k]
    assert len(keys) == 2 * 12
    for k in keys:
        np.testing.assert_allclose(s["state"][k].numpy(),
                                   s["jstate"][k].numpy(),
                                   rtol=0, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_parameters_match_jax(run, step):
    # RMSprop's first update is ~lr*sqrt(10)*sign(g) whatever |g|, so a
    # gradient that differs by ~1e-8 moves a parameter by up to a few lr
    # only where |g| itself is ~1e-8. Bound: 1e-3 lr per step taken.
    s = run["steps"][step]
    for k, p in s["jstate"].items():
        np.testing.assert_allclose(s["state"][k].numpy(), p.numpy(), rtol=0,
                                   atol=1e-3 * LR * (step + 1), err_msg=k)


def test_eval_step_matches_jax(run):
    conf, loss_sum, jconf, jloss_sum = run["eval"]
    assert conf.sum() == 16
    np.testing.assert_array_equal(conf, jconf)
    # summed over 16 clips from float32 logits of magnitude ~1
    assert abs(loss_sum - jloss_sum) < 1e-4


def test_smooth_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 12)).astype(np.float32) * 3
    labels = rng.integers(0, 12, 16)
    for ls in (0.0, 0.1):
        want = float(JO.smooth_cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(labels), ls))
        got = float(O.smooth_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), ls))
        assert abs(got - want) < 1e-6


def test_l2_penalty_covers_kernels_only():
    module, _ = jax_build_model(NAME, num_classes=12)
    v = jax.device_get(module.init(
        {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
        jnp.zeros((1, T)), train=False))
    # BN scale/bias off 1/0 so that counting them would show
    params = jax.tree_util.tree_map(lambda a: a + 0.5, v["params"])
    trainer_model = Trainer(NAME, prepare_model_settings(label_count=12),
                            synthetic_device_dataset(CPU, num_train=4,
                                                     num_val=1, num_pseudo=0),
                            batch_size=2).init_state().model
    trainer_model.load_state_dict(from_flax(params, v["batch_stats"]))
    want = float(JO.l2_kernel_penalty(params, 1e-5))
    with torch.no_grad():
        got = float(O.l2_kernel_penalty(trainer_model, 1e-5))
    assert abs(got - want) < 1e-6 * want
    assert float(O.l2_kernel_penalty(trainer_model, 0.0)) == 0.0


def test_rmsprop_update_matches_keras_rmsprop():
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = O.build_optimizer("rmsprop", [p], LR)
    tx = JO.build_optimizer("rmsprop", LR)
    jp = jnp.asarray(w0)
    js = tx.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-7)


def test_learning_rate_accessors_and_unported_optimizers():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = O.build_optimizer("rmsprop", [p], LR)
    assert O.get_learning_rate(opt) == LR
    O.set_learning_rate(opt, 5e-4)
    assert O.get_learning_rate(opt) == 5e-4
    with pytest.raises(ValueError, match="unknown optimizer"):
        O.build_optimizer("adagrad", [p], LR)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 12, 200)
    preds = rng.integers(0, 12, 200)
    got = M.confusion_matrix(torch.from_numpy(labels),
                             torch.from_numpy(preds), 12)
    want = JM.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), 12)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def cpu_trainer():
    ds = synthetic_device_dataset(CPU, num_train=16, num_val=10,
                                  num_pseudo=4, seed=5)
    return Trainer(NAME, prepare_model_settings(label_count=12), ds,
                   augment=AugmentConfig(pseudo_frequency=0.6),
                   batch_size=4)


def test_cpu_train_steps_use_the_plain_version(cpu_trainer):
    assert cpu_trainer.compute_dtype == "float32"
    state = cpu_trainer.init_state()
    before = launch.runs()
    metrics = cpu_trainer.train_many(state, 2)
    assert launch.runs() == before
    assert metrics["loss"].shape == (2,)
    assert torch.isfinite(metrics["loss"]).all()
    assert state.step == 2


def test_evaluate_drops_the_trailing_partial_batch(cpu_trainer):
    state = cpu_trainer.init_state()
    conf, loss = cpu_trainer.evaluate(state, "validation")
    assert conf.shape == (12, 12) and conf.sum() == (10 // 4) * 4
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="empty"):
        cpu_trainer.evaluate(state, "testing")


def test_same_seed_same_training(cpu_trainer):
    losses = []
    for _ in range(2):
        t = Trainer(NAME, cpu_trainer.settings, cpu_trainer.dataset,
                    batch_size=4, seed=9)
        losses.append(t.train_many(t.init_state(), 2)["loss"])
    assert torch.equal(losses[0], losses[1])


def test_benchmark_refuses_the_cpu(cpu_trainer):
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_train(cpu_trainer, cpu_trainer.init_state(), steps=1,
                        warmup=0)
