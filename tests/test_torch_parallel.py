"""Data-parallel training of the port against the JAX package.

Rank-to-rank checks run in two real processes joined by a ``gloo``
process group on the CPU (rendezvous through a file, so parallel test
workers never race for a port). The module's fixture starts both ranks
once: each runs this file as a script (``_rank_main``), does every
two-rank check in the same order and saves its results; the tests then
hold them against the JAX package and against the port on one process.

- ``decode_augment_sharded``: rank rows for W in {2, 8} against
  ``fused_decode_augment_sharded(..., interpret=True)`` on the 8-device
  CPU mesh (rtol = atol = 1e-6, the JAX test's) and, exactly, against
  the unsharded ``decode_augment``.
- Global-batch BatchNorm on two ranks: against the JAX 2-device sharded
  BN of ``tests/test_bn_dp.py`` (2e-5, its tolerance) in float32, and
  against the port's one-process BatchNorm on the whole batch in
  float64, gradients included (1e-12 of each tensor's max |value|: the
  two differ only in the order of float64 sums over 56 values).
- The flagship: two injected train steps at global batch 8 (4 per
  rank), float64, dropout off, against the JAX package's eager
  single-device step on the same batch (which ``tests/test_bn_dp.py``
  shows is what JAX DP computes; ``tests/test_torch_slice.py``'s
  tolerances and reasons) and against the port's one-process step
  (tighter: only the order of float64 sums differs). Across ranks the
  parameters must be bit-identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from speech_recognition_tpu.data.device_bank import (
    synthetic_device_dataset as jax_synthetic_device_dataset,
)
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.models.layers import BN_EPS, BN_MOMENTUM
from speech_recognition_tpu.ops.augment import rolled_decode_augment
from speech_recognition_tpu.ops.pallas.augment_kernel import (
    chunk_background, double_bank,
)
from speech_recognition_tpu.ops.pallas.sharded import (
    fused_decode_augment_sharded,
)
from speech_recognition_tpu.parallel.distributed import (
    process_shard as jax_process_shard,
)
from speech_recognition_tpu.parallel.mesh import (
    batch_sharding, make_mesh as jax_make_mesh, replicated_sharding,
    shard_batch as jax_shard_batch,
)
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.layers import (
    BatchNorm, Dropout, use_mesh,
)
from speech_recognition_tpu_torch.ops.kernels import sharded as KS
from speech_recognition_tpu_torch.ops.kernels.decode_augment import (
    decode_augment,
)
from speech_recognition_tpu_torch.parallel.collectives import all_reduce_sum
from speech_recognition_tpu_torch.parallel.distributed import (
    host_replicated, initialize_distributed, process_shard,
)
from speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard_batch,
)
from speech_recognition_tpu_torch.train.loop import Draws, Trainer
from speech_recognition_tpu_torch.utils.profiling import clear as clear_spans
from speech_recognition_tpu_torch.utils.profiling import spans

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NAME = "conv_1d_time_sliced_with_attention"
LR = 1e-3
WORLD = 2
BATCH = 8                       # global; 4 rows per rank
T = 16000
STEPS = 2
DATA = dict(num_train=32, num_val=20, num_pseudo=8, seed=3)
EVAL_DATA = dict(num_train=8, num_val=15, num_pseudo=0, seed=4)
# (rank batch_size, the one-rank batch that sweeps the same clips)
EVAL_BATCHES = [(16, 14), (4, 4)]


# -- inputs shared by the ranks and the references -----------------------

def _bn_jax_input():
    """tests/test_bn_dp.py's batch: 8 slices of 4 rows with different
    means; rank r of 2 holds slices 4r..4r+3."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(loc=i, scale=1.0 + 0.2 * i, size=(4, 6))
        for i in range(8)]).astype(np.float32)


def _bn64_inputs():
    """A [8, 5, 7] float64 NCW batch whose two halves have different
    means, BN weight and bias, and a cotangent."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(loc=3.0 * i, scale=1.0 + 0.5 * i,
                                   size=(4, 5, 7)) for i in range(WORLD)])
    return (torch.from_numpy(x), torch.from_numpy(rng.uniform(0.5, 1.5, 5)),
            torch.from_numpy(rng.normal(size=5)),
            torch.from_numpy(rng.normal(size=x.shape)))


def _bn64(x, weight, bias, dy, mesh=None):
    """One train-mode BatchNorm pass and its backward: (y, running mean,
    running var, dx, dweight, dbias)."""
    bn = BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    use_mesh(bn, mesh)
    x = x.clone().requires_grad_()
    y = bn.train()(x)
    (y * dy).sum().backward()
    return (y.detach(), bn.running_mean, bn.running_var, x.grad,
            bn.weight.grad, bn.bias.grad)


def _slice_draws(rng, part, bg_len):
    """One global batch of injected draws (numpy), silence rows muted as
    the JAX policy does (tests/test_torch_slice.py)."""
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


def _tiny_data(seed):
    return dict(num_train=4, num_val=2, num_pseudo=0, seed=seed)


def _flagship_trainer(mesh=None, **kw):
    ds = synthetic_device_dataset(CPU, **DATA)
    return Trainer(NAME, prepare_model_settings(label_count=12), ds,
                   batch_size=BATCH, compute_dtype="float32", mesh=mesh, **kw)


def _train_steps(trainer, weights, draws):
    """The injected float64 steps, dropout off; per step the loss, the
    gradients and the state after it."""
    state = trainer.init_state()
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    state.model.load_state_dict(weights)
    state.model.double()
    steps = []
    for arrays in draws:
        d = Draws(*[torch.from_numpy(np.asarray(a)) for a in arrays])
        wav = trainer.build_batch(d)
        metrics = trainer._update_step(state, wav.double(),
                                       shard_batch(d.labels, trainer.mesh))
        steps.append(dict(
            wav=wav, loss=float(metrics["loss"]),
            acc=float(metrics["categorical_accuracy"]),
            grads={k: p.grad.clone()
                   for k, p in state.model.named_parameters()},
            state={k: t.clone()
                   for k, t in state.model.state_dict().items()}))
    return state, steps


def _evaluate(state, batch_size, mesh=None):
    ds = synthetic_device_dataset(CPU, **EVAL_DATA)
    trainer = Trainer(NAME, prepare_model_settings(label_count=12), ds,
                      batch_size=batch_size, mesh=mesh)
    conf, loss = trainer.evaluate(state, "validation")
    return torch.from_numpy(conf), loss


# -- one rank (run as a script) ------------------------------------------

def _rank_main(rank: int, init_method: str, work: Path) -> None:
    """Every two-rank check, in the same order on both ranks."""
    initialize_distributed(init_method, WORLD, rank, "gloo")
    mesh = make_mesh(CPU)
    out = {"mesh": [mesh.rank, mesh.size, str(mesh.device)]}

    tree = {"a": torch.full((3,), float(rank)),
            "b": [torch.arange(4, dtype=torch.int16) + 10 * rank,
                  torch.tensor([rank == 0, True])]}
    out["replicated"] = host_replicated(tree, mesh)
    ds = host_replicated(synthetic_device_dataset(CPU, **_tiny_data(rank)),
                         mesh)
    out["replicated_bank"] = [ds.wav_bank, ds.background.flat,
                              ds.partitions["training"].is_silence]

    x = (torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)).requires_grad_()
    y = all_reduce_sum(x, mesh)
    (y * (rank + 1)).sum().backward()
    out["all_reduce"] = [y.detach(), x.grad]

    bn = BatchNorm(6)
    bn.reset_parameters()
    use_mesh(bn, mesh)
    x32 = torch.from_numpy(_bn_jax_input()[mesh.rows(32)])
    with torch.no_grad():
        out["bn32"] = [bn.train()(x32[:, :, None])[:, :, 0],
                       bn.running_mean, bn.running_var]

    x64, weight, bias, dy = _bn64_inputs()
    rows = mesh.rows(x64.shape[0])
    out["bn64"] = list(_bn64(x64[rows], weight, bias, dy[rows], mesh))

    weights = torch.load(work / "weights.pt")
    draws = np.load(work / "draws.npz")
    draws = [[draws[f"{s}_{i}"] for i in range(7)] for s in range(STEPS)]
    state, out["steps"] = _train_steps(_flagship_trainer(mesh), weights,
                                       draws)
    state.model.float()
    out["eval"] = [list(_evaluate(state, b, mesh)) for b, _ in EVAL_BATCHES]

    trainer = _flagship_trainer(mesh)
    state = trainer.init_state()
    clear_spans()
    trainer.train_step(state)
    out["step_spans"] = [(r.name, r.step) for r in spans()]
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


# -- the references, and the ranks' results ------------------------------

def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_steps(module, variables, jds, draws):
    """The JAX package's eager single-device float64 steps (see
    tests/test_torch_slice.py for why eager)."""
    bank2 = double_bank(jds.wav_bank)
    waves = [np.asarray(rolled_decode_augment(
        bank2, jds.background, jnp.asarray(fids, jnp.int32),
        jnp.asarray(shifts, jnp.int32), jnp.asarray(fg),
        jnp.asarray(bg_pos, jnp.int32), jnp.asarray(bg_vol),
        num_samples=T)) for fids, _, _, shifts, fg, bg_pos, bg_vol in draws]
    steps = []
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        tx = JO.build_optimizer("rmsprop", LR)
        opt_state = tx.init(params)

        def loss_fn(p, bs, x, y):
            with fnn.intercept_methods(_no_dropout):
                logits, upd = module.apply(
                    {"params": p, "batch_stats": bs}, x, train=True,
                    mutable=["batch_stats"])
            loss = JO.smooth_cross_entropy(logits, y, 0.1)
            return loss + JO.l2_kernel_penalty(p, 1e-5), upd["batch_stats"]

        for wav, (_, labels, *_) in zip(waves, draws):
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, stats, jnp.asarray(wav, jnp.float64),
                jnp.asarray(labels))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            steps.append(dict(
                wav=wav, loss=float(loss),
                grads=from_flax(jax.device_get(grads), {}),
                state=from_flax(jax.device_get(params),
                                jax.device_get(stats))))
    return steps


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start both ranks, compute the references meanwhile, then collect
    the ranks' results."""
    work = tmp_path_factory.mktemp("dp")
    module, _ = jax_build_model(NAME, num_classes=12)
    variables = jax.device_get(module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, T)), train=False))
    weights = from_flax(variables["params"], variables["batch_stats"])
    torch.save(weights, work / "weights.pt")
    ds = synthetic_device_dataset(CPU, **DATA)
    rng = np.random.default_rng(7)
    draws = [_slice_draws(rng, ds.partitions["training"],
                          ds.background.flat.shape[0]) for _ in range(STEPS)]
    np.savez(work / "draws.npz", **{f"{s}_{i}": a for s, d in
                                    enumerate(draws) for i, a in enumerate(d)})

    env = dict(os.environ, PYTHONPATH=str(REPO))
    init_method = f"file://{work / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), init_method, str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(WORLD)]
    try:
        trainer = _flagship_trainer()
        state, one = _train_steps(trainer, weights, draws)
        state.model.float()
        one_eval = [_evaluate(state, b) for _, b in EVAL_BATCHES]
        jds = jax_synthetic_device_dataset(chunked=False, **DATA)
        jax_steps = _jax_steps(module, variables, jds, draws)
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(WORLD)]
    return dict(ranks=ranks, one=one, one_eval=one_eval, jax=jax_steps,
                draws=draws)


# -- the mesh, the process group and process_shard -----------------------

@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (2, 3), (0, 3),
                                         (1, 3), (None, None)])
def test_process_shard_matches_jax(index, count):
    items = list(range(7))
    assert process_shard(items, index, count) == jax_process_shard(
        items, index, count)


def test_make_mesh_without_a_group_is_one_rank():
    assert not dist.is_initialized()
    assert make_mesh(CPU) == Mesh(0, 1, CPU, None)


def test_mesh_rows_and_shard_batch():
    x = torch.arange(12)
    got = [shard_batch({"x": x, "t": (x, x)}, Mesh(r, 3)) for r in range(3)]
    assert torch.equal(torch.cat([g["x"] for g in got]), x)
    assert torch.equal(got[1]["t"][1], torch.tensor([4, 5, 6, 7]))
    with pytest.raises(ValueError, match="does not split"):
        Mesh(0, 5).rows(12)
    with pytest.raises(ValueError, match="outside"):
        Mesh(2, 2)


def test_make_mesh_in_a_process_group(run):
    assert [r["mesh"] for r in run["ranks"]] == [[0, 2, "cpu"],
                                                [1, 2, "cpu"]]


def test_host_replicated_gives_every_rank_rank0s_tensors(run):
    ds = synthetic_device_dataset(CPU, **_tiny_data(0))
    want = [ds.wav_bank, ds.background.flat,
            ds.partitions["training"].is_silence]
    for r in run["ranks"]:
        tree = r["replicated"]
        assert torch.equal(tree["a"], torch.zeros(3))
        assert torch.equal(tree["b"][0], torch.arange(4, dtype=torch.int16))
        assert torch.equal(tree["b"][1], torch.tensor([True, True]))
        for got, w in zip(r["replicated_bank"], want):
            assert got.dtype == w.dtype and torch.equal(got, w)


def test_all_reduce_sum_forward_and_backward(run):
    # y = x_0 + x_1 on both ranks; loss_r = (r + 1) * sum(y), so each
    # x_r's gradient is the sum of both ranks' weights, 1 + 2
    for r in run["ranks"]:
        y, dx = r["all_reduce"]
        assert torch.equal(y, torch.tensor([3.0, 6.0, 9.0]))
        assert torch.equal(dx, torch.full((3,), 3.0))


# -- decode_augment_sharded ----------------------------------------------

def _sharded_inputs():
    """tests/test_sharded_kernel.py's inputs."""
    rng = np.random.default_rng(0)
    n, t, b = 8, 512, 16
    bank = rng.integers(-3000, 3000, (n, t), dtype=np.int16)
    bg_clip = rng.uniform(-0.2, 0.2, 5 * t).astype(np.float32)
    fids = rng.integers(0, n, b).astype(np.int32)
    shifts = rng.integers(-t // 4, t // 4, b).astype(np.int32)
    fg = rng.uniform(0.5, 1.5, b).astype(np.float32)
    bg_pos = rng.integers(0, 4 * t, b).astype(np.int32)
    bg_vol = rng.uniform(0, 0.3, b).astype(np.float32)
    return bank, bg_clip, fids, shifts, fg, bg_pos, bg_vol


@pytest.fixture(scope="module")
def jax_sharded():
    bank, bg_clip, *vectors = _sharded_inputs()
    mesh = jax_make_mesh()
    args = jax_shard_batch(tuple(jnp.asarray(v) for v in vectors), mesh)
    return np.asarray(fused_decode_augment_sharded(
        mesh, double_bank(jnp.asarray(bank)),
        chunk_background(jnp.asarray(bg_clip), bank.shape[1]), *args,
        num_samples=bank.shape[1], interpret=True))


def _port_sharded(world, fn=KS.decode_augment_sharded):
    args = [torch.from_numpy(a) for a in _sharded_inputs()]
    return [fn(Mesh(r, world), *args) for r in range(world)], args


@pytest.mark.parametrize("world", [2, 8])
def test_decode_augment_sharded_matches_jax(jax_sharded, world):
    rows, _ = _port_sharded(world)
    assert all(r.shape == (16 // world, 512) for r in rows)
    np.testing.assert_allclose(torch.cat(rows).numpy(), jax_sharded,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 8])
def test_decode_augment_sharded_equals_unsharded(world):
    before = KS.LAUNCHES
    rows, args = _port_sharded(world)
    plain, _ = _port_sharded(world, KS.decode_augment_sharded_reference)
    assert KS.LAUNCHES == before        # CPU tensors: the plain version
    whole = decode_augment(*args)
    assert torch.equal(torch.cat(rows), whole)
    assert torch.equal(torch.cat(plain), whole)


def test_indivisible_batch_raises():
    with pytest.raises(ValueError, match="does not split"):
        _port_sharded(3)
    with pytest.raises(ValueError, match="does not split"):
        _flagship_trainer(Mesh(0, 3))


# -- dropout -------------------------------------------------------------

@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (3, 4)])
def test_dropout_mask_is_the_global_masks_rows(rank, world):
    x = torch.ones(3 * world, 10)
    whole = Dropout(0.4).train()(x, torch.Generator().manual_seed(5))
    drop = Dropout(0.4).train()
    use_mesh(drop, Mesh(rank, world))
    g = torch.Generator().manual_seed(5)
    got = drop(x[:3], g)
    assert torch.equal(got, whole[3 * rank:3 * rank + 3])
    # every rank's generator has moved past the whole global draw
    after = torch.Generator().manual_seed(5)
    torch.rand((3 * world, 10), generator=after)
    assert torch.equal(g.get_state(), after.get_state())


# -- global-batch BatchNorm ----------------------------------------------

class _BNNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        return fnn.BatchNorm(use_running_average=not train,
                             momentum=BN_MOMENTUM, epsilon=BN_EPS)(x)


@pytest.fixture(scope="module")
def jax_bn():
    """tests/test_bn_dp.py's sharded BN step, on 2 devices."""
    mesh = jax_make_mesh(jax.devices("cpu")[:2])
    x = jnp.asarray(_bn_jax_input())
    module = _BNNet()
    variables = module.init(jax.random.PRNGKey(0), x)

    def step(variables, x):
        out, updated = module.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
        return out, updated["batch_stats"]["BatchNorm_0"]

    out, stats = jax.jit(step)(
        jax.tree_util.tree_map(
            lambda a: jax.device_put(a, replicated_sharding(mesh)),
            variables),
        jax.device_put(x, batch_sharding(mesh)))
    return [np.asarray(out), np.asarray(stats["mean"]),
            np.asarray(stats["var"])]


@pytest.mark.parametrize("i,what", enumerate(["output", "mean", "var"]))
def test_global_bn_matches_jax_sharded_bn(run, jax_bn, i, what):
    got = [r["bn32"][i] for r in run["ranks"]]
    if what == "output":
        got = torch.cat(got)
    else:
        assert torch.equal(got[0], got[1])
        got = got[0]
    np.testing.assert_allclose(got.numpy(), jax_bn[i], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("i,what", enumerate(
    ["output", "running_mean", "running_var", "dx", "dweight", "dbias"]))
def test_global_bn_matches_one_process_bn(run, i, what):
    want = _bn64(*_bn64_inputs())[i]
    got = [r["bn64"][i] for r in run["ranks"]]
    if what in ("output", "dx"):
        got = torch.cat(got)
    elif what in ("dweight", "dbias"):     # each rank's share of the sum
        got = got[0] + got[1]
    else:
        assert torch.equal(got[0], got[1])
        got = got[0]
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


# -- the flagship's train steps ------------------------------------------

def _rank_steps(run, step):
    return [r["steps"][step] for r in run["ranks"]]


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_wave_rows_match_jax(run, step):
    got = torch.cat([s["wav"] for s in _rank_steps(run, step)])
    np.testing.assert_allclose(got.numpy(), run["jax"][step]["wav"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_loss_matches_jax_and_one_process(run, step):
    s0, s1 = _rank_steps(run, step)
    assert s0["loss"] == s1["loss"] and s0["acc"] == s1["acc"]
    assert abs(s0["loss"] - run["jax"][step]["loss"]) < 1e-9
    one = run["one"][step]
    assert abs(s0["loss"] - one["loss"]) < 1e-12
    assert s0["acc"] == one["acc"]


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_gradients_match_jax(run, step):
    # float64 on both sides; tests/test_torch_slice.py's bound
    got = _rank_steps(run, step)[0]["grads"]
    want = run["jax"][step]["grads"]
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_gradients_match_one_process(run, step):
    # the same float64 arithmetic on the same batch, summed in another
    # order (two halves, then the all-reduce): 1e-11 of max |g|
    # (measured up to 9.6e-13)
    got = _rank_steps(run, step)[0]["grads"]
    for k, g in run["one"][step]["grads"].items():
        torch.testing.assert_close(got[k], g, rtol=0,
                                   atol=1e-11 * float(g.abs().max()),
                                   msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_bn_running_stats_match_jax(run, step):
    got = _rank_steps(run, step)[0]["state"]
    want = run["jax"][step]["state"]
    keys = [k for k in want if "running" in k]
    assert len(keys) == 2 * 12
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_parameters_match_jax(run, step):
    # RMSprop's first update is ~lr*sqrt(10)*sign(g) whatever |g| (see
    # tests/test_torch_slice.py): 1e-3 lr per step taken
    got = _rank_steps(run, step)[0]["state"]
    for k, p in run["jax"][step]["state"].items():
        np.testing.assert_allclose(got[k].numpy(), p.numpy(), rtol=0,
                                   atol=1e-3 * LR * (step + 1), err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_state_matches_one_process(run, step):
    # parameters and running statistics. The gradients differ by up to
    # ~1e-12 of max |g|, and RMSprop's update lr*g/(sqrt(0.1 g^2) + 1e-8)
    # scales a difference by up to lr/1e-8 where |g| ~ 1e-8 (measured:
    # 1.7e-12 in a pointwise weight with |g| ~ 1.4e-8): 1e-6 lr per step
    got = _rank_steps(run, step)[0]["state"]
    for k, t in run["one"][step]["state"].items():
        torch.testing.assert_close(got[k], t, rtol=0,
                                   atol=1e-6 * LR * (step + 1), msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_ranks_are_bit_identical(run, step):
    s0, s1 = _rank_steps(run, step)
    for what in ("grads", "state"):
        assert s0[what].keys() == s1[what].keys()
        for k, t in s0[what].items():
            assert torch.equal(t, s1[what][k]), (what, k)


# -- evaluate ------------------------------------------------------------

@pytest.mark.parametrize("i,batch", enumerate(b for b, _ in EVAL_BATCHES))
def test_dp_evaluate_matches_one_rank(run, i, batch):
    conf0, loss0 = run["ranks"][0]["eval"][i]
    conf1, loss1 = run["ranks"][1]["eval"][i]
    assert torch.equal(conf0, conf1) and loss0 == loss1
    # the batch shrinks to a multiple of 2 (16 -> 14 of 15 clips)
    one_batch = EVAL_BATCHES[i][1]
    assert int(conf0.sum()) == 15 // one_batch * one_batch
    want_conf, want_loss = run["one_eval"][i]
    assert torch.equal(conf0, want_conf)
    assert abs(loss0 - want_loss) < 1e-6 * abs(want_loss)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))


def test_a_two_rank_train_step_is_eager(run):
    """Over W > 1 ranks ``train_step`` runs the eager step, with the
    phase spans in order and no graph capture or replay."""
    for r in run["ranks"]:
        assert r["step_spans"] == [
            ("train.draw", 0), ("train.build", 0), ("train.forward", 0),
            ("train.loss", 0), ("train.optimizer", 0),
            ("train.backward", 0), ("train.optimizer", 0),
            ("train.step", 0)]
