"""Shared parity harness for the port's zoo models against the JAX ones
(``tests/test_torch_zoo_*.py``).

The flax variables are not initialised by JAX: their tree comes from
``jax.eval_shape`` of ``module.init`` and every leaf is drawn with numpy
from a seed (glorot-uniform kernels; biases, BN scales and offsets and
BN running statistics off their constant init), so each tensor is
distinct and no large JAX program is compiled for the init. The same
numbers go to the port through ``from_flax``.

* ``eval_logits``: both sides in float32, eval mode.
* ``train_mode_pair``: the train-mode loss (smoothed cross-entropy + the
  L2 penalty on kernels) and its gradients in float64, every Dropout's
  mask injected on both sides in call order (flax's intercepted, the
  port's ``forward`` replaced; a mask of a 3-D activation is drawn NWC
  and transposed to the port's NCW).
* ``twin_logits``: the TF-twin golden's weights, imported into the flax
  tree as tests/test_model_twins.py does, moved with ``from_flax``.

Each ``tests/test_torch_zoo_*.py`` imports the fixtures and tests below
and defines a module-scoped ``name`` fixture over its models; the files
are three so that the driver's workers spread the JAX compiles.
"""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.train import optim as O
# the JAX package's parameter-count goldens and TF-twin logit bounds
from test_model_twins import CASES as TWIN_ATOL
from test_zoo_param_goldens import GOLDEN_PARAM_COUNTS as PARAM_GOLDENS

GOLDENS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "goldens")
sys.path.insert(0, GOLDENS_DIR)

B, T, CLASSES = 2, 16000, 12
LOGITS_RTOL = 1e-4      # of max |logit|, f32
GRAD_RTOL = 1e-10       # of max |g|, f64
LOSS_RTOL = 1e-10


def clips(seed: int, batch: int = B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (batch, T)) \
        .astype(np.float32)


def _draw(path, shape, rng) -> np.ndarray:
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        fan_out = int(shape[-1]) * (int(np.prod(shape[:-2]))
                                    if len(shape) > 2 else 1)
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, shape)
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "mean":
        return rng.normal(0.0, 0.2, shape)
    return rng.normal(0.0, 0.05, shape)         # biases, BN offsets


def flax_weights(name: str, seed: int = 0):
    """(module, params, batch_stats) of the JAX model, numpy leaves."""
    module, _ = jax_build_model(name, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, T)), train=False))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw([k.key for k in p], s.shape, rng).astype(
            np.float32), shapes)
    return module, tree["params"], tree.get("batch_stats", {})


def port(name, params, stats, dtype=torch.float32):
    model, _ = build_model(name, num_classes=CLASSES)
    model.load_state_dict(from_flax(params, stats, model=name))
    return model.to(dtype)


def eval_logits(name, weights, seed: int = 1):
    """(port's, JAX's) eval-mode logits in float32, numpy."""
    module, params, stats = weights
    x = clips(seed)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = port(name, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, want


def _mask(i: int, shape, rate: float) -> np.ndarray:
    rng = np.random.default_rng([7, i])
    return (rng.uniform(size=shape) >= rate).astype(np.float64)


def train_mode_pair(name, weights, jit: bool = True, seed: int = 2):
    """Loss and gradients in float64 on both sides, with the same dropout
    masks: (loss, grads, jax loss, jax grads moved to the port's names,
    number of masks)."""
    module, params, stats = weights
    rng = np.random.default_rng(seed)
    x = clips(seed).astype(np.float64)
    labels = rng.integers(0, CLASSES, B)
    masks = {}

    def dropout(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args, **kwargs)
        h, rate = args[0], context.module.rate
        i = len(masks)
        masks[i] = (_mask(i, h.shape, rate), rate)
        return h * masks[i][0] / (1.0 - rate)

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     stats)

        def loss_fn(p):
            masks.clear()
            with fnn.intercept_methods(dropout):
                logits, _ = module.apply(
                    {"params": p, "batch_stats": s64}, jnp.asarray(x),
                    train=True, mutable=["batch_stats"])
            return (JO.smooth_cross_entropy(logits, jnp.asarray(labels))
                    + JO.l2_kernel_penalty(p, 1e-5))

        grad_fn = jax.value_and_grad(loss_fn)
        jloss, jgrads = (jax.jit(grad_fn) if jit else grad_fn)(p64)
        jloss, jgrads = float(jloss), jax.device_get(jgrads)

    model = port(name, params, stats, torch.float64).train()
    order = iter(range(len(masks)))

    def injected(h, generator=None):
        mask, rate = masks[next(order)]
        if h.ndim == 3:                                 # NWC -> NCW
            mask = mask.transpose(0, 2, 1)
        assert mask.shape == tuple(h.shape), (mask.shape, h.shape)
        return h * torch.from_numpy(mask) / (1.0 - rate)

    for m in model.modules():
        if isinstance(m, L.Dropout):
            m.forward = injected
    logits = model(torch.from_numpy(x))
    assert next(order, None) is None, "a JAX dropout mask went unused"
    loss = (O.smooth_cross_entropy(logits, torch.from_numpy(labels))
            + O.l2_kernel_penalty(model, 1e-5))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return (float(loss.detach()), grads, jloss,
            from_flax(jgrads, {}, model=name), len(masks))


def twin_logits(name, tmp_path):
    """(port's logits, golden logits) on the golden's input, with the TF
    twin's weights."""
    from model_twins_lib import (
        draw_weights, structure_from_json, write_keras2_h5,
    )

    from speech_recognition_tpu.export.keras_import import import_keras_hdf5
    from speech_recognition_tpu.models.keras_order import creation_order

    goldens = np.load(os.path.join(GOLDENS_DIR, "model_twin_goldens.npz"))
    structure = structure_from_json(
        bytes(goldens[f"{name}_structure"]).decode())
    h5 = tmp_path / f"{name}.h5"
    write_keras2_h5(str(h5), structure, draw_weights(structure, 20260817))
    module, _ = jax_build_model(name, num_classes=CLASSES)
    x = goldens[f"{name}_input"]
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    variables = jax.device_get(import_keras_hdf5(
        str(h5), dict(shapes), module_order=creation_order(name)))
    model = port(name, variables["params"],
                 variables.get("batch_stats", {})).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, goldens[f"{name}_logits"]


@pytest.fixture(scope="module")
def weights(name):
    return flax_weights(name)


@pytest.fixture(scope="module")
def pair(name, weights):
    return train_mode_pair(name, weights)


def test_parameter_count_equals_the_golden(name):
    model, spec = build_model(name, num_classes=CLASSES)
    assert sum(p.numel() for p in model.parameters()) == PARAM_GOLDENS[name]
    assert spec.representation == "raw"


def test_from_flax_fills_every_tensor(name, weights):
    _, params, stats = weights
    model, _ = build_model(name, num_classes=CLASSES)
    moved = from_flax(params, stats, model=name)
    assert set(moved) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert moved[k].shape == v.shape, k
    leaves = jax.tree_util.tree_leaves((params, stats))
    assert len(leaves) == len(moved)


def test_eval_logits_match_jax(name, weights):
    got, want = eval_logits(name, weights)
    assert got.shape == want.shape == (B, CLASSES)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max()


def test_train_mode_loss_matches_jax_in_float64(pair):
    loss, _, jloss, _, num_masks = pair
    assert num_masks >= 1
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)


def test_gradients_match_jax_in_float64(pair):
    """Each gradient within 1e-10 of its max |g|. A gradient that the
    model makes zero (a bias that a BatchNorm's mean takes away) is only
    roundoff on both sides: both must stay below 1e-10 of the model's
    largest |g|."""
    _, grads, _, jgrads, _ = pair
    assert set(grads) == set(jgrads)
    top = max(float(g.abs().max()) for g in jgrads.values())
    for k, want in jgrads.items():
        got, scale = grads[k], float(want.abs().max())
        if scale < GRAD_RTOL * top:
            assert float(got.abs().max()) < GRAD_RTOL * top, k
            continue
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale, k


def test_dropout_draws_from_the_generator(name):
    model, _ = build_model(name, num_classes=CLASSES)
    model.train()
    x = torch.from_numpy(clips(3))
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(5))
        b = model(x, torch.Generator().manual_seed(5))
        c = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_logits_match_the_tf_twin_golden(name, tmp_path):
    got, want = twin_logits(name, tmp_path)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TWIN_ATOL[name], rtol=1e-3)
