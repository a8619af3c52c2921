"""Shared parity harness for the port's zoo models against the JAX ones
(``tests/test_torch_zoo_*.py``).

The flax variables are not initialised by JAX: their tree comes from
``jax.eval_shape`` of ``module.init`` and every leaf is drawn with numpy
from a seed (glorot-uniform kernels, the GRU's recurrent ones too;
biases, BN scales and offsets and BN running statistics off their
constant init), so each tensor is distinct and no large JAX program is
compiled for the init. The same numbers go to the port through
``from_flax``.

Both sides are built with the geometry the parameter goldens were
counted at (tests/test_zoo_param_goldens.py: 98 frames, 60 mel features
but 40 for ``simple``, ``snn`` and ``conv_2d*``, 257 bins, 480/160
framing) and fed the input of the model's representation: clips
[B, 16000], flat spectrograms or MFCCs, or the (mfcc, raw) tuple.

* ``eval_logits``: both sides in float32, eval mode.
* ``train_mode_pair``: the train-mode loss (smoothed cross-entropy + the
  L2 penalty on kernels) and its gradients in float64, every random mask
  injected on both sides in call order: each ``jax.random.bernoulli``
  call of the JAX model (flax's Dropout, ``AlphaDropout``, the GRU's
  variational masks) hands out a keep-mask drawn with numpy, and the
  port's ``layers.keep_mask`` hands out the same masks in the same order
  (an activation's mask moved from channels-last to the port's
  channels-first layout; the GRU's (3, B, 1, C) and (3, B, U) masks as
  they are).
* ``twin_logits``: the TF-twin golden's weights, imported into the flax
  tree as tests/test_model_twins.py does, moved with ``from_flax``.

Each ``tests/test_torch_zoo_*.py`` imports the fixtures and tests below
and defines a module-scoped ``name`` fixture over its models; the files
are several so that pytest-xdist's workers spread the JAX compiles.
"""

import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import (
    MODEL_REGISTRY as JAX_REGISTRY, build_model as jax_build_model,
)
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.train import optim as O
# the JAX package's parameter-count goldens and TF-twin logit bounds
from test_model_twins import CASES as TWIN_ATOL, SETTINGS as TWIN_SETTINGS
from test_zoo_param_goldens import (
    GOLDEN_PARAM_COUNTS as PARAM_GOLDENS, SETTINGS as GOLDEN_SETTINGS,
)

GOLDENS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "goldens")
sys.path.insert(0, GOLDENS_DIR)

B, T, CLASSES = 2, 16000, 12
LOGITS_RTOL = 1e-4      # of max |logit|, f32
GRAD_RTOL = 1e-10       # of max |g|, f64
LOSS_RTOL = 1e-10


MEL_40 = ("simple", "snn", "conv_2d", "conv_2d_mobile", "conv_2d_fast")


def settings(name: str) -> dict:
    """The geometry the parameter golden of ``name`` was counted at."""
    s = dict(GOLDEN_SETTINGS)
    if name in MEL_40:
        s["num_log_mel_features"] = 40
    return s


def clips(seed: int, batch: int = B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (batch, T)) \
        .astype(np.float32)


def inputs(name: str, seed: int, batch: int = B):
    """The model's input in its representation, numpy float32: clips,
    flat spectrogram magnitudes or MFCCs, or the (mfcc, raw) tuple."""
    rep = JAX_REGISTRY[name].representation
    s = settings(name)
    rng = np.random.default_rng([seed, 1])
    frames = s["spectrogram_length"]
    mfcc = rng.normal(0.0, 5.0, (batch, frames * s["num_log_mel_features"]))
    if rep == "raw":
        return clips(seed, batch)
    if rep == "spec":
        return rng.uniform(0.0, 2.0, (batch, frames * 257)).astype(
            np.float32)
    if rep == "mfcc":
        return mfcc.astype(np.float32)
    return mfcc.astype(np.float32), clips(seed, batch)


def _map(f, x):
    return tuple(map(f, x)) if isinstance(x, tuple) else f(x)


def to_jax(x, dtype=jnp.float32):
    return _map(lambda a: jnp.asarray(a, dtype), x)


def to_torch(x, dtype=torch.float32):
    return _map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype), x)


def _draw(path, shape, rng) -> np.ndarray:
    leaf = path[-1]
    if "kernel" in leaf:
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
    module, _ = jax_build_model(name, num_classes=CLASSES, **settings(name))
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, to_jax(inputs(name, 0)),
        train=False))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw([k.key for k in p], s.shape, rng).astype(
            np.float32), shapes)
    return module, tree["params"], tree.get("batch_stats", {})


def port(name, params, stats, dtype=torch.float32, geometry=None):
    model, _ = build_model(name, num_classes=CLASSES,
                           **(settings(name) if geometry is None
                              else geometry))
    model.load_state_dict(from_flax(params, stats, model=name))
    return model.to(dtype)


def eval_logits(name, weights, seed: int = 1):
    """(port's, JAX's) eval-mode logits in float32, numpy."""
    module, params, stats = weights
    x = inputs(name, seed)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, to_jax(x)))
    model = port(name, params, stats).eval()
    with torch.no_grad():
        got = model(to_torch(x)).numpy()
    return got, want


def _mask(i: int, shape, rate: float) -> np.ndarray:
    """The i-th keep-mask: True with probability 1 - rate."""
    rng = np.random.default_rng([7, i])
    return rng.uniform(size=shape) >= rate


class Masks:
    """The same keep-masks for both sides, in call order. Inside
    ``jax()``, each ``jax.random.bernoulli`` draws the next numpy mask
    and records it; inside ``port()``, each ``layers.keep_mask`` hands
    out the recorded masks in turn (an activation's moved from
    channels-last to channels-first, the GRU's as it is)."""

    def __init__(self):
        self.masks = []
        self.used = 0

    def _bernoulli(self, key, p=0.5, shape=None):
        i = len(self.masks)
        self.masks.append((_mask(i, shape, 1.0 - p), 1.0 - p))
        return jnp.asarray(self.masks[i][0])

    def jax(self):
        self.masks.clear()
        return mock.patch.object(jax.random, "bernoulli", self._bernoulli)

    def _keep_mask(self, shape, rate, generator, device, mesh=None,
                   batch_axis=0):
        mask, jax_rate = self.masks[self.used]
        self.used += 1
        if batch_axis == 0 and mask.ndim >= 3:     # channels-last -> first
            mask = np.moveaxis(mask, -1, 1)
        assert mask.shape == tuple(shape), (mask.shape, shape)
        assert abs(rate - jax_rate) < 1e-12, (rate, jax_rate)
        return torch.from_numpy(np.ascontiguousarray(mask))

    def port(self):
        self.used = 0
        return mock.patch.object(L, "keep_mask", self._keep_mask)


def train_mode_pair(name, weights, jit: bool = True, seed: int = 2):
    """Loss and gradients in float64 on both sides, with the same random
    masks: (loss, grads, jax loss, jax grads moved to the port's names,
    number of masks)."""
    module, params, stats = weights
    rng = np.random.default_rng(seed)
    x = inputs(name, seed)
    labels = rng.integers(0, CLASSES, B)
    masks = Masks()

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     stats)

        def loss_fn(p):
            with masks.jax():
                logits, _ = module.apply(
                    {"params": p, "batch_stats": s64},
                    to_jax(x, jnp.float64), train=True,
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    mutable=["batch_stats"])
            return (JO.smooth_cross_entropy(logits, jnp.asarray(labels))
                    + JO.l2_kernel_penalty(p, 1e-5))

        grad_fn = jax.value_and_grad(loss_fn)
        jloss, jgrads = (jax.jit(grad_fn) if jit else grad_fn)(p64)
        jloss, jgrads = float(jloss), jax.device_get(jgrads)

    model = port(name, params, stats, torch.float64).train()
    with masks.port():
        logits = model(to_torch(x, torch.float64), torch.Generator())
    assert masks.used == len(masks.masks), "a JAX mask went unused"
    loss = (O.smooth_cross_entropy(logits, torch.from_numpy(labels))
            + O.l2_kernel_penalty(model, 1e-5))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return (float(loss.detach()), grads, jloss,
            from_flax(jgrads, {}, model=name), len(masks.masks))


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
    geometry = TWIN_SETTINGS.get(name, {})
    module, _ = jax_build_model(name, num_classes=CLASSES, **geometry)
    if f"{name}_input_raw" in goldens:
        x = (goldens[f"{name}_input_mfcc"], goldens[f"{name}_input_raw"])
    else:
        x = goldens[f"{name}_input"]
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, to_jax(x), train=False))
    variables = jax.device_get(import_keras_hdf5(
        str(h5), dict(shapes), module_order=creation_order(name)))
    model = port(name, variables["params"], variables.get("batch_stats", {}),
                 geometry=geometry).eval()
    with torch.no_grad():
        got = model(to_torch(x)).numpy()
    return got, goldens[f"{name}_logits"]


@pytest.fixture(scope="module")
def weights(name):
    return flax_weights(name)


@pytest.fixture(scope="module")
def pair(name, weights):
    return train_mode_pair(name, weights)


def test_parameter_count_equals_the_golden(name):
    """The golden's count at its geometry, and the JAX recipe."""
    model, spec = build_model(name, num_classes=CLASSES, **settings(name))
    assert sum(p.numel() for p in model.parameters()) == PARAM_GOLDENS[name]
    want = JAX_REGISTRY[name]
    for field in ("representation", "optimizer", "learning_rate",
                  "momentum", "label_smoothing", "l2_reg"):
        assert getattr(spec, field) == getattr(want, field), field


def test_from_flax_fills_every_tensor(name, weights):
    _, params, stats = weights
    model, _ = build_model(name, num_classes=CLASSES, **settings(name))
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


def has_random_layers(name: str) -> bool:
    model, _ = build_model(name, num_classes=CLASSES, **settings(name))
    return any(isinstance(m, L.RANDOM_LAYERS) for m in model.modules())


def test_train_mode_loss_matches_jax_in_float64(name, pair):
    """Every mask the JAX model drew was injected (none for a model with
    no random layer)."""
    loss, _, jloss, _, num_masks = pair
    assert (num_masks >= 1) == has_random_layers(name)
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
    """Train-mode masks come from the caller's generator alone; a model
    with no random layer (``simple``, ``conv_2d``) gives the same logits
    whatever the generator."""
    model, _ = build_model(name, num_classes=CLASSES, **settings(name))
    model.train()
    random = has_random_layers(name)
    x = to_torch(inputs(name, 3))
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(5))
        b = model(x, torch.Generator().manual_seed(5))
        c = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and torch.equal(a, c) != random


def test_logits_match_the_tf_twin_golden(name, tmp_path):
    got, want = twin_logits(name, tmp_path)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TWIN_ATOL[name], rtol=1e-3)


def errors(name: str, jit: bool = True) -> str:
    """One line of the measured errors of ``name`` against the JAX model:
    f32 eval logits over max |logit|, the f64 loss's relative error, and
    the worst f64 gradient's error over its own max |g| (tensors above
    1e-10 of the model's largest)."""
    w = flax_weights(name)
    got, want = eval_logits(name, w)
    top_logit = float(np.abs(want).max())
    loss, grads, jloss, jgrads, num_masks = train_mode_pair(name, w, jit)
    top = max(float(g.abs().max()) for g in jgrads.values())
    worst = max(float((grads[k] - g).abs().max()) / float(g.abs().max())
                for k, g in jgrads.items()
                if float(g.abs().max()) >= GRAD_RTOL * top)
    logit_err = np.abs(got - want).max() / top_logit
    loss_err = abs(loss - jloss) / abs(jloss)
    return (f"{name}: logits {logit_err:.3g} of max |logit| "
            f"{top_logit:.3g}; loss {loss_err:.3g} relative; worst gradient "
            f"{worst:.3g} of its max |g| ({'jitted' if jit else 'eager'} "
            f"JAX); {num_masks} masks")


if __name__ == "__main__":
    # python tests/torch_zoo_parity.py [--eager] name ... : the errors
    # the parity tests bound, printed per model
    eager = "--eager" in sys.argv[1:]
    for arg in sys.argv[1:]:
        if arg != "--eager":
            print(errors(arg, jit=not eager), flush=True)
