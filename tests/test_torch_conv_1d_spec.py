"""``conv_1d_spec`` (grouped conv ladder on the linear spectrogram) against
the JAX package's, with the weights moved from flax by ``from_flax``.

* eval logits in float32: max abs err <= 1e-4 of max |logit|;
* the train-mode loss (cross-entropy + the L2 penalty) and every
  gradient in float64, on the same inputs and injected dropout masks
  (flax's Dropout intercepted, the port's replaced): <= 1e-10 of the
  gradient's max |value|, the loss to 1e-10 relative (measured ~1e-13;
  unlike the flagship's, ROADMAP C1, this model's jitted JAX gradient
  agrees with its eager one, so the JAX side is jitted);
* the TF-twin golden (tests/goldens/model_twin_goldens.npz): the golden's
  weights imported into the JAX model as tests/test_model_twins.py does,
  moved with ``from_flax``, logits within that test's bound.
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
from speech_recognition_tpu.models.zoo import _truncate_to_groups
from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.train import optim as O

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "goldens"))

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

NAME = "conv_1d_spec"
B, TIME, FREQ, P_DROP = 4, 98, 257, 0.3
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "model_twin_goldens.npz")


def _spectrogram_like(rng, batch=B):
    return np.abs(rng.normal(0.0, 2.0, (batch, TIME * FREQ))).astype(
        np.float32)


@pytest.fixture(scope="module")
def flax_weights():
    """The JAX model's initial weights with BN statistics drawn away from
    (0, 1), so eval mode exercises them."""
    module, _ = jax_build_model(NAME, num_classes=12)
    v = jax.device_get(jax.jit(lambda key: module.init(
        {"params": key}, jnp.zeros((2, TIME * FREQ)), train=False))(
            jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(lambda a: a, v["batch_stats"])
    for layer in stats.values():
        layer["BatchNorm_0"]["mean"] = rng.normal(
            0, 0.5, layer["BatchNorm_0"]["mean"].shape).astype(np.float32)
        layer["BatchNorm_0"]["var"] = rng.uniform(
            0.5, 2.0, layer["BatchNorm_0"]["var"].shape).astype(np.float32)
    return module, v["params"], stats


def _port(params, stats, dtype=torch.float32):
    model, _ = build_model(NAME, num_classes=12)
    model.load_state_dict(from_flax(params, stats, model=NAME))
    return model.to(dtype)


def test_parameters_match_jax_one_for_one(flax_weights):
    _, params, stats = flax_weights
    model, _ = build_model(NAME, num_classes=12)
    moved = from_flax(params, stats, model=NAME)
    assert set(moved) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert moved[k].shape == v.shape, k
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(params))


def test_eval_logits_match_jax(flax_weights):
    module, params, stats = flax_weights
    x = _spectrogram_like(np.random.default_rng(0))
    want = np.asarray(module.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    model = _port(params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 12)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def train_mode_pair(flax_weights):
    """Loss and gradients in float64 on both sides, one train-mode step's
    worth, with an injected dropout mask."""
    module, params, stats = flax_weights
    rng = np.random.default_rng(1)
    x = _spectrogram_like(rng).astype(np.float64)
    labels = rng.integers(0, 12, B)
    mask = (rng.uniform(size=(B, 480)) >= P_DROP).astype(np.float64)

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return args[0] * mask / (1.0 - P_DROP)
        return next_fun(*args, **kwargs)

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     stats)

        def loss_fn(p):
            with fnn.intercept_methods(dropout):
                logits, _ = module.apply(
                    {"params": p, "batch_stats": s64}, jnp.asarray(x),
                    train=True, mutable=["batch_stats"])
            return (JO.smooth_cross_entropy(logits, jnp.asarray(labels))
                    + JO.l2_kernel_penalty(p, 1e-5))

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p64)
        jloss, jgrads = float(jloss), jax.device_get(jgrads)

    model = _port(params, stats, torch.float64).train()
    mask_t = torch.from_numpy(mask)
    model.dropout.forward = lambda h, generator=None: h * mask_t / (1 - P_DROP)
    logits = model(torch.from_numpy(x))
    loss = (O.smooth_cross_entropy(logits, torch.from_numpy(labels))
            + O.l2_kernel_penalty(model, 1e-5))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return float(loss.detach()), grads, jloss, from_flax(jgrads, {},
                                                         model=NAME)


def test_train_mode_loss_matches_jax_in_float64(train_mode_pair):
    loss, _, jloss, _ = train_mode_pair
    assert abs(loss - jloss) <= 1e-10 * abs(jloss)


@pytest.mark.parametrize("layer", [f"blocks.{i}" for i in range(8)]
                         + ["head"])
def test_gradients_match_jax_in_float64(train_mode_pair, layer):
    _, grads, _, jgrads = train_mode_pair
    names = [k for k in jgrads if k.startswith(layer + ".")]
    assert len(names) == (3 if layer != "head" else 2)
    for k in names:
        g, want = grads[k].numpy(), jgrads[k].numpy()
        assert np.abs(g - want).max() <= 1e-10 * np.abs(want).max(), k


@pytest.mark.parametrize("groups,cin,cout", [(3, 12, 9), (4, 8, 12),
                                             (4, 252, 300), (3, 300, 300)])
def test_grouped_conv_kernel_moves_with_its_groups(groups, cin, cout):
    """flax's [k, Cin/g, Cout] kernel and the port's [Cout, Cin/g, k] give
    group j the same output channels."""
    rng = np.random.default_rng(groups + cin)
    kernel = rng.normal(size=(3, cin // groups, cout)).astype(np.float32)
    x = rng.normal(size=(2, 11, cin)).astype(np.float32)       # NWC
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (1,), "VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=groups))
    conv = L.Conv(cin, cout, 3, groups=groups)
    moved = from_flax({"ConvBN_0": {"Conv_0": {"kernel": kernel}}}, {},
                      model=NAME)
    conv.weight.data = moved["blocks.0.conv.weight"]
    got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4)


def test_truncate_to_groups_matches_jax():
    x = np.arange(2 * 5 * 10, dtype=np.float32).reshape(2, 5, 10)   # NWC
    for groups in (1, 3, 4, 10):
        want = np.asarray(_truncate_to_groups(jnp.asarray(x), groups))
        got = L.truncate_to_groups(torch.from_numpy(x).transpose(1, 2),
                                   groups).transpose(1, 2).numpy()
        np.testing.assert_array_equal(got, want)
    assert L.truncate_to_groups(torch.zeros(1, 10, 3), 4).shape[1] == 8
    with pytest.raises(ValueError, match="groups"):
        L.ConvBN(10, 12, 3, groups=4)


def test_logits_match_the_tf_twin_golden(tmp_path):
    from model_twins_lib import (
        draw_weights, structure_from_json, write_keras2_h5,
    )

    from speech_recognition_tpu.export.keras_import import import_keras_hdf5
    from speech_recognition_tpu.models.keras_order import creation_order

    goldens = np.load(GOLDENS)
    structure = structure_from_json(
        bytes(goldens[f"{NAME}_structure"]).decode())
    h5 = tmp_path / f"{NAME}.h5"
    write_keras2_h5(str(h5), structure, draw_weights(structure, 20260817))
    module, _ = jax_build_model(NAME, num_classes=12)
    x = goldens[f"{NAME}_input"]
    variables = module.init({"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x), train=False)
    variables = jax.device_get(import_keras_hdf5(
        str(h5), dict(variables), module_order=creation_order(NAME)))
    model = _port(variables["params"], variables["batch_stats"]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = goldens[f"{NAME}_logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
