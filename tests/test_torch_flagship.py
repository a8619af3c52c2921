"""Port's flagship model (conv_1d_time_sliced_with_attention) vs flax.

Weights go from the flax init to the port through ``from_flax``; every
comparison runs in float32 on the CPU. Logit tolerance 2e-4 is the bound
tests/test_model_twins.py uses for this model against its TF twin.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.models import layers as JL
from speech_recognition_tpu.ops.framing import (
    overlapping_frames as jax_overlapping_frames,
)
from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.ops.framing import (
    overlapping_frames, same_pad_amount,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

NAME = "conv_1d_time_sliced_with_attention"


@pytest.fixture(scope="module")
def flax_flagship():
    """Flax module + variables with non-trivial BN running statistics."""
    module, _ = jax_build_model(NAME, num_classes=12)
    v = jax.device_get(module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 16000)), train=False))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.5, 1.5, a.shape)
                   + rng.normal(0, 0.05, a.shape)).astype(np.float32),
        v["batch_stats"])
    # BN scale/bias (and the Dense(9) bias) off their constant init, so
    # every tensor is distinct
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), v["params"])
    return module, params, stats


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_param_count_golden():
    model, _ = build_model(NAME, num_classes=12)
    assert sum(p.numel() for p in model.parameters()) == 1_191_433


def test_other_models_name_the_roadmap_item():
    """Every zoo name is ported now (ROADMAP A8 is done): a name outside
    the registry raises as the JAX ``build_model`` does."""
    build_model("conv_2d")
    with pytest.raises(ValueError, match="Invalid model: conv_3d"):
        build_model("conv_3d")


def test_init_is_seeded_and_glorot_uniform():
    a, _ = build_model(NAME, generator=torch.Generator().manual_seed(3))
    b, _ = build_model(NAME, generator=torch.Generator().manual_seed(3))
    c, _ = build_model(NAME, generator=torch.Generator().manual_seed(4))
    for (k, pa), pb, pc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(pa, pb), k
    w = a.blocks[3].pointwise.weight   # [256, 192, 1]
    limit = np.sqrt(6.0 / (192 + 256))
    assert w.abs().max() <= limit and w.abs().max() > 0.95 * limit
    assert not torch.equal(w, c.blocks[3].pointwise.weight)
    assert (a.attention.bias == 0).all() and a.head.bias is None


def test_from_flax_round_trips_every_tensor(flax_flagship):
    """Every flax leaf lands in exactly one port tensor, which holds the
    same numbers in the torch layout, and every port tensor is set."""
    _, params, stats = flax_flagship
    model, _ = build_model(NAME, num_classes=12)
    model.load_state_dict(from_flax(params, stats), strict=True)
    sd = model.state_dict()
    leaves = list(_leaves(params)) + list(_leaves(stats))
    assert len(leaves) == len(sd)
    for path, value in leaves:
        hits = [k for k, t in sd.items()
                if _back_to_flax(t, path[-1]).shape == value.shape
                and np.array_equal(_back_to_flax(t, path[-1]), value)]
        assert len(hits) == 1, (path, hits)


def _back_to_flax(t, leaf):
    a = t.numpy()
    if leaf == "kernel" and a.ndim == 3:
        return a.transpose(2, 1, 0)
    if leaf == "kernel" and a.ndim == 2:
        return a.T
    return a


def test_eval_logits_match_flax(flax_flagship):
    module, params, stats = flax_flagship
    model, _ = build_model(NAME, num_classes=12)
    model.load_state_dict(from_flax(params, stats))
    model.eval()
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (4, 16000)).astype(
        np.float32)
    want = np.asarray(module.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 12)
    assert np.abs(want).max() > 1e-2       # not a vacuous comparison
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("length,ksize,stride", [
    (16000, 40, 20), (397, 3, 2), (398, 3, 2), (11, 3, 2), (24, 3, 2)])
def test_same_padding_is_tf_asymmetric(length, ksize, stride):
    out = -(-length // stride)
    left, right = same_pad_amount(length, ksize, stride)
    assert left + right == max((out - 1) * stride + ksize - length, 0)
    assert left == (left + right) // 2          # smaller half on the left


def test_overlapping_frames_match_jax():
    x = np.random.default_rng(2).normal(size=(3, 16000)).astype(np.float32)
    got = overlapping_frames(torch.from_numpy(x), 40, 20, "SAME")
    assert got.shape == (3, 800, 40)
    want = np.asarray(jax_overlapping_frames(jnp.asarray(x), 40, 20, "SAME"))
    np.testing.assert_array_equal(got.numpy(), want)
    valid = overlapping_frames(torch.from_numpy(x), 40, 20, "VALID")
    np.testing.assert_array_equal(
        valid.numpy(),
        np.asarray(jax_overlapping_frames(jnp.asarray(x), 40, 20, "VALID")))


@pytest.mark.parametrize("length", [397, 398])
def test_stride2_same_depthwise_block_matches_flax(length):
    """Train-mode block at the flagship's stride-2 SAME shape: outputs,
    the BN running statistics (biased variance, momentum 0.99) and the
    gradients of both kernels."""
    rng = np.random.default_rng(length)
    c, f = 16, 24
    x = rng.normal(size=(4, length, c)).astype(np.float32)
    jb = JL.DepthwiseConvBlock(f, 3, padding="same", strides=2)
    v = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    w = rng.normal(size=(4, -(-length // 2), f)).astype(np.float32)

    def loss(p):
        y, upd = jb.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (y * w).sum(), upd["batch_stats"]

    (_, new_stats), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
    block = L.DepthwiseConvBlock(c, f, 3, padding="same", stride=2)
    sd = {"depthwise.weight": v["params"]["Conv_0"]["kernel"],
          "pointwise.weight": v["params"]["Conv_1"]["kernel"],
          "bn.weight": v["params"]["BatchNorm_0"]["scale"],
          "bn.bias": v["params"]["BatchNorm_0"]["bias"],
          "bn.running_mean": v["batch_stats"]["BatchNorm_0"]["mean"],
          "bn.running_var": v["batch_stats"]["BatchNorm_0"]["var"]}
    block.load_state_dict({  # flax (k, in/g, out) -> torch (out, in/g, k)
        k: torch.from_numpy(np.array(a.transpose(2, 1, 0) if a.ndim == 3
                                     else a)) for k, a in sd.items()})
    block.train()
    y = block(torch.from_numpy(x).transpose(1, 2))
    (y * torch.from_numpy(w).transpose(1, 2)).sum().backward()
    bs = jax.device_get(new_stats)["BatchNorm_0"]
    np.testing.assert_allclose(block.bn.running_mean.numpy(), bs["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(block.bn.running_var.numpy(), bs["var"],
                               rtol=1e-5, atol=1e-6)
    g = jax.device_get(g)
    for name, jname in (("depthwise", "Conv_0"), ("pointwise", "Conv_1")):
        np.testing.assert_allclose(
            getattr(block, name).weight.grad.numpy(),
            np.asarray(g[jname]["kernel"]).transpose(2, 1, 0),
            rtol=1e-4, atol=1e-4)


def test_attention_flatten_order_is_time_major(flax_flagship):
    """Dense(9) reads NWC [B, 9, C] flattened time-major/channel-minor;
    the port holds NCW [B, C, 9] and must not flatten it as it lies."""
    module, params, stats = flax_flagship
    model, _ = build_model(NAME, num_classes=12)
    model.load_state_dict(from_flax(params, stats))
    model.eval()
    rng = np.random.default_rng(3)
    x_nwc = rng.normal(size=(2, 9, 512)).astype(np.float32)
    kernel = np.asarray(params["Dense_0"]["kernel"])      # [4608, 9]
    bias = np.asarray(params["Dense_0"]["bias"])
    want = np.asarray(jax.nn.softmax(
        x_nwc.reshape(2, -1) @ kernel + bias, axis=-1))
    with torch.no_grad():
        got = model.attention_weights(
            torch.from_numpy(x_nwc).transpose(1, 2))
    assert got.shape == (2, 1, 9)
    # 4608-term f32 dot products summed in another order: ~1e-6 apart
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=0, atol=1e-5)
    wrong = np.asarray(jax.nn.softmax(
        x_nwc.transpose(0, 2, 1).reshape(2, -1) @ kernel + bias, axis=-1))
    assert np.abs(wrong - want).max() > 1e-3   # the test can tell them apart


def test_train_mode_dropout_needs_a_generator():
    model, _ = build_model(NAME, num_classes=12)
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(2, 16000))
    drop = L.Dropout(0.4).train()
    x = torch.ones(4096)
    y = drop(x, torch.Generator().manual_seed(0))
    assert 0.55 < (y > 0).float().mean() < 0.65
    np.testing.assert_allclose(y[y > 0].numpy(), 1 / 0.6, rtol=1e-6)


def test_flax_dropout_positions_match_port_structure(flax_flagship):
    """The port drops at the two places flax does (before Dense(9) and
    before the head), at rate 0.4."""
    module, params, stats = flax_flagship
    rates = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            rates.append(context.module.rate)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(spy):
        module.apply({"params": params, "batch_stats": stats},
                     jnp.zeros((1, 16000)), train=False)
    model, _ = build_model(NAME, num_classes=12)
    port = [m.p for m in model.modules() if isinstance(m, L.Dropout)]
    assert rates == port == [0.4, 0.4]
