"""The layers the eleven raw-waveform zoo models add to the port, against
the JAX package's: ``max_pool_1d`` (forward, and the gradient at tied
maxima, which a chain of ``maximum`` splits), ``avg_pool_1d`` (TF's edge
division), ``Conv`` with dilation and bias under TF SAME padding,
``ConvBN`` with dilation, ``GroupedDepthwiseBlock``, and the generic
flax-name mapping of ``from_flax``. Forward in float32 on the CPU (exact
for the pools, 1e-5 for products), gradients in float64 (1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_recognition_tpu.models import layers as JL
from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.models.convert import from_flax

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _ncw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _nwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 1)


POOLS = [(3, 2, "valid"), (3, 2, "same"), (3, 1, "same"), (2, 2, "same"),
         (4, 3, "same"), (5, 2, "valid")]


@pytest.mark.parametrize("length", [7, 8, 9, 10, 11, 30])
@pytest.mark.parametrize("pool,stride,padding", POOLS)
def test_max_pool_1d_matches_jax(length, pool, stride, padding):
    x = np.random.default_rng(length).normal(size=(2, length, 5)).astype(
        np.float32)
    want = np.asarray(JL.max_pool_1d(jnp.asarray(x), pool, stride, padding))
    got = _nwc(L.max_pool_1d(_ncw(x), pool, stride, padding))
    np.testing.assert_array_equal(got, want)


def _tied(length: int) -> np.ndarray:
    """relu6 outputs: runs of 0 and of 6 (clamped), a few other values."""
    rng = np.random.default_rng(length)
    x = rng.choice([0.0, 6.0, 0.0, 6.0, 1.5, 3.0], size=(2, length, 3))
    return x.astype(np.float64)


@pytest.mark.parametrize("length", [9, 10, 13])
@pytest.mark.parametrize("pool,stride,padding", POOLS)
def test_max_pool_1d_gradient_splits_ties_as_jax(length, pool, stride,
                                                 padding):
    x = _tied(length)
    with jax.enable_x64(True):
        y = JL.max_pool_1d(jnp.asarray(x), pool, stride, padding)
        w = np.random.default_rng(1).normal(size=y.shape)
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            JL.max_pool_1d(v, pool, stride, padding) * w))(jnp.asarray(x)))
    xt = _ncw(x).requires_grad_()
    (L.max_pool_1d(xt, pool, stride, padding)
     * torch.from_numpy(w.transpose(0, 2, 1).copy())).sum().backward()
    np.testing.assert_allclose(_nwc(xt.grad), want, rtol=0, atol=1e-12)


def test_first_winner_pooling_would_not_split_ties():
    """The case above is one ``F.max_pool1d`` gets wrong: it gives a tied
    window's cotangent to its first maximum."""
    x = torch.tensor([[[6.0, 6.0, 1.0, 6.0, 6.0]]], dtype=torch.float64,
                     requires_grad=True)
    L.max_pool_1d(x, 3, 2, "valid").sum().backward()
    split = x.grad.clone()
    x.grad = None
    F.max_pool1d(x, 3, 2).sum().backward()
    assert split.tolist() == [[[0.5, 0.5, 0.0, 0.5, 0.5]]]
    assert not torch.equal(split, x.grad)


@pytest.mark.parametrize("length,padding", [
    (n, p) for p in ("same", "valid") for n in (1, 2, 3, 8, 9, 47)
    if p == "same" or n >= 3])
def test_avg_pool_1d_matches_jax(length, padding):
    x = np.random.default_rng(length).normal(size=(2, length, 4))
    with jax.enable_x64(True):
        want = np.asarray(JL.avg_pool_1d(jnp.asarray(x), 3, 1, padding))
        w = np.random.default_rng(2).normal(size=want.shape)
        gwant = np.asarray(jax.grad(lambda v: jnp.sum(
            JL.avg_pool_1d(v, 3, 1, padding) * w))(jnp.asarray(x)))
    xt = _ncw(x).requires_grad_()
    y = L.avg_pool_1d(xt, 3, 1, padding)
    np.testing.assert_allclose(_nwc(y), want, rtol=0, atol=1e-12)
    (y * torch.from_numpy(w.transpose(0, 2, 1).copy())).sum().backward()
    np.testing.assert_allclose(_nwc(xt.grad), gwant, rtol=0, atol=1e-12)
    if padding == "same" and length > 1:     # TF's edge division by 2
        np.testing.assert_allclose(want[:, 0], x[:, :2].mean(1), atol=1e-12)


def test_avg_pool_1d_refuses_an_asymmetric_same_pad():
    with pytest.raises(ValueError, match="asymmetrically"):
        L.avg_pool_1d(torch.zeros(1, 2, 8), 2, 1, "same")


CONVS = [  # (kernel, stride, dilation, padding, groups, bias)
    (3, 1, 2, "same", 1, False), (3, 2, 2, "same", 1, True),
    (5, 3, 2, "same", 1, True), (3, 1, 2, "valid", 1, False),
    (4, 2, 3, "same", 2, True), (479, 160, 1, "valid", 1, True),
    (161, 160, 1, "same", 1, False), (8, 1, 1, "valid", 1, True),
]


@pytest.mark.parametrize("length,kernel,stride,dilation,padding,groups,bias",
                         [(n, *c) for c in CONVS for n in (37, 40, 1000)
                          if c[3] == "same" or (c[0] - 1) * c[2] < n])
def test_conv_with_dilation_and_bias_matches_flax(length, kernel, stride,
                                                  dilation, padding, groups,
                                                  bias):
    cin, cout = 4, 6
    rng = np.random.default_rng(kernel + length)
    x = rng.normal(size=(2, length, cin)).astype(np.float32)
    conv = JL.Conv(cout, (kernel,), strides=(stride,),
                   padding=padding.upper(), kernel_dilation=(dilation,),
                   feature_group_count=groups, use_bias=bias)
    params = jax.device_get(conv.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))["params"]
    if bias:
        params["bias"] = rng.normal(size=cout).astype(np.float32)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = L.Conv(cin, cout, kernel, stride, padding, groups, dilation,
                  use_bias=bias)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in from_flax(
        {"Conv_0": params}, {}, model="any").items()})
    got = _nwc(port(_ncw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _block_pair(jax_block, port_block, x, train):
    """JAX and port block outputs (NWC) on the same weights; BN running
    statistics drawn off (0, 1)."""
    v = jax.device_get(jax_block.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    top = type(port_block).__name__ + "_0"
    moved = from_flax({top: v["params"]}, {top: stats}, model="any")
    port_block.load_state_dict({k[len(top) + 1:]: t
                                for k, t in moved.items()})
    want = jax_block.apply({"params": v["params"], "batch_stats": stats},
                           jnp.asarray(x), train=train,
                           mutable=["batch_stats"] if train else False)
    want = np.asarray(want[0] if train else want)
    got = _nwc(port_block.train(train)(_ncw(x)))
    return got, want


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cin,features,groups,stride,padding",
                         [(12, 9, 3, 2, "valid"), (8, 8, 2, 1, "valid"),
                          (12, 8, 4, 2, "same"), (6, 6, 3, 1, "same")])
def test_grouped_depthwise_block_matches_jax(train, cin, features, groups,
                                             stride, padding):
    x = np.random.default_rng(cin).normal(size=(3, 21, cin)).astype(
        np.float32)
    got, want = _block_pair(
        JL.GroupedDepthwiseBlock(features, 3, groups, padding=padding,
                                 strides=stride),
        L.GroupedDepthwiseBlock(cin, features, 3, groups, padding, stride),
        x, train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dilation,padding", [(2, "same"), (2, "valid"),
                                              (3, "same")])
def test_conv_bn_with_dilation_matches_jax(train, dilation, padding):
    x = np.random.default_rng(dilation).normal(size=(2, 19, 5)).astype(
        np.float32)
    got, want = _block_pair(
        JL.ConvBN(7, (3,), padding=padding, dilation=(dilation,)),
        L.ConvBN(5, 7, 3, padding=padding, dilation=dilation), x, train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_flax_names_map_to_the_port_by_block_class():
    k3 = np.zeros((3, 1, 4), np.float32)
    moved = from_flax(
        {"ConvBN_7": {"Conv_0": {"kernel": k3},
                      "BatchNorm_0": {"scale": np.ones(4, np.float32)}},
         "GroupedDepthwiseBlock_2": {"Conv_1": {"kernel": k3}},
         "DepthwiseConvBlock_0": {"Conv_0": {"kernel": k3}},
         "Conv_1": {"kernel": k3, "bias": np.zeros(4, np.float32)},
         "Dense_0": {"kernel": np.zeros((5, 3), np.float32)}},
        {"ConvBN_7": {"BatchNorm_0": {"mean": np.zeros(4, np.float32)}}},
        model="inception")
    assert sorted(moved) == sorted([
        "ConvBN_7.conv.weight", "ConvBN_7.bn.weight",
        "GroupedDepthwiseBlock_2.pointwise.weight",
        "DepthwiseConvBlock_0.depthwise.weight", "Conv_1.weight",
        "Conv_1.bias", "Dense_0.weight", "ConvBN_7.bn.running_mean"])
    assert moved["Dense_0.weight"].shape == (3, 5)
    assert moved["Conv_1.weight"].shape == (4, 1, 3)
    for bad in ({"ConvBN_0": {"Conv_1": {"kernel": k3}}},
                {"Residual1D_0": {"Conv_0": {"kernel": k3}}},
                {"Conv_0": {"Conv_0": {"kernel": k3}}}):
        with pytest.raises(KeyError, match="no inception counterpart"):
            from_flax(bad, {}, model="inception")


def test_the_flagship_keeps_its_names_and_checkpoints():
    """The two models ported before keep their own tables."""
    moved = from_flax({"ConvBN_0": {"Conv_0": {"kernel": np.zeros(
        (3, 40, 128), np.float32)}}}, {})
    assert list(moved) == ["stem.conv.weight"]
    moved = from_flax({"Dense_0": {"kernel": np.zeros((4, 2), np.float32)}},
                      {}, model="conv_1d_spec")
    assert list(moved) == ["head.weight"]

