"""The layers the zoo models add to the port, against the JAX package's:
``max_pool_1d`` (forward, and the gradient at tied maxima, which a chain
of ``maximum`` splits), ``avg_pool_1d`` (TF's edge division), ``Conv``
with dilation and bias under TF SAME padding, ``ConvBN`` with dilation,
``GroupedDepthwiseBlock``, and the generic flax-name mapping of
``from_flax``; then ``Residual1D`` in each ``pool_mode``, the 2-D
``ConvBN`` (bias, dilation, SAME per axis, relu), ``max_pool_2d`` with
ties, NCHW ``BatchNorm``, ``AlphaDropout``, and ``GRU``/``BiGRU`` forward
and reverse, with and without their variational masks (injected on both
sides by ``torch_zoo_parity.Masks``), and the nested flax names. Forward
in float32 on the CPU (exact for the pools, 1e-5 for products),
gradients and the recurrent layers in float64 (1e-12).
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
from torch_zoo_parity import Masks

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _ncw(x: np.ndarray) -> torch.Tensor:
    """Channels-last numpy (NWC or NHWC) -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nwc(t: torch.Tensor) -> np.ndarray:
    """Channels-first torch -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


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
                {"Residual1D_0": {"Dense_0": {"kernel": k3}}},
                {"BiGRU_0": {"Conv_0": {"kernel": k3}}},
                {"Residual1D_0": {"kernel": k3}},
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



@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("pool_mode,strides,length", [
    ("pool", 1, 13), ("pool", 2, 13), ("pool", 3, 14),
    ("pool_eq_stride", 1, 13), ("pool_eq_stride", 2, 13),
    ("pool_eq_stride", 2, 12), ("stride_on_first_conv", 1, 13),
    ("stride_on_first_conv", 2, 13), ("stride_on_first_conv", 2, 12)])
def test_residual_1d_matches_jax(train, pool_mode, strides, length):
    cin = 6 if strides == 1 else 4
    x = np.random.default_rng(length).normal(size=(3, length, cin)).astype(
        np.float32)
    got, want = _block_pair(
        JL.Residual1D(6, 3, strides=strides, pool_mode=pool_mode),
        L.Residual1D(cin, 6, 3, strides, pool_mode), x, train)
    assert got.shape == want.shape == (3, -(-length // strides), 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_residual_1d_creates_the_shortcut_first():
    block = L.Residual1D(4, 6, 3, 2)
    assert [n for n, _ in block.named_children()] == [
        "Conv_0", "BatchNorm_0", "DepthwiseConvBlock_0",
        "DepthwiseConvBlock_1"]
    with pytest.raises(ValueError, match="identity shortcut"):
        L.Residual1D(4, 6, 3, 1)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kernel,strides,dilation,padding", [
    ((11, 5), (1, 1), (2, 1), "same"), ((5, 3), (1, 1), (2, 1), "same"),
    ((3, 3), (2, 2), (1, 1), "same"), ((3, 3), (1, 1), (1, 1), "same"),
    ((4, 2), (2, 1), (1, 2), "same"), ((3, 2), (1, 1), (2, 1), "valid")])
def test_conv_bn_2d_matches_jax(train, kernel, strides, dilation, padding):
    """NHWC [2, 19, 10, 3]; SAME pads each axis asymmetrically over the
    dilated span (11 x 5 at dilation (2, 1) spans 21 x 5)."""
    import flax.linen as fnn

    x = np.random.default_rng(kernel[0]).normal(size=(2, 19, 10, 3)).astype(
        np.float32)
    got, want = _block_pair(
        JL.ConvBN(7, kernel, strides=strides, padding=padding,
                  dilation=dilation, use_bias=True, activation=fnn.relu),
        L.ConvBN(3, 7, kernel, strides, padding, dilation=dilation,
                 use_bias=True, activation=F.relu), x, train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 9, 10, 3), (2, 8, 7, 2)])
@pytest.mark.parametrize("pool,stride,padding", [
    ((2, 2), None, "valid"), ((3, 2), (2, 1), "same"),
    ((2, 3), (2, 2), "same")])
def test_max_pool_2d_matches_jax_and_splits_ties(shape, pool, stride,
                                                 padding):
    x = np.random.default_rng(shape[1]).choice(
        [0.0, 6.0, 0.0, 6.0, 1.5, 3.0], size=shape)
    with jax.enable_x64(True):
        y = JL.max_pool_2d(jnp.asarray(x), pool, stride, padding)
        w = np.random.default_rng(1).normal(size=y.shape)
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            JL.max_pool_2d(v, pool, stride, padding) * w))(jnp.asarray(x)))
    xt = _ncw(x).requires_grad_()
    yt = L.max_pool_2d(xt, pool, stride, padding)
    np.testing.assert_array_equal(_nwc(yt), np.asarray(y))
    (yt * _ncw(w)).sum().backward()
    np.testing.assert_allclose(_nwc(xt.grad), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ndim", [3, 4])
def test_batch_norm_takes_every_non_channel_axis(ndim):
    """Train mode on NCW and NCHW against flax's BatchNorm on the
    channels-last input: the output and the running-statistics update;
    then eval mode with the updated statistics, all in float64 (flax's
    statistics start in float64 too)."""
    import flax.linen as fnn

    shape = (4, 9, 5) if ndim == 3 else (4, 9, 6, 5)
    x = np.random.default_rng(ndim).normal(0.3, 2.0, shape)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    with jax.enable_x64(True):
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        rng = np.random.default_rng(5)
        params = {"scale": rng.uniform(0.5, 1.5, 5),
                  "bias": rng.normal(size=5)}
        want, upd = bn.apply({"params": params,
                              "batch_stats": jax.tree_util.tree_map(
                                  lambda a: np.asarray(a, np.float64),
                                  v["batch_stats"])},
                             jnp.asarray(x), mutable=["batch_stats"])
        stats = jax.device_get(upd["batch_stats"])
        want_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-3
                                  ).apply({"params": params,
                                           "batch_stats": stats},
                                          jnp.asarray(x))
    port = L.BatchNorm(5).double()
    port.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.zeros(5, dtype=torch.float64),
        "running_var": torch.ones(5, dtype=torch.float64)})
    got = port.train()(_ncw(x))
    np.testing.assert_allclose(_nwc(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"],
                               rtol=0, atol=1e-12)
    got = port.eval()(_ncw(x))
    np.testing.assert_allclose(_nwc(got), np.asarray(want_eval), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.5])
def test_alpha_dropout_matches_jax(rate):
    x = np.random.default_rng(3).normal(size=(4, 33))
    masks = Masks()
    layer = JL.AlphaDropout(rate)
    with jax.enable_x64(True), masks.jax():
        want = np.asarray(layer.apply({}, jnp.asarray(x), train=True,
                                      rngs={"dropout": jax.random.PRNGKey(0)}))
    port = L.AlphaDropout(rate).train()
    with masks.port():
        got = port(torch.from_numpy(x), torch.Generator()).numpy()
    assert masks.used == len(masks.masks) == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert np.array_equal(port.eval()(torch.from_numpy(x)).numpy(), x)
    dropped = ~masks.masks[0][0]
    assert dropped.any() and np.allclose(got[dropped], got[dropped][0])


def _gru_pair(jax_layer, port_layer, x, train, seed=0):
    """(port output, JAX output, port dx, JAX dx) in float64, the masks
    injected, the weights drawn with numpy and moved by ``from_flax``."""
    masks = Masks()
    rngs = {"dropout": jax.random.PRNGKey(0)}
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jax_layer.init(
            jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda s: rng.uniform(-0.6, 0.6, s.shape), shapes)

        def f(p, v):
            with masks.jax():
                return jax_layer.apply({"params": p}, v, train=train,
                                       rngs=rngs)

        want = np.asarray(f(params, jnp.asarray(x)))
        w = np.random.default_rng(1).normal(size=want.shape)
        dx_want = np.asarray(jax.grad(
            lambda v: jnp.sum(f(params, v) * w))(jnp.asarray(x)))
    top = type(port_layer).__name__ + "_0"
    port_layer.double().train(train)
    port_layer.load_state_dict({k[len(top) + 1:]: t for k, t in from_flax(
        {top: params}, {}, model="any").items()})
    xt = _ncw(x).requires_grad_()
    with masks.port():
        got = port_layer(xt, torch.Generator())
    assert masks.used == len(masks.masks)
    out = got.detach().numpy()
    if got.ndim == 3:       # sequences: NCW -> NWC
        out, wt = _nwc(got), _ncw(w)
    else:
        wt = torch.from_numpy(w)
    (got * wt).sum().backward()
    return out, want, _nwc(xt.grad), dx_want, len(masks.masks)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("return_sequences", [False, True])
def test_gru_matches_jax(train, reverse, return_sequences):
    """The Keras v1 cell on [3, 7, 5] inputs, 4 units, dropout 0.3 and
    recurrent dropout 0.4 (masks only in train mode): the output and
    dx within 1e-12; inputs large enough that hard_sigmoid saturates."""
    x = np.random.default_rng(2).normal(0.0, 2.0, (3, 7, 5))
    got, want, dx, dx_want, num_masks = _gru_pair(
        JL.GRU(4, return_sequences, reverse, dropout=0.3,
               recurrent_dropout=0.4),
        L.GRU(5, 4, return_sequences, reverse, 0.3, 0.4), x, train)
    assert num_masks == (2 if train else 0)
    assert got.shape == want.shape == ((3, 7, 4) if return_sequences
                                       else (3, 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dx, dx_want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("return_sequences", [False, True])
def test_bigru_matches_jax(train, return_sequences):
    x = np.random.default_rng(3).normal(0.0, 2.0, (2, 6, 5))
    got, want, dx, dx_want, num_masks = _gru_pair(
        JL.BiGRU(3, return_sequences, dropout=0.2, recurrent_dropout=0.2),
        L.BiGRU(5, 3, return_sequences, 0.2, 0.2), x, train)
    assert num_masks == (4 if train else 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dx, dx_want, rtol=0, atol=1e-12)


def test_reverse_gru_last_state_is_the_state_after_the_first_step():
    """A one-step offset in the reversed direction would show here: the
    reverse GRU's last state depends on every step, its sequence's first
    entry is that state, and a GRU over the flipped input gives it."""
    gru = L.GRU(3, 4, reverse=True).double().eval()
    L.init_parameters(gru, torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    last = gru(x)
    gru.return_sequences = True
    seq = gru(x)
    assert torch.equal(seq[:, :, 0], last)
    gru.reverse, gru.return_sequences = False, False
    assert torch.allclose(gru(x.flip(2)), last, atol=1e-15)


def test_nested_flax_names_map_into_residual_and_bigru_blocks():
    k = np.zeros((3, 1, 4), np.float32)
    moved = from_flax(
        {"Residual1D_3": {
            "Conv_0": {"kernel": np.zeros((1, 2, 4), np.float32)},
            "BatchNorm_0": {"scale": np.ones(4, np.float32)},
            "DepthwiseConvBlock_1": {"Conv_0": {"kernel": k}}},
         "BiGRU_0": {"GRU_1": {
             "kernel": np.zeros((5, 12), np.float32),
             "recurrent_kernel_zr": np.zeros((4, 8), np.float32),
             "recurrent_kernel_h": np.zeros((4, 4), np.float32)}}},
        {"Residual1D_3": {"BatchNorm_0": {"var": np.ones(4, np.float32)}}},
        model="xception_with_attention")
    assert {k: tuple(v.shape) for k, v in moved.items()} == {
        "Residual1D_3.Conv_0.weight": (4, 2, 1),
        "Residual1D_3.BatchNorm_0.weight": (4,),
        "Residual1D_3.DepthwiseConvBlock_1.depthwise.weight": (4, 1, 3),
        "BiGRU_0.GRU_1.weight": (12, 5),
        "BiGRU_0.GRU_1.recurrent_weight_zr": (8, 4),
        "BiGRU_0.GRU_1.recurrent_weight_h": (4, 4),
        "Residual1D_3.BatchNorm_0.running_var": (4,)}
    kernel_2d = np.arange(2 * 3 * 1 * 4, dtype=np.float32).reshape(2, 3, 1, 4)
    moved = from_flax({"Conv_0": {"kernel": kernel_2d}}, {}, model="conv_2d")
    assert torch.equal(moved["Conv_0.weight"],
                       torch.from_numpy(kernel_2d.transpose(3, 2, 0, 1)))
