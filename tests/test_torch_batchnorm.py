"""Train-mode BatchNorm's kernels (``ops/kernels/batchnorm.py``,
``csrc/batchnorm.cu``), their plain twin and ``models/layers.py::
BatchNorm``.

On the CPU: ``batch_norm_train_plain`` (the kernels' arithmetic in
PyTorch: f32 shifted sums, then the normalisation and the backward
formula) against a float64 evaluation of the formula, y, mean, var and
the gradients of x, weight and bias, over [B, C], NCW and NCHW, one
channel, and a channel whose mean is 1e3 times its standard deviation;
the wrapper's checks; ``BatchNorm`` on the CPU as it was (``var_mean``
and ``F.batch_norm``), launching nothing.

On the card (marked ``cuda``; ``-m cuda --noconftest``; this file imports
no jax): the kernels against the plain twin at every BatchNorm shape of
the benchmark's three models at batch 384, bf16 and f32; two runs give
the same bits; a model's forward and backward captured and replayed runs
each kernel once a BatchNorm layer; ``BatchNorm`` on the card; what the
wrapper refuses there.
"""

import pytest
import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.kernels import batchnorm as BN
from speech_recognition_tpu_torch.ops.kernels import launch

torch.set_num_threads(1)

EPS = L.BN_EPS
U32 = 2.0 ** -24          # float32's unit roundoff

SHAPES = {"bc": (40, 6), "ncw": (5, 4, 13), "nchw": (3, 4, 5, 7),
          "one_channel": (6, 1, 9), "far_mean": (7, 3, 11)}


def _inputs(shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if shape == SHAPES["far_mean"]:
        # channel 1: mean 1e3, standard deviation 1
        x[:, 1] += 1e3
    c = shape[1]
    w = 1.0 + 0.2 * torch.randn(c, generator=g, dtype=torch.float64)
    b = 0.1 * torch.randn(c, generator=g, dtype=torch.float64)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return x.to(dtype), w.float(), b.float(), dy.to(dtype)


def _formula64(x, w, b, dy):
    """The formula in float64 over the same (rounded) values, its
    gradients by autograd."""
    x = x.double().requires_grad_(True)
    w = w.double().requires_grad_(True)
    b = b.double().requires_grad_(True)
    dims = (0,) + tuple(range(2, x.ndim))
    view = (-1,) + (1,) * (x.ndim - 2)
    mean = x.mean(dims)
    var = (x - mean.reshape(view)).square().mean(dims)
    y = ((x - mean.reshape(view)) / torch.sqrt(var.reshape(view) + EPS)
         * w.reshape(view) + b.reshape(view))
    y.backward(dy.double())
    return [v.detach() for v in (y, mean, var, x.grad, w.grad, b.grad)]


def _per_channel_max(v):
    return v.abs().transpose(0, 1).reshape(v.shape[1], -1).amax(1)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_plain_twin_holds_to_float64(shape):
    """Each quantity within what float32 resolves of it. The inputs are
    float32 values and the float64 formula is exact for them, so the gap
    is the twin's own: sums of a few hundred terms (1e-5 relative covers
    them many times over) and, for a channel far from 0, the resolution
    of x itself (a few ulps of max |x| in the mean, and so in x - mean)."""
    x, w, b, dy = _inputs(SHAPES[shape])
    x.requires_grad_(True)
    w_, b_ = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y, mean, var = BN.batch_norm_train_plain(x, w_, b_, EPS)
    y.backward(dy)
    y64, mean64, var64, dx64, dw64, db64 = _formula64(x.detach(), w, b, dy)
    view = (-1,) + (1,) * (x.ndim - 2)
    invstd = 1.0 / torch.sqrt(var64 + EPS)
    xmax = _per_channel_max(x.detach().double())
    res = 4 * U32 * xmax * invstd           # x - mean's resolution, in std
    assert y.dtype == x.dtype and mean.dtype == var.dtype == torch.float32
    assert ((mean.double() - mean64).abs()
            <= 4 * U32 * xmax + 1e-6 * var64.sqrt()).all()
    assert ((var.double() - var64).abs() <= 1e-5 * var64).all()
    assert ((y.detach().double() - y64).abs()
            <= (1e-5 + res * w.double().abs()).reshape(view)).all()
    dims = (0,) + tuple(range(2, x.ndim))
    dy_abs = dy.double().abs().sum(dims)
    xhat_abs = _per_channel_max(
        (x.detach().double() - mean64.reshape(view)) * invstd.reshape(view))
    assert ((b_.grad.double() - db64).abs() <= 1e-5 * dy_abs).all()
    assert ((w_.grad.double() - dw64).abs()
            <= (1e-5 * xhat_abs + res) * dy_abs).all()
    dx_scale = (w.double().abs() * invstd * _per_channel_max(dy.double()))
    assert ((x.grad.double() - dx64).abs()
            <= (4 * (1e-5 + res) * dx_scale).reshape(view)).all()


def test_the_plain_twin_does_not_cancel_far_from_zero():
    """E[x^2] - E[x]^2 in float32 would lose the far channel's variance
    (its mean 1e3 squares to 1e6, where float32's step is 0.06); the
    shifted sums keep it to 1e-5."""
    x, w, b, _ = _inputs(SHAPES["far_mean"])
    _, _, var = BN.batch_norm_train_plain(x, w, b, EPS)
    var64 = x.double().var((0, 2), unbiased=False)
    naive = (x.square().mean((0, 2)) - x.mean((0, 2)).square()).double()
    assert (var.double() - var64).abs()[1] <= 1e-5 * var64[1]
    assert (naive - var64).abs()[1] > 1e-3 * var64[1]


def test_the_kernel_path_is_the_plain_twin_on_the_cpu():
    x, w, b, dy = _inputs(SHAPES["ncw"])
    outs = []
    for fn in (BN.batch_norm_train, BN.batch_norm_train_plain):
        xg = x.clone().requires_grad_(True)
        wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y, mean, var = fn(xg, wg, bg, EPS)
        y.backward(dy)
        outs.append([y, mean, var, xg.grad, wg.grad, bg.grad])
    for a, c in zip(*outs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("bad", ["ndim", "empty", "weight_shape",
                                 "bias_shape", "device", "contiguity",
                                 "dtype"])
def test_the_wrapper_checks_its_inputs(bad):
    x, w, b, _ = _inputs(SHAPES["ncw"])
    if bad == "ndim":
        x = x[:, 0, 0]
    elif bad == "empty":
        x = x[:0]
    elif bad == "weight_shape":
        w = w[:-1]
    elif bad == "bias_shape":
        b = torch.cat([b, b])
    elif bad == "device":
        w = w.to("meta")
    elif bad == "contiguity":
        x = x.transpose(0, 2).contiguous().transpose(0, 2)
    else:
        x = (x * 100).long()
    with pytest.raises(ValueError):
        BN.batch_norm_train(x, w, b, EPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ["bc", "ncw", "nchw"])
def test_batchnorm_on_the_cpu_is_var_mean_and_f_batch_norm(shape, dtype):
    """The CPU path as it was: the output of ``F.batch_norm`` in train
    mode, the running statistics moved by 0.01 toward ``var_mean``'s
    (biased), bit for bit; no kernel runs."""
    x, _, _, _ = _inputs(SHAPES[shape], dtype=dtype)
    c = x.shape[1]
    m = L.BatchNorm(c).to(dtype).train()
    L.init_parameters(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        m.bias.uniform_(-0.2, 0.2)
    before = launch.runs()
    y = m(x)
    dims = (0,) + tuple(range(2, x.ndim))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    want = F.batch_norm(x, None, None, m.weight, m.bias, training=True,
                        eps=EPS)
    assert torch.equal(y, want)
    mom = L.BN_MOMENTUM
    assert torch.equal(m.running_mean, torch.zeros(c, dtype=dtype)
                       .mul_(mom).add_(mean, alpha=1.0 - mom))
    assert torch.equal(m.running_var, torch.ones(c, dtype=dtype)
                       .mul_(mom).add_(var, alpha=1.0 - mom))
    assert launch.runs() == before


@pytest.mark.parametrize("reader", ["port", "benchmark"])
@pytest.mark.parametrize("kernel", ["bn_fw_stats_kernel<__nv_bfloat16, 8>",
                                    "bn_fw_apply_kernel<float>",
                                    "bn_bw_reduce_kernel<__half, 1>",
                                    "bn_bw_dx_kernel<__nv_bfloat16>"])
def test_the_kernels_are_classed_as_normalization(kernel, reader):
    """The kernels' names as the profiler gives them fall in the class the
    ATen BatchNorm kernels fell in, for the port's trace reader and the
    benchmark's (its ``bn_device_ms_per_step``), not in ``reduction``."""
    if reader == "port":
        from speech_recognition_tpu_torch.utils.profiling import op_class
    else:
        from kws_bench.trace import op_class
    name = f"void (anonymous namespace)::{kernel}(float const*, float*)"
    assert op_class(name) == "normalization"


# -- on the card -------------------------------------------------------

BATCH = 384
# (C, T) of every BatchNorm input of the benchmark's three models at
# batch 384 (flagship conv_1d_time_sliced_with_attention, steffeNet,
# xception_with_attention)
CARD_SHAPES = sorted({
    (128, 399), (128, 397), (192, 199), (192, 197), (256, 99), (256, 97),
    (320, 49), (320, 47), (384, 24), (384, 22), (512, 11), (512, 9),
    (320, 160), (384, 80), (512, 40), (768, 20), (1024, 10), (1536, 5),
    (256, 320),
    (256, 100), (128, 399), (256, 200), (384, 100), (64, 399), (128, 200),
    (384, 50), (1, 50)})
KERNELS = ("bn_fw_stats", "bn_fw_apply", "bn_bw_reduce", "bn_bw_dx")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_inputs(shape, dtype, device, seed=3):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2.0 + 0.5).to(device, dtype)
    w = (1.0 + 0.2 * torch.randn(c, generator=g)).to(device)
    b = (0.1 * torch.randn(c, generator=g)).to(device)
    dy = torch.randn(shape, generator=g).to(device, dtype)
    return x, w, b, dy


def _run(fn, x, w, b, dy):
    xg = x.clone().requires_grad_(True)
    wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y, mean, var = fn(xg, wg, bg, EPS)
    y.backward(dy)
    return [y.detach(), mean, var, xg.grad, wg.grad, bg.grad]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("ct", CARD_SHAPES, ids=lambda ct: f"{ct[0]}x{ct[1]}")
def test_the_kernels_match_their_plain_twin(cuda, ct, dtype):
    """Kernels and twin take the same f32 sums in other orders. Sums of
    up to 153,216 terms: each within about sqrt(N) u = 2.3e-5 of the
    sum of the terms' magnitudes, so 1e-4 of it (mean, var, dweight,
    dbias). y and dx: the f32 values then differ by ~1e-5 of their
    scale, which may move a rounding to the dtype by one step: one bf16
    step (2^-8 of the value) or 1e-4 of the largest |value| in f32."""
    x, w, b, dy = _card_inputs((BATCH,) + ct, dtype, cuda)
    got = _run(BN.batch_norm_train, x, w, b, dy)
    want = _run(BN.batch_norm_train_plain, x, w, b, dy)
    torch.cuda.synchronize()
    names = ("y", "mean", "var", "dx", "dweight", "dbias")
    view = (-1, 1)
    xf, dyf = x.float(), dy.float()
    mean, var = want[1], want[2]
    scale = {
        "mean": (xf - mean.reshape(view)).abs().mean((0, 2)),
        "var": (xf - mean.reshape(view)).square().mean((0, 2)),
        "dbias": dyf.abs().sum((0, 2)),
        "dweight": (dyf * (xf - mean.reshape(view))).abs().sum((0, 2))
        / torch.sqrt(var + EPS),
    }
    for name, a, c in zip(names, got, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        gap = (a.float() - c.float()).abs()
        if name in scale:
            assert (gap <= 1e-4 * scale[name] + 1e-30).all(), name
        elif dtype == torch.bfloat16:
            top = c.float().abs().max()
            assert (gap <= 2.0 ** -7 * c.float().abs() + 1e-4 * top).all(), \
                name
        else:
            assert (gap <= 1e-4 * c.float().abs().max()).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("ct", [(128, 399), (1536, 5), (1, 50)],
                         ids=lambda ct: f"{ct[0]}x{ct[1]}")
def test_two_runs_give_the_same_bits(cuda, ct):
    x, w, b, dy = _card_inputs((BATCH,) + ct, torch.bfloat16, cuda)
    first = _run(BN.batch_norm_train, x, w, b, dy)
    second = _run(BN.batch_norm_train, x, w, b, dy)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["f16", "f32"])
@pytest.mark.parametrize("shape", [(37, 300), (5, 7, 3, 11), (3, 2, 5)],
                         ids=["bc", "nchw", "small"])
def test_the_kernels_take_every_layout(cuda, shape, dtype):
    """[B, C], NCHW and a batch below the row groups, against the twin:
    as in ``test_the_kernels_match_their_plain_twin``."""
    x, w, b, dy = _card_inputs(shape, dtype, cuda)
    got = _run(BN.batch_norm_train, x, w, b, dy)
    want = _run(BN.batch_norm_train_plain, x, w, b, dy)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        gap = (a.float() - c.float()).abs().max()
        top = c.float().abs().max()
        assert gap <= (2.0 ** -9 if dtype == torch.float16 else 1e-4) * top


@pytest.mark.cuda
def test_a_replayed_step_runs_each_kernel_once_a_layer(cuda):
    """The flagship's forward and backward under bf16 autocast, captured
    (``launch.capture``) and replayed: the capture runs nothing, a
    replay counts one run of each kernel for each of its 12 BatchNorms,
    one of each depthwise kernel for each of its 11 depthwise convs and
    no other run, and gives the eager step's gradients from the same
    generator state (to 1e-3 of the largest: cuDNN's weight gradients
    may sum in another order from run to run)."""
    from speech_recognition_tpu_torch.models.zoo import build_model

    model, _ = build_model("conv_1d_time_sliced_with_attention", 12)
    model = model.to(cuda).train()
    layers = sum(isinstance(m, L.BatchNorm) for m in model.modules())
    x = torch.randn(16, 16000, generator=torch.Generator().manual_seed(0))
    x = x.to(cuda)
    gen = torch.Generator(device=cuda)
    params = list(model.parameters())

    def body():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = model(x, gen)
        return torch.autograd.grad(y.float().square().sum(), params)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    before = launch.runs()
    with launch.capture(graph):
        out = body()
    assert launch.runs() == before
    gen.manual_seed(11)
    want = [g.clone() for g in body()]
    eager = launch.runs()
    gen.manual_seed(11)
    launch.replay(graph)
    torch.cuda.synchronize()
    dws = sum(isinstance(m, L.Conv) and m.depthwise_1d()
              for m in model.modules())
    assert layers == 12 and dws == 11
    assert {k: v for k, v in (eager - before).items()
            if k in KERNELS} == dict.fromkeys(KERNELS, layers)
    assert launch.runs() - eager == {
        **dict.fromkeys(KERNELS, layers),
        **dict.fromkeys(("dwconv1d_fw", "dwconv1d_bw"), dws)}
    for a, c in zip(out, want):
        assert (a - c).abs().max() <= 1e-3 * c.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 24, 50), (32, 8, 6, 5)],
                         ids=["ncw", "nchw"])
def test_batchnorm_on_the_card_runs_the_kernels(cuda, shape):
    """A train-mode ``BatchNorm`` on the card: the twin's y, the running
    statistics moved by its mean and var, one run of each kernel; eval
    mode and float64 run none (ATen's)."""
    c = shape[1]
    m = L.BatchNorm(c).to(cuda).train()
    L.init_parameters(m, torch.Generator().manual_seed(0))
    x, w, b, dy = _card_inputs(shape, torch.float32, cuda)
    x.requires_grad_(True)
    before = launch.runs()
    y = m(x)
    y.backward(dy)
    torch.cuda.synchronize()
    assert launch.runs() - before == dict.fromkeys(KERNELS, 1)
    want, mean, var = BN.batch_norm_train_plain(x.detach(), m.weight.detach(),
                                                m.bias.detach(), EPS)
    assert (y - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.allclose(m.running_mean, 0.01 * mean, rtol=1e-4,
                          atol=1e-6)
    assert torch.allclose(m.running_var, 0.99 + 0.01 * var, rtol=1e-4)
    before = launch.runs()
    m.eval()(x)
    m.train().double()(x.detach().double())
    assert launch.runs() == before


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "weight_dtype", "aligned",
                                 "contiguity"])
def test_a_cuda_input_the_kernels_do_not_take_raises(cuda, bad):
    x, w, b, _ = _card_inputs((8, 4, 9), torch.float32, cuda)
    if bad == "float64":
        x = x.double()
    elif bad == "weight_dtype":
        w = w.half()
    elif bad == "aligned":
        x = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    else:
        x = x.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises(ValueError):
        BN.batch_norm_train(x, w, b, EPS)
