"""The max-pool kernels (``ops/kernels/maxpool.py``, ``csrc/maxpool.cu``),
their plain twin and ``models/layers.py::_max_pool_axis``'s routing.

On the CPU: the plain twin (``maxpool_forward_plain``,
``maxpool_backward_plain``: the kernels' gather arithmetic in PyTorch)
against ``_max_pool_axis``'s chain of
``torch.maximum``, forward and gradient bit for bit in float32, float64
and bfloat16, on relu6-like inputs (ties everywhere) and dyadic
cotangents, so that every sum is exact in each dtype; the three-way tie,
a pad tap beside the winner and NaN; ``max_pool_last`` on a CPU tensor
as the twin; the wrapper's checks; the chain kept on the CPU; the kernels' names in no frozen op class, and the
benchmark's reader of them.

On the card (marked ``cuda``; ``-m cuda --noconftest``; this file imports
no jax): the kernels against the twin at every pool shape of xception's
and mfcc_and_raw's steps at batch 384, a ``max_pool_2d`` W pass and the
other pools and strides; two runs give the same bits; a replayed step
runs each kernel once a pool; every zoo model that pools, through the
kernels at each of its pools as a train step meets them, and its eval
logits against the chain's; the routing and what the wrapper refuses
there.
"""

import copy
import itertools

import pytest
import torch

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.ops.kernels import maxpool as MP

torch.set_num_threads(1)

# relu6 outputs: 0 and 6 (clamped) most often, a few values between
RELU6 = torch.tensor([0.0, 6.0, 0.0, 6.0, 1.5, 3.0])
# cotangents whose weighted sums (weights 2^-k, k < pool) stay exact in
# bfloat16 for pool <= 5
DYADIC = torch.tensor([-1.0, -0.5, 0.5, 1.0])
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
# every (pool, stride) of pool 2-5 and stride 1-3; this holds
# tests/test_torch_zoo_layers.py's POOLS, each at both paddings
GRID = list(itertools.product(range(2, 6), range(1, 4), ("same", "valid")))
KERNELS = ("maxpool1d_fw", "maxpool1d_bw")


def _draw(values, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return values[torch.randint(len(values), shape, generator=g)]


def _chain(x, dy, pool, stride, padding, dim=-1):
    """``_max_pool_axis``'s y and x's gradient."""
    x = x.clone().requires_grad_(True)
    y = L._max_pool_axis(x, pool, stride, padding, dim)
    y.backward(dy)
    return y.detach(), x.grad


def _twin(x, dy, pool, stride, padding):
    """The plain twin's y and dx."""
    return (MP.maxpool_forward_plain(x, pool, stride, padding),
            MP.maxpool_backward_plain(dy, x, pool, stride, padding))


def _same(a, b):
    """Equal bits, NaN where the other has NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("padding", ["same", "valid", "VALID"])
def test_the_window_geometry(padding):
    """``window``, which the chain and the kernels both take: SAME has
    ceil(T / s) windows and TF's pads (``same_pad_amount``), VALID the
    windows that fit and no pad; every window ends inside the padded
    row, and the last reaches its end."""
    for (pool, stride, _), t in itertools.product(GRID, range(1, 31)):
        if padding != "same" and t < pool:
            continue
        out, left, right = MP.window(t, pool, stride, padding)
        if padding == "same":
            assert (out, left, right) == (-(-t // stride),) + \
                same_pad_amount(t, pool, stride)
        else:
            assert (out, left, right) == ((t - pool) // stride + 1, 0, 0)
        assert (out - 1) * stride + pool <= left + t + right
        assert out * stride + pool > left + t + right


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pool,stride,padding", GRID)
def test_the_plain_twin_is_the_chain(pool, stride, padding, dtype):
    """Lengths 1-30 (VALID from the pool up): the twin's y and gradient
    are the chain's to the bit."""
    for t in range(1, 31):
        if padding == "valid" and t < pool:
            continue
        x = _draw(RELU6, (2, 3, t), t).to(DTYPES[dtype])
        out = MP.window(t, pool, stride, padding)[0]
        dy = _draw(DYADIC, (2, 3, out), 100 + t).to(DTYPES[dtype])
        want, got = _chain(x, dy, pool, stride, padding), \
            _twin(x, dy, pool, stride, padding)
        assert got[0].dtype == got[1].dtype == x.dtype
        assert torch.equal(got[0], want[0]), (t, "y")
        assert torch.equal(got[1], want[1]), (t, "dx")


def test_a_three_way_tie_gives_the_last_tap_half():
    """``torch.maximum``'s derivative halves a tie at each step of the
    chain: 1/4, 1/4, 1/2, not an even split."""
    x = torch.zeros(1, 1, 3)
    for fn in (_chain, _twin):
        _, dx = fn(x, torch.ones(1, 1, 1), 3, 1, "valid")
        assert dx.tolist() == [[[0.25, 0.25, 0.5]]]


@pytest.mark.parametrize("row", [[5.0, 1.0, 2.0, 0.0], [1.0, 2.0, 7.0],
                                 [float("-inf"), 1.0, float("-inf")],
                                 [float("-inf")] * 4],
                         ids=["left", "right", "inf_beside_pad", "all_inf"])
@pytest.mark.parametrize("pool,stride", [(3, 1), (4, 1), (5, 2)])
def test_windows_at_the_pad(row, pool, stride):
    """SAME windows whose winner is a pad tap's neighbour, and -inf inputs
    that tie with the pad (the pad's share dropped): as the chain."""
    x = torch.tensor([[row]], dtype=torch.float64)
    out = MP.window(len(row), pool, stride, "same")[0]
    dy = _draw(DYADIC, (1, 1, out), 7).double()
    want, got = _chain(x, dy, pool, stride, "same"), \
        _twin(x, dy, pool, stride, "same")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nan_wins_as_in_the_chain(dtype):
    """A NaN tap makes its windows NaN, and the chain's derivative gives
    both sides of a NaN comparison the whole cotangent: the twin does
    the same."""
    x = _draw(RELU6, (3, 4, 17), 5).to(DTYPES[dtype])
    x[0, 1, 4] = x[2, 3, 16] = x[1, 0, 0] = float("nan")
    for pool, stride, padding in ((3, 2, "same"), (3, 1, "same"),
                                  (2, 2, "valid")):
        out = MP.window(17, pool, stride, padding)[0]
        dy = _draw(DYADIC, (3, 4, out), 9).to(x.dtype)
        want, got = _chain(x, dy, pool, stride, padding), \
            _twin(x, dy, pool, stride, padding)
        assert got[0].isnan().sum() > 0
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_the_kernel_path_is_the_twin_on_the_cpu():
    """On a CPU tensor, ``max_pool_last`` and its gradient, and the two
    wrappers, are the plain twin's, with nothing launched."""
    x = _draw(RELU6, (2, 5, 13), 3)
    dy = _draw(DYADIC, (2, 5, 7), 4)
    before = launch.runs()
    xa = x.clone().requires_grad_(True)
    y = MP.max_pool_last(xa, 3, 2, "same")
    y.backward(dy)
    want = _twin(x, dy, 3, 2, "same")
    assert torch.equal(y, want[0]) and torch.equal(xa.grad, want[1])
    assert torch.equal(MP.maxpool_forward(x, 3, 2, "same"), want[0])
    assert torch.equal(MP.maxpool_backward(dy, x, 3, 2, "same"), want[1])
    assert launch.runs() == before


@pytest.mark.parametrize("bad", ["scalar", "empty", "pool", "stride",
                                 "padding", "window", "dtype", "device",
                                 "dy_shape"])
def test_the_wrapper_checks_its_inputs(bad):
    x, dy = torch.zeros(2, 3, 8), torch.zeros(2, 3, 4)
    pool, stride, padding = 3, 2, "same"
    if bad == "scalar":
        x = torch.zeros(())
    elif bad == "empty":
        x = torch.zeros(0, 3, 8)
    elif bad == "pool":
        pool = 0
    elif bad == "stride":
        stride = 0
    elif bad == "padding":
        padding = "full"
    elif bad == "window":
        pool, padding = 9, "valid"
    elif bad == "dtype":
        x = x.long()
    elif bad == "device":
        x = x.to("meta")
    else:
        dy = dy[..., :3]
    with pytest.raises(ValueError):
        if bad == "dy_shape":
            MP.maxpool_backward(dy, x, pool, stride, padding)
        else:
            MP.max_pool_last(x, pool, stride, padding)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dim", [-1, 1, 2])
def test_the_cpu_keeps_the_chain(monkeypatch, dim, dtype):
    """On the CPU every axis and dtype pools by the chain: the kernels'
    function is never called, nothing launches, and y and the gradient
    are the chain's as written out here (``max_pool_2d``'s H and W
    passes among them)."""
    def refuse(*args):
        raise AssertionError("the kernels' function was called")

    monkeypatch.setattr(L, "max_pool_last", refuse)
    x = _draw(RELU6, (2, 4, 9, 11), 2).to(DTYPES[dtype])
    before = launch.runs()
    y, dx = _chain(x, torch.ones((2, 4, 9, 6) if dim == -1 else
                                 (2, 2, 9, 11) if dim == 1 else
                                 (2, 4, 5, 11), dtype=x.dtype),
                   3, 2, "same", dim)
    xm = x.movedim(dim, -1)
    t = xm.shape[-1]
    xp = torch.nn.functional.pad(xm, same_pad_amount(t, 3, 2),
                                 value=float("-inf"))
    taps = [xp[..., i:i + t + t % 2 - 1:2] for i in range(3)]
    want = torch.maximum(torch.maximum(taps[0], taps[1]),
                         taps[2]).movedim(-1, dim)
    assert torch.equal(y, want)
    assert dx.shape == x.shape
    L.max_pool_2d(x, (2, 2), padding="same")
    assert launch.runs() == before


KERNEL_NAMES = [
    "maxpool1d_fw_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
    "__nv_bfloat16*, (anonymous namespace)::Window)",
    "maxpool1d_bw_kernel<float>(float const*, float const*, float*, "
    "(anonymous namespace)::Window)",
    "maxpool1d_fw_kernel<__half>(__half const*, __half*, "
    "(anonymous namespace)::Window)",
    "maxpool1d_bw_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16*, (anonymous namespace)::Window)",
]


@pytest.mark.parametrize("reader", ["port", "benchmark"])
@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_the_kernels_fall_in_no_frozen_op_class(kernel, reader):
    """The kernels' names as the profiler gives them match none of the
    op classes' patterns (so ``elementwise`` and the others keep their
    meaning), for the port's trace reader and the benchmark's."""
    if reader == "port":
        from speech_recognition_tpu_torch.utils.profiling import op_class
    else:
        from kws_bench.trace import op_class
    assert op_class(f"void (anonymous namespace)::{kernel}") == "other"


def test_the_benchmark_reader_sums_exactly_the_maxpool_kernels():
    from kws_bench.metrics import maxpool_device_ms_per_step as reader

    kernels = {f"void (anonymous namespace)::{n}": (0.001 * (i + 1), 20)
               for i, n in enumerate(KERNEL_NAMES)}
    kernels["void at::native::elementwise_kernel<128, 4>(int)"] = (0.5, 9)
    kernels["void (anonymous namespace)::bn_fw_stats_kernel<float, 4>"
            "(float const*, float*)"] = (0.25, 20)
    layers = {"kind": "train",
              "trace": {"steps": 20, "summary": {"kernels": kernels}}}
    assert reader.read(layers) == pytest.approx(1e3 * 0.010 / 20,
                                                rel=1e-12)
    for name in list(kernels):
        if "maxpool1d_" in name:
            del kernels[name]
    assert reader.read(layers) is None
    assert reader.read({"kind": "train", "trace": None}) is None
    assert reader.read({"kind": "predict", "trace": layers["trace"]}) is None


# -- on the card -------------------------------------------------------

BATCH = 384
# (C, T, pool, stride) of every pool of xception_with_attention (11) and
# conv_1d_mfcc_and_raw (10) at batch 384, all SAME
STEP_SHAPES = sorted({
    (128, 399, 3, 2), (256, 200, 3, 2), (256, 100, 3, 1), (384, 100, 3, 2),
    (160, 96, 3, 1), (192, 96, 3, 2), (192, 48, 3, 1), (256, 48, 3, 2),
    (256, 24, 3, 1), (320, 24, 3, 2), (320, 12, 3, 1), (384, 12, 3, 2),
    (384, 6, 3, 1)})
# every zoo model that pools: the stacked ladders, multi-time-sliced, the
# Inceptions, the residual trunks, the 2-D models' W pass
POOLING_MODELS = ("conv_1d_heavy", "conv_1d_log_mfcc", "conv_1d_mfcc_and_raw",
                  "conv_1d_multi_time_sliced", "conv_1d_residual",
                  "conv_1d_spectrogram", "conv_1d_time_stacked", "conv_2d",
                  "conv_2d_fast", "inception", "inception_d1",
                  "xception_with_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_pair(shape, pool, stride, padding, dtype, device, exact, seed=3):
    out = MP.window(shape[-1], pool, stride, padding)[0]
    if exact:
        x = _draw(RELU6, shape, seed)
        dy = _draw(DYADIC, shape[:-1] + (out,), seed + 1)
    else:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(shape, generator=g)
        dy = torch.randn(shape[:-1] + (out,), generator=g)
    return x.to(device, dtype), dy.to(device, dtype)


def _kernels(x, dy, pool, stride, padding):
    return (MP.maxpool_forward(x, pool, stride, padding),
            MP.maxpool_backward(dy, x, pool, stride, padding))


def _check_against_twin(x, dy, pool, stride, padding, exact):
    before = launch.runs()
    got = _kernels(x, dy, pool, stride, padding)
    want = _twin(x, dy, pool, stride, padding)
    torch.cuda.synchronize()
    assert launch.runs() - before == dict.fromkeys(KERNELS, 1)
    assert got[0].dtype == got[1].dtype == x.dtype
    assert _same(got[0], want[0]), "y"
    if exact:
        assert torch.equal(got[1], want[1]), "dx"
    else:
        gap = (got[1].float() - want[1].float()).abs()
        assert (gap <= torch.finfo(x.dtype).eps
                * want[1].float().abs()).all(), "dx"


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "normal"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", STEP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_the_kernels_match_the_twin_at_the_steps_pools(cuda, shape, dtype,
                                                       exact):
    """y is the twin's to the bit; dx too where every sum is exact, and
    within one rounding of the dtype otherwise (both sum in f32)."""
    c, t, pool, stride = shape
    x, dy = _card_pair((BATCH, c, t), pool, stride, "same", dtype, cuda,
                       exact)
    _check_against_twin(x, dy, pool, stride, "same", exact)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16],
                         ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("case", [
    ((BATCH, 64, 49, 40), 2, 2, "valid"), ((BATCH, 16, 49, 40), 2, 2, "valid"),
    ((64, 48, 1598), 3, 2, "valid"), ((64, 16, 3998), 3, 2, "same"),
    ((64, 64, 96), 1, 1, "same"), ((37, 53), 4, 3, "same"),
    ((37, 53), 5, 2, "valid"), ((5, 7, 3, 30), 5, 1, "same"),
    ((11, 2), 5, 3, "same"), ((3, 1), 3, 1, "same"),
    ((64, 20, 41), 2, 3, "same")],
    ids=["w_pass_conv_2d", "w_pass_conv_2d_fast", "stacked", "multi_sliced",
         "pool1", "p4s3", "p5s2_valid", "p5s1", "short_rows", "one_step",
         "p2s3_gaps"])
def test_the_kernels_take_every_pool(cuda, case, dtype):
    """The 2-D models' W pass, the ladders' pools, and other pools and
    strides up to the longest window the kernels take, a stride longer
    than the pool among them (positions no window covers)."""
    shape, pool, stride, padding = case
    for exact in (True, False):
        x, dy = _card_pair(shape, pool, stride, padding, dtype, cuda, exact)
        _check_against_twin(x, dy, pool, stride, padding, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 399, 3, 2), (384, 6, 3, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_two_runs_give_the_same_bits(cuda, shape):
    c, t, pool, stride = shape
    x, dy = _card_pair((BATCH, c, t), pool, stride, "same", torch.bfloat16,
                       cuda, False)
    first = _kernels(x, dy, pool, stride, "same")
    second = _kernels(x, dy, pool, stride, "same")
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _pooling_input(name, device, batch, seed=0):
    """A zoo model at the golden geometry, on the card, and its input:
    clips, or the features of the port's Frontend."""
    import dataclasses

    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    s = prepare_model_settings(label_count=12)
    if name in ("conv_2d", "conv_2d_fast"):
        s = dataclasses.replace(s, num_log_mel_features=40)
    model, spec = build_model(
        name, num_classes=12, generator=torch.Generator().manual_seed(1),
        spectrogram_length=s.spectrogram_length,
        num_log_mel_features=s.num_log_mel_features,
        spectrogram_frequencies=s.spectrogram_frequencies,
        window_size_samples=s.window_size_samples,
        window_stride_samples=s.window_stride_samples)
    g = torch.Generator().manual_seed(seed)
    clips = (torch.rand(batch, s.desired_samples, generator=g) - 0.5)
    x = Frontend(s).features(clips.to(device), spec.representation)
    return model.to(device), x


@pytest.mark.cuda
@pytest.mark.parametrize("name", POOLING_MODELS)
def test_every_pooling_model_runs_the_kernels(cuda, monkeypatch, name):
    """A train step in f32 (no TF32) at batch 4 runs one forward and one
    backward a pool on the last axis, with finite logits and gradients;
    at each of those pools' inputs, as the step met them, the kernels'
    y is the chain's and their dx the twin's to the bit; in eval mode
    (the TTA Predictor's path), forward runs alone, the logits through
    the kernels are the chain's (the kernels' dtypes emptied) within
    1e-5 of their largest, from the same weights and statistics. (A
    train step's logits are not compared: at batch 4, BatchNorm's batch
    statistics carry a rounding of a gradient-free op to the logits
    whole.)"""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, x = _pooling_input(name, cuda, 4)
    params = [p for p in model.parameters() if p.requires_grad]
    start = copy.deepcopy(model.state_dict())
    seen = []
    chain = L._max_pool_axis

    def recorded(x, pool, stride, padding, dim):
        if dim % x.ndim == x.ndim - 1:
            seen.append((x.detach().clone(), pool, stride, padding))
        return chain(x, pool, stride, padding, dim)

    with monkeypatch.context() as m:
        m.setattr(L, "_max_pool_axis", recorded)
        before = launch.runs()
        y = model.train()(x, torch.Generator(device=cuda).manual_seed(5))
        grads = torch.autograd.grad(y.square().sum(), params)
        torch.cuda.synchronize()
        runs = launch.runs() - before
    assert len(seen) >= 1
    assert {k: runs[k] for k in KERNELS} == dict.fromkeys(KERNELS, len(seen))
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(g).all() for g in grads)
    for i, (xs, pool, stride, padding) in enumerate(seen):
        dy = torch.randn(MP.maxpool_forward(xs, pool, stride, padding).shape,
                         generator=torch.Generator().manual_seed(i))
        dy = dy.to(cuda)
        got = _kernels(xs, dy, pool, stride, padding)
        with monkeypatch.context() as m:
            m.setattr(L, "MAXPOOL_KERNEL_DTYPES", ())
            want_y = chain(xs, pool, stride, padding, -1)
        want_dx = MP.maxpool_backward_plain(dy, xs, pool, stride, padding)
        assert torch.equal(got[0], want_y) and torch.equal(got[1], want_dx)

    def logits(kernels):
        model.load_state_dict(start)
        with monkeypatch.context() as m:
            if not kernels:
                m.setattr(L, "MAXPOOL_KERNEL_DTYPES", ())
            with torch.no_grad():
                return model.eval()(x)

    before = launch.runs()
    got = logits(True)
    runs = launch.runs() - before
    want = logits(False)
    assert {k: runs[k] for k in KERNELS} == {"maxpool1d_fw": len(seen),
                                             "maxpool1d_bw": 0}
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name,pools", [("xception_with_attention", 11),
                                        ("conv_1d_mfcc_and_raw", 10)])
def test_a_replayed_step_runs_each_kernel_once_a_pool(cuda, name, pools):
    """The model's forward and backward under bf16 autocast, captured
    (``launch.capture``) and replayed: the capture runs nothing, a replay
    counts one run of each kernel a pool."""
    model, x = _pooling_input(name, cuda, 16)
    model.train()
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
        body()
    assert launch.runs() == before
    launch.replay(graph)
    torch.cuda.synchronize()
    runs = launch.runs() - before
    assert {k: runs[k] for k in KERNELS} == dict.fromkeys(KERNELS, pools)


@pytest.mark.cuda
def test_the_routing_on_the_card(cuda):
    """The last axis in bfloat16, float16 and float32 runs the kernels;
    float64, ``max_pool_2d``'s H pass and a window longer than the
    kernels take keep the chain."""
    x = _draw(RELU6, (4, 6, 10, 12), 1).to(cuda)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        before = launch.runs()
        y = L.max_pool_1d(x.to(dtype), 3, 2, "same")
        assert launch.runs() - before == {"maxpool1d_fw": 1}
        assert torch.equal(y.cpu(), L.max_pool_1d(x.cpu().to(dtype), 3, 2,
                                                  "same"))
    before = launch.runs()
    L.max_pool_1d(x.double(), 3, 2, "same")
    L._max_pool_axis(x, 2, 2, "valid", 2)
    y = L.max_pool_1d(x, MP.MAX_POOL + 1, 2, "same")
    assert launch.runs() == before
    assert torch.equal(y.cpu(), L.max_pool_1d(x.cpu(), MP.MAX_POOL + 1, 2,
                                              "same"))
    L.max_pool_2d(x, (2, 2))
    assert launch.runs() - before == {"maxpool1d_fw": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "int", "long_window"])
def test_a_cuda_input_the_kernels_do_not_take_raises(cuda, bad):
    x = torch.zeros(2, 3, 8, device=cuda,
                    dtype={"float64": torch.float64,
                           "int": torch.int32}.get(bad, torch.float32))
    pool = MP.MAX_POOL + 1 if bad == "long_window" else 3
    with pytest.raises(ValueError):
        MP.maxpool_forward(x, pool, 2, "same")
