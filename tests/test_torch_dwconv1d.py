"""The depthwise conv kernels (``ops/kernels/dwconv1d.py``,
``csrc/dwconv1d.cu``), their plain twin and ``models/layers.py::Conv``'s
routing.

On the CPU: the plain twin (``dwconv1d_forward_plain``,
``dwconv1d_backward_plain``: explicit taps with the pad applied inside)
against ``F.pad`` + ``F.conv1d(groups=C)``, values and both gradients, in
float32 and float64, at every depthwise geometry of the zoo with k <= 5
(k 3 and 5, strides 1, 2 and 4, SAME and VALID, odd and even T, the
asymmetric SAME pads, the cells' shortest rows and the longest); the
entry on a CPU tensor as the twin; the wrapper's checks; the tiling the
wrapper picks; which convs the route takes and which keep ``F.conv1d``
(k > 5, grouped pointwise, 2-D, dilation > 1, a bias, the CPU); the
depthwise convs of each cell's model and of the zoo; the kernels' names
in the op class of ATen's; the benchmark's reader.

On the card (marked ``cuda``; ``-m cuda --noconftest``; this file imports
no jax): the kernels against the float64 twin at every depthwise conv of
the five cells' models at batch 384 and at the zoo's odd geometries; two
runs give the same bits; the flagship's captured step holds 11 launches
of each kernel; every zoo model with a depthwise conv through the
kernels; the routing and what the wrapper refuses there.
"""

import functools

import pytest
import torch
import torch.nn.functional as F

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels import dwconv1d as D
from speech_recognition_tpu_torch.ops.kernels import launch

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# every depthwise geometry of the zoo with k <= 5: k 3 and 5; strides 1
# and 2 (the zoo's), 4 (conv_1d_gru's, whose k is longer); SAME and
# VALID; odd and even T: the cells' shortest rows (5, 6), short and long
# ones between, the longest (999). SAME pads asymmetrically at even
# totals over odd ones (12 at stride 2 and k 3: (0, 1); 6 at stride 4
# and k 5: (1, 2))
GEOMETRY = [(k, s, pad, t) for k in (3, 5) for s in (1, 2, 4)
            for pad in ("same", "valid") for t in (5, 6, 11, 12, 999)]
KERNELS = ("dwconv1d_fw", "dwconv1d_bw")
# the benchmark's five models and their depthwise convs (a step runs each
# once forward and once backward)
CELLS = {"conv_1d_time_sliced_with_attention": 11, "steffeNet": 25,
         "xception_with_attention": 23, "conv_1d_mfcc_and_raw": 20,
         "conv_1d_simple": 13}
# every zoo model with a 1-D depthwise conv of at most 5 taps, and how many
ZOO = {"conv_1d_gru": 1, "conv_1d_log_mfcc": 21,
       "conv_1d_mfcc_and_raw": 20, "conv_1d_multi_time_sliced": 27,
       "conv_1d_residual": 28, "conv_1d_simple": 13,
       "conv_1d_spectrogram": 21, "conv_1d_time_sliced": 13,
       "conv_1d_time_sliced_group": 21,
       "conv_1d_time_sliced_with_attention": 11, "conv_1d_top_down": 8,
       "steffeNet": 25, "xception_with_attention": 23}


def _pads(t, k, s, pad):
    return same_pad_amount(t, k, s) if pad == "same" else (0, 0)


def _aten(x, w, dy, s, left, right):
    """``Conv.forward``'s path off the route: y, then dx and dw by
    autograd."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    y = F.conv1d(F.pad(x, (left, right)), w, stride=s, groups=x.shape[1])
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    return y.detach(), dx, dw


def _twin(x, w, dy, s, left, right):
    return (D.dwconv1d_forward_plain(x, w, s, left, right),
            *D.dwconv1d_backward_plain(dy, x, w, s, left, right))


def _magnitudes(x, w, dy, s, left, right):
    """Each output's sum of absolute terms, in float64: what a rounding
    of the sum's terms scales with."""
    return _twin(x.double().abs(), w.double().abs(), dy.double().abs(), s,
                 left, right)


def _operands(b, c, t, k, s, pad, dtype, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    left, right = _pads(t, k, s, pad)
    out = D.outputs(t, k, s, left, right)
    x = torch.randn(b, c, t, generator=g, dtype=torch.float64)
    w = torch.randn(c, 1, k, generator=g, dtype=torch.float64)
    dy = torch.randn(b, c, out, generator=g, dtype=torch.float64)
    return (x.to(device, dtype), w.to(device, torch.float32
                                      if device != "cpu" else dtype),
            dy.to(device, dtype), left, right)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,s,pad,t", GEOMETRY)
def test_the_plain_twin_is_aten(k, s, pad, t, dtype):
    """y, dx and dw of the twin are ``F.pad`` + ``F.conv1d``'s: within
    64 roundings of the dtype of each sum's absolute terms (the two sum
    in other orders; dw's sums run over up to 2 x 999 terms)."""
    x, w, dy, left, right = _operands(2, 3, t, k, s, pad, DTYPES[dtype])
    got = _twin(x, w, dy, s, left, right)
    want = _aten(x, w, dy, s, left, right)
    mag = _magnitudes(x, w, dy, s, left, right)
    eps = torch.finfo(DTYPES[dtype]).eps
    for name, a, b, m in zip(("y", "dx", "dw"), got, want, mag):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert ((a.double() - b.double()).abs() <= 64 * eps * m).all(), name


def test_the_twin_keeps_a_bf16_input_dtype_and_sums_in_f32():
    """bfloat16 x (the cells' activations) with a float32 weight: y and
    dx in bfloat16, dw in float32; the sums in float32, so y is the
    float64 sum of the same operands rounded once to bfloat16 but for
    float32's own rounding."""
    x, w, dy, left, right = _operands(3, 4, 37, 5, 2, "same", torch.float32)
    x, dy = x.bfloat16(), dy.bfloat16()
    y = D.dwconv1d_forward_plain(x, w, 2, left, right)
    dx, dw = D.dwconv1d_backward_plain(dy, x, w, 2, left, right)
    assert (y.dtype, dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16,
                                             torch.float32)
    y64 = D.dwconv1d_forward_plain(x.double(), w.double(), 2, left, right)
    gap = (y.double() - y64).abs()
    assert (gap <= 2.0 ** -8 * y64.abs() + 1e-6).all()


def test_the_entry_on_a_cpu_tensor_is_the_twin():
    """``depthwise_conv1d`` on CPU tensors runs the twin, differentiable in
    x and the weight; nothing is launched."""
    x, w, dy, left, right = _operands(2, 5, 21, 3, 2, "same", torch.float64)
    xs, ws = x.requires_grad_(True), w.requires_grad_(True)
    before = launch.runs()
    y = D.depthwise_conv1d(xs, ws, 2, left, right)
    dx, dw = torch.autograd.grad(y, (xs, ws), dy)
    assert launch.runs() == before
    want = _twin(x.detach(), w.detach(), dy, 2, left, right)
    for a, b in zip((y.detach(), dx, dw), want):
        assert torch.equal(a, b)
    # without x's gradient only dw comes back
    _, dw_only = D.dwconv1d_backward(dy, x.detach(), w.detach(), 2, left,
                                     right, input_grad=False)
    assert torch.equal(dw_only, want[2])


@pytest.mark.parametrize("bad", ["2d", "weight_shape", "stride", "pad",
                                 "too_short", "dy_shape", "integer"])
def test_the_wrapper_checks_its_inputs(bad):
    x, w, dy = torch.zeros(2, 3, 8), torch.zeros(3, 1, 3), torch.zeros(2, 3, 8)
    args = {"2d": (x[0], w, 1, 1, 1), "weight_shape": (x, w[:2], 1, 1, 1),
            "stride": (x, w, 0, 1, 1), "pad": (x, w, 1, -1, 1),
            "too_short": (x[..., :2], w, 1, 0, 0),
            "dy_shape": (x, w, 2, 1, 1),
            "integer": (x.long(), w, 1, 1, 1)}[bad]
    with pytest.raises(ValueError):
        if bad == "dy_shape":
            D.dwconv1d_backward(dy, *args)
        else:
            D.dwconv1d_forward(*args)


def _build(name):
    """A zoo model at the default geometry on the CPU, its spec and the
    settings."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.models.zoo import build_model

    s = prepare_model_settings(label_count=12)
    model, spec = build_model(
        name, num_classes=12, generator=torch.Generator().manual_seed(1),
        spectrogram_length=s.spectrogram_length,
        num_log_mel_features=s.num_log_mel_features,
        spectrogram_frequencies=s.spectrogram_frequencies,
        window_size_samples=s.window_size_samples,
        window_stride_samples=s.window_stride_samples)
    return model, spec, s


def _model(name):
    """A zoo model at the default geometry on the CPU, and an input of
    its representation at batch 2."""
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    model, spec, s = _build(name)
    clips = torch.rand(2, s.desired_samples,
                       generator=torch.Generator().manual_seed(2)) - 0.5
    return model, Frontend(s).features(clips, spec.representation)


@functools.lru_cache(maxsize=None)
def depthwise_shapes(name):
    """(C, T, k, stride, padding) of each conv of ``name`` that the
    kernels take, in the forward's order (``chip_smoke.dwconv_shapes``,
    which times the kernels at these shapes: one CPU pass at batch 2)."""
    import chip_smoke

    return tuple(chip_smoke.dwconv_shapes(name))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_cells_model_has_its_depthwise_convs(name):
    """The convs the route takes, counted on the module and met by a
    forward pass, with at most 5 taps (3 or 5) each."""
    model, _ = _model(name)
    convs = [m for m in model.modules()
             if isinstance(m, L.Conv) and m.depthwise_1d()]
    shapes = depthwise_shapes(name)
    assert len(convs) == len(shapes) == CELLS[name]
    assert {k for _, _, k, _, _ in shapes} <= {3, 5}
    assert all(conv.weight.shape[1:] == (1, conv.kernel[0])
               for conv in convs)


def test_the_zoo_models_with_depthwise_convs():
    """Every zoo model whose convs the route takes, and how many: 13
    models (the 1-D depthwise convs of longer windows, conv_1d_gru's
    7/15/31 and conv_1d_multi_time_sliced's 11-28, keep ``F.conv1d``)."""
    from speech_recognition_tpu_torch.models.zoo import MODEL_REGISTRY

    found = {}
    for name in sorted(MODEL_REGISTRY):
        count = sum(isinstance(m, L.Conv) and m.depthwise_1d()
                    for m in _build(name)[0].modules())
        if count:
            found[name] = count
    assert found == ZOO and len(ZOO) == 13


def _conv(kind):
    return {
        "depthwise_k3": L.Conv(8, 8, 3, 1, "same", groups=8),
        "depthwise_k5_s2": L.Conv(8, 8, 5, 2, "same", groups=8),
        "depthwise_k1": L.Conv(8, 8, 1, groups=8),
        "depthwise_k7": L.Conv(8, 8, 7, 4, "same", groups=8),
        "depthwise_k28": L.Conv(8, 8, 28, groups=8),
        "grouped_pointwise": L.Conv(8, 8, 1, groups=4),
        "grouped_k3": L.Conv(8, 8, 3, groups=4),
        "depthwise_2d": L.Conv(8, 8, (3, 3), padding="same", groups=8),
        "dilation_2": L.Conv(8, 8, 3, groups=8, dilation=2),
        "bias": L.Conv(8, 8, 3, groups=8, use_bias=True),
        "dense": L.Conv(8, 16, 3),
        "multiplier_2": L.Conv(8, 16, 3, groups=8),
    }[kind]


ROUTED = ("depthwise_k3", "depthwise_k5_s2", "depthwise_k1")


@pytest.mark.parametrize("kind", ["depthwise_k3", "depthwise_k5_s2",
                                  "depthwise_k1", "depthwise_k7",
                                  "depthwise_k28", "grouped_pointwise",
                                  "grouped_k3", "depthwise_2d", "dilation_2",
                                  "bias", "dense", "multiplier_2"])
def test_which_convs_the_route_takes(kind):
    """1-D, groups = in = out channels, no bias, dilation 1 and at most
    ``MAX_TAPS`` taps; every other conv keeps ``F.pad`` + ``F.conv1d``."""
    assert _conv(kind).depthwise_1d() == (kind in ROUTED)


@pytest.mark.parametrize("autocast", [False, True])
@pytest.mark.parametrize("kind", ROUTED)
def test_the_cpu_keeps_f_conv1d(monkeypatch, kind, autocast):
    """On the CPU a conv the kernels would take runs ``F.pad`` +
    ``F.conv1d`` as before (the kernels' entry is never called), under
    CPU autocast too."""
    conv = _conv(kind)
    conv.reset_parameters(torch.Generator().manual_seed(0))

    def refuse(*_):
        raise AssertionError("the CPU took the depthwise kernels")

    monkeypatch.setattr(L, "depthwise_conv1d", refuse)
    x = torch.randn(2, 8, 13, generator=torch.Generator().manual_seed(1))
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        y = conv(x)
    left, right = _pads(13, conv.kernel[0], conv.stride[0], conv.padding)
    want = F.conv1d(F.pad(x, (left, right)), conv.weight,
                    stride=conv.stride, groups=8)
    assert y.shape == want.shape
    if not autocast:
        assert torch.equal(y, want)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", sorted(CELLS) + ["conv_1d_multi_time_sliced"])
def test_the_tiling_at_every_depthwise_conv(name, itemsize):
    """At batch 384 the tile holds at most ``SLOTS`` outputs, a batch
    row's x and dy runs (each with a 16-byte vector of room either side,
    rounded to vectors, as csrc/dwconv1d.cu stages them) fit in
    ``STAGE_BYTES``, the backward's blocks fit one wave of
    ``BACKWARD_BLOCKS`` unless a tile alone outnumbers it, and the
    splits cover the batch once; a row longer than a tile is cut."""
    v = 16 // itemsize

    def room(n):
        return -(-(n + 2 * v) // v) * v

    for c, t, k, s, pad in depthwise_shapes(name):
        left, right = _pads(t, k, s, pad)
        out = D.outputs(t, k, s, left, right)
        cb, tt, per, parts = D.plan(384, c, t, out, k, s, itemsize)
        slices = -(-out // tt)
        tiles = -(-c // cb) * slices
        splits = -(-384 // per)
        assert 1 <= cb <= c and 1 <= tt <= out and cb * tt <= D.SLOTS
        assert cb == 1 or tt == out
        xlen = cb * t if slices == 1 else tt * s + 2 * k
        dlen = cb * out if slices == 1 else tt + k - 1
        assert (room(xlen) + room(dlen)) * itemsize <= D.STAGE_BYTES
        assert tiles * splits <= D.BACKWARD_BLOCKS or splits == 1
        assert per * (splits - 1) < 384 <= per * splits
        assert parts == splits * slices
        if out > D.SLOTS:
            assert slices > 1


KERNEL_NAMES = [
    "dwconv1d_fw_kernel<__nv_bfloat16, 3>(__nv_bfloat16 const*, "
    "float const*, __nv_bfloat16*, (anonymous namespace)::Plan)",
    "dwconv1d_bw_kernel<__nv_bfloat16, 3>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, float const*, __nv_bfloat16*, float*, "
    "(anonymous namespace)::Plan)",
    "dwconv1d_merge_kernel(float const*, float*, int, int)",
]


@pytest.mark.parametrize("reader", ["port", "benchmark"])
@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_the_kernels_fall_in_atens_op_class(kernel, reader):
    """The kernels' names, as the profiler gives them, fall in the op
    class of ATen's depthwise kernels that they replace
    (``convolution``), for the port's trace reader and the benchmark's."""
    if reader == "port":
        from speech_recognition_tpu_torch.utils.profiling import op_class
    else:
        from kws_bench.trace import op_class
    assert op_class(f"void (anonymous namespace)::{kernel}") \
        == op_class("at::native::conv_depthwise2d_backward_kernel") \
        == "convolution"


def test_the_benchmark_reader_sums_the_depthwise_kernels():
    """``depthwise_device_ms_per_step`` reads ATen's depthwise kernels (the
    parent's) and the port's alike, and nothing else."""
    from kws_bench.metrics import depthwise_device_ms_per_step as reader

    names = ["at::native::conv_depthwise2d_forward_kernel_generic",
             "at::native::conv_depthwise2d_grad_weight_kernel"] + [
        f"void (anonymous namespace)::{n}" for n in KERNEL_NAMES]
    kernels = {n: (0.001 * (i + 1), 20) for i, n in enumerate(names)}
    kernels["void at::native::elementwise_kernel<128, 4>(int)"] = (0.5, 9)
    kernels["cutlass::Kernel2"] = (0.25, 20)
    layers = {"kind": "train",
              "trace": {"steps": 20, "summary": {"kernels": kernels}}}
    assert reader.read(layers) == pytest.approx(1e3 * 0.015 / 20,
                                                rel=1e-12)
    for name in names:
        del kernels[name]
    assert reader.read(layers) is None
    assert reader.read({"kind": "train", "trace": None}) is None


# -- on the card -------------------------------------------------------

BATCH = 384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_against_twin(x, w, dy, s, left, right):
    """The kernels' y, dx and dw against the float64 twin on the same
    operands (x and dy in the card's dtype, w float32). y and dx: one
    rounding to x's dtype of the float32 sum (half a step of the dtype at
    the value, or of its subnormals below the smallest normal, which
    float16 reaches at 6.1e-5; the sum of at most k terms within 2^-20 of
    their absolute sum); dw: float32 sums over up to 384 x 999 terms, in a
    fixed tree of at most a few hundred serial steps, within 2^-16 of the
    absolute sum."""
    before = launch.runs()
    y = D.dwconv1d_forward(x, w, s, left, right)
    dx, dw = D.dwconv1d_backward(dy, x, w, s, left, right)
    torch.cuda.synchronize()
    assert launch.runs() - before == dict.fromkeys(KERNELS, 1)
    assert (y.dtype, dx.dtype, dw.dtype) == (x.dtype, x.dtype,
                                             torch.float32)
    want = _twin(x.double(), w.double(), dy.double(), s, left, right)
    mag = _magnitudes(x, w, dy, s, left, right)
    info = torch.finfo(x.dtype)
    for name, got, ref, m, tol in zip(
            ("y", "dx", "dw"), (y, dx, dw), want, mag,
            (2.0 ** -20, 2.0 ** -20, 2.0 ** -16)):
        rounding = 0 if name == "dw" else info.eps / 2 * torch.clamp(
            ref.abs(), min=info.smallest_normal)
        gap = (got.double() - ref).abs()
        assert (gap <= rounding + tol * m).all(), name
    return y, dx, dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_kernels_match_the_twin_at_the_cells_convs(cuda, name, dtype):
    for i, (c, t, k, s, pad) in enumerate(sorted(set(
            depthwise_shapes(name)))):
        x, w, dy, left, right = _operands(BATCH, c, t, k, s, pad, dtype,
                                          cuda, seed=i)
        _check_against_twin(x, w, dy, s, left, right)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16],
                         ids=["bf16", "f32", "f16"])
def test_the_kernels_take_every_geometry(cuda, dtype):
    """The zoo's geometries at a ragged batch and channel count, and rows
    longer than a tile (sliced with their halos): conv_1d_multi_time_
    sliced's 4000 and 3200 steps, and 9000 at stride 3."""
    cases = [(7, 13, t, k, s, pad) for k, s, pad, t in GEOMETRY] + [
        (16, 4, 4000, 3, 1, "valid"), (8, 5, 3200, 3, 1, "valid"),
        (3, 3, 9000, 2, 3, "same"), (5, 448, 16, 5, 2, "same")]
    for i, (b, c, t, k, s, pad) in enumerate(cases):
        x, w, dy, left, right = _operands(b, c, t, k, s, pad, dtype, cuda,
                                          seed=i)
        _check_against_twin(x, w, dy, s, left, right)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 999, 3, 1, "valid"),
                                   (1536, 5, 3, 1, "same"),
                                   (384, 50, 5, 1, "same")],
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_two_runs_give_the_same_bits(cuda, shape):
    """No float atomics: y, dx and dw repeat bit for bit."""
    x, w, dy, left, right = _operands(BATCH, *shape, torch.bfloat16, cuda)
    s = shape[3]
    first = (D.dwconv1d_forward(x, w, s, left, right),
             *D.dwconv1d_backward(dy, x, w, s, left, right))
    second = (D.dwconv1d_forward(x, w, s, left, right),
              *D.dwconv1d_backward(dy, x, w, s, left, right))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_flagships_captured_step_holds_each_kernel_once_a_conv(cuda):
    """The flagship's train step, captured in its CUDA graph: 11
    ``dwconv1d_fw`` and 11 ``dwconv1d_bw`` launches (one a depthwise conv
    and direction), each replay running them once."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    ds = synthetic_device_dataset(cuda, num_train=64, num_val=40,
                                  num_pseudo=8)
    trainer = Trainer("conv_1d_time_sliced_with_attention",
                      prepare_model_settings(label_count=12), ds,
                      batch_size=16)
    state = trainer.init_state()
    before = launch.runs()
    trainer.train_many(state, 3)
    held = launch._GRAPHS[trainer._graph.graph]
    assert {k: held[k] for k in KERNELS} == dict.fromkeys(KERNELS, 11)
    runs = launch.runs() - before
    assert {k: runs[k] for k in KERNELS} == dict.fromkeys(KERNELS, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ZOO))
def test_every_depthwise_model_runs_the_kernels(cuda, monkeypatch, name):
    """A train step in float32 (no TF32) at batch 4 runs one forward and
    one backward a depthwise conv, with finite logits and gradients; in
    eval mode the logits through the kernels are ATen's (the kernels'
    dtypes emptied) within 1e-5 of their largest, from the same weights
    and statistics."""
    import copy

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, x = _model(name)
    model, x = model.to(cuda), x.to(cuda) if torch.is_tensor(x) else tuple(
        v.to(cuda) for v in x)
    params = [p for p in model.parameters() if p.requires_grad]
    start = copy.deepcopy(model.state_dict())
    before = launch.runs()
    y = model.train()(x, torch.Generator(device=cuda).manual_seed(5))
    grads = torch.autograd.grad(y.square().sum(), params)
    torch.cuda.synchronize()
    runs = launch.runs() - before
    assert {k: runs[k] for k in KERNELS} == dict.fromkeys(KERNELS, ZOO[name])
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(g).all() for g in grads)

    def logits(kernels):
        model.load_state_dict(start)
        with monkeypatch.context() as m:
            if not kernels:
                m.setattr(L, "DW_KERNEL_DTYPES", ())
            with torch.no_grad():
                return model.eval()(x)

    got, want = logits(True), logits(False)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_the_routing_on_the_card(cuda):
    """Under bf16 autocast a depthwise conv casts x as ``F.conv1d`` would,
    reads the float32 weight as it is and gives a bfloat16 y and a float32
    weight gradient; float32 and float16 inputs take the kernels too;
    float64, a longer window, a bias, a grouped pointwise conv and a 2-D
    conv keep ATen's."""
    for kind in ROUTED:
        conv = _conv(kind)
        conv.reset_parameters(torch.Generator().manual_seed(0))
        conv = conv.to(cuda)
        x = torch.randn(4, 8, 30, device=cuda, requires_grad=True)
        before = launch.runs()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = conv(x)
        y.float().sum().backward()
        assert launch.runs() - before == dict.fromkeys(KERNELS, 1)
        assert y.dtype == torch.bfloat16
        assert conv.weight.grad.dtype == torch.float32
        assert x.grad.dtype == torch.float32
        for dtype in (torch.float32, torch.float16):
            before = launch.runs()
            assert conv(x.detach().to(dtype)).dtype == dtype
            assert launch.runs() - before == {"dwconv1d_fw": 1}
    before = launch.runs()
    conv64 = _conv("depthwise_k3").double().to(cuda)
    conv64(torch.randn(4, 8, 30, device=cuda, dtype=torch.float64))
    for kind in ("depthwise_k7", "bias", "grouped_pointwise", "dilation_2"):
        _conv(kind).to(cuda)(torch.randn(4, 8, 30, device=cuda))
    _conv("depthwise_2d").to(cuda)(torch.randn(4, 8, 6, 6, device=cuda))
    assert launch.runs() == before


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "f64_weight", "long_window",
                                 "pad_past_the_window"])
def test_a_cuda_input_the_kernels_do_not_take_raises(cuda, bad):
    x = torch.zeros(2, 3, 8, device=cuda,
                    dtype=torch.float64 if bad == "float64" else torch.float32)
    w = torch.zeros(3, 1, D.MAX_TAPS + 1 if bad == "long_window" else 3,
                    device=cuda,
                    dtype=torch.float64 if bad == "f64_weight" else
                    torch.float32)
    left = 3 if bad == "pad_past_the_window" else 1
    with pytest.raises(ValueError):
        D.dwconv1d_forward(x, w, 1, left, 1)
