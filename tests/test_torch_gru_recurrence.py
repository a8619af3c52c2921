"""The GRU recurrence kernel (``ops/kernels/gru.py``,
``csrc/gru_recurrence.cu``) and its plain twin, against the loop of
``models/layers.py::GRU`` (``GRU.loop``, the CPU path).

On the CPU, the path a CUDA input takes (``layers.gru_kernel``: the
projections, ``GRURecurrence`` over the plain twin, the weights'
gradients by ``weight_grads``) against autograd of the loop in float64,
output and every gradient (input, input weights and bias, both recurrent
weights): at xception's shape (192 units, 50 steps, 384 channels) and
``conv_1d_simple``'s (128, 10, 224), train mode with the six masks and
eval mode without, one direction forward or reversed and a BiGRU's two,
``return_sequences`` on and off; gate inputs on the hard_sigmoid's edges
(the gradient is inclusive at both, as ``torch.clamp``'s); bf16 operands
under CPU autocast; the wrapper's checks.

On the card (marked ``cuda``; ``-m cuda --noconftest``; this file imports
no jax), at batch 384 and both shapes: the kernel against the loop under
bf16 autocast (no farther from a float64 loop than the loop is) and in
f32, forward and every gradient, with and without ``return_sequences``;
against its plain twin at every dtype pair and a ragged batch; inside a
captured and replayed CUDA graph; its launches; what it refuses;
``tools.model_info``'s FLOPs of the two BiGRU models, the same on the
card as on the CPU.
"""

import copy

import pytest
import torch

from speech_recognition_tpu_torch.models import layers as L
from speech_recognition_tpu_torch.ops.kernels import gru as G
from speech_recognition_tpu_torch.ops.kernels import launch

torch.set_num_threads(1)

# (input channels, units, time steps)
SHAPES = {"xception": (384, 192, 50), "conv_1d_simple": (224, 128, 10)}


def _module(direction, shape, return_sequences, dtype=torch.float64,
            seed=0):
    c, u, _ = SHAPES[shape]
    if direction == "both":
        m = L.BiGRU(c, u, return_sequences, 0.2, 0.2)
    else:
        m = L.GRU(c, u, return_sequences, direction == "reverse", 0.2, 0.2)
    L.init_parameters(m, torch.Generator().manual_seed(seed))
    return m.to(dtype)


def _grus(m):
    return m.directions if isinstance(m, L.BiGRU) else [m]


def _x(shape, batch=3, dtype=torch.float64, device="cpu", seed=1):
    c, _, t = SHAPES[shape]
    x = torch.randn(batch, c, t, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(device=device, dtype=dtype).requires_grad_(True)


def _loop(m, x, generator):
    return torch.cat([g.loop(x, generator) for g in _grus(m)], dim=1)


def _kernel_path(m, x, generator):
    return L.gru_kernel(_grus(m), x, generator)


def _value_and_grads(fn, m, x, seed=3):
    """fn's output and the gradients of a fixed weighting of it: the
    input's, then every parameter's."""
    x.grad = None
    m.zero_grad(set_to_none=True)
    y = fn()
    w = torch.randn(y.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    (y.double() * w.to(y.device)).sum().backward()
    return [y.detach().double()] + [v.grad.double() for v in
                                    [x, *m.parameters()]]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("direction", ["forward", "reverse", "both"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_kernel_path_matches_the_loop_in_float64(shape, train, direction,
                                                     return_sequences):
    m = _module(direction, shape, return_sequences).train(train)
    x = _x(shape)
    want = _value_and_grads(
        lambda: _loop(m, x, torch.Generator().manual_seed(2)), m, x)
    got = _value_and_grads(
        lambda: _kernel_path(m, x, torch.Generator().manual_seed(2)), m, x)
    assert got[0].shape == want[0].shape
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-12


@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_hard_sigmoid_gradient_is_inclusive_at_both_edges(shape):
    """Units whose z and r gate inputs are exactly -2.5 or 2.5 at the
    first step (their input weights 0, their biases there, the state 0):
    0.2 a + 0.5 is exactly 0 or 1 there, and the gradients still match
    autograd of the loop, which passes torch.clamp's gradient at both
    ends."""
    c, u, _ = SHAPES[shape]
    m = _module("forward", shape, True).train()
    edge = torch.arange(0, u, 7)
    with torch.no_grad():
        for gate in (0, 1):
            rows = gate * u + edge
            m.weight[rows] = 0.0
            m.bias[rows] = torch.where(edge % 2 == 0, -2.5, 2.5).double()
    x = _x(shape)
    want = _value_and_grads(
        lambda: m.loop(x, torch.Generator().manual_seed(2)), m, x)
    got = _value_and_grads(
        lambda: _kernel_path(m, x, torch.Generator().manual_seed(2)), m, x)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-12
    xw, rm = m.project(x.detach().transpose(1, 2),
                       torch.Generator().manual_seed(2))
    _, _, (yz, yr, _, _) = G.gru_forward_plain(
        [xw], m.recurrent_weight_zr[None].detach(),
        m.recurrent_weight_h[None].detach(), rm[None], [False])
    for y in (yz, yr):
        first = y[0, :, 0, edge]
        assert ((first == 0) | (first == 1)).all()
        assert (first == 0).any() and (first == 1).any()


@pytest.mark.parametrize("train", [True, False])
def test_bf16_operands_under_cpu_autocast_stay_near_float64(train):
    """Under bf16 autocast the kernel path rounds the products' operands
    to bf16 (train mode: f32 projections, as the loop's; eval: bf16
    ones) and keeps an f32 state."""
    m = _module("both", "conv_1d_simple", False, torch.float32).train(train)
    x = _x("conv_1d_simple", dtype=torch.float32)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = _value_and_grads(
            lambda: _kernel_path(m, x, torch.Generator().manual_seed(2)),
            m, x)
    m64 = copy.deepcopy(m).double()
    x64 = x.detach().double().requires_grad_(True)
    want = _value_and_grads(
        lambda: _loop(m64, x64, torch.Generator().manual_seed(2)), m64, x64)
    for a, b in zip(got, want):
        assert _rel(a, b) < 3e-2


def test_the_loop_is_the_cpu_path():
    m = _module("both", "conv_1d_simple", True).train()
    x = _x("conv_1d_simple")
    launches = launch.runs()
    y = m(x, torch.Generator().manual_seed(2))
    assert torch.equal(y, _loop(m, x, torch.Generator().manual_seed(2)))
    assert launch.runs() == launches


def _inputs(b=4, t=5, u=8, dirs=2):
    xws = [torch.randn(b, t, 3 * u) for _ in range(dirs)]
    return xws, torch.randn(dirs, 2 * u, u), torch.randn(dirs, u, u), \
        torch.rand(dirs, 3, b, u)


@pytest.mark.parametrize("bad", ["xw_shape", "directions", "weights",
                                 "masks", "flags", "dtypes"])
def test_the_wrapper_checks_its_inputs(bad):
    xws, wzr, wh, rm = _inputs()
    reverse = [False, True]
    if bad == "xw_shape":
        xws[1] = xws[1][:, :, :-3]
    elif bad == "directions":
        xws, reverse = xws * 2, reverse * 2
    elif bad == "weights":
        wzr = wzr[:, :, :-1]
    elif bad == "masks":
        rm = rm[:, :2]
    elif bad == "flags":
        reverse = [False]
    else:
        wh = wh.double()
    with pytest.raises(ValueError):
        G.gru_recurrence(xws, wzr, wh, rm, reverse)


# -- on the card -------------------------------------------------------

BATCH = 384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_card(fn, m, x, seed=5, bf16=False):
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
        return _value_and_grads(lambda: fn(m, x, gen), m, x)


@pytest.mark.cuda
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("mode", ["bf16_train", "f32_train", "f32_eval"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_kernel_holds_to_the_loop_on_the_card(cuda, shape, mode,
                                                  return_sequences):
    """Output and every gradient of a BiGRU at batch 384: in f32 the
    kernel and the loop within 1e-4 of the largest value; under bf16
    autocast the kernel no farther from the loop in float64 than the
    loop under autocast is (the issue's "nowhere lower")."""
    m = _module("both", shape, return_sequences, torch.float32).to(cuda)
    m.train(mode != "f32_eval")
    x = _x(shape, BATCH, torch.float32, cuda)
    bf16 = mode == "bf16_train"
    got = _on_card(_kernel_path, m, x, bf16=bf16)
    loop = _on_card(_loop, m, x, bf16=bf16)
    m64 = copy.deepcopy(m).double()
    x64 = x.detach().double().requires_grad_(True)
    want = _on_card(_loop, m64, x64)
    names = ["y", "dx"] + [n for n, _ in m.named_parameters()]
    errs = {n: (_rel(a, w), _rel(b, w))
            for n, a, b, w in zip(names, got, loop, want)}
    for n, (kernel, plain) in errs.items():
        if bf16:
            assert kernel <= 1.25 * plain + 1e-3, (n, errs)
        else:
            assert kernel < 1e-4 and plain < 1e-4, (n, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32)])
@pytest.mark.parametrize("batch", [BATCH, 37])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_kernels_match_their_plain_twin(cuda, shape, batch, dtypes):
    """Both directions (the second reversed) with masks: the forward's
    last state, states and saves, and the backward's input-projection
    gradient from both output gradients, against the plain twin on the
    card at the same dtypes: 1e-5 of the largest value with f32
    operands, 2e-2 with bf16 ones (a sum in another order may round an
    operand the other way)."""
    op, io = dtypes
    _, u, t = SHAPES[shape]
    g = torch.Generator().manual_seed(4)
    xws = [torch.randn(batch, t, 3 * u, generator=g).to(cuda, io)
           for _ in range(2)]
    # the scale of the orthogonal init: larger weights make a chaotic
    # recurrence that grows one operand's rounding over the steps
    wzr = (torch.randn(2, 2 * u, u, generator=g) / u ** 0.5).to(cuda, op)
    wh = (torch.randn(2, u, u, generator=g) / u ** 0.5).to(cuda, op)
    rm = (torch.rand(2, 3, batch, u, generator=g) > 0.2).float().to(cuda)
    rm = rm / 0.8
    reverse = (False, True)
    got = G.gru_forward(xws, wzr, wh, rm, reverse)
    want = G.gru_forward_plain(xws, wzr, wh, rm, reverse)
    tol = 1e-5 if op == torch.float32 else 2e-2
    flat = lambda r: [r[0].float(), r[1]] + [v.float() for v in r[2]]
    for a, b in zip(flat(got), flat(want)):
        assert _rel(a, b) < tol
    dlast = torch.randn(got[0].shape, generator=g).to(cuda, io)
    dhseq = torch.randn(got[1].shape, generator=g).to(cuda)
    saves = want[2][:3]
    dxw = G.gru_backward(dlast, dhseq, wzr, wh, rm, reverse, want[1],
                         *saves, io)
    dxw_plain = G.gru_backward_plain(dlast, dhseq, wzr, wh, rm, reverse,
                                     want[1], *saves, io)
    assert _rel(dxw.float(), dxw_plain.float()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_kernels_replay_in_a_cuda_graph(cuda, shape):
    """A BiGRU's forward and backward under bf16 autocast, with its
    masks, captured and replayed, against the same step run eagerly
    from the same generator state; the capture's launches run nothing
    and count one run each at each replay (``launch.replay``)."""
    m = _module("both", shape, False, torch.float32).to(cuda).train()
    x = _x(shape, BATCH, torch.float32, cuda)
    gen = torch.Generator(device=cuda)
    params = list(m.parameters())

    def body():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = m.run(x, gen)
        grads = torch.autograd.grad(y.float().square().sum(), [x, *params])
        return [y.float(), *grads]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    before = launch.runs()
    with launch.capture(graph):
        out = body()
    assert launch.runs() == before
    gen.manual_seed(11)
    want = [v.clone() for v in body()]
    eager = launch.runs()
    gen.manual_seed(11)
    launch.replay(graph)
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert _rel(a, b) < 1e-5
    one_pass = {"gru_forward": 1, "gru_backward": 1}
    assert eager - before == one_pass
    assert launch.runs() - eager == one_pass


@pytest.mark.cuda
def test_a_bigru_call_launches_once_a_pass(cuda):
    m = _module("both", "xception", False, torch.float32).to(cuda).train()
    x = _x("xception", 16, torch.float32, cuda)
    gen = torch.Generator(device=cuda)
    before = launch.runs()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = m(x, gen)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert launch.runs() - before == {"gru_forward": 1, "gru_backward": 1}
    before = launch.runs()
    with torch.no_grad():
        m.directions[1](x, gen)
    assert launch.runs() - before == {"gru_forward": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "float16", "units"])
def test_a_cuda_input_the_kernel_does_not_take_raises(cuda, case):
    if case == "units":
        m = L.BiGRU(24, 96)
        L.init_parameters(m, torch.Generator().manual_seed(0))
        m, x = m.to(cuda), torch.randn(4, 24, 5, device=cuda)
    else:
        m = _module("both", "conv_1d_simple", False, torch.float32).to(cuda)
        x = _x("conv_1d_simple", 4, torch.float32, cuda)
    m.eval()
    with pytest.raises(ValueError):
        if case == "float64":
            m.double()(x.double())
        elif case == "float16":
            with torch.autocast("cuda", dtype=torch.float16):
                m(x)
        else:
            m(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xception_with_attention",
                                  "conv_1d_simple"])
def test_model_info_counts_the_recurrence_on_the_card(cuda, name):
    """``tools.model_info``'s forward FLOPs of a BiGRU model are the same
    with ``--device cuda`` as on the CPU, the recurrent products
    included, though on the card they run in the kernel."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.tools import model_info

    s = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation="raw")
    on_card = model_info.model_info(name, s, device=cuda)
    on_cpu = model_info.model_info(name, s)
    assert on_card["forward_flops_per_clip"] == \
        on_cpu["forward_flops_per_clip"]
