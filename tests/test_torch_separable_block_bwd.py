"""Port's fused separable block backward and its autograd function vs the
JAX Pallas backward and custom VJP.

The CUDA kernel runs only on a card; here ``separable_block_bwd`` takes
its plain PyTorch version (CPU tensors), which is what the kernel is held
against on the card (tests/test_torch_cuda.py, chip_smoke.py). The JAX
kernels run in interpret mode, as tests/test_separable_kernel.py runs
them.

Tolerances, per output, against the largest |value| of the reference:
- float32, 1e-5: both sides take the same products; only the order of
  the f32 sums differs (measured up to 8e-7).
- bfloat16: dx within 2^-6 |dx| + 2^-8 max|dx| and the f32 sums dw_dw,
  dw_pw, da, db within 1e-3, the card's bounds (chip_smoke.py). Both
  sides round at the same points, but a different f32 sum can flip ddw
  to the neighbouring bf16 value, which moves one tap piece of dx and
  one term of each sum by a bf16 step (measured here: dx exact, the sums
  within 1.5e-7).
- gradients of the whole block against torch autograd of
  ``reference_block``: 5e-4 (the JAX test's own bound; the kernel
  recomputes the depthwise chain in another order than autodiff).
- the float64 numpy loop: 1e-5, float32 against float64.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops.pallas.experiments import (
    separable_kernel as J,
)
from speech_recognition_tpu_torch.export.benchmark import (
    SEPARABLE_SHAPES, benchmark_separable_block_grads,
)
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.ops.kernels import separable_block as K

torch.set_num_threads(1)

CASES = [
    # (T, Cin, Cout, stride, padding) — those of tests/test_separable_kernel.py
    (47, 128, 128, 1, "VALID"),
    (39, 128, 192, 2, "SAME"),
    (21, 256, 320, 2, "SAME"),
    (11, 384, 512, 2, "SAME"),
    (9, 512, 512, 1, "VALID"),
]
# the card tests' ragged shapes (tests/test_torch_cuda.py): B * To no
# multiple of the kernel's tiles, Cin and Cout no multiples of 16 or of 8,
# SAME at stride 2 with an asymmetric pad (T = 40) and a symmetric one; no
# VALID stride-2 shape with T - k odd, where the JAX backward raises
RAGGED = [
    (37, 40, 56, 1, "VALID"),
    (37, 40, 56, 2, "SAME"),
    (40, 40, 56, 2, "SAME"),
    (37, 40, 56, 1, "SAME"),
    (37, 40, 56, 2, "VALID"),
    (37, 36, 44, 2, "SAME"),
]
F32_RTOL = 1e-5
BF16_DX_RTOL, BF16_DX_ATOL = 2.0 ** -6, 2.0 ** -8
BF16_SUM_RTOL = 1e-3
GRAD_RTOL = 5e-4
NAMES = ("dx", "dw_dw", "dw_pw", "da", "db")


def _inputs(t, cin, cout, batch=4, seed=0):
    """Numpy inputs at the JAX test's scales, and cotangents dy, ds1, ds2
    at its scales (N(0, 1), 0.01 N(0, 1), 0.001 N(0, 1))."""
    rng = np.random.default_rng(seed + 7 * t + cin)
    x = rng.standard_normal((batch, t, cin)).astype(np.float32)
    w_dw = (rng.standard_normal((3, 1, cin)) * 0.2).astype(np.float32)
    w_pw = (rng.standard_normal((1, cin, cout)) * 0.1).astype(np.float32)
    a = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    b = (rng.standard_normal(cin) * 0.1).astype(np.float32)
    return x, w_dw, w_pw, a, b


def _cotangents(batch, t_out, cout, seed=99):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, t_out, cout)).astype(np.float32),
            (rng.standard_normal(cout) * 0.01).astype(np.float32),
            (rng.standard_normal(cout) * 0.001).astype(np.float32))


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _close(got, want, of_max, name, rtol=0.0):
    """|got - want| <= rtol |want| + of_max max|want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=of_max * np.abs(want).max(), err_msg=name)


def _bwd_both(t, cin, cout, s, pad, dtype, prologue=True, seed=0, batch=4):
    """(port, JAX) backward of one case on identical inputs; y is the
    port's rounded forward output, handed to both."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, w_dw, w_pw, a, b = _inputs(t, cin, cout, batch=batch, seed=seed)
    t_out, _ = K.out_len(t, 3, s, pad)
    dy, ds1, ds2 = _cotangents(x.shape[0], t_out, cout)
    tx = torch.from_numpy(x).to(dtype)
    ab = [torch.from_numpy(a), torch.from_numpy(b)] if prologue else [None] * 2
    w = [torch.from_numpy(w_dw), torch.from_numpy(w_pw)]
    y = K.fused_separable_block(tx, *w, *ab, stride=s, padding=pad)[0]
    got = K.separable_block_bwd(tx, y, torch.from_numpy(dy).to(dtype),
                                torch.from_numpy(ds1), torch.from_numpy(ds2),
                                *w, *ab, stride=s, padding=pad)
    want = J._fused_block_bwd_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(_f32(y)).astype(jdt),
        jnp.asarray(dy).astype(jdt), jnp.asarray(ds1), jnp.asarray(ds2),
        jnp.asarray(a) if prologue else None,
        jnp.asarray(b) if prologue else None,
        jnp.asarray(w_dw), jnp.asarray(w_pw), stride=s, padding=pad,
        prologue=prologue, interpret=True)
    return got, want


@pytest.mark.parametrize("t,cin,cout,s,pad", CASES)
@pytest.mark.parametrize("prologue", [True, False])
def test_plain_bwd_matches_pallas_kernel_f32(t, cin, cout, s, pad,
                                             prologue):
    got, want = _bwd_both(t, cin, cout, s, pad, torch.float32, prologue)
    assert got[0].dtype == torch.float32
    for name, g, w in zip(NAMES, got, want):
        if name in ("da", "db") and not prologue:
            assert g is None
            continue
        assert g.dtype == torch.float32
        _close(g, w, F32_RTOL, name)


@pytest.mark.parametrize("t,cin,cout,s,pad", [CASES[0], CASES[1], CASES[3]])
def test_plain_bwd_matches_pallas_kernel_bf16(t, cin, cout, s, pad):
    got, want = _bwd_both(t, cin, cout, s, pad, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    _close(got[0], want[0], BF16_DX_ATOL, "dx", rtol=BF16_DX_RTOL)
    for name, g, w in zip(NAMES[1:], got[1:], want[1:]):
        assert g.dtype == torch.float32
        _close(g, w, BF16_SUM_RTOL, name)


@pytest.mark.parametrize("t,cin,cout,s,pad", RAGGED)
@pytest.mark.parametrize("prologue", [True, False])
def test_plain_bwd_matches_pallas_kernel_at_ragged_shapes_f32(t, cin, cout, s,
                                                              pad, prologue):
    got, want = _bwd_both(t, cin, cout, s, pad, torch.float32, prologue,
                          batch=7)
    for name, g, w in zip(NAMES, got, want):
        if name in ("da", "db") and not prologue:
            assert g is None
            continue
        _close(g, w, F32_RTOL, name)


@pytest.mark.parametrize("t,cin,cout,s,pad", [RAGGED[1], RAGGED[2],
                                              RAGGED[5]])
def test_plain_bwd_matches_pallas_kernel_at_ragged_shapes_bf16(t, cin, cout,
                                                               s, pad):
    got, want = _bwd_both(t, cin, cout, s, pad, torch.bfloat16, batch=3)
    _close(got[0], want[0], BF16_DX_ATOL, "dx", rtol=BF16_DX_RTOL)
    for name, g, w in zip(NAMES[1:], got[1:], want[1:]):
        _close(g, w, BF16_SUM_RTOL, name)


def test_chip_smoke_bounds_per_trunk_shape():
    """``chip_smoke.separable_bound`` at batch 384 gives the backward's
    bytes, FLOP and bound of each trunk shape (3.35 TB/s, 989 TFLOP/s
    bf16: every shape bound by bytes), and ``separable_bounds`` their sum,
    0.2394 ms. Computed from shapes alone, on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # (MB, GFLOP of the two products, bound ms) per trunk shape
    want = [(156.6, 9.99, 0.0467), (136.9, 7.51, 0.0409),
            (117.0, 11.15, 0.0349), (97.3, 7.47, 0.0291),
            (77.5, 9.76, 0.0231), (62.7, 6.17, 0.0187),
            (47.8, 7.39, 0.0143), (38.0, 4.53, 0.0113),
            (28.0, 4.98, 0.0084), (22.8, 3.32, 0.0068),
            (17.3, 3.62, 0.0052)]
    for shape, (mb, gflop, ms) in zip(SEPARABLE_SHAPES, want):
        t, cin, cout, stride, padding = shape
        got_ms, by, nbytes, flops = smoke.separable_bound(shape, 384,
                                                          backward=True)
        to = K.out_len(t, 3, stride, padding)[0]
        assert by == "bytes", shape
        assert round(nbytes / 1e6, 1) == mb, shape
        assert round(4 * 384 * to * cin * cout / 1e9, 2) == gflop, shape
        assert flops > 4 * 384 * to * cin * cout, shape
        assert round(got_ms, 4) == ms, shape
    total, by = smoke.separable_bounds(SEPARABLE_SHAPES, 384, backward=True)
    assert round(total, 4) == 0.2394 and by == "bytes"


def _torch_grads(fn, x, a, b, w_dw, w_pw, dy, ds1, ds2):
    """Gradients of <y, dy> + <s1, ds1> + <s2, ds2> w.r.t. the five
    tensors, through ``torch.autograd.grad``."""
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, a, b, w_dw,
                                                          w_pw)]
    y, s1, s2 = fn(*ins)
    return torch.autograd.grad(
        (y, s1, s2), ins, (torch.from_numpy(dy), torch.from_numpy(ds1),
                           torch.from_numpy(ds2)))


def _reference(s, pad):
    return lambda x, a, b, w_dw, w_pw: K.reference_block(
        x, w_dw, w_pw, a, b, stride=s, padding=pad)


@pytest.mark.parametrize("t,cin,cout,s,pad", CASES)
def test_vjp_matches_jax_grad_and_autograd(t, cin, cout, s, pad):
    x, w_dw, w_pw, a, b = _inputs(t, cin, cout, seed=1)
    t_out, _ = K.out_len(t, 3, s, pad)
    dy, ds1, ds2 = _cotangents(4, t_out, cout)
    got = _torch_grads(
        lambda *v: K.fused_separable_block_vjp(*v, s, pad), x, a, b, w_dw,
        w_pw, dy, ds1, ds2)

    def loss(*v):
        y, s1, s2 = J.fused_separable_block_vjp(*v, s, pad, True)
        return (y * dy).sum() + (s1 * ds1).sum() + (s2 * ds2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, a, b, w_dw, w_pw)))
    auto = _torch_grads(_reference(s, pad), x, a, b, w_dw, w_pw, dy, ds1,
                        ds2)
    for name, g, w, r in zip(("dx", "da", "db", "dw_dw", "dw_pw"), got, want,
                             auto):
        assert g.shape == w.shape == r.shape and g.dtype == torch.float32
        _close(g, w, F32_RTOL, name)
        _close(g, r, GRAD_RTOL, name)


def test_vjp_grads_take_the_input_dtypes():
    x, w_dw, w_pw, a, b = (torch.from_numpy(v) for v in
                           _inputs(21, 64, 96, seed=2))
    ins = [x.bfloat16(), a, b, w_dw.bfloat16(), w_pw]
    for v in ins:
        v.requires_grad_()
    y, s1, s2 = K.fused_separable_block_vjp(*ins, 2, "SAME")
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    grads = torch.autograd.grad((y.float() * y.float()).sum() + s1.sum(),
                                ins)
    for g, v in zip(grads, ins):
        assert g.shape == v.shape and g.dtype == v.dtype
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("used", ["y_sum", "s1", "s2", "y_strided"])
def test_vjp_takes_missing_and_expanded_cotangents(used):
    """Autograd hands None for unused outputs and expanded or strided
    cotangents for used ones; the gradient is that of the reference."""
    x, w_dw, w_pw, a, b = _inputs(22, 32, 48, seed=3)

    def loss(fn):
        def f(*v):
            y, s1, s2 = fn(*v)
            return {"y_sum": lambda: y.sum(), "s1": lambda: s1[::2].sum(),
                    "s2": lambda: (s2 * 0.5).sum(),
                    "y_strided": lambda: y[:, ::2].sum()}[used]()
        return f

    def grads(fn):
        ins = [torch.from_numpy(v).requires_grad_() for v in (x, a, b, w_dw,
                                                              w_pw)]
        return torch.autograd.grad(loss(fn)(*ins), ins)

    got = grads(lambda *v: K.fused_separable_block_vjp(*v, 2, "SAME"))
    want = grads(_reference(2, "SAME"))
    for name, g, w in zip(("dx", "da", "db", "dw_dw", "dw_pw"), got, want):
        _close(g, w, GRAD_RTOL, name)


def test_relu6_mask_is_strict():
    """Where x * a + b is exactly 0 or 6 the kernel passes no gradient, as
    the JAX kernel's mask (separable_kernel.py:375); torch.clamp's autograd
    passes it there."""
    x, w_dw, w_pw, _, _ = _inputs(16, 8, 12, seed=4)
    a, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    x[:, 3, :4] = 0.0
    x[:, 5, 4:] = 6.0
    t_out, _ = K.out_len(16, 3, 1, "SAME")
    dy, ds1, ds2 = _cotangents(4, t_out, 12)
    tx, tw = torch.from_numpy(x), [torch.from_numpy(w_dw),
                                   torch.from_numpy(w_pw)]
    kw = dict(stride=1, padding="SAME")
    y = K.fused_separable_block(tx, *tw, torch.from_numpy(a),
                                torch.from_numpy(b), **kw)[0]
    cts = [torch.from_numpy(v) for v in (dy, ds1, ds2)]
    dx = K.separable_block_bwd(tx, y, *cts, *tw, torch.from_numpy(a),
                               torch.from_numpy(b), **kw)[0]
    # the gradient that reaches relu6's output: the no-prologue backward
    # of xin = relu6(x) (here x itself: a = 1, b = 0, x in [0, 6] there)
    dxin = K.separable_block_bwd(tx.clamp(0, 6), y, *cts, *tw, **kw)[0]
    on_edge = torch.zeros_like(tx, dtype=torch.bool)
    on_edge[:, 3, :4] = on_edge[:, 5, 4:] = True
    assert (dxin[on_edge].abs() > 1e-3).all()
    assert (dx[on_edge] == 0).all()
    torch.testing.assert_close(dx[~on_edge & (tx > 0) & (tx < 6)],
                               dxin[~on_edge & (tx > 0) & (tx < 6)])
    want = J._fused_block_bwd_pallas(
        *(jnp.asarray(v) for v in (x, _f32(y), dy, ds1, ds2, a, b, w_dw,
                                   w_pw)), prologue=True, interpret=True,
        **kw)
    _close(dx, want[0], F32_RTOL, "dx")
    auto = _torch_grads(_reference(1, "SAME"), x, a, b, w_dw, w_pw, dy, ds1,
                        ds2)[0]
    assert (auto[on_edge] != 0).all()


def _numpy_grads(x, a, b, w_dw, w_pw, dy, ds1, ds2, stride, pad_lo, t_out):
    """float64 numpy loops: the gradients of <y, dy> + <s1, ds1> +
    <s2, ds2> w.r.t. (x, a, b, w_dw, w_pw) for the block with the
    prologue."""
    x, a, b, w_dw, w_pw = (np.asarray(v, np.float64)
                           for v in (x, a, b, w_dw, w_pw))
    bsz, t, cin = x.shape
    k = w_dw.shape[0]
    pre = x * a + b
    rows = max((t_out - 1) * stride + k, pad_lo + t)
    xp = np.zeros((bsz, rows, cin))
    xp[:, pad_lo:pad_lo + t] = np.clip(pre, 0.0, 6.0)
    dw = np.zeros((bsz, t_out, cin))
    for to in range(t_out):
        for i in range(k):
            dw[:, to] += xp[:, to * stride + i] * w_dw[i, 0]
    y = dw @ w_pw[0]
    g = dy + ds1 + 2.0 * y * ds2
    ddw = g @ w_pw[0].T
    dwdw = np.zeros((k, 1, cin))
    dxp = np.zeros_like(xp)
    for to in range(t_out):
        for i in range(k):
            dwdw[i, 0] += (xp[:, to * stride + i] * ddw[:, to]).sum(0)
            dxp[:, to * stride + i] += ddw[:, to] * w_dw[i, 0]
    dpre = dxp[:, pad_lo:pad_lo + t] * ((pre > 0) & (pre < 6))
    return (dpre * a, (dpre * x).sum((0, 1)), dpre.sum((0, 1)), dwdw,
            np.einsum("btc,btn->cn", dw, g)[None])


def test_odd_valid_stride2_shape_gets_the_gradient_jax_cannot():
    """T = 10, k = 3, stride 2, VALID: the last input row feeds no output.
    The JAX backward slices past its padded buffer there and raises
    (ROADMAP C); the port gives that row a zero gradient."""
    t, cin, cout, s, pad = 10, 8, 16, 2, "VALID"
    x, w_dw, w_pw, a, b = _inputs(t, cin, cout, batch=2, seed=5)
    t_out, pad_lo = K.out_len(t, 3, s, pad)
    assert (t_out - 1) * s + 3 < t
    dy, ds1, ds2 = _cotangents(2, t_out, cout)
    got = _torch_grads(lambda *v: K.fused_separable_block_vjp(*v, s, pad),
                       x, a, b, w_dw, w_pw, dy, ds1, ds2)
    auto = _torch_grads(_reference(s, pad), x, a, b, w_dw, w_pw, dy, ds1,
                        ds2)
    loops = _numpy_grads(x, a, b, w_dw, w_pw, dy, ds1, ds2, s, pad_lo, t_out)
    for name, g, r, n in zip(("dx", "da", "db", "dw_dw", "dw_pw"), got, auto,
                             loops):
        _close(g, r, GRAD_RTOL, name)
        _close(g, n, F32_RTOL, name)
    assert (got[0][:, -1] == 0).all() and (got[0][:, -2] != 0).any()
    with pytest.raises(TypeError, match="slice"):
        jax.grad(lambda *v: J.fused_separable_block_vjp(
            *v, s, pad, True)[0].sum(), argnums=0)(
                *(jnp.asarray(v) for v in (x, a, b, w_dw, w_pw)))


class _PlainPair(torch.autograd.Function):
    """The two plain versions as one differentiable block (float64)."""

    @staticmethod
    def forward(ctx, x, a, b, w_dw, w_pw, stride, padding):
        y, s1, s2 = K.separable_block_plain(x, w_dw, w_pw, a, b,
                                            stride=stride, padding=padding)
        ctx.save_for_backward(x, a, b, w_dw, w_pw, y)
        ctx.conv = dict(stride=stride, padding=padding)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, a, b, w_dw, w_pw, y = ctx.saved_tensors
        dx, dw_dw, dw_pw, da, db = K.separable_block_bwd_plain(
            x, y, dy, ds1, ds2, w_dw, w_pw, a, b, **ctx.conv)
        return (dx, da, db, dw_dw.reshape(w_dw.shape),
                dw_pw.reshape(w_pw.shape), None, None)


@pytest.mark.parametrize("t,s,pad", [(7, 2, "SAME"), (8, 1, "VALID"),
                                     (10, 2, "VALID")])
def test_gradcheck_of_the_plain_pair_in_float64(t, s, pad):
    x, w_dw, w_pw, a, b = (torch.from_numpy(v).double().requires_grad_()
                           for v in _inputs(t, 3, 4, batch=2, seed=6))
    assert torch.autograd.gradcheck(
        lambda *v: _PlainPair.apply(*v, s, pad), (x, a, b, w_dw, w_pw))
    out = _PlainPair.apply(x, a, b, w_dw, w_pw, s, pad)
    assert all(v.dtype == torch.float64 for v in out)


def _bwd_args(**over):
    x, w_dw, w_pw, a, b = (torch.from_numpy(v) for v in _inputs(9, 16, 24))
    y = K.fused_separable_block(x, w_dw, w_pw, a, b)[0]
    dy, ds1, ds2 = (torch.from_numpy(v) for v in _cotangents(4, 7, 24))
    args = dict(x=x, y=y, dy=dy, ds1=ds1, ds2=ds2, w_dw=w_dw, w_pw=w_pw, a=a,
                b=b)
    args.update(over)
    return args


@pytest.mark.parametrize("case", [
    "x_float64", "y_dtype", "y_shape", "dy_shape", "dy_int", "ds1_shape",
    "ds2_int", "a_without_b", "padding", "meta_dy", "meta_x",
])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(case):
    base = _bwd_args()
    bad = {
        "x_float64": dict(x=base["x"].double()),
        "y_dtype": dict(y=base["y"].bfloat16()),
        "y_shape": dict(y=base["y"][:, 1:]),
        "dy_shape": dict(dy=base["dy"][:, :, 1:]),
        "dy_int": dict(dy=base["dy"].int()),
        "ds1_shape": dict(ds1=base["ds1"][1:]),
        "ds2_int": dict(ds2=base["ds2"].int()),
        "a_without_b": dict(b=None),
        "padding": {},
        "meta_dy": dict(dy=base["dy"].to("meta")),
        "meta_x": {k: v.to("meta") for k, v in base.items()},
    }[case]
    args = _bwd_args(**bad)
    padding = "FULL" if case == "padding" else "VALID"
    with pytest.raises(ValueError):
        K.separable_block_bwd(**args, stride=1, padding=padding)


def test_vjp_requires_the_prologue():
    x, w_dw, w_pw, a, _ = (torch.from_numpy(v) for v in _inputs(9, 16, 24))
    with pytest.raises(ValueError, match="a and b"):
        K.fused_separable_block_vjp(x, a, None, w_dw, w_pw, 1, "VALID")


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    args = _bwd_args()
    dy = torch.cat([args["dy"], args["dy"]], 2)[:, :, ::2]
    assert not dy.is_contiguous()
    before = launch.runs()
    got = K.separable_block_bwd(**dict(args, dy=dy), stride=1,
                                padding="VALID")
    want = K.separable_block_bwd_plain(**dict(args, dy=dy.contiguous()),
                                       stride=1, padding="VALID")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert launch.runs() == before


def test_bwd_takes_an_f32_dy_with_bf16_compute_unrounded():
    args = _bwd_args()
    x = args["x"].bfloat16()
    y = K.fused_separable_block(x, args["w_dw"], args["w_pw"], args["a"],
                                args["b"])[0]
    kw = dict(args, x=x, y=y, stride=1, padding="VALID")
    got = K.separable_block_bwd(**kw)
    # dy + ds1 is formed in f32: rounding dy to bf16 first differs
    rounded = K.separable_block_bwd(**dict(kw, dy=args["dy"].bfloat16()))
    assert not torch.equal(got[2], rounded[2])
    dy32 = args["dy"].bfloat16().float()
    torch.testing.assert_close(
        K.separable_block_bwd(**dict(kw, dy=dy32))[2], rounded[2], rtol=0,
        atol=0)


def test_grads_benchmark_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_separable_block_grads("cpu")
