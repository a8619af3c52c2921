"""Port's fused separable block (forward) vs the JAX Pallas kernel.

The CUDA kernel runs only on a card; here the wrapper takes its plain
PyTorch version (CPU tensors), which is what the kernel is held against
on the card (tests/test_torch_cuda.py, chip_smoke.py). The JAX kernel
runs in interpret mode, as tests/test_separable_kernel.py runs it.

Tolerances:
- float32, atol 2e-5 on y of magnitude ~1 (the JAX test's own bound):
  both sides take the same products in f32; only the order of the
  matrix product's sums differs.
- bfloat16, one bf16 step: |d| <= 2^-7 |y| + 1e-5 (tighter than the
  JAX test's atol 6e-2). Both sides round at the same points; where the
  f32 sums of the matrix product differ in their last bits, y can round
  to the neighbouring bf16 value (~1e-4 of the outputs do).
- statistics: rtol 2e-5, atol 1e-4 against f32 sums of the rounded y.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops.pallas.experiments import (
    separable_kernel as J,
)
from speech_recognition_tpu_torch.export.benchmark import (
    SEPARABLE_SHAPES, benchmark_separable_blocks, separable_block_inputs,
)
from speech_recognition_tpu_torch.ops.framing import same_pad_amount
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.ops.kernels import separable_block as K

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

CASES = [
    # (T, Cin, Cout, stride, padding) — flagship trunk shapes (reduced T),
    # those of tests/test_separable_kernel.py
    (47, 128, 128, 1, "VALID"),
    (39, 128, 192, 2, "SAME"),
    (21, 256, 320, 2, "SAME"),
    (11, 384, 512, 2, "SAME"),
    (9, 512, 512, 1, "VALID"),
]
F32_ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
STATS_RTOL, STATS_ATOL = 2e-5, 1e-4


def _inputs(t, cin, cout, batch=4, seed=0):
    """Numpy inputs at the JAX test's scales."""
    rng = np.random.default_rng(seed + 7 * t + cin)
    x = rng.standard_normal((batch, t, cin)).astype(np.float32)
    w_dw = (rng.standard_normal((3, 1, cin)) * 0.2).astype(np.float32)
    w_pw = (rng.standard_normal((1, cin, cout)) * 0.1).astype(np.float32)
    a = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    b = (rng.standard_normal(cin) * 0.1).astype(np.float32)
    return x, w_dw, w_pw, a, b


def _port(x, w_dw, w_pw, a=None, b=None, dtype=torch.float32, **kw):
    """The wrapper on CPU tensors; x in ``dtype``, the rest as given."""
    args = [torch.from_numpy(x).to(dtype), torch.from_numpy(w_dw),
            torch.from_numpy(w_pw)]
    if a is not None:
        args += [torch.from_numpy(a), torch.from_numpy(b)]
    return K.fused_separable_block(*args, **kw)


def _jax(x, w_dw, w_pw, a=None, b=None, dtype=jnp.float32, **kw):
    args = [jnp.asarray(x).astype(dtype), jnp.asarray(w_dw),
            jnp.asarray(w_pw)]
    if a is not None:
        args += [jnp.asarray(a), jnp.asarray(b)]
    return J.fused_separable_block(*args, interpret=True, **kw)


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _assert_stats(y, s1, s2):
    """s1, s2 are the f32 sums of y and of y * y taken in y's dtype."""
    yf = y.float()
    np.testing.assert_allclose(s1.numpy(), yf.sum((0, 1)).numpy(),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    np.testing.assert_allclose(s2.numpy(), (y * y).float().sum((0, 1)),
                               rtol=STATS_RTOL, atol=STATS_ATOL)


@pytest.mark.parametrize("t,cin,cout,s,pad", CASES)
@pytest.mark.parametrize("fold", [False, True])
def test_plain_matches_pallas_kernel_f32(t, cin, cout, s, pad, fold):
    ins = _inputs(t, cin, cout)
    kw = dict(stride=s, padding=pad, fold_weights=fold)
    y, s1, s2 = _port(*ins, **kw)
    yj, s1j, s2j = _jax(*ins, **kw)
    assert y.shape == yj.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(s1.numpy(), _f32(s1j), rtol=STATS_RTOL,
                               atol=STATS_ATOL)
    np.testing.assert_allclose(s2.numpy(), _f32(s2j), rtol=STATS_RTOL,
                               atol=STATS_ATOL)


@pytest.mark.parametrize("t,cin,cout,s,pad", [CASES[0], CASES[1], CASES[3]])
@pytest.mark.parametrize("fold", [False, True])
def test_plain_matches_pallas_kernel_bf16(t, cin, cout, s, pad, fold):
    ins = _inputs(t, cin, cout)
    kw = dict(stride=s, padding=pad, fold_weights=fold)
    y, s1, s2 = _port(*ins, dtype=torch.bfloat16, **kw)
    yj, _, _ = _jax(*ins, dtype=jnp.bfloat16, **kw)
    assert y.dtype == torch.bfloat16 and y.shape == yj.shape
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    _assert_stats(y, s1, s2)


@pytest.mark.parametrize("t,cin,cout,s,pad", CASES)
@pytest.mark.parametrize("prologue", [False, True])
def test_reference_block_matches_jax_reference(t, cin, cout, s, pad,
                                               prologue):
    x, w_dw, w_pw, a, b = _inputs(t, cin, cout, seed=1)
    ab = (a, b) if prologue else (None, None)
    got = K.reference_block(
        torch.from_numpy(x), torch.from_numpy(w_dw), torch.from_numpy(w_pw),
        *[None if v is None else torch.from_numpy(v) for v in ab],
        stride=s, padding=pad)
    want = J.reference_block(
        jnp.asarray(x), jnp.asarray(w_dw), jnp.asarray(w_pw),
        *[None if v is None else jnp.asarray(v) for v in ab],
        stride=s, padding=pad)
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), rtol=0,
                               atol=F32_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), _f32(w), rtol=STATS_RTOL,
                                   atol=STATS_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [False, True])
def test_stats_are_sums_of_the_rounded_output(dtype, fold):
    y, s1, s2 = _port(*_inputs(39, 128, 192, seed=2), dtype=dtype,
                      stride=2, padding="SAME", fold_weights=fold)
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == (192,)
    _assert_stats(y, s1, s2)


@pytest.mark.parametrize("fold", [False, True])
def test_no_prologue_matches_pallas_kernel(fold):
    x, w_dw, w_pw, _, _ = _inputs(23, 128, 128, seed=3)
    kw = dict(stride=1, padding="VALID", fold_weights=fold)
    y, s1, _ = _port(x, w_dw, w_pw, **kw)
    yj, s1j, _ = _jax(x, w_dw, w_pw, **kw)
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(s1.numpy(), _f32(s1j), rtol=STATS_RTOL,
                               atol=STATS_ATOL)


@pytest.mark.parametrize("fold", [False, True])
def test_emit_stats_false_returns_y_alone(fold):
    ins = _inputs(21, 256, 320, seed=4)
    kw = dict(stride=2, padding="SAME", fold_weights=fold)
    y = _port(*ins, emit_stats=False, **kw)
    assert isinstance(y, torch.Tensor)
    torch.testing.assert_close(y, _port(*ins, **kw)[0], rtol=0, atol=0)
    yj = _jax(*ins, emit_stats=False, **kw)
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=0, atol=F32_ATOL)


def _numpy_block(x, w_dw, w_pw, a, b, stride, pad_lo, t_out):
    """f64 numpy: prologue, THEN zero padding, depthwise, pointwise."""
    xin = np.clip(x.astype(np.float64) * a + b, 0.0, 6.0)
    k = w_dw.shape[0]
    bsz, t, cin = x.shape
    xp = np.zeros((bsz, (t_out - 1) * stride + k + t, cin))
    xp[:, pad_lo:pad_lo + t] = xin
    dw = sum(xp[:, i:i + (t_out - 1) * stride + 1:stride] * w_dw[i, 0]
             for i in range(k))
    return dw @ w_pw[0]


@pytest.mark.parametrize("t,s", [(22, 2), (23, 2), (16, 1)])
@pytest.mark.parametrize("fold", [False, True])
def test_same_padding_comes_after_the_prologue(t, s, fold):
    """With b > 0, relu6(b) > 0: a padded row must still be 0."""
    x, w_dw, w_pw, a, _ = _inputs(t, 64, 96, seed=5)
    b = np.full(64, 0.5, np.float32)
    t_out, pad_lo = K.out_len(t, 3, s, "SAME")
    kw = dict(stride=s, padding="SAME", fold_weights=fold)
    y, _, _ = _port(x, w_dw, w_pw, a, b, **kw)
    want = _numpy_block(x, w_dw, w_pw, a, b, s, pad_lo, t_out)
    np.testing.assert_allclose(_f32(y), want, rtol=0, atol=F32_ATOL)
    yj, _, _ = _jax(x, w_dw, w_pw, a, b, **kw)
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=0, atol=F32_ATOL)
    # the case tells the two orders apart: padding relu6(b) moves the ends
    wrong = _numpy_block(np.pad(x, ((0, 0), (pad_lo, t_out * s + 3 - t),
                                    (0, 0)), constant_values=0.0)
                         [:, :(t_out - 1) * s + 3], w_dw, w_pw, a, b, s, 0,
                         t_out)
    assert np.abs(wrong - want).max() > 100 * F32_ATOL


def test_out_len_agrees_with_same_pad_amount_and_jax():
    for t in range(1, 64):
        for k in (1, 3, 5):
            for s in (1, 2, 3):
                t_out, lo = K.out_len(t, k, s, "SAME")
                assert lo == same_pad_amount(t, k, s)[0]
                assert (t_out, lo) == J._out_len(t, k, s, "SAME")
                if t >= k:
                    assert K.out_len(t, k, s, "VALID") == J._out_len(
                        t, k, s, "VALID")
    # SAME at stride 2 is asymmetric: (out, lo), hi = total - lo
    assert K.out_len(397, 3, 2, "SAME") == (199, 1)
    assert same_pad_amount(397, 3, 2) == (1, 1)
    assert K.out_len(22, 3, 2, "SAME") == (11, 0)
    assert same_pad_amount(22, 3, 2) == (0, 1)
    assert K.out_len(399, 3, 1, "VALID") == (397, 0)
    with pytest.raises(ValueError):
        K.out_len(10, 3, 1, "same")


def test_cpu_path_does_not_count_launches():
    before = launch.runs()
    _port(*_inputs(11, 32, 32), stride=2, padding="SAME")
    _port(*_inputs(11, 32, 32), stride=2, padding="SAME",
          fold_weights=False)
    assert launch.runs() == before


def _torch_inputs(**over):
    x, w_dw, w_pw, a, b = (torch.from_numpy(v) for v in _inputs(9, 16, 24))
    ins = dict(x=x, w_dw=w_dw, w_pw=w_pw, a=a, b=b)
    ins.update(over)
    return ins


@pytest.mark.parametrize("case", [
    "x_float64", "x_int", "x_rank2", "w_dw_shape", "w_pw_cin",
    "a_without_b", "a_shape", "w_int", "padding", "stride0", "too_short",
    "meta_weights", "meta_x",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    base = _torch_inputs()
    bad = {
        "x_float64": dict(x=base["x"].double()),
        "x_int": dict(x=base["x"].int()),
        "x_rank2": dict(x=base["x"][0]),
        "w_dw_shape": dict(w_dw=base["w_dw"].reshape(3, 16, 1)),
        "w_pw_cin": dict(w_pw=base["w_pw"][:, :8]),
        "a_without_b": dict(b=None),
        "a_shape": dict(a=base["a"][:8]),
        "w_int": dict(w_pw=base["w_pw"].int()),
        "padding": {},
        "stride0": {},
        "too_short": dict(x=base["x"][:, :2]),
        "meta_weights": dict(w_pw=base["w_pw"].to("meta")),
        "meta_x": {k: v.to("meta") for k, v in base.items()},
    }[case]
    ins = _torch_inputs(**bad)
    kw = dict(stride=1, padding="VALID")
    if case == "padding":
        kw["padding"] = "FULL"
    if case == "stride0":
        kw["stride"] = 0
    with pytest.raises(ValueError):
        K.fused_separable_block(ins["x"], ins["w_dw"], ins["w_pw"],
                                ins["a"], ins["b"], **kw)


def test_wrapper_accepts_bf16_weights_and_non_contiguous_cpu_x():
    ins = _torch_inputs()
    x = torch.cat([ins["x"], ins["x"]], 2)[:, :, ::2]     # strided view
    assert not x.is_contiguous()
    got = K.fused_separable_block(x, ins["w_dw"].bfloat16(),
                                  ins["w_pw"].bfloat16(), ins["a"],
                                  ins["b"])
    want = K.separable_block_plain(x.contiguous(), ins["w_dw"].bfloat16(),
                                   ins["w_pw"].bfloat16(), ins["a"],
                                   ins["b"])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_shapes_match_the_jax_block_benchmark():
    tree = ast.parse((REPO / "scripts/bench_separable_kernel.py").read_text())
    cfgs = next(node.value for node in ast.walk(tree)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "CFGS")
    assert [tuple(c) for c in ast.literal_eval(cfgs)] == SEPARABLE_SHAPES


@pytest.mark.parametrize("shape", SEPARABLE_SHAPES)
def test_slice_shapes_plain_fold_and_fuse_match_jax_reference(shape):
    """Each benchmark shape at batch 2, f32: the port's two plain variants
    and its ATen baseline against the JAX ``reference_block``."""
    t, cin, cout, s, pad = shape
    ins = separable_block_inputs(t, cin, cout, batch=2, dtype=torch.float32)
    want = J.reference_block(*[jnp.asarray(v.numpy()) for v in ins],
                             stride=s, padding=pad)
    outs = [K.fused_separable_block(*ins, stride=s, padding=pad,
                                    fold_weights=fold)
            for fold in (False, True)]
    outs.append(K.reference_block(*ins, stride=s, padding=pad))
    for got in outs:
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), rtol=0,
                                   atol=F32_ATOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), _f32(w), rtol=STATS_RTOL,
                                       atol=STATS_ATOL * 10)


def test_benchmark_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_separable_blocks("cpu")


def test_benchmark_inputs_follow_the_seed_and_dtype():
    x, w_dw, w_pw, a, b = separable_block_inputs(11, 16, 24, batch=3)
    assert x.shape == (3, 11, 16) and x.dtype == torch.bfloat16
    assert w_dw.shape == (3, 1, 16) and w_pw.shape == (1, 16, 24)
    assert w_pw.dtype == torch.bfloat16 and a.dtype == b.dtype == \
        torch.float32
    assert float(a.min()) >= 0.5 and float(a.max()) <= 1.5
    again = separable_block_inputs(11, 16, 24, batch=3)
    for u, v in zip((x, w_dw, w_pw, a, b), again):
        assert torch.equal(u, v)


# ---- the forward kernel's x tile (csrc/separable_block.cu) -------------------
#
# A numpy twin of the kernel's slot table: a block of `tile_rows` flattened
# (b, t_out) output rows from m0 stages each padded input row its rows read
# once; tap i of tile row r is slot row_slot[r] + i, and slot_src[s] is the
# offset in x of the slot's input row, or -1 (outside [0, T), or past the
# last output row), which the kernel writes as 0 (never relu6(b)).

KERNEL_ROWS = 128       # csrc/separable_block.cu: kRows
KERNEL_DYN_BYTES = 160 * 1024   # kMaxDynBytes
# shapes whose B * To rows are no multiple of 128, T - k odd at stride 2
# VALID, SAME with an asymmetric and a symmetric pad (tests/test_torch_cuda.py
# RAGGED_SHAPES), and taps and strides of the general build
RAGGED_SLOT_SHAPES = [(37, 40, 56, 1, "VALID"), (37, 40, 56, 2, "SAME"),
                      (40, 40, 56, 2, "SAME"), (38, 40, 56, 2, "VALID"),
                      (37, 40, 56, 1, "SAME"), (37, 36, 44, 2, "SAME"),
                      (38, 20, 28, 2, "VALID"), (37, 19, 27, 1, "VALID")]


def _slot_table(m0, tile_rows, batch, t_in, k, stride, pad_lo, t_out, cin):
    """(row_slot [128], slot_src [nslots]) as the kernel's table pass
    builds them; every slot is written exactly once."""
    rows, u = batch * t_out, min(stride, k)
    row_slot = np.zeros(KERNEL_ROWS, np.int64)
    src = {}
    for r in range(tile_rows):
        m = m0 + r
        bi, t = divmod(m, t_out)
        slot = u * r + (k - u) * (bi - m0 // t_out)
        last = r == tile_rows - 1 or t == t_out - 1
        ti0 = t * stride - pad_lo
        for i in range(k if last else u):
            ti = ti0 + i
            assert slot + i not in src
            src[slot + i] = ((bi * t_in + ti) * cin
                             if m < rows and 0 <= ti < t_in else -1)
        row_slot[r] = slot
    nslots = int(row_slot[tile_rows - 1]) + k
    assert sorted(src) == list(range(nslots))
    return row_slot, np.array([src[s] for s in range(nslots)])


def _tile_slots(r, k, stride, t_out):
    """The launch's bound on a tile's slots (``tile_slots``)."""
    u = min(stride, k)
    return u * r + (k - u) * min((r - 1) // t_out + 2, r)


def _tile_rows(k, stride, t_out, slot_bytes=148):
    """The launch's row tile: the largest power of two up to 128 whose x
    tile fits (148 bytes per slot: 144 of x and 4 of the table)."""
    r = KERNEL_ROWS
    while r > 1 and _tile_slots(r, k, stride, t_out) * slot_bytes \
            > KERNEL_DYN_BYTES:
        r //= 2
    return r


def _check_tiles(t, cin, stride, padding, k=3, batch=3, tile_rows=None):
    rng = np.random.default_rng(t * 31 + cin + k)
    x = rng.standard_normal((batch, t, cin)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    b = np.full(cin, 0.5, np.float32)           # relu6(b) > 0
    t_out, pad_lo = K.out_len(t, k, stride, padding)
    xin = np.clip(x * a + b, 0, 6)
    taps = [v.reshape(-1, cin).numpy() for v in
            K._taps(torch.from_numpy(xin), k, stride, pad_lo, t_out)]
    rows = batch * t_out
    tile_rows = tile_rows or _tile_rows(k, stride, t_out)
    flat = xin.reshape(-1)
    starts = list(range(0, rows, tile_rows))
    crossing = 0
    for m0 in starts:
        row_slot, src = _slot_table(m0, tile_rows, batch, t, k, stride,
                                    pad_lo, t_out, cin)
        assert len(src) <= _tile_slots(tile_rows, k, stride, t_out)
        # the staged tile: the prologue where the slot is inside, else 0
        tile = np.stack([flat[s:s + cin] if s >= 0 else np.zeros(cin)
                         for s in src])
        own = [r for r in range(tile_rows) if m0 + r < rows]
        crossing += len({(m0 + r) // t_out for r in own}) > 1
        for i in range(k):
            np.testing.assert_array_equal(
                tile[row_slot[own] + i], taps[i][[m0 + r for r in own]])
    return crossing


@pytest.mark.parametrize("shape", SEPARABLE_SHAPES)
def test_slot_table_gathers_the_taps_at_the_trunk_shapes(shape):
    t, cin, _, stride, padding = shape
    assert _tile_rows(3, stride, K.out_len(t, 3, stride, padding)[0]) == 128
    assert _check_tiles(t, 4, stride, padding) > 0


@pytest.mark.parametrize("shape", RAGGED_SLOT_SHAPES)
def test_slot_table_gathers_the_taps_at_ragged_shapes(shape):
    t, cin, _, stride, padding = shape
    assert _check_tiles(t, cin, stride, padding, batch=7) > 0


@pytest.mark.parametrize("k,stride,padding,tile_rows", [
    (5, 1, "SAME", None), (5, 2, "VALID", None), (3, 3, "SAME", None),
    (8, 2, "SAME", None), (1, 1, "VALID", None), (8, 3, "VALID", 16),
    (5, 1, "SAME", 1), (200, 1, "SAME", None)])
def test_slot_table_gathers_the_taps_of_the_general_build(k, stride, padding,
                                                          tile_rows):
    _check_tiles(37, 6, stride, padding, k=k, batch=7, tile_rows=tile_rows)


def test_row_tile_shrinks_only_where_the_x_tile_would_not_fit():
    # the trunk's and the general build's usual k keep 128 rows
    for k, stride, t_out in ((3, 1, 9), (3, 2, 11), (8, 1, 1), (8, 3, 30)):
        assert _tile_rows(k, stride, t_out) == 128
    assert _tile_rows(200, 1, 37) == 64
    # one row's k slots fit up to the kernel's largest k
    assert _tile_slots(1, K.MAX_FWD_TAPS, 1, 1) * 148 <= KERNEL_DYN_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fold_weights_round_the_f32_product_once(dtype):
    """Weights already in the compute dtype take one elementwise product;
    it must equal the f32 product rounded once, bit for bit, also at the
    ends of the range (tiny products underflow the same way)."""
    rng = np.random.default_rng(11)
    w_dw = torch.from_numpy(rng.standard_normal((3, 1, 40)).astype(
        np.float32) * np.float32(2.0) ** rng.integers(-70, 60, (3, 1, 40)))
    w_pw = torch.from_numpy(rng.standard_normal((1, 40, 24)).astype(
        np.float32) * np.float32(2.0) ** rng.integers(-70, 60, (1, 40, 24)))
    w_dw, w_pw = w_dw.to(dtype), w_pw.to(dtype)
    want = (w_dw.reshape(3, 40, 1).float()
            * w_pw.reshape(1, 40, 24).float()).to(dtype)
    got = K.fold_weights_of(w_dw, w_pw, dtype)
    assert got.dtype == dtype and got.shape == (3, 40, 24)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
