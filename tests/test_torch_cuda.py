"""Card-only tests of the port: the CUDA kernels against their plain
versions (decode+augment also per rank of a data-parallel mesh) and the
train step on the card. Marked ``cuda``; without a CUDA device
they skip. This file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.export.benchmark import (
    separable_block_cotangents, separable_block_inputs,
)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K
from speech_recognition_tpu_torch.ops.kernels import separable_block as S

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

T = 16000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, batch, num_clips, index_dtype, seed=0):
    g = np.random.default_rng(seed)
    bank = torch.from_numpy(g.integers(-32768, 32767, (num_clips, T),
                                       dtype=np.int16)).to(device)
    bg = torch.from_numpy(g.uniform(-0.2, 0.2, 3 * T).astype(
        np.float32)).to(device)
    fids = g.integers(0, num_clips, batch)
    fids[-1] = num_clips - 1
    shifts = g.integers(-T, T, batch)
    shifts[0] = 0
    fg = g.uniform(-1.5, 1.5, batch).astype(np.float32)
    fg[1] = 0.0
    bg_pos = g.integers(0, 2 * T + 1, batch)
    bg_pos[-1] = 2 * T
    bg_vol = g.uniform(0, 0.3, batch).astype(np.float32)
    bg_vol[2] = 0.0

    def idx(a):
        return torch.from_numpy(a).to(device, index_dtype)

    return (bank, bg, idx(fids), idx(shifts),
            torch.from_numpy(fg).to(device), idx(bg_pos),
            torch.from_numpy(bg_vol).to(device))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch", [3, 7, 384])
def test_kernel_matches_plain_version(cuda, batch, index_dtype):
    args = _inputs(cuda, batch, 64, index_dtype)
    before = K.LAUNCHES
    got = K.decode_augment(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.decode_augment_reference(*args)
    assert got.shape == (batch, T) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_kernel_rows_make_the_unsharded_batch(cuda, world):
    from speech_recognition_tpu_torch.ops.kernels import sharded as KS
    from speech_recognition_tpu_torch.parallel.mesh import Mesh

    args = _inputs(cuda, 384, 64, torch.int64)
    before = KS.LAUNCHES
    rows = [KS.decode_augment_sharded(Mesh(r, world), *args)
            for r in range(world)]
    torch.cuda.synchronize()
    assert KS.LAUNCHES == before + world
    for r, got in enumerate(rows):
        assert got.shape == (384 // world, T)
        want = KS.decode_augment_sharded_reference(Mesh(r, world), *args)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(torch.cat(rows), K.decode_augment(*args))


def test_kernel_writes_out_of_range_rows_as_nan(cuda):
    bank, bg, fids, shifts, fg, bg_pos, bg_vol = _inputs(
        cuda, 4, 8, torch.int64)
    fids[1] = 8                         # past the bank
    bg_pos[2] = bg.shape[0] - T + 1     # window past the background
    out = K.decode_augment(bank, bg, fids, shifts, fg, bg_pos, bg_vol)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and torch.isnan(out[2]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[3]).all()


def test_wrapper_rejects_non_contiguous_inputs(cuda):
    args = list(_inputs(cuda, 8, 8, torch.int64))
    args[3] = torch.stack([args[3], args[3]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        K.decode_augment(*args)


def test_train_steps_launch_the_kernel(cuda):
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.train import loop
    from speech_recognition_tpu_torch.train.loop import Trainer

    ds = synthetic_device_dataset(cuda, num_train=64, num_val=40,
                                  num_pseudo=8)
    trainer = Trainer("conv_1d_time_sliced_with_attention",
                      prepare_model_settings(label_count=12), ds,
                      batch_size=16)
    assert trainer.compute_dtype == "bfloat16"
    state = trainer.init_state()
    before = K.LAUNCHES + loop.REPLAYS
    metrics = trainer.train_many(state, 3)
    # one run a step: the first launched, the others replays of its graph
    assert K.LAUNCHES + loop.REPLAYS == before + 3
    assert torch.isfinite(metrics["loss"]).all()
    conf, loss = trainer.evaluate(state)
    assert conf.sum() == 32 and np.isfinite(loss)


def _draws(device, t, batch, index_dtype, *, seed=1, num_clips=6,
           views=False):
    """Draws at any T: shifts over [-2T, 2T], background positions over
    the whole legal range, the last bank row at the largest legal window
    in the last row, and rows with fg_vol 0 (row 1) and bg_vol 0 (row 2).
    With ``views`` the bank and the background are ``[1:]`` views (at an
    odd T, bases that are not 16-byte aligned)."""
    g = np.random.default_rng(seed)
    extra = 1 if views else 0
    bank = torch.from_numpy(g.integers(-32768, 32767, (num_clips + extra, t),
                                       dtype=np.int16)).to(device)[extra:]
    bg = torch.from_numpy(g.uniform(-0.2, 0.2, 3 * t + 7 + extra).astype(
        np.float32)).to(device)[extra:]
    m = bg.shape[0]
    fids = g.integers(0, num_clips, batch)
    shifts = g.integers(-2 * t, 2 * t + 1, batch)
    bg_pos = g.integers(0, m - t + 1, batch)
    fids[-1], bg_pos[-1] = num_clips - 1, m - t
    fg = g.uniform(-1.5, 1.5, batch).astype(np.float32)
    bg_vol = g.uniform(0, 0.3, batch).astype(np.float32)
    fg[1 % batch], bg_vol[2 % batch] = 0.0, 0.0

    def idx(a):
        return torch.from_numpy(a).to(device, index_dtype)

    return (bank, bg, idx(fids), idx(shifts),
            torch.from_numpy(fg).to(device), idx(bg_pos),
            torch.from_numpy(bg_vol).to(device))


def _assert_kernel_equals_plain(args):
    """One launch, equal to the plain version (torch.equal: +0 == -0)."""
    before = K.LAUNCHES
    got = K.decode_augment(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.decode_augment_reference(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t", [16000, 16001])
def test_kernel_every_shift_and_bg_pos_residue(cuda, t, index_dtype):
    # 32 rows: every shift residue mod 8 with every bg_pos residue mod 4;
    # the wrap falls inside a 16-byte unit of the output at most of them
    args = list(_draws(cuda, t, 32, index_dtype))
    g, r = np.random.default_rng(5), np.arange(32)
    shifts = 8 * g.integers(-t // 8, t // 8, 32) + r % 8
    bg_pos = 4 * g.integers(0, (args[1].shape[0] - t) // 4, 32) + r // 8
    args[3], args[5] = (torch.from_numpy(a).to(cuda, index_dtype)
                        for a in (shifts, bg_pos))
    _assert_kernel_equals_plain(args)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t", [16000, 16001, 37, 8, 1])
def test_kernel_at_odd_lengths(cuda, t, index_dtype):
    _assert_kernel_equals_plain(_draws(cuda, t, 5, index_dtype))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t", [16001, 37])
def test_kernel_on_misaligned_views(cuda, t, index_dtype):
    args = _draws(cuda, t, 9, index_dtype, views=True)
    assert args[0].data_ptr() % 16 and args[1].data_ptr() % 16
    _assert_kernel_equals_plain(args)


@pytest.mark.parametrize("batch", [1, 3, 384])
def test_kernel_batches_at_odd_length(cuda, batch):
    _assert_kernel_equals_plain(_draws(cuda, 16001, batch, torch.int64))


@pytest.mark.parametrize("t", [16000, 16001])
def test_kernel_last_bank_row_at_the_largest_window(cuda, t):
    # every row reads the last bank row and the last window, whose start
    # M - T = 2 T + 7 is not 16-byte aligned, on whole tensors and views
    for views in (False, True):
        args = list(_draws(cuda, t, 4, torch.int64, views=views))
        m = args[1].shape[0]
        args[2] = torch.full_like(args[2], args[0].shape[0] - 1)
        args[5] = torch.full_like(args[5], m - t)
        args[3] = torch.tensor([0, -1, 3, -T - 5], device=cuda)
        _assert_kernel_equals_plain(args)


def test_kernel_zero_volume_rows(cuda):
    # fg_vol 0, bg_vol 0 and both, at both alignments of T
    for t in (16000, 16001):
        args = _draws(cuda, t, 12, torch.int64)
        args[4][0:4] = 0.0
        args[6][4:8] = 0.0
        args[4][8:12] = 0.0
        args[6][8:12] = 0.0
        _assert_kernel_equals_plain(args)
        out = K.decode_augment(*args)
        assert (out[8:12] == 0).all()


def test_kernel_nan_rows_whatever_the_volumes(cuda):
    bank, bg, fids, shifts, fg, bg_pos, bg_vol = _draws(
        cuda, 16001, 6, torch.int64)
    fids[0], fids[1] = -1, bank.shape[0]            # ids outside the bank
    bg_pos[2], bg_pos[3] = -1, bg.shape[0] - 16001 + 1  # windows outside
    fg[0:4:2] = 0.0
    bg_vol[0:4] = 0.0
    out = K.decode_augment(bank, bg, fids, shifts, fg, bg_pos, bg_vol)
    torch.cuda.synchronize()
    assert torch.isnan(out[:4]).all()
    assert torch.isfinite(out[4:]).all()


def test_kernel_replays_in_a_cuda_graph(cuda):
    args = _draws(cuda, 16000, 64, torch.int64)
    eager = K.decode_augment(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):     # warm up off the default stream
        K.decode_augment(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K.decode_augment(*args)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


# separable block: y within one bf16 step (bf16) or f32 summation order
# (f32, TF32 off); statistics relative to sum|y| and to s2
SEP_Y_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}
SEP_STATS_RTOL = 1e-4
SEP_SHAPES = [(399, 128, 128, 1, "VALID"), (397, 128, 192, 2, "SAME")]


def _sep_inputs(cuda, batch, shape, dtype):
    t, cin, cout, _, _ = shape
    x, w_dw, w_pw, a, b = separable_block_inputs(
        t, cin, cout, batch=batch, dtype=torch.float32, device=cuda)
    return [v.to(dtype) for v in (x, w_dw, w_pw)] + [a, b]


def _assert_block_close(got, want, dtype):
    y, s1, s2 = got
    yw, s1w, s2w = want
    assert y.shape == yw.shape and y.dtype == dtype
    rtol, atol = SEP_Y_TOL[dtype]
    torch.testing.assert_close(y.float(), yw.float(), rtol=rtol, atol=atol)
    scale1 = yw.float().abs().sum((0, 1))
    assert ((s1 - s1w).abs() <= SEP_STATS_RTOL * scale1).all()
    assert ((s2 - s2w).abs() <= SEP_STATS_RTOL * s2w).all()


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SEP_SHAPES)
@pytest.mark.parametrize("batch", [3, 7, 384])
def test_separable_kernel_matches_plain_version(cuda, batch, shape, dtype,
                                                fold):
    ins = _sep_inputs(cuda, batch, shape, dtype)
    kw = dict(stride=shape[3], padding=shape[4], fold_weights=fold)
    got = S.fused_separable_block(*ins, **kw)
    torch.cuda.synchronize()
    _assert_block_close(got, S.separable_block_plain(*ins, **kw), dtype)


def test_separable_launches_are_counted_by_variant(cuda):
    ins = _sep_inputs(cuda, 3, SEP_SHAPES[1], torch.bfloat16)
    before = dict(S.LAUNCHES)
    S.fused_separable_block(*ins, stride=2, padding="SAME")
    S.fused_separable_block(*ins, stride=2, padding="SAME",
                            fold_weights=False)
    S.fused_separable_block(*ins, stride=2, padding="SAME",
                            fold_weights=False, emit_stats=False)
    torch.cuda.synchronize()
    assert S.LAUNCHES == {"fold": before["fold"] + 1,
                          "fuse": before["fuse"] + 2, "bwd": before["bwd"]}


@pytest.mark.parametrize("fold", [False, True])
def test_separable_kernel_without_prologue_or_stats(cuda, fold):
    x, w_dw, w_pw, _, _ = _sep_inputs(cuda, 7, SEP_SHAPES[1], torch.bfloat16)
    kw = dict(stride=2, padding="SAME", fold_weights=fold)
    got = S.fused_separable_block(x, w_dw, w_pw, **kw)
    want = S.separable_block_plain(x, w_dw, w_pw, **kw)
    _assert_block_close(got, want, torch.bfloat16)
    y = S.fused_separable_block(x, w_dw, w_pw, emit_stats=False, **kw)
    torch.cuda.synchronize()
    assert isinstance(y, torch.Tensor)
    torch.testing.assert_close(y.float(), want[0].float(), rtol=2.0 ** -7,
                               atol=1e-5)


def test_separable_same_padding_comes_after_the_prologue(cuda):
    x, w_dw, w_pw, a, b = _sep_inputs(cuda, 3, (22, 64, 96, 2, "SAME"),
                                      torch.float32)
    b = torch.full_like(b, 0.5)            # relu6(b) > 0 in a padded row
    for fold in (False, True):
        kw = dict(stride=2, padding="SAME", fold_weights=fold)
        got = S.fused_separable_block(x, w_dw, w_pw, a, b, **kw)
        torch.cuda.synchronize()
        _assert_block_close(got, S.separable_block_plain(
            x, w_dw, w_pw, a, b, **kw), torch.float32)


def _assert_block_own_stats(got, want, dtype):
    """y as in ``_assert_block_close``; s1 and s2 against the f32 sums of
    the kernel's own rounded y and y * y, which is what they are. At a few
    hundred rows one y that rounds to the neighbouring bf16 value (a
    different f32 sum order) moves s2 by more than SEP_STATS_RTOL of the
    plain version's s2, so the sums are held to the kernel's own y."""
    y = got[0]
    y_sums = (want[0], y.float().sum((0, 1)), (y * y).float().sum((0, 1)))
    _assert_block_close(got, y_sums, dtype)


def test_separable_wrapper_rejects_non_contiguous_x(cuda):
    x, w_dw, w_pw, a, b = _sep_inputs(cuda, 3, SEP_SHAPES[0],
                                      torch.bfloat16)
    x = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        S.fused_separable_block(x, w_dw, w_pw, a, b)


# separable block backward against its plain version on the same inputs,
# per output relative to its largest |value|: dx in f32 differs only by
# ddw's f32 sum order; in bf16 a different f32 sum can flip ddw to the
# neighbouring bf16 value, which moves a tap piece of dx by one bf16
# step; the f32 sums dw_dw, dw_pw, da, db are taken with atomics in
# another order, and in bf16 a flipped ddw moves one of their terms by a
# bf16 step (chip_smoke.py states the measured errors)
SEP_BWD_DX_TOL = {torch.float32: (0.0, 1e-5),
                  torch.bfloat16: (2.0 ** -6, 2.0 ** -8)}
SEP_BWD_SUM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _bwd_inputs(cuda, batch, shape, dtype, prologue=True):
    x, w_dw, w_pw, a, b = _sep_inputs(cuda, batch, shape, dtype)
    kw = dict(stride=shape[3], padding=shape[4])
    if not prologue:
        a = b = None
    y = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)[0]
    dy, ds1, ds2 = separable_block_cotangents(y.shape[1], shape[2],
                                              batch=batch, dtype=dtype,
                                              device=cuda)
    return (x, y, dy, ds1, ds2, w_dw, w_pw, a, b), kw


def _assert_bwd_close(got, want, dtype):
    for name, g, w in zip(("dx", "dw_dw", "dw_pw", "da", "db"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        scale = float(w.float().abs().max())
        if name == "dx":
            assert g.dtype == dtype
            rtol, atol = SEP_BWD_DX_TOL[dtype]
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol * scale)
        else:
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w.float(), rtol=0,
                                       atol=SEP_BWD_SUM_RTOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SEP_SHAPES)
@pytest.mark.parametrize("batch", [3, 7, 384])
def test_separable_bwd_kernel_matches_plain_version(cuda, batch, shape,
                                                    dtype):
    args, kw = _bwd_inputs(cuda, batch, shape, dtype)
    got = S.separable_block_bwd(*args, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(got, S.separable_block_bwd_plain(*args, **kw), dtype)


@pytest.mark.parametrize("prologue", [True, False])
def test_separable_bwd_odd_valid_stride2_shape(cuda, prologue):
    """T - k odd at stride 2, VALID: the last input row feeds no output
    and gets dx = 0."""
    args, kw = _bwd_inputs(cuda, 7, (398, 128, 192, 2, "VALID"),
                           torch.float32, prologue)
    got = S.separable_block_bwd(*args, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(got, S.separable_block_bwd_plain(*args, **kw),
                      torch.float32)
    assert (got[0][:, -1] == 0).all() and (got[0][:, -2] != 0).any()


def test_separable_bwd_launches_are_counted(cuda):
    args, kw = _bwd_inputs(cuda, 3, SEP_SHAPES[1], torch.bfloat16)
    before = dict(S.LAUNCHES)
    S.separable_block_bwd(*args, **kw)
    x, _, _, _, _, w_dw, w_pw, a, b = args
    leaves = [v.clone().requires_grad_() for v in (x, a, b, w_dw, w_pw)]
    y, s1, _ = S.fused_separable_block_vjp(*leaves, **kw)
    torch.autograd.grad(y.float().sum() + s1.sum(), leaves)
    torch.cuda.synchronize()
    assert S.LAUNCHES == {"fold": before["fold"] + 1,
                          "fuse": before["fuse"], "bwd": before["bwd"] + 2}


@pytest.mark.parametrize("shape", SEP_SHAPES)
def test_separable_vjp_on_card_matches_cpu(cuda, shape):
    ins = _sep_inputs(cuda, 3, shape, torch.float32)
    t_out, _ = S.out_len(shape[0], 3, shape[3], shape[4])
    cts = separable_block_cotangents(t_out, shape[2], batch=3,
                                     dtype=torch.float32, device=cuda)

    def grads(device):
        leaves = [v.detach().to(device).requires_grad_() for v in ins]
        out = S.fused_separable_block_vjp(*leaves[:1], *leaves[3:],
                                          *leaves[1:3], shape[3], shape[4])
        return torch.autograd.grad(out, leaves,
                                   [c.to(device) for c in cts])

    for name, g, w in zip(("dx", "dw_dw", "dw_pw", "da", "db"),
                          grads(cuda), grads("cpu")):
        assert g.device.type == "cuda" and g.shape == w.shape, name
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


# shapes whose B * To rows are no multiple of the kernels' tiles, with Cin
# and Cout no multiples of 16 (40, 56), of 8 (36, 44, 20, 28: the kernels'
# element-by-element copies) or of 2 (19, 27: one channel at a time in the
# epilogue): T - k odd at stride 2 VALID (the last input row gets dx = 0),
# SAME at stride 2 with an asymmetric pad (T = 40: 0 before, 1 after) and
# with a symmetric one (T = 37)
RAGGED_SHAPES = [(37, 40, 56, 1, "VALID"), (37, 40, 56, 2, "SAME"),
                 (40, 40, 56, 2, "SAME"), (38, 40, 56, 2, "VALID"),
                 (37, 40, 56, 1, "SAME"), (37, 36, 44, 2, "SAME"),
                 (38, 20, 28, 2, "VALID"), (37, 19, 27, 1, "VALID")]
# (compute dtype, dy dtype): dy in f32 with bf16 compute is its own entry
BWD_DTYPES = [(torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32)]


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("dtypes", BWD_DTYPES)
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("batch", [3, 7])
def test_separable_bwd_kernel_at_ragged_shapes(cuda, batch, shape, dtypes,
                                               prologue):
    dtype, dy_dtype = dtypes
    args, kw = _bwd_inputs(cuda, batch, shape, dtype, prologue)
    x, y, dy, ds1, ds2, w_dw, w_pw, a, b = args
    args = (x, y, dy.to(dy_dtype), ds1, ds2, w_dw, w_pw, a, b)
    got = S.separable_block_bwd(*args, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(got, S.separable_block_bwd_plain(*args, **kw), dtype)
    t, _, _, stride, padding = shape
    if padding == "VALID" and stride == 2 and (t - 3) % 2:
        assert (got[0][:, -1] == 0).all() and (got[0][:, -2] != 0).any()


def test_separable_bwd_takes_inputs_at_unaligned_offsets(cuda):
    """Views that start off a 16-byte boundary (the kernel reads some
    inputs 16 bytes at a time) give the same result as fresh tensors."""
    args, kw = _bwd_inputs(cuda, 3, (37, 40, 56, 2, "SAME"), torch.bfloat16)
    x, y, dy, ds1, ds2, w_dw, w_pw, a, b = args

    def shifted(v):
        flat = torch.zeros(v.numel() + 1, dtype=v.dtype, device=cuda)
        flat[1:] = v.reshape(-1)
        return flat[1:].view(v.shape)

    got = S.separable_block_bwd(x, *(shifted(v) for v in (y, dy, ds1, ds2)),
                                w_dw, shifted(w_pw), a, b, **kw)
    want = S.separable_block_bwd(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dw_dw", "dw_pw", "da", "db"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=SEP_BWD_SUM_RTOL[
            torch.bfloat16] * float(w.float().abs().max()), msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_separable_bwd_mma_fragment_layout_16x16x16(cuda, dtype):
    """Both products at 16 x 16 x 16 (16 output rows, Cin 16, Cout 16) on
    small integers, where every value and every f32 sum is exact in
    either order: a slip in the mma.sync fragment layout or in an
    ldmatrix transpose moves some output, and the kernel must equal its
    plain version bit for bit."""
    g = np.random.default_rng(16)

    def ints(lo, hi, shape):
        return torch.from_numpy(g.integers(lo, hi + 1, shape).astype(
            np.float32)).to(cuda, dtype)

    x, w_dw, w_pw = ints(-3, 3, (1, 18, 16)), ints(-1, 1, (3, 1, 16)), \
        ints(-2, 2, (1, 16, 16))
    dy = ints(-3, 3, (1, 16, 16))
    zeros = torch.zeros(16, device=cuda)
    y = torch.zeros_like(dy)
    args = (x, y, dy, zeros, zeros, w_dw, w_pw)
    got = S.separable_block_bwd(*args, stride=1, padding="VALID")
    torch.cuda.synchronize()
    want = S.separable_block_bwd_plain(*args, stride=1, padding="VALID")
    for name, gv, wv in zip(("dx", "dw_dw", "dw_pw"), got, want):
        assert wv.abs().max() > 0, name
        torch.testing.assert_close(gv, wv, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("k,stride,padding", [(5, 1, "SAME"), (5, 2, "VALID"),
                                              (3, 3, "SAME"), (8, 2, "SAME")])
def test_separable_bwd_general_build(cuda, k, stride, padding):
    """Taps and strides other than the trunk's (k = 3 at stride 1 or 2)
    take the kernel's general build; more than 8 taps are refused."""
    g = np.random.default_rng(k * 10 + stride)
    t, cin, cout, batch = 37, 40, 56, 7

    def rand(*shape, scale=1.0):
        return torch.from_numpy((g.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda)

    x, w_dw, w_pw = rand(batch, t, cin), rand(k, 1, cin, scale=0.2), \
        rand(1, cin, cout, scale=0.1)
    a, b = rand(cin, scale=0.2) + 1.0, rand(cin, scale=0.1)
    kw = dict(stride=stride, padding=padding)
    for dtype in (torch.bfloat16, torch.float32):
        xs, wd, wp = (v.to(dtype) for v in (x, w_dw, w_pw))
        y = S.separable_block_plain(xs, wd, wp, a, b, **kw)[0]
        dy, ds1, ds2 = separable_block_cotangents(y.shape[1], cout,
                                                  batch=batch, dtype=dtype,
                                                  device=cuda)
        args = (xs, y, dy, ds1, ds2, wd, wp, a, b)
        got = S.separable_block_bwd(*args, **kw)
        torch.cuda.synchronize()
        _assert_bwd_close(got, S.separable_block_bwd_plain(*args, **kw), dtype)
    y = torch.zeros(batch, t, cout, device=cuda)     # SAME, stride 1
    with pytest.raises(ValueError, match="at most 8 taps"):
        S.separable_block_bwd(x, y, y, ds1, ds2, rand(9, 1, cin), w_pw, a, b,
                              stride=1, padding="SAME")


# the forward kernel at the same ragged shapes: the x tile's element-by-
# element copies (Cin no multiple of 8 in bf16, of 4 in f32), odd channel
# counts in the fuse chain, y written element by element (Cout no multiple
# of 8 or 4), tiles of 128 rows that cross batch rows
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("batch", [3, 7])
def test_separable_kernel_at_ragged_shapes(cuda, batch, shape, dtype,
                                           prologue, fold):
    x, w_dw, w_pw, a, b = _sep_inputs(cuda, batch, shape, dtype)
    if not prologue:
        a = b = None
    kw = dict(stride=shape[3], padding=shape[4], fold_weights=fold)
    got = S.fused_separable_block(x, w_dw, w_pw, a, b, **kw)
    torch.cuda.synchronize()
    _assert_block_own_stats(got, S.separable_block_plain(
        x, w_dw, w_pw, a, b, **kw), dtype)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_separable_kernel_odd_valid_stride2_shape(cuda, dtype, fold):
    """T - k odd at stride 2, VALID: the last input row feeds no output."""
    ins = _sep_inputs(cuda, 7, (398, 128, 192, 2, "VALID"), dtype)
    kw = dict(stride=2, padding="VALID", fold_weights=fold)
    got = S.fused_separable_block(*ins, **kw)
    torch.cuda.synchronize()
    _assert_block_own_stats(got, S.separable_block_plain(*ins, **kw), dtype)


@pytest.mark.parametrize("k,stride,padding", [
    (5, 1, "SAME"), (5, 2, "VALID"), (3, 3, "SAME"), (8, 2, "SAME"),
    (1, 1, "VALID"), (200, 1, "SAME")])
def test_separable_kernel_general_build(cuda, k, stride, padding):
    """Taps other than the trunk's k = 3 take the general build, and k = 3
    at stride 3 the k = 3 build with rows that share no tap. At k = 200 the
    x tile of 128 rows does not fit in shared memory, and the launch takes
    a smaller row tile; more than 1024 taps are refused."""
    g = np.random.default_rng(k * 10 + stride)
    t, cin, cout, batch = 37, 40, 56, 7

    def rand(*shape, scale=1.0):
        return torch.from_numpy((g.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda)

    x, w_dw, w_pw = rand(batch, t, cin), rand(k, 1, cin, scale=0.2), \
        rand(1, cin, cout, scale=0.1)
    a, b = rand(cin, scale=0.2) + 1.0, rand(cin, scale=0.1)
    for dtype in (torch.bfloat16, torch.float32):
        xs, wd, wp = (v.to(dtype) for v in (x, w_dw, w_pw))
        for fold in (False, True):
            kw = dict(stride=stride, padding=padding, fold_weights=fold)
            got = S.fused_separable_block(xs, wd, wp, a, b, **kw)
            torch.cuda.synchronize()
            _assert_block_own_stats(got, S.separable_block_plain(
                xs, wd, wp, a, b, **kw), dtype)
    with pytest.raises(ValueError, match="at most 1024 taps"):
        S.fused_separable_block(x, rand(1025, 1, cin), w_pw, a, b,
                                stride=1, padding="SAME")


@pytest.mark.parametrize("fold", [False, True])
def test_separable_kernel_takes_inputs_at_unaligned_offsets(cuda, fold):
    """Views that start off a 16-byte boundary (the kernel reads x and the
    weights 16 bytes at a time) give the same y as fresh tensors."""
    x, w_dw, w_pw, a, b = _sep_inputs(cuda, 3, (37, 40, 56, 2, "SAME"),
                                      torch.bfloat16)

    def shifted(v):
        flat = torch.zeros(v.numel() + 1, dtype=v.dtype, device=cuda)
        flat[1:] = v.reshape(-1)
        return flat[1:].view(v.shape)

    kw = dict(stride=2, padding="SAME", fold_weights=fold)
    got = S.fused_separable_block(shifted(x), shifted(w_dw), shifted(w_pw),
                                  a, b, **kw)
    want = S.fused_separable_block(x, w_dw, w_pw, a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    _assert_block_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batch", [1, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_separable_mma_fragment_layout_16x16x16(cuda, dtype, batch, stride,
                                                fold):
    """16 output rows per batch row, Cin 16, Cout 16, on small integers,
    where every value, product and f32 sum is exact in any order: a slip
    in the gathered ldmatrix row addresses (``fold``: tap i of row r is
    slot row_slot[r] + i), in the mma.sync fragment layout or in the slot
    table moves some output, and y, s1 and s2 must equal the plain
    version bit for bit. Batch 9 makes 144 rows: two tiles, each crossing
    batch rows."""
    g = np.random.default_rng(16 + stride)

    def ints(lo, hi, shape):
        return torch.from_numpy(g.integers(lo, hi + 1, shape).astype(
            np.float32)).to(cuda, dtype)

    x = ints(-3, 3, (batch, 15 * stride + 3, 16))
    w_dw, w_pw = ints(-1, 1, (3, 1, 16)), ints(-2, 2, (1, 16, 16))
    a, b = ints(1, 2, (16,)).float(), ints(-1, 1, (16,)).float()
    kw = dict(stride=stride, padding="VALID", fold_weights=fold)
    got = S.fused_separable_block(x, w_dw, w_pw, a, b, **kw)
    torch.cuda.synchronize()
    want = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)
    assert got[0].shape == (batch, 16, 16) and want[0].abs().max() > 0
    for name, gv, wv in zip(("y", "s1", "s2"), got, want):
        torch.testing.assert_close(gv, wv, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("precision", ["highest", "fastest"])
def test_frontend_on_card_matches_cpu(cuda, precision):
    """The frontend's products on the card against the CPU: f32 with TF32
    off to 1e-5 of max |spectrogram| and 1e-4 of max |mfcc|; 'fastest'
    (TF32) to 1e-2 of them, the JAX DEFAULT precision's own error, with
    the process's TF32 flag left as it was."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    g = np.random.default_rng(8)
    t = np.arange(T) / T
    wav = torch.from_numpy((np.sin(2 * np.pi * 440 * t)[None]
                            * g.uniform(0.1, 0.5, (6, 1))
                            + g.normal(0, 0.05, (6, T))).astype(np.float32))
    ref = Frontend(prepare_model_settings(12))
    front = Frontend(prepare_model_settings(12), precision)
    tol = {"highest": (1e-5, 1e-4), "fastest": (1e-2, 1e-2)}[precision]
    for name, rtol in zip(("spectrogram", "mfcc"), tol):
        want = getattr(ref, name)(wav)
        got = getattr(front, name)(wav.to(cuda)).cpu()
        assert (got - want).abs().max() <= rtol * want.abs().max(), name
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_fit_on_card_launches_decode_augment_per_step_and_bn_batch(
        cuda, tmp_path):
    """Two epochs of conv_1d_spec in bf16 on a small hard corpus: one
    decode+augment launch per train step and per BN re-estimation batch,
    finite history, the confusion matrix over whole batches."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.device_bank import (
        build_device_dataset,
    )
    from speech_recognition_tpu_torch.data.hard_corpus import (
        WANTED, build_hard_corpus,
    )
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.train import loop
    from speech_recognition_tpu_torch.train.loop import Trainer

    build_hard_corpus(tmp_path, clips_per_word=20, seed=0)
    settings = prepare_model_settings(12, output_representation="spec")
    index = build_dataset_index([str(tmp_path)], 13.0, 60.0, WANTED, 20.0,
                                0.0)
    ds = build_device_dataset(index, settings, cuda)
    trainer = Trainer("conv_1d_spec", settings, ds, batch_size=32)
    assert trainer.compute_dtype == "bfloat16"
    assert trainer.frontend.precision == "fastest"
    state = trainer.init_state()
    K.LAUNCHES = loop.REPLAYS = 0
    state, history = trainer.fit(state, epochs=2, bn_recalibration_batches=3,
                                 steps_per_dispatch=4)
    steps = ds.set_size("training") // 32
    # launched, or run by a replay of the train step's graph
    assert K.LAUNCHES + loop.REPLAYS == 2 * (steps + 3)
    assert trainer.graph_error is None and loop.REPLAYS > 0
    assert state.step == 2 * steps
    for k, v in history.items():
        if k == "confusion":
            assert all(c.sum() == ds.set_size("validation") // 32 * 32
                       for c in v)
        else:
            assert np.isfinite(v).all(), k
    bn = state.model.blocks[0].bn
    assert bn.running_mean.dtype == torch.float32
    assert torch.isfinite(bn.running_var).all()
