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
    from speech_recognition_tpu_torch.train.loop import Trainer

    ds = synthetic_device_dataset(cuda, num_train=64, num_val=40,
                                  num_pseudo=8)
    trainer = Trainer("conv_1d_time_sliced_with_attention",
                      prepare_model_settings(label_count=12), ds,
                      batch_size=16)
    assert trainer.compute_dtype == "bfloat16"
    state = trainer.init_state()
    before = K.LAUNCHES
    metrics = trainer.train_many(state, 3)
    assert K.LAUNCHES == before + 3
    assert torch.isfinite(metrics["loss"]).all()
    conf, loss = trainer.evaluate(state)
    assert conf.sum() == 32 and np.isfinite(loss)


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
