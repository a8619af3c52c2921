"""Port's fused decode+augment vs the JAX Pallas kernel and jnp path.

The CUDA kernel runs only on a card; here the wrapper takes its plain
PyTorch version (CPU tensors), which is what the kernel is held against
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: atol 1e-6 on outputs of magnitude < 0.5 — both sides compute
the same products in float32 in the same order, so they agree to f32
rounding (~3e-8); the bound leaves room for a different rounding of the
fused forms. Against numpy, which rounds each operation as the port does,
the outputs are equal. The kernel's index plan (its 16-byte units and
slots, and the split at the wrap point) has a numpy twin here,
``_kernel_plan``, held to the plain version's indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops.augment import (
    BackgroundBank as JaxBackgroundBank, rolled_decode_augment,
)
from speech_recognition_tpu.ops.pallas.augment_kernel import (
    double_bank, fused_decode_augment,
)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs(batch, t, seed=0, num_clips=8):
    """Numpy inputs with negative and zero shifts, silence (fg 0), bg_vol
    0 and the largest legal background position."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(-3000, 3000, (num_clips, t), dtype=np.int16)
    bg_flat = rng.uniform(-0.2, 0.2, 4 * t).astype(np.float32)
    fids = rng.integers(0, num_clips, batch).astype(np.int32)
    fids[-1] = num_clips - 1
    shifts = rng.integers(-t // 32, 1, batch).astype(np.int32)
    shifts[0] = 0
    fg = rng.uniform(0.5, 1.5, batch).astype(np.float32)
    fg[1 % batch] = 0.0                       # silence row
    bg_pos = rng.integers(0, 3 * t, batch).astype(np.int32)
    bg_pos[-1] = bg_flat.shape[0] - t         # largest legal position
    bg_vol = rng.uniform(0, 0.3, batch).astype(np.float32)
    bg_vol[0] = 0.0
    return bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol


def _port(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol):
    args = [torch.from_numpy(a) for a in
            (bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol)]
    return K.decode_augment(*args).numpy()


def _numpy_reference(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol):
    t = bank.shape[1]
    rows = [np.roll(bank[f].astype(np.float32) * (fg[b] / np.float32(32768)),
                    shifts[b])
            + bg_flat[bg_pos[b]:bg_pos[b] + t] * bg_vol[b]
            for b, f in enumerate(fids)]
    return np.stack(rows)


@pytest.mark.parametrize("batch,t", [(4, 512), (3, 16000)])
def test_plain_matches_pallas_kernel_interpret(batch, t):
    ins = _inputs(batch, t)
    want = np.asarray(fused_decode_augment(
        *[jnp.asarray(a) for a in ins], interpret=True))
    np.testing.assert_allclose(_port(*ins), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch,t", [(4, 512), (3, 16000), (16, 1024)])
def test_plain_matches_rolled_decode_augment(batch, t):
    bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol = _inputs(batch, t, 1)
    background = JaxBackgroundBank.from_arrays([bg_flat], t)
    want = np.asarray(rolled_decode_augment(
        double_bank(jnp.asarray(bank)), background, jnp.asarray(fids),
        jnp.asarray(shifts), jnp.asarray(fg), jnp.asarray(bg_pos),
        jnp.asarray(bg_vol), num_samples=t))
    got = _port(bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_plain_matches_numpy_roll(index_dtype):
    ins = list(_inputs(5, 640, 2))
    for i in (2, 3, 5):
        ins[i] = ins[i].astype(index_dtype)
    np.testing.assert_allclose(_port(*ins), _numpy_reference(*ins),
                               rtol=0, atol=ATOL)


def test_zero_shift_and_volume():
    bank = np.full((2, 256), 16384, dtype=np.int16)
    bg = np.zeros(512, np.float32)
    got = _port(bank, bg, np.array([0, 1], np.int32),
                np.zeros(2, np.int32), np.array([1.0, 0.0], np.float32),
                np.zeros(2, np.int32), np.zeros(2, np.float32))
    np.testing.assert_allclose(got[0], 0.5)
    np.testing.assert_allclose(got[1], 0.0)
    jax_got = np.asarray(fused_decode_augment(
        jnp.asarray(bank), jnp.asarray(bg), jnp.asarray([0, 1], jnp.int32),
        jnp.zeros(2, jnp.int32), jnp.asarray([1.0, 0.0], jnp.float32),
        jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.float32), interpret=True))
    np.testing.assert_array_equal(got, jax_got)


def test_full_shift_range_wraps_like_np_roll():
    # every shift in [-T, T] on one clip, including |s| = T (no-op)
    t = 64
    bank = np.arange(t, dtype=np.int16)[None, :] * 100
    shifts = np.arange(-t, t + 1, dtype=np.int64)
    b = shifts.shape[0]
    ins = (bank, np.zeros(t, np.float32), np.zeros(b, np.int64), shifts,
           np.ones(b, np.float32), np.zeros(b, np.int64),
           np.zeros(b, np.float32))
    np.testing.assert_array_equal(_port(*ins), _numpy_reference(*ins))


def _residue_inputs(t, seed=3, num_clips=5):
    """35 rows: rows 0-31 pair every shift residue mod 8 with every
    bg_pos residue mod 4 (most of the shifts put the wrap inside a
    16-byte unit of the output); then fg_vol 0, bg_vol 0, and both 0 on
    the last bank row at the largest legal bg_pos (misaligned: M - T is
    3 T + 3)."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(-32768, 32767, (num_clips, t), dtype=np.int16)
    m = 4 * t + 3
    bg_flat = rng.uniform(-0.2, 0.2, m).astype(np.float32)
    r = np.arange(35)
    fids = rng.integers(0, num_clips, 35)
    shifts = 8 * rng.integers(-t // 8 - 1, t // 8 + 1, 35) + r % 8
    bg_pos = 4 * rng.integers(0, (m - t) // 4, 35) + r // 8 % 4
    fg = rng.uniform(-1.5, 1.5, 35).astype(np.float32)
    bg_vol = rng.uniform(0, 0.3, 35).astype(np.float32)
    fg[32], bg_vol[33] = 0.0, 0.0
    fg[34] = bg_vol[34] = 0.0
    fids[34], bg_pos[34] = num_clips - 1, m - t
    return bank, bg_flat, fids, shifts, fg, bg_pos, bg_vol


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_plain_matches_pallas_kernel_at_every_residue(index_dtype):
    # T a multiple of 128, as double_bank requires; JAX takes int32
    ins = list(_residue_inputs(512))
    jax_ins = [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
               for a in ins]
    want = np.asarray(fused_decode_augment(*jax_ins, interpret=True))
    for i in (2, 3, 5):
        ins[i] = ins[i].astype(index_dtype)
    np.testing.assert_allclose(_port(*ins), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [16000, 16001, 37, 8, 1])
def test_plain_matches_numpy_roll_at_every_residue(t):
    ins = _residue_inputs(t)
    np.testing.assert_array_equal(_port(*ins), _numpy_reference(*ins))


def _kernel_plan(t, start, p, out_lead, bank_lead, bg_lead):
    """Numpy twin of ``csrc/decode_augment.cu``'s plan for one row.

    Addresses count elements from a 16-byte aligned origin: the output
    row starts at ``out_lead`` floats, the bank row at ``bank_lead`` int16
    samples and bg_flat at ``bg_lead`` floats. Returns, per output i, the
    bank row index and the bg_flat index that the kernel reads for it,
    and how often it is written. Asserts that every float4 store is
    aligned and that every 16-byte unit loaded holds a sample the quad
    needs."""
    fg_src = np.full(t, -1)
    bg_src = np.full(t, -1)
    written = np.zeros(t, int)
    lead = out_lead % 4
    head = min(4 - lead, t) if lead else 0
    quads = (t - head) // 4

    def one_sample(i):
        src = i + start
        fg_src[i] = src - t if src >= t else src
        bg_src[i] = p + i
        written[i] += 1

    tail = t - head - 4 * quads
    for k in range(head + tail):
        one_sample(k if k < head else 4 * quads + k)
    for q in range(quads):
        j = head + 4 * q
        assert (out_lead + j) % 4 == 0
        src = j + start
        if src >= t:
            src -= t
        if src + 4 <= t:
            # load_bank4: 8 samples a unit, the words are sample pairs
            a = bank_lead + src
            unit, m = a - a % 8, a % 8
            lo = [unit + s for s in range(8)]
            hi = [unit + 8 + s for s in range(8)] if m > 4 else [None] * 8
            w = [(lo[2 * k], lo[2 * k + 1]) for k in range(4)] \
                + [(hi[0], hi[1]), (hi[2], hi[3])]
            if m & 4:
                w[0:4] = w[2:6]
            if m & 2:
                w[0:3] = w[1:4]
            pairs = [(w[k][1], w[k + 1][0]) if m & 1 else w[k]
                     for k in (0, 1)]
            got = [s for pair in pairs for s in pair]
            assert None not in got
            if m > 4:
                assert any(unit + 8 <= s for s in got)
            fg_src[j:j + 4] = np.array(got) - bank_lead
        else:                           # the wrap point lies in this quad
            fg_src[j:j + 4] = [s - t if s >= t else s
                               for s in range(src, src + 4)]
        # load_bg4: 4 floats a unit
        a = bg_lead + p + j
        unit, qq = a - a % 4, a % 4
        w = [unit + s for s in range(4)] \
            + ([unit + 4 + s for s in range(3)] if qq else [None] * 3)
        if qq & 2:
            w[0:5] = w[2:7]
        if qq & 1:
            w[0:4] = w[1:5]
        assert None not in w[:4]
        if qq:
            assert w[3] >= unit + 4
        bg_src[j:j + 4] = np.array(w[:4]) - bg_lead
        written[j:j + 4] += 1
    return fg_src, bg_src, written


@pytest.mark.parametrize("t", [1, 3, 8, 12, 37, 64, 16001, 16000])
def test_kernel_plan_twin_gathers_the_plain_indices(t):
    rng = np.random.default_rng(t)
    leads = [(o, b, g) for o in range(4) for b in range(8) for g in range(4)]
    if t > 100:     # the big rows: every residue of each lead, fewer pairs
        leads = [leads[i] for i in rng.choice(len(leads), 12, replace=False)]
        leads += [(o, o, o) for o in range(4)] + [(0, 7, 3), (3, 5, 1)]
    starts = sorted({0, 1, t - 1, t // 2, *rng.integers(0, t, 3).tolist()})
    i = np.arange(t)
    for out_lead, bank_lead, bg_lead in leads:
        for start in starts:
            p = int(rng.integers(0, 4 * t))
            fg_src, bg_src, written = _kernel_plan(t, start, p, out_lead,
                                                   bank_lead, bg_lead)
            np.testing.assert_array_equal(fg_src, (i + start) % t)
            np.testing.assert_array_equal(bg_src, p + i)
            np.testing.assert_array_equal(written, 1)


def test_cpu_path_does_not_count_launches():
    before = K.LAUNCHES
    _port(*_inputs(2, 256))
    assert K.LAUNCHES == before


@pytest.mark.parametrize("field,bad", [
    ("bank", lambda a: a.astype(np.int32)),
    ("bg_flat", lambda a: a.astype(np.float64)),
    ("fids", lambda a: a.astype(np.float32)),
    ("shifts", lambda a: a.astype(np.int64)),   # mixed index dtypes
    ("fg", lambda a: a[:-1]),
    ("bg_vol", lambda a: a.astype(np.float64)),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(field, bad):
    names = ["bank", "bg_flat", "fids", "shifts", "fg", "bg_pos", "bg_vol"]
    ins = list(_inputs(3, 256))
    i = names.index(field)
    ins[i] = bad(ins[i])
    with pytest.raises(ValueError):
        _port(*ins)


def test_wrapper_rejects_tensors_on_different_devices():
    ins = [torch.from_numpy(a) for a in _inputs(3, 256)]
    ins[1] = ins[1].to("meta")
    with pytest.raises(ValueError):
        K.decode_augment(*ins)
