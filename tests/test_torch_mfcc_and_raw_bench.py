"""The benchmark's plain reference of ``conv_1d_mfcc_and_raw``
(``kws_bench/reference/mfcc_and_raw.py``) against the port, on the CPU:

- f64, the published widths, batch 3: the same weights and the head's
  mask drawn in ``dropout_shapes`` order give the port's logits to 1e-10
  in train and eval mode, and every leaf's gradient to rtol 1e-8;
- the reference's features (tf.signal's pipeline with ``torch.fft.rfft``)
  are the port's ``Frontend`` at 'highest' (a DFT as products with
  float32 bases), to the rounding of the port's float32 constants;
- the parameter names and shapes and the penalised kernels are the
  port's, and the configuration's feature geometry is the model's;
- the trainer's generator after a step is the reference's after it
  redraws the batch and the head's mask;
- the reference's FLOPs against the configuration's
  ``forward_flops_per_clip`` and the step's, worked out from it;
- a CPU run of the cell at batch 8 in f32 reads under every limit, and
  a frontend fault planted in the port, the Hann window left out of its
  DFT basis, reads above ``feature_gap``'s.
"""

import numpy as np
import pytest
import torch

from kws_bench import flops, harness
from kws_bench.reference import draws as D
from kws_bench.reference import mfcc_and_raw
from kws_bench.reference import train as RT
from kws_bench.traffic import _train as T
from kws_bench.traffic import train_bank
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.models.zoo import (
    build_model, settings_geometry,
)
from speech_recognition_tpu_torch.ops import frontend as FE

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "mfcc_and_raw.train_bank"
SMALL_MIX = dict(num_train=64, num_val=8, num_pseudo=8, background_clips=2,
                 background_seconds=2)


def _settings():
    cfg = harness.load_config("mfcc_and_raw")
    return prepare_model_settings(label_count=cfg["num_classes"],
                                  **cfg["model_settings"])


def _net():
    net, _ = build_model("conv_1d_mfcc_and_raw", num_classes=12,
                         **settings_geometry(_settings()))
    return net


def _wav(b, dtype=torch.float64):
    return torch.randn(b, 16000, generator=torch.Generator().manual_seed(1),
                       dtype=dtype) * 0.3


def _ctx(tmp_path, batch, seed):
    spec = harness.load_spec()
    return harness.Context(
        cell=harness.find_cell(spec, CELL),
        config=dict(harness.load_config("mfcc_and_raw"), batch_size=batch,
                    compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), **SMALL_MIX),
        limits=harness.load_limits(CELL), seed=seed, seconds=0.0,
        trace=False, device=CPU, workdir=str(tmp_path))


@pytest.mark.parametrize("train", [True, False])
def test_reference_is_the_port_model_in_float64(train):
    b = 3
    w = harness.make_weights(mfcc_and_raw.param_shapes(12), 5, CPU)
    w = {k: v.double() for k, v in w.items()}
    net = _net().double()
    net.load_state_dict(w)
    net.train(train)
    x = mfcc_and_raw.features(_wav(b))
    out = net(x, torch.Generator().manual_seed(2)) if train else net(x)
    keep = D.dropout_masks(torch.Generator().manual_seed(2),
                           mfcc_and_raw.dropout_shapes(b), CPU)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = mfcc_and_raw.forward(p, x, train, keep)
    torch.testing.assert_close(ref, out, rtol=1e-10, atol=1e-10)
    if train:
        out.square().sum().backward()
        ref.square().sum().backward()
        for name, v in net.named_parameters():
            torch.testing.assert_close(p[name].grad, v.grad, rtol=1e-8,
                                       atol=1e-10, msg=name)


def test_features_are_the_ports_frontend():
    """In f64 on both sides the one difference is the port's constants
    (its DFT bases with the window folded in, the mel and DCT matrices),
    each rounded to f32 once, 2^-24 of itself at most: the magnitude
    keeps that relative error, the log turns it into an absolute one of
    the same size, and the DCT adds 80 such terms of weight at most
    2 / sqrt(160) = 0.158, so the MFCCs stay within 80 x 2^-24 of the
    largest one. (The waveform is handed on as it is.)"""
    wav = _wav(3)
    mfcc, raw = mfcc_and_raw.features(wav)
    got = FE.Frontend(_settings(), "highest").features(wav)
    assert got[1] is wav and raw is wav
    assert mfcc.shape == got[0].shape == (3, 98 * 60)
    tol = 80 * 2.0 ** -24 * float(mfcc.abs().max())
    torch.testing.assert_close(got[0], mfcc, rtol=0.0, atol=tol)


def test_parameters_and_penalised_kernels_are_the_ports():
    cfg = harness.load_config("mfcc_and_raw")
    shapes = mfcc_and_raw.param_shapes(cfg["num_classes"])
    net = _net()
    assert {n: tuple(s) for n, s, _ in shapes} == {
        n: tuple(v.shape) for n, v in net.state_dict().items()}
    assert sum(p.numel() for p in net.parameters()) == cfg["parameters"]
    kernels = {f"{name}.{k}" for name, m in net.named_modules()
               for k in getattr(m, "KERNELS", ())}
    assert kernels == {n for n, _, k in shapes if k == "kernel"}
    s = _settings()
    assert (s.spectrogram_length, s.num_log_mel_features,
            s.dct_coefficient_count, s.window_size_samples,
            s.window_stride_samples, s.output_representation) == (
        98, mfcc_and_raw.MFCCS, mfcc_and_raw.MELS, mfcc_and_raw.FRAME,
        mfcc_and_raw.HOP, "mfcc_and_raw")
    assert net.shape == (98, 60) and net.framing == (480, 160)


def test_draws_are_the_trainers(tmp_path):
    c = train_bank.Cell(_ctx(tmp_path, 4, 2 ** 31 + 11))
    g = D.trainer_generator(c.trainer_seed, CPU)
    assert mfcc_and_raw.dropout_shapes(4) == [((4, 384), 0.3)]
    for _ in range(2):
        d = c.tr.draw_batch()
        r = c.draw(g)
        for k in ("file_ids", "labels", "is_silence", "shifts", "fg_vol",
                  "bg_pos", "bg_vol"):
            assert torch.equal(getattr(d, k), getattr(r, k)), k
        x = c.tr.build_batch(d)
        assert torch.equal(x[1], D.decode_augment(c.bank, c.bg[0], r))
        c.tr._update_step(c.state, x, d.labels)
        D.dropout_masks(g, mfcc_and_raw.dropout_shapes(4), CPU)
        assert torch.equal(g.get_state(), c.tr.generator.get_state())


def test_flops_are_the_configurations():
    """The model's forward is the configuration's figure a clip, to the
    FLOP, and its backward twice it less the two stems' input gradients
    (the MFCCs and the frames need none); the features add their mel and
    DCT products, forward only (the FFT is no product the counter
    sees)."""
    cfg = harness.load_config("mfcc_and_raw")
    b = cfg["batch_size"]
    shapes = mfcc_and_raw.param_shapes(cfg["num_classes"])
    keep = [torch.ones(s, dtype=torch.bool, device="meta")
            for s, _ in mfcc_and_raw.dropout_shapes(b)]
    c = flops.count_flops(
        lambda p, x: mfcc_and_raw.forward(
            p, mfcc_and_raw.features(x), True, keep),
        {n: s for n, s, _ in shapes},
        {n: k in RT.KINDS_TRAINED for n, _, k in shapes}, b,
        cfg["clip_samples"])
    model = cfg["forward_flops_per_clip"] * b
    frontend = 2 * b * 98 * (257 * 80 + 80 * 60)
    assert frontend == 4_970_560 * b
    assert c["forward"] == model + frontend
    stems = 2 * b * 96 * (64 * 60 * 3 + 96 * 480 * 3)
    assert c["backward"] == 2 * model - stems
    assert c["step"] == T.step_flops(mfcc_and_raw, cfg)


@pytest.fixture(scope="module")
def limits():
    return harness.load_limits(CELL)


def _first_steps(tmp_path):
    """The cell's compared numbers at batch 8 in f32."""
    c = train_bank.Cell(_ctx(tmp_path, 8, 4_000_000_019))
    prog = T.checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    c.free_program()
    return RT.compare(prog, c.reference())


def test_the_program_reads_under_every_limit(tmp_path, limits):
    got = _first_steps(tmp_path)
    assert all(got[k] <= limits[k]
               for k in T.NUMBERS + ("feature_gap",)), got


def test_a_frontend_without_its_window_is_seen(tmp_path, limits,
                                               monkeypatch):
    """The port's DFT bases built without the Hann window (a rectangular
    frame), the cache of constants cleared before and after."""
    monkeypatch.setattr(FE, "hann_window_periodic",
                        lambda n, dtype=np.float32: np.ones(n, dtype))
    FE._constants.cache_clear()
    try:
        got = _first_steps(tmp_path)
    finally:
        monkeypatch.undo()
        FE._constants.cache_clear()
    assert got["input_gap"] <= limits["input_gap"]
    assert got["feature_gap"] > limits["feature_gap"], got
