"""The plain references against the port on the CPU at small batches:
the same weights give the same logits, loss gradients and draws."""

import pytest
import torch

from kws_bench import harness
from kws_bench.reference import draws as D
from kws_bench.reference import flagship, layers, steffenet
from kws_bench.reference import train as RT
from kws_bench.traffic import train_bank

CPU = torch.device("cpu")


@pytest.mark.parametrize("ref,zoo_name", [
    (flagship, "conv_1d_time_sliced_with_attention"),
    (steffenet, "steffeNet")])
@pytest.mark.parametrize("train", [True, False])
def test_reference_model_is_the_port_model(ref, zoo_name, train):
    from speech_recognition_tpu_torch.models.zoo import build_model

    b = 3
    w = harness.make_weights(ref.param_shapes(12), 5, CPU)
    w = {k: v.double() for k, v in w.items()}
    net, _ = build_model(zoo_name, num_classes=12)
    net = net.double()
    net.load_state_dict(w)
    net.train(train)
    x = torch.randn(b, 16000, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64) * 0.3
    g = torch.Generator().manual_seed(2)
    out = net(x, g) if train else net(x)
    g = torch.Generator().manual_seed(2)
    keep = D.dropout_masks(g, ref.dropout_shapes(b), CPU)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_out = ref.forward(p, x, train, keep)
    torch.testing.assert_close(ref_out, out, rtol=1e-10, atol=1e-10)
    if train:
        out.square().sum().backward()
        ref_out.square().sum().backward()
        grads = dict(net.named_parameters())
        for name, v in grads.items():
            torch.testing.assert_close(p[name].grad, v.grad, rtol=1e-8,
                                       atol=1e-10)


def test_draws_are_the_trainers(tmp_path):
    spec = harness.load_spec()
    cell = harness.find_cell(spec, "flagship.train_bank")
    ctx = harness.Context(
        cell=cell, config=dict(harness.load_config("flagship"),
                               batch_size=16, compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), num_train=64,
                 num_val=8, num_pseudo=8, background_clips=2,
                 background_seconds=2),
        limits={}, seed=2 ** 31 + 11, seconds=0.0, trace=False, device=CPU,
        workdir=str(tmp_path))
    c = train_bank.Cell(ctx)
    g = D.trainer_generator(c.trainer_seed, CPU)
    for _ in range(3):
        d = c.tr.draw_batch()
        r = c.draw(g)
        for k in ("file_ids", "labels", "is_silence", "shifts", "fg_vol",
                  "bg_pos", "bg_vol"):
            assert torch.equal(getattr(d, k), getattr(r, k)), k
        assert torch.equal(c.tr.build_batch(d),
                           D.decode_augment(c.bank, c.bg[0], r))
        c.tr._update_step(c.state, c.tr.build_batch(d), d.labels)
        D.dropout_masks(g, flagship.dropout_shapes(16), CPU)
        assert torch.equal(g.get_state(), c.tr.generator.get_state())


def test_first_step_matches_in_float32(tmp_path):
    """One step in float32: the program's first gradient (from RMSprop's
    accumulator) and loss are the reference's to rounding."""
    from kws_bench.traffic import _train as T

    spec = harness.load_spec()
    ctx = harness.Context(
        cell=harness.find_cell(spec, "flagship.train_bank"),
        config=dict(harness.load_config("flagship"), batch_size=8,
                    compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), num_train=64,
                 num_val=8, num_pseudo=8, background_clips=2,
                 background_seconds=2),
        limits={}, seed=123, seconds=0.0, trace=False, device=CPU,
        workdir=str(tmp_path))
    c = train_bank.Cell(ctx)
    prog = T.checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    ref = RT.steps(c.model, ctx.config, c.weights, lambda i, g: c.draw(g),
                   lambda i: c.bank, c.bg[0], c.trainer_seed, 1)
    assert float((prog["losses"][0] - ref["losses"][0]).abs()) < 1e-5
    assert RT.elem_gap(prog["grads"], ref["grads"]) < 1e-4
    assert RT.grad_norm_gap(prog["grads"], ref["grads"]) < 1e-5
    assert sorted(prog["bn_stats"]) == sorted(ref["bn_stats"])
    assert RT.bn_gap(prog["bn_stats"], ref["bn_stats"]) < 1e-4


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -0.3])
    y = layers.fp8_e4m3(x)
    assert y[0] == 1.0 and y[3] == 448.0
    assert float((y - x).abs().max()) <= 448.0 / 2 ** 4
    assert not torch.equal(layers.fp8_e4m3(torch.tensor([1.0, 1.03])),
                           torch.tensor([1.0, 1.03]))


def test_leaf_gap_takes_the_median_leaf_as_floor():
    ref = torch.tensor([1.0, 2.0, 3.0, 1e-6])
    prog = torch.tensor([1.0, 2.2, 3.0, 2e-6])
    assert RT.leaf_gap(prog, ref) == pytest.approx(0.1)
    mask = torch.tensor([True, False, True, True])
    assert RT.leaf_gap(prog, ref, mask) == pytest.approx(1e-6 / 1.0)
    assert RT.moved([torch.full((4,), v / 2) for v in ref.tolist()]
                    ).tolist() == [True, True, True, False]


def test_gradient_gaps():
    ref = [torch.tensor([3.0, -4.0]), torch.tensor([0.0])]
    assert RT.elem_gap([torch.tensor([3.0, 4.0]), torch.tensor([0.0])],
                       ref) == 0.0
    prog = [torch.tensor([3.0, 4.0]), torch.tensor([1.0])]
    assert RT.elem_gap(prog, ref) == pytest.approx(0.2)
    assert RT.grad_norm_gap(prog, ref) == pytest.approx(26 ** 0.5 / 5 - 1)


def test_bn_gap_is_in_standard_deviations():
    ref = {"a": (torch.tensor([0.0, 1.0]), torch.tensor([4.0, 1.0]))}
    prog = {"a": (torch.tensor([0.2, 1.0]), torch.tensor([4.0, 1.1]))}
    # mean gaps 0.1 and 0 std, variance gaps 0 and 0.1: rms over 4
    assert RT.bn_gap(prog, ref) == pytest.approx((0.02 / 4) ** 0.5)
