"""The benchmark's plain reference of ``xception_with_attention``
(``kws_bench/reference/xception.py`` and its Keras-v1 GRU,
``recurrent.py``) against the port, on the CPU:

- f64, the published widths, batch 3: the same weights and the masks
  drawn in ``dropout_shapes`` order give the port's logits to 1e-10 in
  train and eval mode, and every leaf's gradient to rtol 1e-8;
- the trainer's generator after a step is the reference's after it
  redraws the batch and the four GRU mask sets;
- the reference's FLOPs against the configuration's
  ``forward_flops_per_clip`` and the step's, worked out from it;
- a fault planted in the port's GRU, the reverse direction run forward,
  reads above the cell's ``grad_gap`` or ``change_gap`` limit in a CPU
  run of the cell at batch 8 in f32, where the program as it is reads
  under every limit. (``sigmoid`` for ``hard_sigmoid`` does not: at the
  seeded weights the gates' inputs lie near 0, where the two differ by
  their slopes alone, 0.25 against 0.2.)
"""

import pytest
import torch

from kws_bench import flops, harness
from kws_bench.reference import draws as D
from kws_bench.reference import train as RT
from kws_bench.reference import xception
from kws_bench.traffic import _train as T
from kws_bench.traffic import train_bank

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "xception.train_bank"
SMALL_MIX = dict(num_train=64, num_val=8, num_pseudo=8, background_clips=2,
                 background_seconds=2)


def _ctx(tmp_path, batch, seed):
    spec = harness.load_spec()
    return harness.Context(
        cell=harness.find_cell(spec, CELL),
        config=dict(harness.load_config("xception"), batch_size=batch,
                    compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), **SMALL_MIX),
        limits=harness.load_limits(CELL), seed=seed, seconds=0.0,
        trace=False, device=CPU, workdir=str(tmp_path))


@pytest.mark.parametrize("train", [True, False])
def test_reference_is_the_port_model_in_float64(train):
    from speech_recognition_tpu_torch.models.zoo import build_model

    b = 3
    w = harness.make_weights(xception.param_shapes(12), 5, CPU)
    w = {k: v.double() for k, v in w.items()}
    net, _ = build_model("xception_with_attention", num_classes=12)
    net = net.double()
    net.load_state_dict(w)
    net.train(train)
    x = torch.randn(b, 16000, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64) * 0.3
    out = net(x, torch.Generator().manual_seed(2)) if train else net(x)
    keep = D.dropout_masks(torch.Generator().manual_seed(2),
                           xception.dropout_shapes(b), CPU)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = xception.forward(p, x, train, keep)
    torch.testing.assert_close(ref, out, rtol=1e-10, atol=1e-10)
    if train:
        out.square().sum().backward()
        ref.square().sum().backward()
        for name, v in net.named_parameters():
            torch.testing.assert_close(p[name].grad, v.grad, rtol=1e-8,
                                       atol=1e-10, msg=name)


def test_parameters_and_penalised_kernels_are_the_ports():
    from speech_recognition_tpu_torch.models.zoo import build_model

    cfg = harness.load_config("xception")
    shapes = xception.param_shapes(cfg["num_classes"])
    net, _ = build_model(cfg["model"], num_classes=cfg["num_classes"])
    state = net.state_dict()
    assert {n: tuple(s) for n, s, _ in shapes} == {
        n: tuple(v.shape) for n, v in state.items()}
    assert sum(p.numel() for p in net.parameters()) == cfg["parameters"]
    kernels = {f"{name}.{k}" for name, m in net.named_modules()
               for k in getattr(m, "KERNELS", ())}
    assert kernels == {n for n, _, k in shapes if k == "kernel"}
    assert {n for n in kernels if ".GRU_" in n} == {
        f"BiGRU_0.GRU_{i}.{k}" for i in (0, 1)
        for k in ("weight", "recurrent_weight_zr", "recurrent_weight_h")}


def test_draws_are_the_trainers(tmp_path):
    c = train_bank.Cell(_ctx(tmp_path, 4, 2 ** 31 + 11))
    g = D.trainer_generator(c.trainer_seed, CPU)
    assert xception.dropout_shapes(4) == [
        ((3, 4, 1, 384), 0.2), ((3, 4, 192), 0.2)] * 2
    for _ in range(2):
        d = c.tr.draw_batch()
        r = c.draw(g)
        for k in ("file_ids", "labels", "is_silence", "shifts", "fg_vol",
                  "bg_pos", "bg_vol"):
            assert torch.equal(getattr(d, k), getattr(r, k)), k
        assert torch.equal(c.tr.build_batch(d),
                           D.decode_augment(c.bank, c.bg[0], r))
        c.tr._update_step(c.state, c.tr.build_batch(d), d.labels)
        D.dropout_masks(g, xception.dropout_shapes(4), CPU)
        assert torch.equal(g.get_state(), c.tr.generator.get_state())


def test_flops_are_the_configurations():
    """The forward is the configuration's figure a clip, to the FLOP; the
    backward twice it, less the products whose input needs no gradient:
    the stem's (its input is the clip) and, in each direction, the first
    recurrent step's z and r products (their state is the zero h_0; the
    candidate's takes r * h_0, which does)."""
    cfg = harness.load_config("xception")
    b = cfg["batch_size"]
    shapes = xception.param_shapes(cfg["num_classes"])
    keep = [torch.ones(s, dtype=torch.bool, device="meta")
            for s, _ in xception.dropout_shapes(b)]
    c = flops.count_flops(
        lambda p, x: xception.forward(p, x, True, keep),
        {n: s for n, s, _ in shapes},
        {n: k in RT.KINDS_TRAINED for n, _, k in shapes}, b,
        cfg["clip_samples"])
    fwd = cfg["forward_flops_per_clip"] * b
    assert c["forward"] == fwd == 413_946_752 * b
    stem = 2 * b * 64 * 399 * 40 * 3
    first_state = 2 * 2 * (2 * b * 192 * 192)
    assert c["step"] == 3 * fwd - stem - first_state
    assert c["step"] == T.step_flops(xception, cfg)
    gru = 2 * (2 * 50 * 384 * 576 + 50 * 3 * 2 * 192 * 192)
    assert gru == 66_355_200                 # the GRU's share a clip


def _first_steps(tmp_path, reverse=True):
    """The cell's compared numbers at batch 8 in f32, the reverse GRU's
    direction as ``reverse`` says."""
    c = train_bank.Cell(_ctx(tmp_path, 8, 4_000_000_019))
    c.state.model.BiGRU_0.GRU_1.reverse = reverse
    prog = T.checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    c.free_program()
    return RT.compare(prog, c.reference())


@pytest.fixture(scope="module")
def limits():
    return harness.load_limits(CELL)


def test_the_program_reads_under_every_limit(tmp_path, limits):
    got = _first_steps(tmp_path)
    assert all(got[k] <= limits[k] for k in T.NUMBERS), got


def test_a_gru_run_the_wrong_way_is_seen(tmp_path, limits):
    got = _first_steps(tmp_path, reverse=False)
    assert got["grad_gap"] > limits["grad_gap"] \
        or got["change_gap"] > limits["change_gap"], got
