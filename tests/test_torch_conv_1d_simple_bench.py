"""The benchmark's plain reference of ``conv_1d_simple``
(``kws_bench/reference/conv_1d_simple.py``) against the port, on the CPU:

- f64, the published widths, batch 3: the same weights and the GRU's
  six masks drawn in ``dropout_shapes`` order give the port's logits to
  1e-10 in train and eval mode, and every leaf's gradient to rtol 1e-8;
- the parameter names and shapes and the penalised kernels are the
  port's, and the zoo's recipe (Adam) is the configuration's;
- the trainer's generator after a step is the reference's after it
  redraws the batch and the GRU's masks;
- the reference's FLOPs against the configuration's
  ``forward_flops_per_clip`` and the step's, worked out from it;
- a CPU run of the cell at batch 8 in f32 reads under every limit, and
  an Adam step without its bias correction, planted in a copy of the
  port's optimizer, reads above ``change_gap``'s.
"""

import pytest
import torch

from kws_bench import flops, harness
from kws_bench.reference import conv_1d_simple
from kws_bench.reference import draws as D
from kws_bench.reference import train as RT
from kws_bench.traffic import _train as T
from kws_bench.traffic import train_bank
from speech_recognition_tpu_torch.models.zoo import build_model, get_spec

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "conv_1d_simple.train_bank"
SMALL_MIX = dict(num_train=64, num_val=8, num_pseudo=8, background_clips=2,
                 background_seconds=2)


def _net():
    net, _ = build_model("conv_1d_simple", num_classes=12)
    return net


def _ctx(tmp_path, batch, seed):
    spec = harness.load_spec()
    return harness.Context(
        cell=harness.find_cell(spec, CELL),
        config=dict(harness.load_config("conv_1d_simple"), batch_size=batch,
                    compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), **SMALL_MIX),
        limits=harness.load_limits(CELL), seed=seed, seconds=0.0,
        trace=False, device=CPU, workdir=str(tmp_path))


@pytest.mark.parametrize("train", [True, False])
def test_reference_is_the_port_model_in_float64(train):
    b = 3
    w = harness.make_weights(conv_1d_simple.param_shapes(12), 5, CPU)
    w = {k: v.double() for k, v in w.items()}
    net = _net().double()
    net.load_state_dict(w)
    net.train(train)
    x = torch.randn(b, 16000, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64) * 0.3
    out = net(x, torch.Generator().manual_seed(2)) if train else net(x)
    keep = D.dropout_masks(torch.Generator().manual_seed(2),
                           conv_1d_simple.dropout_shapes(b), CPU)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = conv_1d_simple.forward(p, x, train, keep)
    torch.testing.assert_close(ref, out, rtol=1e-10, atol=1e-10)
    if train:
        out.square().sum().backward()
        ref.square().sum().backward()
        for name, v in net.named_parameters():
            torch.testing.assert_close(p[name].grad, v.grad, rtol=1e-8,
                                       atol=1e-10, msg=name)


def test_parameters_penalised_kernels_and_recipe_are_the_ports():
    cfg = harness.load_config("conv_1d_simple")
    shapes = conv_1d_simple.param_shapes(cfg["num_classes"])
    net = _net()
    assert {n: tuple(s) for n, s, _ in shapes} == {
        n: tuple(v.shape) for n, v in net.state_dict().items()}
    assert sum(p.numel() for p in net.parameters()) == cfg["parameters"]
    kernels = {f"{name}.{k}" for name, m in net.named_modules()
               for k in getattr(m, "KERNELS", ())}
    assert kernels == {n for n, _, k in shapes if k == "kernel"}
    spec = get_spec("conv_1d_simple")
    assert (spec.optimizer, spec.learning_rate, spec.label_smoothing,
            spec.l2_reg) == (cfg["optimizer"], cfg["learning_rate"],
                             cfg["label_smoothing"], cfg["l2_reg"])
    # 16,000 samples to 999 steps at the stem, 10 into the BiGRU
    t, lengths = 16000, []
    for _, _, _, k, stride in conv_1d_simple._blocks():
        t = (t - k) // stride + 1
        lengths.append(t)
    assert lengths[:2] == [999, 997] and lengths[-1] == 10


def test_draws_are_the_trainers(tmp_path):
    c = train_bank.Cell(_ctx(tmp_path, 4, 2 ** 31 + 11))
    g = D.trainer_generator(c.trainer_seed, CPU)
    assert conv_1d_simple.dropout_shapes(4) == 2 * [
        ((3, 4, 1, 224), 0.2), ((3, 4, 128), 0.2)]
    for _ in range(2):
        d = c.tr.draw_batch()
        r = c.draw(g)
        for k in ("file_ids", "labels", "is_silence", "shifts", "fg_vol",
                  "bg_pos", "bg_vol"):
            assert torch.equal(getattr(d, k), getattr(r, k)), k
        x = c.tr.build_batch(d)
        assert torch.equal(x, D.decode_augment(c.bank, c.bg[0], r))
        c.tr._update_step(c.state, x, d.labels)
        D.dropout_masks(g, conv_1d_simple.dropout_shapes(4), CPU)
        assert torch.equal(g.get_state(), c.tr.generator.get_state())


def test_flops_are_the_configurations():
    """The model's forward is the configuration's figure a clip, to the
    FLOP, and its backward twice it less the input gradients that no
    leaf needs: the stem's (the clip) and, in each direction, the first
    step's z and r products' (the zero state)."""
    cfg = harness.load_config("conv_1d_simple")
    b = cfg["batch_size"]
    shapes = conv_1d_simple.param_shapes(cfg["num_classes"])
    keep = [torch.ones(s, dtype=torch.bool, device="meta")
            for s, _ in conv_1d_simple.dropout_shapes(b)]
    c = flops.count_flops(
        lambda p, x: conv_1d_simple.forward(p, x, True, keep),
        {n: s for n, s, _ in shapes},
        {n: k in RT.KINDS_TRAINED for n, _, k in shapes}, b,
        cfg["clip_samples"])
    model = cfg["forward_flops_per_clip"] * b
    assert c["forward"] == model
    stem = 2 * b * 999 * 31                 # the k31 depthwise conv's
    first_state = 2 * 2 * (2 * b * 128 * 128)
    assert c["backward"] == 2 * model - stem - first_state
    assert c["step"] == T.step_flops(conv_1d_simple, cfg)
    # the BiGRU's products: the input projections of 10 steps and the
    # recurrent ones, both directions
    gru = 2 * 2 * b * 10 * (3 * 224 * 128 + 3 * 128 * 128)
    assert gru < model


@pytest.fixture(scope="module")
def limits():
    return harness.load_limits(CELL)


def _first_steps(tmp_path, optimizer=None):
    """The cell's compared numbers at batch 8 in f32; ``optimizer(params,
    opt)`` replaces the port's optimizer before the first step."""
    c = train_bank.Cell(_ctx(tmp_path, 8, 4_000_000_019))
    if optimizer is not None:
        c.state.optimizer = optimizer(list(c.state.model.parameters()),
                                      c.state.optimizer)
    prog = T.checked_steps(c.tr, c.state, c.step, c.names, c.weights)
    c.free_program()
    return RT.compare(prog, c.reference())


def test_the_program_reads_under_every_limit(tmp_path, limits):
    got = _first_steps(tmp_path)
    assert all(got[k] <= limits[k] for k in T.NUMBERS), got


class _UncorrectedAdam(torch.optim.Adam):
    """The port's Adam with its constants, less the bias correction:
    p <- p - lr m / (sqrt(v) + eps), m and v as Adam keeps them."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                s = self.state[p]
                if not s:
                    s["step"] = torch.zeros(())
                    s["exp_avg"] = torch.zeros_like(p)
                    s["exp_avg_sq"] = torch.zeros_like(p)
                s["step"] += 1
                s["exp_avg"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
                s["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad,
                                                  value=1.0 - b2)
                p.addcdiv_(s["exp_avg"],
                           s["exp_avg_sq"].sqrt().add_(group["eps"]),
                           value=-group["lr"])


def test_adam_without_its_bias_correction_is_seen(tmp_path, limits):
    """Uncorrected, Adam's first three steps are 3.2-5.0x the corrected
    ones: the change reads far above its limit, the first gradient (read
    back from ``exp_avg_sq``, which the fault leaves as it was) under
    its own."""
    def copy(params, opt):
        group = opt.param_groups[0]
        return _UncorrectedAdam(params, lr=group["lr"],
                                betas=group["betas"], eps=group["eps"])

    got = _first_steps(tmp_path, copy)
    assert got["grad_gap"] <= limits["grad_gap"], got
    assert got["change_gap"] > limits["change_gap"], got
