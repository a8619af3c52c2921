"""The reference's optimizers against the program's, and the first
gradient read back from each optimizer's state, in float64 on the
CPU."""

import pytest
import torch

from kws_bench.reference import train as RT
from kws_bench.traffic import _train as T

# the zoo's recipes: learning rate and momentum; the constants that
# ``build_optimizer`` fixes, under the configurations' names
CONFIGS = {
    "rmsprop": {"optimizer": "rmsprop", "learning_rate": 1e-3, "rho": 0.9,
                "epsilon": 1e-8},
    "adam": {"optimizer": "adam", "learning_rate": 1e-3, "beta_1": 0.9,
             "beta_2": 0.999, "epsilon": 1e-8},
    "sgd": {"optimizer": "sgd", "learning_rate": 1e-2, "momentum": 0.9},
}


def _leaves():
    g = torch.Generator().manual_seed(3)
    return [torch.randn(5, 4, generator=g, dtype=torch.float64),
            torch.randn(4, generator=g, dtype=torch.float64)]


def _loss(params, i):
    """A loss whose gradient changes from step to step."""
    w, b = params
    x = torch.linspace(-1.0, 1.0, 20, dtype=torch.float64).view(4, 5) + i
    return ((x @ w + b).tanh() - 0.3).square().sum()


def _program(cfg):
    from speech_recognition_tpu_torch.train.optim import build_optimizer

    params = [p.clone().requires_grad_(True) for p in _leaves()]
    opt = build_optimizer(cfg["optimizer"], params, cfg["learning_rate"],
                          cfg.get("momentum", 0.0))
    return params, opt


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_the_reference_optimizer_is_torchs(kind):
    """Three steps of ``RT.optimizer`` equal three of the
    ``torch.optim`` object the program builds, in float64."""
    cfg = CONFIGS[kind]
    params, opt = _program(cfg)
    assert T.optimizer_constants(opt) == {
        k: cfg[k] for k in T.optimizer_constants(opt)}
    ref = [p.clone().requires_grad_(True) for p in _leaves()]
    update = RT.optimizer(cfg, ref)
    for i in range(3):
        opt.zero_grad()
        _loss(params, i).backward()
        opt.step()
        grads = torch.autograd.grad(_loss(ref, i), ref)
        with torch.no_grad():
            update(grads)
    for p, r, start in zip(params, ref, _leaves()):
        assert not torch.equal(p.detach(), start)
        torch.testing.assert_close(r, p.detach(), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_the_first_gradient_comes_back_from_the_state(kind):
    """After one step, each optimizer's state gives back the gradient's
    magnitude that autograd computed."""
    params, opt = _program(CONFIGS[kind])
    _loss(params, 0).backward()
    grads = [p.grad.clone() for p in params]
    opt.step()
    for p, g in zip(params, grads):
        torch.testing.assert_close(T.first_gradient(opt, p), g.abs(),
                                   rtol=1e-12, atol=1e-15)


def test_a_parameter_without_gradient_reads_zero():
    params, opt = _program(CONFIGS["adam"])
    params[0].sum().backward()              # none for params[1]
    opt.step()
    assert torch.equal(T.first_gradient(opt, params[1]),
                       torch.zeros_like(params[1]))


@pytest.mark.parametrize("opt", [
    lambda p: torch.optim.SGD(p, lr=0.1),               # keeps no buffer
    lambda p: torch.optim.Adagrad(p, lr=0.1)])
def test_an_optimizer_without_a_reading_is_refused(opt):
    params = [p.requires_grad_(True) for p in _leaves()]
    o = opt(params)
    _loss(params, 0).backward()
    o.step()
    with pytest.raises(TypeError):
        T.first_gradient(o, params[0])


def test_an_unknown_reference_optimizer_is_refused():
    with pytest.raises(ValueError):
        RT.optimizer({"optimizer": "adagrad", "learning_rate": 0.1},
                     _leaves())
