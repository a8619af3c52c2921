"""The port's optimizers and LR controller against the JAX package's.

``build_optimizer``'s SGD (with and without momentum), Adam and RMSprop
take 3 updates on the same gradients as the optax transforms of the JAX
``build_optimizer``, in float32: parameters within 1e-7 relative (to the
largest |value| of each). ``ReduceLROnPlateau`` gives the same LR
sequence as the JAX class on scripted metric sequences.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.train import optim as O
from speech_recognition_tpu_torch.train.checkpoint import PlateauCallback
from speech_recognition_tpu_torch.train.loop import TrainState

torch.set_num_threads(1)


@pytest.mark.parametrize("name,lr,momentum", [
    ("sgd", 1e-2, 0.9), ("sgd", 1e-2, 0.95), ("sgd", 1e-2, 0.0),
    ("adam", 1e-3, 0.0), ("adam", 3e-4, 0.0), ("rmsprop", 2e-3, 0.0)])
def test_three_updates_match_optax(name, lr, momentum):
    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]

    tx = JO.build_optimizer(name, lr, momentum)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)

    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = O.build_optimizer(name, list(ps.values()), lr, momentum)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in ps.items():
        want = np.asarray(params[k])
        got = p.detach().numpy()
        assert np.abs(got - want).max() <= 1e-7 * np.abs(want).max(), k
        assert not np.array_equal(got, init[k])


@pytest.mark.parametrize("mode,metrics", [
    ("max", [0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.60005, 0.7, 0.7, 0.7, 0.7,
             0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7]),
    ("min", [2.0, 1.5, 1.5, 1.49995, 1.5, 1.6, 1.0, 1.0, 1.0, 1.0, 1.0]),
])
def test_reduce_lr_on_plateau_matches_jax(mode, metrics):
    got = O.ReduceLROnPlateau(factor=0.5, patience=2 if mode == "min" else 4,
                              min_lr=1e-4, mode=mode, verbose=False)
    want = JO.ReduceLROnPlateau(factor=0.5, patience=2 if mode == "min"
                                else 4, min_lr=1e-4, mode=mode,
                                verbose=False)
    lr, jlr, lrs, jlrs = 2e-3, 2e-3, [], []
    for m in metrics:
        lr, jlr = got.update(m, lr), want.update(m, jlr)
        lrs.append(lr)
        jlrs.append(jlr)
    assert lrs == jlrs
    assert min(lrs) < 2e-3 and min(lrs) >= 1e-4


def test_plateau_callback_sets_the_learning_rate_in_place():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = O.build_optimizer("rmsprop", [p], 1e-3)
    state = TrainState(model=torch.nn.Linear(1, 1), optimizer=opt)
    cb = PlateauCallback(O.ReduceLROnPlateau(patience=1, verbose=False))
    logs = {"val_categorical_accuracy": 0.5}
    assert cb.on_epoch_end(0, state, logs) is None
    assert O.get_learning_rate(opt) == 1e-3
    cb.on_epoch_end(1, state, logs)
    assert O.get_learning_rate(opt) == 5e-4
