"""The port's Keras-v1 BiGRU models against the JAX ones (ROADMAP A8e):
``conv_1d_simple`` (a depthwise ladder on the raw clip, then a BiGRU of
128 units over 10 steps) and ``xception_with_attention`` (a
``Residual1D`` trunk, a softmax over time, a BiGRU of 192 units over 50
steps). The tests are ``tests/torch_zoo_parity.py``'s (see
``test_torch_zoo_ladders.py``); the f64 comparison injects the GRUs'
variational masks, three per gate on the input and three on the state
for each direction, in the JAX draw order. Also the L2 penalty over
every kernel-named tensor, the GRUs' three included, against the JAX
``l2_kernel_penalty``.
"""

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu.train import optim as JO
from speech_recognition_tpu_torch.models.convert import from_flax
from speech_recognition_tpu_torch.train import optim as O
from torch_zoo_parity import (  # noqa: F401  (fixtures and tests)
    flax_weights, pair, port, test_dropout_draws_from_the_generator,
    test_eval_logits_match_jax, test_from_flax_fills_every_tensor,
    test_gradients_match_jax_in_float64,
    test_logits_match_the_tf_twin_golden,
    test_parameter_count_equals_the_golden,
    test_train_mode_loss_matches_jax_in_float64, weights,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MODELS = ["conv_1d_simple", "xception_with_attention"]


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param


def test_l2_penalty_covers_the_gru_kernels_as_jax_does():
    """xception_with_attention's penalty in f64 equals the JAX one to
    1e-12 relative, and the GRUs' kernels are part of it."""
    name = "xception_with_attention"
    _, params, stats = flax_weights(name)
    with jax.enable_x64(True):
        want = float(JO.l2_kernel_penalty(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), params), 1e-5))
    model = port(name, params, stats, torch.float64)
    got = float(O.l2_kernel_penalty(model, 1e-5).detach())
    assert abs(got - want) <= 1e-12 * want
    gru = {k: v for k, v in from_flax(params, {}, model=name).items()
           if k.startswith("BiGRU_0.")}
    assert sorted(k.rsplit(".", 1)[1] for k in gru) == sorted(
        ["weight", "bias", "recurrent_weight_zr", "recurrent_weight_h"] * 2)
    gru_part = 1e-5 * sum(float(v.double().square().sum())
                          for k, v in gru.items() if "weight" in k)
    assert gru_part > 1e-3 * want
