"""The port's raw-waveform residual models against the JAX ones (ROADMAP
A8c): ``conv_1d_residual`` (frames of 40, thirteen ``Residual1D`` blocks
that pool 3 at their stride, the head blocks created after the trunk)
and ``steffeNet`` (a k75 stride-50 SAME stem, twelve ``Residual1D``
blocks with the stride on the first conv and no pool, a max+avg head
with no bias; 20,056,448 parameters). The tests are
``tests/torch_zoo_parity.py``'s (see ``test_torch_zoo_ladders.py``).
"""

import pytest
import torch

from torch_zoo_parity import (  # noqa: F401  (fixtures and tests)
    pair, test_dropout_draws_from_the_generator,
    test_eval_logits_match_jax, test_from_flax_fills_every_tensor,
    test_gradients_match_jax_in_float64,
    test_logits_match_the_tf_twin_golden,
    test_parameter_count_equals_the_golden,
    test_train_mode_loss_matches_jax_in_float64, weights,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MODELS = ["conv_1d_residual", "steffeNet"]


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param
