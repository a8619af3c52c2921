"""The port's grouped models against the JAX ones (ROADMAP A8b):
``conv_1d_time_sliced_group`` and ``conv_1d_top_down``, built of
``GroupedDepthwiseBlock`` with the channels truncated to a multiple of
the groups, and the zero step that aligns the two branches of
``conv_1d_time_sliced_group``. The tests are
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

MODELS = ["conv_1d_time_sliced_group", "conv_1d_top_down"]


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param
