"""The port's 1-D ladder models against the JAX ones (ROADMAP A8a):
parameter-count golden, eval logits in f32 (1e-4 of max |logit|), the
train-mode loss and gradients in f64 with injected dropout masks (1e-10),
and the TF-twin golden within tests/test_model_twins.py's bound. The
tests are ``tests/torch_zoo_parity.py``'s. The JAX side is jitted: each
model's jitted f64 gradient agrees with the port's, so none shows the
flagship's jit-only difference (ROADMAP C1). Also the flagship's TF-twin
golden, which no port test held before.
"""

import pytest
import torch

from torch_zoo_parity import (  # noqa: F401  (fixtures and tests)
    pair, test_dropout_draws_from_the_generator,
    test_eval_logits_match_jax, test_from_flax_fills_every_tensor,
    test_gradients_match_jax_in_float64,
    test_logits_match_the_tf_twin_golden,
    test_parameter_count_equals_the_golden,
    test_train_mode_loss_matches_jax_in_float64, twin_logits, weights,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MODELS = ["conv_1d_time_sliced", "conv_1d_time_stacked", "conv_1d_heavy",
          "conv_1d_gru", "conv_1d_fast", "conv_1d_learned_spec",
          "conv_1d_multi_time_sliced"]


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param


def test_flagship_logits_match_the_tf_twin_golden(tmp_path):
    import numpy as np
    got, want = twin_logits("conv_1d_time_sliced_with_attention", tmp_path)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_filter_mult_widens_conv_1d_time_sliced():
    from speech_recognition_tpu_torch.models.zoo import build_model
    model, _ = build_model("conv_1d_time_sliced", num_classes=12,
                           model_kwargs={"filter_mult": 2})
    assert model.trunk[0].conv.weight.shape == (64, 40, 3)
    assert model.eval()(torch.zeros(2, 16000)).shape == (2, 12)
