"""The port's MFCC models against the JAX ones (ROADMAP A8d): the MLPs
``simple`` (``preprocess_mfcc`` -> Dense) and ``snn`` (SELU,
``AlphaDropout``, lecun-normal Dense layers), and the 2-D convs
``conv_2d``, ``conv_2d_mobile`` and ``conv_2d_fast`` (NCHW, TF SAME per
axis, dilation (2, 1), separable ``max_pool_2d``, 4-D dropout masks), on
flat MFCCs of 98 x 40. The tests are ``tests/torch_zoo_parity.py``'s
(see ``test_torch_zoo_ladders.py``); the f64 comparison injects every
Dropout and AlphaDropout mask on both sides.
"""

import numpy as np
import pytest
import torch

from torch_zoo_parity import (  # noqa: F401  (fixtures and tests)
    CLASSES, inputs, pair, settings, test_dropout_draws_from_the_generator,
    test_eval_logits_match_jax, test_from_flax_fills_every_tensor,
    test_gradients_match_jax_in_float64,
    test_logits_match_the_tf_twin_golden,
    test_parameter_count_equals_the_golden,
    test_train_mode_loss_matches_jax_in_float64, to_torch, weights,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MODELS = ["simple", "snn", "conv_2d", "conv_2d_mobile", "conv_2d_fast"]


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param


def test_conv_2d_fast_flatten_head_matches_jax():
    """The ablation field ``head='flatten'`` reaches the constructor
    through ``model_kwargs`` and flattens the 6 x 2 grid in NHWC order."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_tpu.models import build_model as jax_build
    from speech_recognition_tpu_torch.models.convert import from_flax
    from speech_recognition_tpu_torch.models.zoo import build_model

    geometry = dict(settings("conv_2d_fast"), model_kwargs={"head":
                                                             "flatten"})
    module, _ = jax_build("conv_2d_fast", num_classes=CLASSES, **geometry)
    x = inputs("conv_2d_fast", 4)
    v = jax.device_get(module.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                   train=False))
    want = np.asarray(module.apply(v, jnp.asarray(x), train=False))
    model, _ = build_model("conv_2d_fast", num_classes=CLASSES, **geometry)
    assert model.head[0].weight.shape == (CLASSES, 128 * 6 * 2)
    model.load_state_dict(from_flax(v["params"], v["batch_stats"],
                                    model="conv_2d_fast"))
    with torch.no_grad():
        got = model.eval()(to_torch(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
