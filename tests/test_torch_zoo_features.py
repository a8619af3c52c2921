"""The port's residual feature models against the JAX ones (ROADMAP
A8c): ``conv_1d_log_mfcc`` (flat MFCCs of 98 x 60) and
``conv_1d_spectrogram`` (flat spectrograms of 98 x 257), both the
``_ResidualFeatureTrunk`` of ``Residual1D`` blocks that pool at their
stride with a softmax over time, and ``conv_1d_mfcc_and_raw``, fed the
(mfcc, raw) tuple, its raw side framed VALID at 480/160. The tests are
``tests/torch_zoo_parity.py``'s (see ``test_torch_zoo_ladders.py``).
Also the port's ``Predictor`` on ``conv_1d_mfcc_and_raw`` against the
JAX ``Predictor``, which passes the frontend's tuple to the model.
"""

import numpy as np
import pytest
import torch

from torch_zoo_parity import (  # noqa: F401  (fixtures and tests)
    CLASSES, flax_weights, pair, port,
    test_dropout_draws_from_the_generator, test_eval_logits_match_jax,
    test_from_flax_fills_every_tensor, test_gradients_match_jax_in_float64,
    test_logits_match_the_tf_twin_golden,
    test_parameter_count_equals_the_golden,
    test_train_mode_loss_matches_jax_in_float64, weights,
)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MODELS = ["conv_1d_log_mfcc", "conv_1d_spectrogram", "conv_1d_mfcc_and_raw"]
PROB_ATOL = 5e-5        # tests/test_torch_infer.py's bound


@pytest.fixture(scope="module", params=MODELS)
def name(request):
    return request.param


@pytest.mark.parametrize("use_tta", [False, True])
def test_predictor_on_the_mfcc_and_raw_tuple_matches_jax(use_tta):
    """Both Predictors featurize the clips into (mfcc, raw) and give the
    tuple to the model; the probabilities agree within 5e-5."""
    from speech_recognition_tpu.config import (
        prepare_model_settings as jax_settings,
    )
    from speech_recognition_tpu.infer.tta import (
        Predictor as JaxPredictor, TTAConfig as JaxTTAConfig,
    )
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig

    name, rep = "conv_1d_mfcc_and_raw", "mfcc_and_raw"
    module, params, stats = flax_weights(name)
    model = port(name, params, stats).eval()
    jax_pred = JaxPredictor(module, jax_settings(
        CLASSES, output_representation=rep), rep,
        JaxTTAConfig(use_tta=use_tta))
    pred = Predictor(model, prepare_model_settings(
        CLASSES, output_representation=rep), rep,
        TTAConfig(use_tta=use_tta), torch.device("cpu"))
    wav = np.random.default_rng(11).uniform(-0.6, 0.6, (3, 16000)).astype(
        np.float32)
    want = np.asarray(jax_pred.predict(
        {"params": params, "batch_stats": stats}, wav))
    got = pred.predict(wav).numpy()
    assert got.shape == want.shape == (3, CLASSES)
    assert np.abs(got - want).max() <= PROB_ATOL
    assert np.ptp(want, axis=0).max() > 3e-3 and want.max() < 0.999
