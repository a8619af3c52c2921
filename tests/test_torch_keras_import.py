"""The port's Keras checkpoint import against the JAX package's.

Each checkpoint is a Keras-2.1.2-layout HDF5 written from the structure
of a TF-twin golden (tests/goldens/model_twin_goldens.npz, through
``model_twins_lib.write_keras2_h5``), with a distinct value in every
element of every weight, so that any transposition, swapped gate or
misassigned group shows. The JAX importer loads it into the flax
variables' shapes (``jax.eval_shape`` of the init, no JAX program
compiled), ``from_flax`` moves its output to the port's layout, and the
port's ``import_keras_state_dict`` must give exactly that state_dict.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.export import keras_import as JK
from speech_recognition_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.models.keras_order import (
    creation_order as jax_creation_order,
)
from speech_recognition_tpu.models.keras_order_manifest import (
    KERAS_CREATION_ORDER as JAX_MANIFEST,
)
from speech_recognition_tpu_torch.export import keras_import as K
from speech_recognition_tpu_torch.models.convert import from_flax, to_flax
from speech_recognition_tpu_torch.models.keras_order import creation_order
from speech_recognition_tpu_torch.models.zoo import (
    MODEL_REGISTRY, build_model,
)
from speech_recognition_tpu_torch.tools import import_checkpoint
from speech_recognition_tpu_torch.train.checkpoint import restore_checkpoint
from speech_recognition_tpu_torch.train.loop import TrainState
from speech_recognition_tpu_torch.train.optim import build_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "goldens"))
from model_twins_lib import (  # noqa: E402
    structure_from_json, write_keras2_h5,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "model_twin_goldens.npz")
FLAGSHIP = "conv_1d_time_sliced_with_attention"
# one bare Dense, the flagship, nested Residual1D blocks, the BiGRU
MODELS = ("simple", FLAGSHIP, "conv_1d_residual", "conv_1d_simple")
MEL_40 = ("simple", "snn", "conv_2d", "conv_2d_mobile", "conv_2d_fast")


def _structure(name):
    goldens = np.load(GOLDENS)
    return structure_from_json(bytes(goldens[f"{name}_structure"]).decode())


def _distinct(structure):
    """Every element of every weight distinct: consecutive integers over
    the whole checkpoint, scaled into a small range."""
    out, start = [], 0
    for _, records in structure:
        for _, _, shape in records:
            n = int(np.prod(shape))
            out.append((np.arange(start, start + n, dtype=np.float64)
                        .reshape(shape) * 1e-6 - 0.3).astype(np.float32))
            start += n
    return out


def _write(path, structure, weights=None):
    write_keras2_h5(str(path), structure,
                    _distinct(structure) if weights is None else weights)
    return str(path)


def _port_model(name):
    geometry = ({"num_log_mel_features": 40} if name in MEL_40 else {})
    return build_model(name, num_classes=12, **geometry)[0]


def _jax_variables(name):
    module, _ = jax_build_model(name, num_classes=12)
    rep = JAX_REGISTRY[name].representation
    x = (jnp.zeros((1, 98 * 40)) if rep == "mfcc"
         else jnp.zeros((1, 16000)))
    return jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, x, train=False))


@pytest.mark.parametrize("name", sorted(JAX_MANIFEST))
def test_manifest_copy_equals_jax(name):
    assert set(MODEL_REGISTRY) == set(JAX_MANIFEST)
    assert creation_order(name) == jax_creation_order(name)


def test_unknown_model_has_no_manifest():
    with pytest.raises(ValueError, match="manifest"):
        creation_order("no_such_model")
    with pytest.raises(ValueError, match="manifest"):
        jax_creation_order("no_such_model")


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_flax_skeleton_round_trips_and_is_in_the_manifest(name):
    sd = _port_model(name).state_dict()
    params, stats = to_flax(sd, name)
    back = from_flax(params, stats, model=name)
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    # every module path of the skeleton is one the manifest orders
    manifest = set(creation_order(name))

    def paths(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield "/".join(prefix + (k,))
                yield from paths(v, prefix + (k,))

    assert set(paths(params)) | set(paths(stats)) <= manifest


@pytest.mark.parametrize("name", MODELS)
def test_import_equals_the_jax_import(name, tmp_path):
    structure = _structure(name)
    h5 = _write(tmp_path / f"{name}.h5", structure)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax.device_get(JK.import_keras_hdf5(
            h5, _jax_variables(name), module_order=jax_creation_order(name)))
        got = K.import_keras_state_dict(h5, _port_model(name), name)
    want = from_flax(want["params"], want.get("batch_stats", {}),
                     model=name)
    assert set(got) == set(want) == set(_port_model(name).state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # every Keras value landed exactly once
    keras = np.sort(np.concatenate([w.ravel() for w in _distinct(structure)]))
    port = np.sort(np.concatenate([t.numpy().ravel() for t in got.values()]))
    np.testing.assert_array_equal(port, keras)


def test_gru_gate_order(tmp_path):
    """conv_1d_simple's forward GRU: the Keras recurrent_kernel [u, 3u]
    splits into zr = [:, :2u] and h = [:, 2u:], each transposed."""
    structure = _structure("conv_1d_simple")
    weights = _distinct(structure)
    h5 = _write(tmp_path / "gru.h5", structure, weights)
    flat = [(layer, wname) for layer, recs in structure
            for wname, _, _ in recs]
    first = next(i for i, (_, w) in enumerate(flat)
                 if w.endswith("recurrent_kernel:0"))
    rk = weights[first]
    u = rk.shape[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = K.import_keras_state_dict(h5, _port_model("conv_1d_simple"),
                                        "conv_1d_simple")
    np.testing.assert_array_equal(
        got["BiGRU_0.GRU_0.recurrent_weight_zr"].numpy(), rk[:, :2 * u].T)
    np.testing.assert_array_equal(
        got["BiGRU_0.GRU_0.recurrent_weight_h"].numpy(), rk[:, 2 * u:].T)


@pytest.mark.parametrize("fault", ["missing", "leftover", "unknown_module"])
def test_import_faults_raise(fault, tmp_path):
    structure = _structure(FLAGSHIP)
    model = _port_model(FLAGSHIP)
    if fault == "missing":
        structure = structure[:-1]
        match = "no unused Keras weight"
    elif fault == "leftover":
        structure = structure + [["extra_dense", [
            ["extra_dense/bias:0", "bias", [7]]]]]
        match = "unconsumed Keras weights"
    else:
        match = "not in the Keras creation-order manifest"
    h5 = _write(tmp_path / "ckpt.h5", structure)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match=match):
            if fault == "unknown_module":
                params, stats = to_flax(model.state_dict(), FLAGSHIP)
                params["Renamed_0"] = params.pop("Dense_1")
                K.import_keras_hdf5(h5, {"params": params,
                                         "batch_stats": stats},
                                    module_order=creation_order(FLAGSHIP))
            else:
                K.import_keras_state_dict(h5, model, FLAGSHIP)


def test_transform_matches_jax():
    rng = np.random.default_rng(0)
    cases = [("l", "l/depthwise_kernel:0", rng.normal(size=(1, 3, 5, 1))),
             ("l", "l/recurrent_kernel:0", rng.normal(size=(4, 12))),
             ("l", "l/gamma:0", rng.normal(size=6)),
             ("l", "l/beta:0", rng.normal(size=6)),
             ("l", "l/moving_mean:0", rng.normal(size=6)),
             ("l", "l/moving_variance:0", rng.normal(size=6)),
             ("l", "l/kernel:0", rng.normal(size=(3, 4, 5)))]
    for case in cases:
        got, want = K._transform(*case), JK._transform(*case)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_import_checkpoint_cli_round_trips(tmp_path, capsys):
    h5 = _write(tmp_path / "ep-001-vl-0.5.hdf5", _structure(FLAGSHIP))
    out = str(tmp_path / "imported.pt")
    import_checkpoint.main(["--hdf5", h5, "--out", out, "--wanted_only"])
    assert "1191433 params" in capsys.readouterr().out
    model = _port_model(FLAGSHIP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = K.import_keras_state_dict(h5, model, FLAGSHIP)
    state = TrainState(model, build_optimizer("rmsprop",
                                              model.parameters(), 1e-3))
    state.step = 5
    restore_checkpoint(out, state)
    assert state.step == 0
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, want[k]), k
