"""Keras HDF5 checkpoint import (port of
speech_recognition_tpu/export/keras_import.py).

The reference ships trained Keras 2.1.2 ``.hdf5`` checkpoints
(train.py:65-68). ``import_keras_state_dict`` loads one into a zoo
model of the port. It runs the JAX package's matching algorithm, copied
here as it is (``read_keras_weights``, ``_transform``,
``_ordered_leaves``, ``import_keras_hdf5``), over a flax-layout skeleton
of the port's model (``models.convert.to_flax``), then moves the matched
arrays to the port's layout with ``models.convert.from_flax``: one
algorithm, held against the JAX one by
``tests/test_torch_keras_import.py``.

The algorithm: every Keras weight, after its layout transform
(``_transform``: a ``DepthwiseConv2D(1, k)`` kernel [1, k, C, 1] ->
[k, 1, C]; a GRU ``recurrent_kernel`` [u, 3u] -> ``recurrent_kernel_zr``
[u, 2u] + ``recurrent_kernel_h`` [u, u]; BN ``gamma``/``beta``/moving
statistics -> ``scale``/``beta``/``mean``/``var``), is consumed exactly
once by a slot of the same kind and shape, and within each (kind, shape)
group the i-th slot in creation order (``models/keras_order.py``) gets
the i-th weight of the group in storage order. A BN ``beta`` is a kind
of its own, never a plain bias. A module path missing from the manifest,
a slot no weight fits and a weight left over each raise; groups matched
by order alone are reported by ``warnings.warn``.

``h5py`` is imported where a file is read, so the module imports where
h5py is not installed.
"""

from __future__ import annotations

import collections
import re
import warnings
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def read_keras_weights(h5_path: str) -> List[Tuple[str, str, np.ndarray]]:
    """[(layer_name, weight_name, array)] in Keras storage order."""
    import h5py
    out = []
    with h5py.File(h5_path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in group.attrs["layer_names"]]
        for layer in layer_names:
            g = group[layer]
            weight_names = [n.decode() if isinstance(n, bytes) else n
                            for n in g.attrs.get("weight_names", [])]
            for wn in weight_names:
                out.append((layer, wn, np.asarray(g[wn])))
    return out


def _ordered_leaves(tree: Any, prefix: Tuple[str, ...] = (),
                    order_index: Dict[str, int] = None):
    """Depth-first leaves in slot-assignment order.

    With ``order_index`` (module path -> creation position), module
    children at every level walk in creation order and an unknown module
    path raises; leaf arrays keep numeric-aware name order. Without it,
    all keys natural-sort (flax names modules Conv_0..Conv_10), for
    imports of bare layers that have no manifest.
    """
    if not (isinstance(tree, dict) or hasattr(tree, "items")):
        yield prefix, tree
        return
    keys = list(tree.keys())
    if order_index is None:
        ordered = sorted(keys, key=_natural_key)
    else:
        dict_keys = [k for k in keys if hasattr(tree[k], "keys")]
        unknown = [k for k in dict_keys
                   if "/".join(prefix + (str(k),)) not in order_index]
        if unknown:
            raise ValueError(
                f"module path(s) {unknown} under "
                f"{'/'.join(prefix) or '<root>'} not in the Keras "
                "creation-order manifest (models/keras_order_manifest.py)")
        ordered = sorted(
            dict_keys,
            key=lambda k: order_index["/".join(prefix + (str(k),))])
        ordered += sorted((k for k in keys if k not in dict_keys),
                          key=_natural_key)
    for k in ordered:
        yield from _ordered_leaves(tree[k], prefix + (str(k),),
                                   order_index)


def _transform(layer: str, weight_name: str,
               arr: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """Keras array -> [(slot_kind, array)] in assignment order."""
    wn = weight_name.rsplit("/", 1)[-1].split(":")[0]
    if "depthwise" in wn and arr.ndim == 4 and arr.shape[0] == 1 \
            and arr.shape[-1] == 1:
        # [1, k, C, 1] -> [k, 1, C]
        return [("kernel", arr[0, :, :, 0][:, None, :])]
    if wn == "recurrent_kernel":
        u = arr.shape[0]
        return [("recurrent_kernel_zr", arr[:, :2 * u]),
                ("recurrent_kernel_h", arr[:, 2 * u:])]
    if wn == "gamma":
        return [("scale", arr)]
    if wn == "beta":
        # a kind of its own: a BN beta must never match a same-length
        # Conv/Dense/GRU bias slot (conv_1d_gru's Dense(256) bias)
        return [("beta", arr)]
    if wn == "moving_mean":
        return [("mean", arr)]
    if wn == "moving_variance":
        return [("var", arr)]
    return [(wn, arr)]


def import_keras_hdf5(h5_path: str, variables: Dict[str, Any],
                      module_order: Sequence[str] = None,
                      ) -> Dict[str, Any]:
    """Load a Keras checkpoint into flax-layout ``variables``
    ({'params': ..., 'batch_stats': ...}, nested dicts of numpy arrays).

    ``module_order`` (``models.keras_order.creation_order(name)``) pins
    slot order to Keras creation order; without it slots natural-sort
    (enough for one layer alone). Returns new variables with every leaf
    replaced by its Keras weight, in the leaf's dtype.
    """
    sources: List[Tuple[str, str, np.ndarray]] = []
    for layer, wn, arr in read_keras_weights(h5_path):
        for kind, t in _transform(layer, wn, arr):
            sources.append((layer, kind, t))

    order_index = (None if module_order is None
                   else {p: i for i, p in enumerate(module_order)})
    param_slots = list(_ordered_leaves(variables.get("params", {}),
                                       order_index=order_index))
    stat_slots = list(_ordered_leaves(variables.get("batch_stats", {}),
                                      order_index=order_index))

    def kind_of(path: Tuple[str, ...]) -> str:
        # flax BatchNorm stores beta as 'bias'; reclassify so BN betas
        # and plain biases form disjoint matching groups (see _transform)
        if path[-1] == "bias" and len(path) >= 2 \
                and path[-2].startswith("BatchNorm"):
            return "beta"
        return path[-1]

    assigned: Dict[Tuple[str, ...], np.ndarray] = {}
    used = [False] * len(sources)
    for path, leaf in param_slots + stat_slots:
        want_kind = kind_of(path)
        want_shape = tuple(leaf.shape)
        hit = None
        for i, (layer, kind, arr) in enumerate(sources):
            if used[i]:
                continue
            if kind == want_kind and tuple(arr.shape) == want_shape:
                hit = i
                break
        if hit is None:
            raise ValueError(
                f"no unused Keras weight matches {'/'.join(path)} "
                f"kind={want_kind} shape={want_shape}")
        assigned[path] = sources[hit][2]
        used[hit] = True

    leftovers = [f"{layer}/{kind}{list(arr.shape)}"
                 for (layer, kind, arr), u in zip(sources, used) if not u]
    if leftovers:
        raise ValueError(f"unconsumed Keras weights: {leftovers}")

    # surface the groups where assignment relied on order congruence
    group_sizes = collections.Counter(
        (kind, tuple(arr.shape)) for _, kind, arr in sources)
    ambiguous = sorted(f"{kind}{list(shape)}x{n}"
                       for (kind, shape), n in group_sizes.items()
                       if n > 1)
    if ambiguous:
        warnings.warn(
            "keras_import matched these same-kind same-shape weight "
            f"groups by storage order: {ambiguous} — correct iff the "
            "checkpoint's creation order matches the flax module order",
            stacklevel=2)

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: rebuild(tree[k], prefix + (str(k),))
                    for k in tree.keys()}
        return np.asarray(assigned[prefix], dtype=tree.dtype)

    out = {"params": rebuild(variables.get("params", {}))}
    if variables.get("batch_stats"):
        out["batch_stats"] = rebuild(variables["batch_stats"])
    return out


def import_keras_state_dict(h5_path: str, model: torch.nn.Module,
                            name: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of zoo model ``name`` (an instance: ``model``)
    with every tensor taken from the Keras checkpoint ``h5_path``."""
    from speech_recognition_tpu_torch.models.convert import (
        from_flax, to_flax,
    )
    from speech_recognition_tpu_torch.models.keras_order import (
        creation_order,
    )

    params, stats = to_flax(model.state_dict(), name)
    loaded = import_keras_hdf5(
        h5_path, {"params": params, "batch_stats": stats},
        module_order=creation_order(name))
    return from_flax(loaded["params"], loaded.get("batch_stats", {}),
                     model=name)
