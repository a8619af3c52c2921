"""Move zoo weights from the flax layout to the port's ``state_dict``.

Layouts (flax is NWC, the port NCW):

* conv kernels (k, in/groups, out) -> (out, in/groups, k), and 2-D ones
  (kh, kw, in/groups, out) -> (out, in/groups, kh, kw);
* dense kernels (in, out) -> (out, in), and so the GRU's ``kernel``,
  ``recurrent_kernel_zr`` and ``recurrent_kernel_h`` -> ``weight``,
  ``recurrent_weight_zr`` and ``recurrent_weight_h``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and batch_stats
  ``mean``/``var`` -> ``running_mean``/``running_var``, one to one.

A grouped conv's flax kernel (k, in/g, out) and torch's (out, in/g, k)
both give group j the output channels [j out/g, (j+1) out/g), so the same
transpose carries it.

Module names, the flagship: ``ConvBN_0`` -> ``stem``,
``DepthwiseConvBlock_i`` -> ``blocks.i`` (its ``Conv_0``/``Conv_1`` ->
``depthwise``/``pointwise``), ``Dense_0`` -> ``attention``, ``Dense_1``
-> ``head``, ``BatchNorm_0`` -> ``bn``. ``conv_1d_spec``: ``ConvBN_i``
-> ``blocks.i`` (``Conv_0`` -> ``conv``, ``BatchNorm_0`` -> ``bn``),
``Dense_0`` -> ``head``. Every other ported model registers its layers
under flax's own names (``ConvBN_7``, ``Conv_0``, ``Dense_1``:
``layers.py`` ``FlaxNamed``), so their names carry over at every level,
and a fixed table per block class gives the leaves inside a block
(``BLOCK_LEAVES``). Blocks nest: ``Residual1D_i`` holds ``Conv_0``,
``BatchNorm_0`` and ``DepthwiseConvBlock_j``, and ``BiGRU_0`` holds
``GRU_0`` and ``GRU_1`` (``CONTAINERS``). The inputs are nested dicts of
numpy arrays (e.g. from ``jax.device_get``), so this module needs no jax.

``to_flax`` is the inverse: a ``state_dict`` -> flax-layout ``params`` and
``batch_stats`` (``export/keras_import.py`` matches a Keras checkpoint
against that skeleton with the JAX package's algorithm).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "recurrent_kernel_zr": "recurrent_weight_zr",
         "recurrent_kernel_h": "recurrent_weight_h"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


FLAGSHIP = "conv_1d_time_sliced_with_attention"

# flax's names of a block's submodules -> the port's, per block class
_CONV_BN = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_SEPARABLE = {"Conv_0": "depthwise", "Conv_1": "pointwise",
              "BatchNorm_0": "bn"}
BLOCK_LEAVES = {"ConvBN": _CONV_BN, "DepthwiseConvBlock": _SEPARABLE,
                "GroupedDepthwiseBlock": _SEPARABLE}
# block classes that keep flax's names inside -> the kinds they hold
CONTAINERS = {"Residual1D": ("Conv", "BatchNorm", "DepthwiseConvBlock"),
              "BiGRU": ("GRU",)}
# what a model built of flax-named layers holds at its top level
_TOP = ("Conv", "Dense", "GRU", *BLOCK_LEAVES, *CONTAINERS)


def _flax_named(path: Tuple[str, ...], model: str) -> str:
    """The port's module name of a model built of flax-named layers."""
    names, allowed, rest = [], _TOP, list(path)
    while rest:
        top = rest.pop(0)
        kind = top.rpartition("_")[0]
        if kind not in allowed:
            break
        names.append(top)
        if kind in BLOCK_LEAVES:
            if len(rest) == 1 and rest[0] in BLOCK_LEAVES[kind]:
                return ".".join(names + [BLOCK_LEAVES[kind][rest[0]]])
            break
        if kind in CONTAINERS:
            allowed = CONTAINERS[kind]
        elif not rest:              # Conv, Dense, BatchNorm or GRU
            return ".".join(names)
        else:
            break
    raise KeyError(f"no {model} counterpart for flax path {path!r}")


def _module_name(path: Tuple[str, ...], model: str) -> str:
    if model not in (FLAGSHIP, "conv_1d_spec"):
        return _flax_named(path, model)
    top, *inner = path
    kind, _, idx = top.rpartition("_")
    if model == FLAGSHIP and kind == "ConvBN":
        names = {"Conv_0": "stem.conv", "BatchNorm_0": "stem.bn"}
    elif model == FLAGSHIP and kind == "DepthwiseConvBlock":
        names = {"Conv_0": f"blocks.{idx}.depthwise",
                 "Conv_1": f"blocks.{idx}.pointwise",
                 "BatchNorm_0": f"blocks.{idx}.bn"}
    elif model == FLAGSHIP and kind == "Dense" and not inner:
        return {"0": "attention", "1": "head"}[idx]
    elif model == "conv_1d_spec" and kind == "ConvBN":
        names = {"Conv_0": f"blocks.{idx}.conv",
                 "BatchNorm_0": f"blocks.{idx}.bn"}
    elif model == "conv_1d_spec" and kind == "Dense" and idx == "0" \
            and not inner:
        return "head"
    else:
        raise KeyError(f"no {model} counterpart for flax module {top!r}")
    if len(inner) != 1 or inner[0] not in names:
        raise KeyError(f"no {model} counterpart for flax path {path!r}")
    return names[inner[0]]


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if "kernel" not in leaf:
        return value
    if value.ndim == 2:
        return value.T
    # (*spatial, in/groups, out) -> (out, in/groups, *spatial)
    return value.transpose(value.ndim - 1, value.ndim - 2,
                           *range(value.ndim - 2))


def from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
              model: str = FLAGSHIP) -> Dict[str, torch.Tensor]:
    """Flax ``params`` + ``batch_stats`` -> ``model``'s ``state_dict``.

    Also maps any params-shaped tree (gradients, for instance) when
    ``batch_stats`` is empty. Tensors keep the arrays' dtype.
    """
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree):
            *mod, leaf = path
            key = f"{_module_name(tuple(mod), model)}.{_LEAF[leaf]}"
            out[key] = torch.from_numpy(np.array(
                _to_torch_layout(leaf, value), order="C"))
    return out


def _flax_module_path(name: str, model: str) -> Tuple[str, ...]:
    """The flax module path of the port's module ``name``: the inverse of
    ``_module_name``, checked against it."""
    parts = name.split(".")
    if model == FLAGSHIP:
        fixed = {"stem.conv": ("ConvBN_0", "Conv_0"),
                 "stem.bn": ("ConvBN_0", "BatchNorm_0"),
                 "attention": ("Dense_0",), "head": ("Dense_1",)}
        path = fixed.get(name)
        if path is None and len(parts) == 3 and parts[0] == "blocks":
            inv = {v: k for k, v in _SEPARABLE.items()}
            path = (f"DepthwiseConvBlock_{parts[1]}", inv.get(parts[2], ""))
    elif model == "conv_1d_spec":
        path = ("Dense_0",) if name == "head" else None
        if len(parts) == 3 and parts[0] == "blocks":
            inv = {v: k for k, v in _CONV_BN.items()}
            path = (f"ConvBN_{parts[1]}", inv.get(parts[2], ""))
    else:
        path = tuple(parts)
        block = parts[-2].rpartition("_")[0] if len(parts) > 1 else ""
        if block in BLOCK_LEAVES:
            inv = {v: k for k, v in BLOCK_LEAVES[block].items()}
            path = tuple(parts[:-1]) + (inv.get(parts[-1], ""),)
    try:
        if path is not None and _module_name(path, model) == name:
            return path
    except KeyError:
        pass
    raise KeyError(f"no flax path of {model} for module {name!r}")


def _to_flax_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if "kernel" not in leaf:
        return value
    if value.ndim == 2:
        return value.T
    # (out, in/groups, *spatial) -> (*spatial, in/groups, out)
    return value.transpose(*range(2, value.ndim), 1, 0)


def to_flax(state_dict: Mapping[str, torch.Tensor], model: str = FLAGSHIP,
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``model``'s ``state_dict`` -> (flax ``params``, ``batch_stats``):
    nested dicts of numpy arrays keyed by flax's module paths, in flax's
    layouts. A module with running statistics is a BatchNorm (its
    ``weight`` is flax's ``scale``); every other ``weight`` is a
    ``kernel``. ``from_flax`` of the result gives ``state_dict`` back."""
    batchnorms = {k.rpartition(".")[0] for k in state_dict
                  if k.endswith(".running_mean")}
    leaves = {v: k for k, v in _LEAF.items() if k != "scale"}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        is_bn = mod in batchnorms
        flax_leaf = "scale" if is_bn and leaf == "weight" else leaves[leaf]
        tree = stats if flax_leaf in ("mean", "var") else params
        for part in _flax_module_path(mod, model):
            tree = tree.setdefault(part, {})
        tree[flax_leaf] = np.ascontiguousarray(_to_flax_layout(
            flax_leaf, value.detach().cpu().numpy()))
    return params, stats
