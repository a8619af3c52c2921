"""Loss, optimizer and LR control (port of speech_recognition_tpu/train/optim.py).

Ported: ``smooth_cross_entropy``, ``l2_kernel_penalty``, the Keras
RMSprop recipe and the LR accessors. SGD, Adam and ReduceLROnPlateau
come with ROADMAP A3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speech_recognition_tpu_torch.models.layers import Conv, Dense


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed softmax CE from logits; ``labels`` are class ids."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()


def l2_kernel_penalty(model: nn.Module, scale: float) -> torch.Tensor:
    """scale * sum(w**2) over conv and dense weights (Keras l2(scale)).

    These are the tensors flax names ``kernel``; BatchNorm weights and
    all biases are excluded, as in the JAX package.
    """
    weights = [m.weight for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    if scale == 0.0:
        return torch.zeros((), device=weights[0].device)
    return scale * sum(w.square().sum() for w in weights)


def build_optimizer(name: str, params,
                    learning_rate: float) -> torch.optim.Optimizer:
    """Keras-equivalent optimizer over ``params``.

    ``rmsprop`` is Keras 2.1.2's: rho 0.9, eps 1e-8 added *outside* the
    sqrt, zero-initialised accumulator — exactly torch's RMSprop with
    ``alpha=0.9, eps=1e-8``. SGD with momentum and Adam come with
    ROADMAP A3.
    """
    if name.lower() != "rmsprop":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A3)")
    return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.9, eps=1e-8)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr
