"""Per-model Keras layer-creation order (port of
speech_recognition_tpu/models/keras_order.py).

Keras 2.1.2 stores a checkpoint's weights in layer-creation order, and
``export/keras_import.py`` assigns each group of same-kind same-shape
weights to the model's slots in that order. ``creation_order(name)``
gives a zoo model's flax module paths (``"a/b/c"``) in creation order,
from ``keras_order_manifest.KERAS_CREATION_ORDER``: a copy of the JAX
package's manifest, which the JAX package derives from a flax init and
the port cannot derive again. ``tests/test_torch_keras_import.py``
holds the copy equal to the JAX manifest for all 25 models.
"""

from __future__ import annotations

from typing import Tuple


def creation_order(name: str) -> Tuple[str, ...]:
    """The creation-order manifest of zoo model ``name``; raises
    ``ValueError`` for a name it does not hold."""
    from speech_recognition_tpu_torch.models.keras_order_manifest import (
        KERAS_CREATION_ORDER,
    )
    try:
        return KERAS_CREATION_ORDER[name]
    except KeyError:
        raise ValueError(
            f"no Keras creation-order manifest for model {name!r}") from None
