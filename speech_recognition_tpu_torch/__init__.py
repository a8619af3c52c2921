"""speech_recognition_tpu_torch — the PyTorch/CUDA port of speech_recognition_tpu.

The package mirrors the JAX package's module paths: the counterpart of
``speech_recognition_tpu/ops/augment.py`` is
``speech_recognition_tpu_torch/ops/augment.py``. It imports ``torch``
and never ``jax``, ``flax``, ``optax`` or the JAX package itself.

Ported so far: the flagship train step and eval step
(``conv_1d_time_sliced_with_attention`` on raw waveforms), on one card or
data-parallel over several (``parallel/``), with the fused decode+augment
data path as a hand-written CUDA kernel (``csrc/decode_augment.cu``), and
the fused separable block's forward and backward kernels. ROADMAP.md
lists what is still to come.
"""

__version__ = "0.1.0"
