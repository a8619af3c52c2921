"""speech_recognition_tpu_torch — the PyTorch/CUDA port of speech_recognition_tpu.

The package mirrors the JAX package's module paths: the counterpart of
``speech_recognition_tpu/ops/augment.py`` is
``speech_recognition_tpu_torch/ops/augment.py``. It imports ``torch``
and never ``jax``, ``flax``, ``optax`` or the JAX package itself.

Ported so far: the flagship train step and eval step
(``conv_1d_time_sliced_with_attention`` on raw waveforms), on one card or
data-parallel over several (``parallel/``), with the fused decode+augment
data path as a hand-written CUDA kernel (``csrc/decode_augment.cu``), and
the fused separable block's forward and backward kernels; training from
a corpus on disk (``data/index.py``, ``data/wav.py``) with the spectral
frontend (``ops/frontend.py``), ``conv_1d_spec``, ``Trainer.fit`` with BN
re-estimation and checkpoints; the accuracy calibration
(``tools/calibrate_accuracy.py``) and the bench (``python -m
speech_recognition_tpu_torch.bench``); the serving path: TTA prediction
(``infer/``), the speed-TTA stretch (``ops/stretch.py``), submissions,
pseudo-labels and their command-line tools, and the inference bench
(``tools/``). ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"
