"""Plain PyTorch and NumPy references of what the benchmark's cells run.

Nothing here imports the program (``speech_recognition_tpu_torch``),
JAX or the JAX package: each file re-derives, from the inputs the
benchmark made, what the program computes, so that the program's
outputs can be judged against it. One file per configuration
(``<config>.py``: its parameter shapes and its forward pass) beside the
shared plain layers (``layers.py``).
"""
