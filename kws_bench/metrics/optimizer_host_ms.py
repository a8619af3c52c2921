"""Optimizer: the host's ms a step in the program's
``train.optimizer`` spans (the gradients cleared, then the update),
median over the window's tail of unprofiled steps."""

from kws_bench.metrics._spans import phase_ms


def read(layers):
    return phase_ms(layers, "train.optimizer")
