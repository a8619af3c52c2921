"""Loss and L2 penalty: the host's ms a step in the program's
``train.loss`` spans (smoothed cross-entropy and the L2 penalty on
the kernels), median over the window's tail of unprofiled steps."""

from kws_bench.metrics._spans import phase_ms


def read(layers):
    return phase_ms(layers, "train.loss")
