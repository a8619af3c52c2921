"""Model backward: the host's ms a step in the program's
``train.backward`` spans (the main thread's wait for the backward that
autograd's engine dispatches), median over the window's tail of
unprofiled steps."""

from kws_bench.metrics._spans import phase_ms


def read(layers):
    return phase_ms(layers, "train.backward")
