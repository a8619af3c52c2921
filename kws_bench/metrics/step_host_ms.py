"""Host dispatch: the host's ms a step in the program's ``train.step``
span (the whole train step, its phases and the glue between them),
median over the window's tail of unprofiled steps."""

from kws_bench.metrics._spans import phase_ms


def read(layers):
    return phase_ms(layers, "train.step")
