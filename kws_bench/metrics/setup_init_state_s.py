"""Set-up: the seconds of the process's first ``setup.init_state``
span, ``Trainer.init_state`` building the model on the host and moving it
to the card (before the benchmark loads its weights)."""

from kws_bench.metrics._spans import first_s


def read(layers):
    return first_s(layers, "setup.init_state")
