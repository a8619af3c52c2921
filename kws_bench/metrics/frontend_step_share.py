"""Data path, frontend: the share (%) of the train step's device time
that the feature frontend takes, the card's ms a step in the program's
``frontend.forward`` device span (``frontend_device_ms_per_step``) over
the captured busy ms a step (``train_device_ms_per_step``). None where
either is.
"""

from kws_bench.metrics import frontend_device_ms_per_step
from kws_bench.metrics import train_device_ms_per_step


def read(layers):
    frontend = frontend_device_ms_per_step.read(layers)
    busy = train_device_ms_per_step.read(layers)
    return None if frontend is None or not busy \
        else 100.0 * frontend / busy
