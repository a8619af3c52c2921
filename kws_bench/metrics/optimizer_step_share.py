"""Optimizer update: the share (%) of the train step's device time that
the optimizer's update takes, the card's ms a step in the program's
``optimizer.step`` device span (``optimizer_device_ms_per_step``) over
the captured busy ms a step (``train_device_ms_per_step``). None where
either is.
"""

from kws_bench.metrics import optimizer_device_ms_per_step
from kws_bench.metrics import train_device_ms_per_step


def read(layers):
    update = optimizer_device_ms_per_step.read(layers)
    busy = train_device_ms_per_step.read(layers)
    return None if update is None or not busy else 100.0 * update / busy
