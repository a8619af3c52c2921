"""Model forward and backward, BiGRU: the share (%) of the train step's
device time that the BiGRU's forward and backward take, the card's ms a
step in the program's ``gru.forward`` and ``gru.backward`` device spans
(``gru_device_ms_per_step``) over the captured busy ms a step
(``train_device_ms_per_step``). None where either is.
"""

from kws_bench.metrics import gru_device_ms_per_step, train_device_ms_per_step


def read(layers):
    gru = gru_device_ms_per_step.read(layers)
    busy = train_device_ms_per_step.read(layers)
    return None if gru is None or not busy else 100.0 * gru / busy
