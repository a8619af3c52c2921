"""Set-up: the seconds of the process's first ``train.step`` span on
the host: lazy CUDA, cuDNN and cuBLAS set-up, the kernels' library
loads, and their build in a fresh checkout."""

from kws_bench.metrics._spans import first_s


def read(layers):
    return first_s(layers, "train.step")
