"""Whole train step: FLOPs a step (the reference model's forward and
backward at the cell's batch, counted from shapes) over the unprofiled
wall time a step, as a share of the H100's 989 TFLOP/s in bf16."""

from kws_bench.peaks import BF16_FLOPS


def read(layers):
    if layers.get("kind") != "train" or not layers.get("flops_step"):
        return None
    wall = layers["window_s"] / layers["steps"]
    return 100.0 * layers["flops_step"] / wall / BF16_FLOPS
