"""Depthwise convs: device ms a step of the kernels whose names hold
``conv_depthwise`` (ATen's ``conv_depthwise2d`` forward, input-gradient
and weight-gradient kernels) or ``dwconv1d_`` (the port's depthwise
kernels: forward, backward and the weight gradient's merge), so that a
program on either reads the same work; None where the capture ran none."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    s = [sec for name, (sec, _) in tr["summary"]["kernels"].items()
         if "conv_depthwise" in name or "dwconv1d_" in name]
    return 1e3 * sum(s) / tr["steps"] if s else None
