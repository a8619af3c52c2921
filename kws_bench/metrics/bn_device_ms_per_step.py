"""BatchNorm: device ms a step of the kernels the frozen op classes call
normalization."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    s = tr["summary"]["ops"].get("normalization")
    return None if not s else 1e3 * s / tr["steps"]
