"""Max pool: device ms a step of the kernels whose names hold
``maxpool1d_``, the port's max-pool kernels (forward and backward); None
where the capture ran none."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    s = [sec for name, (sec, _) in tr["summary"]["kernels"].items()
         if "maxpool1d_" in name]
    return 1e3 * sum(s) / tr["steps"] if s else None
