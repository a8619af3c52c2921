"""Model forward and backward: captured device busy ms a step."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    return 1e3 * tr["summary"]["busy_s"] / tr["steps"]
