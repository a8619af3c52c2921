"""Host dispatch: 1 - the captured device busy time a step over the
unprofiled wall time a step, in %."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    busy = tr["summary"]["busy_s"] / tr["steps"]
    return 100.0 * (1.0 - busy / (layers["window_s"] / layers["steps"]))
