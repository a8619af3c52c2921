"""Host dispatch: device activities (kernels, copies, memsets) a step
in the capture."""


def read(layers):
    tr = layers.get("trace")
    if layers.get("kind") != "train" or not tr:
        return None
    return tr["summary"]["activities"] / tr["steps"]
