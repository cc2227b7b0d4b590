"""train.slot_fill: real edges over the edge slots the window's dense
batches assembled (bucket edge slot x batch size per step), in %."""


def read(layer):
    if layer.get("kind") != "train" or "slot_fill" not in layer:
        return None
    real, slots = layer["slot_fill"]
    return 100.0 * real / slots if slots else None
