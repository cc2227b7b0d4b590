"""train.device_idle: the share of the traced training pass in which no
operation ran on the card (torch.profiler), in %."""


def read(layer):
    trace = layer.get("trace")
    if layer.get("kind") != "train" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
