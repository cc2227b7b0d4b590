"""train.host_wait: the harness's spans around the calls the step loop
waits on (next() on the BatchLoader, or DensePass.plan), summed over the
window and divided by it, in %."""


def read(layer):
    if layer.get("kind") != "train":
        return None
    return 100.0 * layer["host_wait_s"] / layer["window_s"]
