"""k1.roofline: K1 (the fused aggregate's forward) over the traced training pass: the summed least
time of its launches (portbench/lib/counts.py aggregate_bound, from each
batch's plan, at 3.35 TB/s and 67 TFLOP/s) over the device time the
profiler gives its kernels, in %. Read only from a trace whose launch
count equals the program's own counter (the training runner retries once, then
fails the run)."""

KERNEL = "rgcn_aggregate_fwd"


def read(layer):
    trace = layer.get("trace")
    if layer.get("kind") != "train" or "k1" not in layer or trace is None:
        return None
    busy = trace.device_s(KERNEL)
    return 100.0 * layer["k1"] / busy if busy > 0 else None
