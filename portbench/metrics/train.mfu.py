"""train.mfu: the model operations of every training step in the window
(portbench/lib/counts.py, least-work count from each step's real nodes and
edges) over window seconds x 67 TFLOP/s (float32 outside the tensor
cores, H100 SXM data sheet), in %."""

from portbench.lib.counts import PEAK_F32_FLOP_PER_S


def read(layer):
    if layer.get("kind") != "train" or "flops" not in layer:
        return None
    return 100.0 * layer["flops"] / (layer["window_s"] * PEAK_F32_FLOP_PER_S)
