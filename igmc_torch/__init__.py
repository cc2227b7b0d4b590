"""igmc_torch — IGMC (inductive graph-based matrix completion) in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `igmc_tpu`, which stays the reference. This
package imports nothing of it: what it needs lives here, in modules named
after their JAX counterparts.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (igmc_torch/device.py). On the CPU every kernel wrapper
computes its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.

Ported so far: training, evaluation and serving on the dense slot layout
(float32 or bfloat16; edge, adjacency and relation-slotted strategies,
edge-k as an alias of edge; giant batches) and on the flat layout with the fused R-GCN
aggregate kernels, the MovieLens datasets, and the CLIs (README.md), on
one device or several (parallel/: data parallel and edge-partitioned,
one process per device over torch.distributed).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
