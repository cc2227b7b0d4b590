"""igmc_torch — IGMC (inductive graph-based matrix completion) in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `igmc_tpu`, which stays the reference. This
package imports nothing of it: what it needs lives here, in modules named
after their JAX counterparts.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (igmc_torch/device.py). On the CPU every kernel wrapper
computes its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.

Ported so far: checkpoint evaluation on the flat layout with the fused
R-GCN aggregate kernel (`train.loop.test_once(flat_aggregate="pallas")`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
