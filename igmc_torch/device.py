"""Device resolution: the CUDA device unless the caller asks for the CPU.

Every entry point of the package takes `device=` (default "cuda") and
resolves it here. Without a CUDA device, "cuda" raises: nothing quietly
carries on on the CPU. Resolving a device also turns TF32 off for float32
matrix products and cuDNN convolutions, so that float32 on the card is
float32 (TF32 keeps about three decimal digits, which would break parity
with the JAX reference).
"""

from __future__ import annotations

import torch


def tf32_enabled() -> bool:
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device, with TF32 turned off.

    Raises RuntimeError for a CUDA device when none is available; pass
    ``device="cpu"`` explicitly to run the plain PyTorch path on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "igmc_torch: no CUDA device is available; pass device='cpu' "
            "explicitly to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"igmc_torch runs on 'cuda' or 'cpu', not {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
