"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    Entry points default to "cuda" and never carry on quietly on the CPU:
    a caller who wants the plain PyTorch versions passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel). Any other device raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cpu"
    raise ValueError(f"tensor on unsupported device {t.device}")
