"""Device choice and kernel-build status for the port.

The port's entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``): :func:`default_device` is the single place that
decision is made, and it refuses to carry on without a card.  Each kernel
wrapper then picks its route from the tensor it is given: a CPU tensor
goes to the kernel's plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises.
"""
from __future__ import annotations

import torch


def default_device() -> str:
    """``"cuda"`` when a card is visible; otherwise raise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the GPU unless "
            "the caller passes device='cpu' (or --device cpu)")
    return "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else
    :func:`default_device`."""
    return torch.device(default_device() if device is None else device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so a host
    clock around a call times the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def status() -> dict:
    """Card name, capability, kernel build directory and whether every
    kernel source has been built."""
    from repro_torch.kernels import build
    cuda = torch.cuda.is_available()
    return {
        "cuda": cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "capability": (".".join(map(str, torch.cuda.get_device_capability(0)))
                       if cuda else None),
        "build_dir": str(build.BUILD_DIR),
        "built": build.is_built(),
    }
