"""Device choice for the PyTorch port.

Entry points run on the GPU unless the caller asks for the CPU. With no
GPU present and no explicit ``device``, they raise instead of quietly
running on the host.
"""

from __future__ import annotations

import torch

__all__ = ["has_cuda", "default_device", "resolve_device"]


def has_cuda() -> bool:
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The device entry points use when the caller names none: ``cuda``.

    Raises RuntimeError when CUDA is absent; pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels on the host.
    """
    if not has_cuda():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run pyflwdir_torch on the host"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not has_cuda():
        raise RuntimeError("device='cuda' requested but no CUDA device is available")
    return device
