"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the device an entry point should build on.

    The default is the CUDA card. Asking for CUDA on a host without one
    raises instead of silently running on the CPU; pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
