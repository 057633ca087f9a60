"""Where the port's entry points run."""

from __future__ import annotations

import torch

from asyncflow_tpu_torch.errors import NoDeviceError


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``cuda`` unless the caller names a device.  With no device given and
    no GPU present this raises: the port never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            msg = (
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
            raise NoDeviceError(msg)
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = f"device {device!r} was asked for but no CUDA device is available"
        raise NoDeviceError(msg)
    return dev
