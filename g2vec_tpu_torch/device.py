"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU. A request
for ``cuda`` on a machine where torch sees no card is an error, never a
silent move to the CPU: a CPU run of this program measures nothing the
port is for.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) -> ``torch.device``.

    Raises ``RuntimeError`` when ``cuda`` is requested and no card is
    visible, and ``ValueError`` for device types the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                f"device; the port runs on the GPU unless the caller asks "
                f"for the CPU (--device cpu, or device='cpu')")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(dev)!r}")
    return dev
