"""Device selection shared by every entry point of the port.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); the CPU path exists for tests.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the default everywhere) or ``"cpu"`` as a torch device.
    A CUDA request without a card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the CUDA device was requested but torch.cuda.is_available() "
                "is False: no GPU is visible.  The CPU path exists for tests "
                "only and must be asked for (device='cpu' / --device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
