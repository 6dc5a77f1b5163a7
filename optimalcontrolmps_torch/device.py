"""The port's device rule: entry points run on the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card, which must exist; the CPU only when the
    caller passes it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card "
                               "unless the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)
