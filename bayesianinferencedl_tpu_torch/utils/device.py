"""The device an entry point runs on: the card unless the caller asks for the
CPU, and never a silent fallback from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but torch.cuda.is_available() is False")
    return dev
