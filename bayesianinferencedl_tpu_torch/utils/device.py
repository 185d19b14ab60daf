"""The device an entry point runs on: the card unless the caller asks for the
CPU, and never a silent fallback from one to the other; and the generators
drawn from a run's generator."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but torch.cuda.is_available() is False")
    return dev


def child_generator(gen: torch.Generator) -> torch.Generator:
    """A fresh generator on gen's device, seeded from gen's stream."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return torch.Generator(device=gen.device).manual_seed(seed)
