"""Reduced-order model: snapshots (batched FOM solves), POD (host float64, or
on the device for a fin without host algebra), Galerkin projection, and the
batched fixed-iteration reduced PCG."""

from bayesianinferencedl_tpu_torch.rom.pod import pod_basis  # noqa: F401
from bayesianinferencedl_tpu_torch.rom.snapshots import generate_snapshots  # noqa: F401
