"""Reduced-order model: snapshots (batched FOM solves), host-f64 POD and
Galerkin projection, and the batched fixed-iteration reduced PCG."""
