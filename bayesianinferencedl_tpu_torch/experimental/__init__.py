"""Experimental: the JAX package's ``experimental`` modules, ported.

- pcn_fused: the whole pCN sampler (proposal, reduced PCG solve, MLP
  correction, accept, burn-in adaptation) as ONE hand-written CUDA kernel,
  K2 (``csrc/pcn_fused.cu``), with its plain torch version. The JAX package
  demoted its Pallas counterpart on TPU measurements; the port's own times
  on the H100 are in PERF.md. Nothing in ``api`` calls it: a caller builds a
  pipeline and hands its operators to ``run_pcn_fused``.
- shift_cost: the reference script ``scripts/diag_roll_cost.py``, the
  shift-cost probe, as kernel K5 (``csrc/shift_cost.cu``) with its plain
  torch version and its own entry point.
"""
