"""Experimental: the JAX package's ``experimental`` modules, ported.

- pcn_fused: the whole pCN sampler (proposal, reduced PCG solve, MLP
  correction, accept, burn-in adaptation) as ONE hand-written CUDA kernel,
  K2r (``csrc/pcn_fused_r.cu``; K2, ``csrc/pcn_fused.cu``, kept beside it off
  the main path), with its plain torch version. The JAX package
  demoted its Pallas counterpart on TPU measurements; the port's own times
  on the H100 are in PERF.md. Nothing in ``api`` calls it: a caller builds a
  pipeline and hands its operators to ``run_pcn_fused``.
- shift_cost: the reference script ``scripts/diag_roll_cost.py``, the
  shift-cost probe, as kernel K5 (``csrc/shift_cost.cu``) with its plain
  torch version and its own entry point.
- k2r_phases: where K2r's time goes on the card (clocks per phase of an
  instrumented copy, sweeps over the chains, r and cg_iters).
- multigrid: the geometric multigrid-preconditioned flexible CG on (B, X0,
  Y0) stencil planes, in plain torch as the JAX package's is plain XLA; its
  crossover against the stencil kernels on an H100 is in PERF.md. Nothing
  in ``api`` calls it: ``MGHierarchy.create(res, biot).solve(ks)``.
- svgd_khat: SVGD's moment-matched PSIS k-hat over seeds, on the card.
"""
