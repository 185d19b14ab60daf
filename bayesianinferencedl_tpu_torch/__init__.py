"""bayesianinferencedl_tpu_torch — the PyTorch/CUDA port of
``bayesianinferencedl_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: every module here keeps its
counterpart's path and public names (``fem/dia.py``, ``ops/pcg_stencil.py``,
``rom/galerkin.py``, ...), and the tests hold each one against it. This
package imports ``torch``, ``numpy`` and ``scipy``, never ``jax`` and nothing
of the reference package: ``config`` and ``geometry`` are its own copies.

Layer map (the offline build, single-temperature pCN and the fused sampler):

    config.py    PipelineConfig and its stage dataclasses
    geometry/    the fin's regions and its structured P1 mesh
    fem/     P1 elements, 7-diagonal stencil operator (NumPy host + torch),
             the differentiable Jacobi-PCG solve
    ops/     hand-written CUDA kernels (K3r, K4r, K4c; K1 where lanes_route
             names it) with their plain versions
    experimental/  the whole pCN sampler as one CUDA kernel (K2r; K2 kept
             beside it); the shift-cost probe (K5)
    rom/     snapshots, host-f64 POD, Galerkin ROM, batched reduced PCG
    models/  the 5-parameter fin, MLP error surrogate, corrected forward
    data/    ROM-error dataset generation
    infer/   Gaussian prior, pCN, delayed acceptance, tempering and the
             evidence, BFGS MAP and Laplace, Laplace MH / gpCN, MALA, HMC,
             diagnostics
    utils/   metrics logger, posterior predictive check, per-call fp32 pins
    api.py   build_pipeline / run_inversion;  cli.py  ``fom``, ``snapshots``,
             ``rom``, ``invert``, ``map``
"""

__version__ = "0.1.0"
