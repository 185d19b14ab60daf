"""Auxiliary subsystems: metrics, the posterior predictive check, and the
hand-coded adjoint oracle."""

from bayesianinferencedl_tpu_torch.utils.adjoint import adjoint_gn_hvp, adjoint_gradient  # noqa: F401
