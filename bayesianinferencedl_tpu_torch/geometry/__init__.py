"""Thermal-fin geometry and meshing (SURVEY.md §1 L1, Appendix B).

The port's own copy of the JAX package's ``geometry``. Host-side NumPy only:
meshes are static, so nothing here runs on the device. The mesh is consumed
by ``fem.dia.assemble_fin_dia``, which turns it into the stencil operator.
"""

from bayesianinferencedl_tpu_torch.geometry.fin import (  # noqa: F401
    FIN_EXTENT,
    N_REGIONS,
    POST_HALF_WIDTH,
    POST_HEIGHT,
    REGION_POST,
    SUBFIN_THICKNESS,
    subfin_y_interval,
    region_of_points,
)
from bayesianinferencedl_tpu_torch.geometry.mesh import FinMesh, build_fin_mesh  # noqa: F401
