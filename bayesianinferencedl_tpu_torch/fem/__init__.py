"""P1 finite-element full-order model, in two operator layouts.

  p1.py         closed-form P1 element matrices (host NumPy)
  dia.py        host stencil assembly (NumPy) and the torch ``StencilOperator``
  assemble.py   host ELL assembly (NumPy), the layout on the mesh's own nodes
  operators.py  the torch ELL ``FinOperator``
  solve.py      the differentiable batched Jacobi-PCG (adjoint-solve backward)
  oracle.py     SciPy float64 reference assembly and direct solve (the oracle)
"""

from bayesianinferencedl_tpu_torch.fem.assemble import FinFEMHost, assemble_fin  # noqa: F401
from bayesianinferencedl_tpu_torch.fem.operators import FinOperator  # noqa: F401
from bayesianinferencedl_tpu_torch.fem.solve import pcg, solve_fom  # noqa: F401
