"""P1 finite-element full-order model on the 7-diagonal stencil layout.

  p1.py   closed-form P1 element matrices (host NumPy)
  dia.py    host stencil assembly (NumPy) and the torch ``StencilOperator``
  solve.py  the differentiable batched Jacobi-PCG (adjoint-solve backward)
"""
