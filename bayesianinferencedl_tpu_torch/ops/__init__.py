"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

  pcg_stencil.py  K1: batched deflated Jacobi-PCG on the stencil operator
                  (csrc/pcg_stencil.cu)
  deflation.py    the coarse space and per-sample coarse inverses K1 uses
  _build.py       nvcc build into build/torch_kernels/ + ctypes loading
"""
