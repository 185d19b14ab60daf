"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

  pcg_stencil.py  batched Jacobi-PCG on the stencil operator, by mesh size:
                  K1 (csrc/pcg_stencil.cu, deflated, one sample per block),
                  K3 (csrc/pcg_stencil_tile.cu, deflated, 8 per block),
                  K4 (csrc/pcg_stencil_grid.cu, one sample's 2-D grid)
  deflation.py    the coarse space and per-sample coarse inverses K1 uses
  _build.py       nvcc build into build/torch_kernels/ + ctypes loading
"""
