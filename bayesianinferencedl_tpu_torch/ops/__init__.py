"""Hand-written CUDA kernels for Hopper, each with its plain torch version.

  pcg_stencil.py  batched Jacobi-PCG on the stencil operator, by mesh size:
                  K1 (csrc/pcg_stencil.cu, deflated, one sample per block),
                  K3r (csrc/pcg_stencil_tile_mma.cu, deflated, 8 per cluster,
                  tensor-core deflation products; K3, csrc/pcg_stencil_tile.cu,
                  8 per block, beside it off the main path),
                  and one sample's 2-D grid: K4r (csrc/pcg_stencil_grid_resident.cu,
                  in the shared memory of every SM) where it fits, else
                  K4c (csrc/pcg_stencil_grid_cluster.cu, streamed, one sample
                  per thread-block cluster); K4 (csrc/pcg_stencil_grid.cu, one
                  block per sample) beside them off the main path
  deflation.py    the coarse space and per-sample coarse inverses K1 uses
  _build.py       nvcc build into build/torch_kernels/ + ctypes loading
"""
