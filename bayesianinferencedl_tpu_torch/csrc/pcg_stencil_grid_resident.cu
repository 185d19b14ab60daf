// K4r: one sample's Jacobi-PCG on the fin's 2-D grid, held in the shared
// memory of every SM of the card; the samples of a batch one after another.
//
// Replaces the TPU Pallas kernel `_pcg_kernel`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py, launched by `pcg_stencil_batch`)
// wherever one sample's strips fit the card's shared memory
// (`grid_route` in ops/pcg_stencil.py); larger grids take K4
// (csrc/pcg_stencil_grid.cu). It computes what K4 computes, bit for bit the
// same operations:
//
//   stencil   acc = v3 p + sum_{s != 3} v_s p[ix+dx_s, iy+dy_s] over the 7 planes of
//             OFFSETS_2D = (-1,-1) (-1,0) (0,-1) (0,0) (0,1) (1,0) (1,1), in that
//             order; reads outside the true (X0, Y0) grid are zero.
//   precond   z = D^-1 r, D^-1 = 0 where the diagonal is 0; no deflation.
//   stopping  ||r||^2 <= tol^2 ||F||^2 tested before every iteration, under the
//             plain `maxiter` cap; alpha and beta are 0 where their denominators
//             are not positive. x0 = null starts from zero.
//   rounding  every product and sum of the stencil and of the x, r, p updates
//             rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: no FMA), as
//             the plain torch version rounds them; the dots summed in float64.
//
// What bounds it on an H100. K4 keeps a sample's x, r, p, Ap in device memory
// and streams ~80 bytes per cell and iteration; at res32 that puts it near the
// card's memory rate for its own traffic, and ~100x above its operation bound.
// Here the sample's 7 planes, D^-1 and x, r, p, Ap live in shared memory for
// the whole solve, cut into row strips: block j of a cooperative grid of one
// block per SM owns the true rows [j X0 / nb, (j+1) X0 / nb) (5-6 rows of 513 at
// res32, ~157 KB of its 227 KB), and device memory leaves the iteration loop.
// What is left per iteration is a sweep of ~3k cells per SM in shared memory
// and the two grid barriers that CG's two reductions need, so latency, not
// bandwidth, bounds it.
//
// One iteration:
//   A   Ap = A p over the strip (p holds one halo row above and below and a
//       zero column on each side), p.Ap summed per block; BARRIER 1; every
//       block sums the blocks' partials in block order -> alpha.
//   B   x += alpha p, r -= alpha Ap, z = D^-1 r, r.z and r.r per block; the
//       strip's first and last rows of r are published to device memory;
//       BARRIER 2; the partials summed in block order -> beta, rr.
//   C   p = z + beta p on the strip, and on the two halo rows too: each block
//       computes its neighbours' new p itself from their published r, its own
//       copy of their old p and their D^-1, the same operations in the same
//       order as the owner, so the same bits. No third barrier.
//
// Agreement. Every block sums the same partials in the same order (see
// grid_sum2), so every block holds the same alpha, beta, rr and stop decision
// bit for bit, and the result is the same from run to run. A block that
// decided otherwise would wait at a barrier the others never reach.
//
// The barrier. A hand-written one under the cooperative launch's guarantee
// that every block is resident: thread 0 of each block adds one to a counter
// (atom.add.acq_rel.gpu) and waits (ld.acquire.gpu) until the counter reaches
// the next multiple of the grid's size. The 64-bit counter starts at 0 for
// each launch (the wrapper zeroes it) and is never reset inside one, so a
// late reader can never miss a generation. cudaLaunchCooperativeKernel
// refuses a grid whose blocks cannot all be resident at once (the refusal is
// returned to the caller), and a wait longer than 10 s traps, so a fault ends
// the launch with an error instead of hanging the card.
//
// Buffers shared between blocks, and why none is overwritten before every
// block has read it. Number the barriers in the order every block passes
// them. A buffer written before barrier N is read after N and before the
// reader arrives at N+1, and no block leaves N+1 before every block has
// arrived there; so the next write may come after N+1, i.e. before N+2 at
// the earliest.
//   slots FF     written once, before the first barrier.
//   slots PAP    written before every barrier 1: barrier 1s are two apart.
//   slots RZ, RR and the published rows of r: written before every barrier 2
//                and before each sample's first barrier ("init"), which a
//                barrier 1 follows before the next barrier 2.
//   Each sample ends with a barrier ("end") after its last reads, so the next
//   sample's init writes come two barriers after them.
// Device-memory traffic between blocks goes through L2 (__stcg / __ldcg).
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: warp 0 reduces one value per warp
constexpr int kRed = 4 * kWarps;       // the block's float64 reduction scratch

// The shared-memory bytes one block needs for a strip of `rows` rows of width
// W; ops/pcg_stencil.py's resident_bytes() computes the same.
__host__ __device__ inline size_t strip_bytes(int rows, int W) {
  const size_t floats = (size_t)11 * rows * W        // 7 planes, D^-1, x, r, Ap
                        + (size_t)(rows + 2) * (W + 2)  // p with its halo and zero border
                        + (size_t)2 * W;                // D^-1 of the two halo rows
  return kRed * sizeof(double) + floats * sizeof(float);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

typedef unsigned long long u64;

enum Row { kFF = 0, kPAP = 1, kRZ = 2, kRR = 3 };  // the rows of nb partials each

// A barrier that waits longer than this has lost a block: the kernel traps,
// so a fault ends the launch with an error instead of hanging the card.
constexpr u64 kWaitTimeoutNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ u64 add_acq_rel(u64* p, u64 v) {
  u64 old;
  asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], %2;" : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

// Every block of the grid arrives before any leaves; every write issued
// before it by any thread of the grid is visible after it to every thread.
// Thread 0 alone arrives and waits: one poller per SM on one word.
__device__ __forceinline__ void grid_barrier(u64* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const u64 nb = gridDim.x;
    const u64 target = (add_acq_rel(counter, 1ull) / nb + 1ull) * nb;
    const u64 t0 = globaltimer();
    for (unsigned polls = 1; ld_acquire(counter) < target; ++polls) {
      if (polls % 256 == 0 && globaltimer() - t0 > kWaitTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// Sums a (and b, where sb is not null) over the whole grid in float64, in a
// fixed order: each block's threads by warp and lane; then the blocks'
// partials, block k read by lane k % 32 of warp k / 32 (one load each, all in
// flight together), summed by each such warp's shuffle tree and the warps in
// order. Slots sa, sb hold one partial per block. Returns the sums, rounded to
// float32, to every thread of every block, all blocks the same bits (see the
// header). Contains one grid barrier.
__device__ float2 grid_sum2(double a, double b, double* sa, double* sb, u64* counter,
                            double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x, nw = (nb + 31) / 32;  // nb <= 32 * kWarps
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const double s = warp_sum(red[lane]), t = warp_sum(red[kWarps + lane]);
    if (lane == 0) {
      __stcg(sa + blockIdx.x, s);
      if (sb != nullptr) __stcg(sb + blockIdx.x, t);
    }
  }
  grid_barrier(counter);
  if (warp < nw) {
    const int k = 32 * warp + lane;
    double va = k < nb ? __ldcg(sa + k) : 0.0;
    double vb = k < nb && sb != nullptr ? __ldcg(sb + k) : 0.0;
    va = warp_sum(va);
    vb = warp_sum(vb);
    if (lane == 0) {
      red[2 * kWarps + warp] = va;
      red[3 * kWarps + warp] = vb;
    }
  }
  __syncthreads();
  double s = 0.0, t = 0.0;
  for (int w = 0; w < nw; ++w) {
    s += red[2 * kWarps + w];
    t += red[3 * kWarps + w];
  }
  return make_float2((float)s, (float)t);
}

// A thread's walk over the strip's cells c = tid, tid + kThreads, ... as
// (row i, column col) of width W, without a division per step.
struct Cells {
  int c, i, col;
  const int cells, W, di, dc;
  __device__ Cells(int tid, int cells_, int W_)
      : c(tid), i(tid / W_), col(tid - (tid / W_) * W_), cells(cells_), W(W_),
        di(kThreads / W_), dc(kThreads - (kThreads / W_) * W_) {}
  __device__ bool more() const { return c < cells; }
  __device__ void next() {
    c += kThreads;
    i += di;
    col += dc;
    if (col >= W) {
      col -= W;
      ++i;
    }
  }
};

__device__ __forceinline__ float inv_diag(float d) { return d != 0.f ? 1.f / d : 0.f; }

// y + a * x with the product and the sum each rounded (never an FMA)
__device__ __forceinline__ float madd(float y, float a, float x) { return __fadd_rn(y, __fmul_rn(a, x)); }

// The 7-plane stencil at a strip cell: v = the strip's planes (7, rows * W) at
// the cell's index ci, pp = p at the cell in the bordered (rows + 2, W + 2)
// array. Term order follows the plain version and K4.
__device__ __forceinline__ float stencil(const float* v, size_t plane, int ci, const float* pp, int P) {
  float acc = __fmul_rn(v[3 * plane + ci], pp[0]);
  acc = madd(acc, v[ci], pp[-P - 1]);               // (-1, -1)
  acc = madd(acc, v[plane + ci], pp[-P]);           // (-1, 0)
  acc = madd(acc, v[2 * plane + ci], pp[-1]);       // (0, -1)
  acc = madd(acc, v[4 * plane + ci], pp[1]);        // (0, 1)
  acc = madd(acc, v[5 * plane + ci], pp[P]);        // (1, 0)
  acc = madd(acc, v[6 * plane + ci], pp[P + 1]);    // (1, 1)
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
pcg_stencil_grid_resident_kernel(const float* __restrict__ vals2d,  // (B, 7, X, Y)
                                 const float* __restrict__ F,       // (X, Y)
                                 const float* __restrict__ x0,      // (B, X, Y) or null
                                 float* __restrict__ x_out,         // (B, X, Y)
                                 int* __restrict__ iters,           // (B,)
                                 u64* counter,                      // 1, zero at launch
                                 double* slots,                     // (4, nb)
                                 float* pub,                        // (nb, 2, Y0): r's edge rows
                                 int B, int X, int Y, int X0, int Y0, int R, float tol2_scale,
                                 int maxiter) {
  extern __shared__ double smem[];
  const int nb = gridDim.x, j = blockIdx.x, tid = threadIdx.x;
  const int W = Y0, P = W + 2;
  const int row0 = (int)(((long long)j * X0) / nb);
  const int nr = (int)(((long long)(j + 1) * X0) / nb) - row0;  // rows of this strip, <= R
  const int cells = nr * W;
  const size_t plane = (size_t)R * W;
  const size_t N = (size_t)X * Y;

  double* red = smem;
  float* pl = reinterpret_cast<float*>(smem + kRed);  // (7, R * W)
  float* dinv = pl + 7 * plane;                       // (R * W)
  float* xs = dinv + plane;
  float* rs = xs + plane;
  float* aps = rs + plane;
  float* ps = aps + plane;                            // (R + 2, W + 2)
  float* dinvh = ps + (size_t)(R + 2) * P;            // (2, W): rows row0 - 1 and row0 + nr
  const bool has_up = row0 > 0, has_dn = row0 + nr < X0;
  float* pub_mine = pub + (size_t)j * 2 * W;
  const float* pub_up = has_up ? pub + ((size_t)(j - 1) * 2 + 1) * W : pub;  // block j - 1's last row
  const float* pub_dn = has_dn ? pub + (size_t)(j + 1) * 2 * W : pub;        // block j + 1's first row
  double* s_ff = slots + kFF * nb;
  double* s_pap = slots + kPAP * nb;
  double* s_rz = slots + kRZ * nb;
  double* s_rr = slots + kRR * nb;

  // p's border columns stay zero for the whole launch
  for (int i = tid; i < R + 2; i += kThreads) ps[(size_t)i * P] = ps[(size_t)i * P + W + 1] = 0.f;

  double ff = 0.0;
  for (Cells e(tid, cells, W); e.more(); e.next()) {
    const float f = F[(size_t)(row0 + e.i) * Y + e.col];
    ff += (double)f * f;
  }
  const float tol2 = tol2_scale * grid_sum2(ff, 0.0, s_ff, nullptr, counter, red).x;

  for (int b = 0; b < B; ++b) {
    const float* v = vals2d + (size_t)b * 7 * N;
    const float* xb0 = x0 != nullptr ? x0 + (size_t)b * N : nullptr;

    // Load the strip: planes and D^-1; x0 (zero where null) into x and, with
    // its halo rows, into p, which holds x for the first residual.
    for (Cells e(tid, cells, W); e.more(); e.next()) {
      const size_t g = (size_t)(row0 + e.i) * Y + e.col;
#pragma unroll
      for (int s = 0; s < 7; ++s) pl[s * plane + e.c] = v[s * N + g];
      dinv[e.c] = inv_diag(pl[3 * plane + e.c]);
    }
    for (Cells e(tid, (nr + 2) * W, W); e.more(); e.next()) {
      const int row = row0 - 1 + e.i;
      const bool in = row >= 0 && row < X0;
      const float xv = in && xb0 != nullptr ? xb0[(size_t)row * Y + e.col] : 0.f;
      ps[(size_t)e.i * P + e.col + 1] = xv;
      if (e.i >= 1 && e.i <= nr) xs[e.c - W] = xv;
    }
    for (int col = tid; col < W; col += kThreads) {
      dinvh[col] = has_up ? inv_diag(v[3 * N + (size_t)(row0 - 1) * Y + col]) : 0.f;
      dinvh[W + col] = has_dn ? inv_diag(v[3 * N + (size_t)(row0 + nr) * Y + col]) : 0.f;
    }
    __syncthreads();

    // r = F - A x0 (p still holds x0 until every thread has read it)
    for (Cells e(tid, cells, W); e.more(); e.next()) {
      const float ax = stencil(pl, plane, e.c, ps + (size_t)(e.i + 1) * P + e.col + 1, P);
      rs[e.c] = F[(size_t)(row0 + e.i) * Y + e.col] - ax;
    }
    __syncthreads();
    // p = z = D^-1 r; r.z, r.r; publish r's edge rows
    double d_rz = 0.0, d_rr = 0.0;
    for (Cells e(tid, cells, W); e.more(); e.next()) {
      const float ri = rs[e.c], zi = dinv[e.c] * ri;
      ps[(size_t)(e.i + 1) * P + e.col + 1] = zi;
      d_rz += (double)ri * zi;
      d_rr += (double)ri * ri;
      if (e.i == 0) __stcg(pub_mine + e.col, ri);
      if (e.i == nr - 1) __stcg(pub_mine + W + e.col, ri);
    }
    float2 s = grid_sum2(d_rz, d_rr, s_rz, s_rr, counter, red);  // barrier "init"
    float rz = s.x, rr = s.y;
    // the halo rows' p = z from the neighbours' published r (zero outside the grid)
    for (int col = tid; col < W; col += kThreads) {
      if (has_up) ps[col + 1] = dinvh[col] * __ldcg(pub_up + col);
      if (has_dn) ps[(size_t)(nr + 1) * P + col + 1] = dinvh[W + col] * __ldcg(pub_dn + col);
    }
    __syncthreads();

    int it = 0;
    // rr and it are the same in every block (see the header): all blocks take
    // the same number of trips, so all reach the same barriers
    while (it < maxiter && rr > tol2) {
      double d_pap = 0.0;
      for (Cells e(tid, cells, W); e.more(); e.next()) {
        const float* pp = ps + (size_t)(e.i + 1) * P + e.col + 1;
        const float a = stencil(pl, plane, e.c, pp, P);
        aps[e.c] = a;
        d_pap += (double)pp[0] * a;
      }
      const float pAp = grid_sum2(d_pap, 0.0, s_pap, nullptr, counter, red).x;  // barrier 1
      const float alpha = pAp > 0.f ? rz / pAp : 0.f;
      d_rz = 0.0;
      d_rr = 0.0;
      for (Cells e(tid, cells, W); e.more(); e.next()) {
        const float pi = ps[(size_t)(e.i + 1) * P + e.col + 1];
        xs[e.c] = madd(xs[e.c], alpha, pi);
        const float ri = __fsub_rn(rs[e.c], __fmul_rn(alpha, aps[e.c]));
        rs[e.c] = ri;
        d_rz += (double)ri * (dinv[e.c] * ri);
        d_rr += (double)ri * ri;
        if (e.i == 0) __stcg(pub_mine + e.col, ri);
        if (e.i == nr - 1) __stcg(pub_mine + W + e.col, ri);
      }
      s = grid_sum2(d_rz, d_rr, s_rz, s_rr, counter, red);  // barrier 2
      const float beta = rz > 0.f ? s.x / rz : 0.f;
      for (Cells e(tid, cells, W); e.more(); e.next()) {
        float* pp = ps + (size_t)(e.i + 1) * P + e.col + 1;
        *pp = madd(dinv[e.c] * rs[e.c], beta, *pp);
      }
      for (int col = tid; col < W; col += kThreads) {
        if (has_up) ps[col + 1] = madd(dinvh[col] * __ldcg(pub_up + col), beta, ps[col + 1]);
        if (has_dn) {
          float* pp = ps + (size_t)(nr + 1) * P + col + 1;
          *pp = madd(dinvh[W + col] * __ldcg(pub_dn + col), beta, *pp);
        }
      }
      __syncthreads();  // p complete before the next stencil reads its neighbours
      rz = s.x;
      rr = s.y;
      ++it;
    }

    // x once, with zeros in the padding: each block its rows' full width, the
    // last block the padded rows too
    float* xb = x_out + (size_t)b * N;
    const int row_end = j == nb - 1 ? X : row0 + nr;
    for (Cells e(tid, (row_end - row0) * Y, Y); e.more(); e.next())
      xb[(size_t)(row0 + e.i) * Y + e.col] = e.i < nr && e.col < W ? xs[(size_t)e.i * W + e.col] : 0.f;
    if (j == 0 && tid == 0) iters[b] = it;
    grid_barrier(counter);  // barrier "end": this sample's reads before the next one's writes
  }
}

}  // namespace

extern "C" {

// The card's SM count and the shared memory one block may opt in to.
cudaError_t pcg_stencil_grid_resident_device(int device, int* n_sm, int* smem_per_block) {
  cudaError_t err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The dynamic shared memory of one block for X0 rows of Y0 cells over nb blocks.
long long pcg_stencil_grid_resident_bytes(int X0, int Y0, int nb) {
  if (X0 <= 0 || Y0 <= 0 || nb <= 0) return -1;
  return (long long)strip_bytes((X0 + nb - 1) / nb, Y0);
}

// nb blocks (one per SM, nb <= X0) solve the B samples one after another.
// counter: one 64-bit unsigned, zero; slots: (4, nb) float64; pub: (nb, 2, Y0) float32.
cudaError_t pcg_stencil_grid_resident_launch(const float* vals2d, const float* F, const float* x0,
                                             float* x, int* iters, unsigned long long* counter,
                                             double* slots, float* pub,
                                             int B, int X, int Y, int X0, int Y0, int nb,
                                             float tol2_scale, int maxiter, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (X0 <= 0 || Y0 <= 0 || X0 > X || Y0 > Y || nb <= 0 || nb > X0 || nb > 32 * kWarps ||
      maxiter < 0)
    return cudaErrorInvalidValue;
  if ((long long)X * Y > 0x7fffffffLL / 8) return cudaErrorInvalidValue;
  int R = (X0 + nb - 1) / nb;
  const size_t bytes = strip_bytes(R, Y0);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pcg_stencil_grid_resident_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&vals2d, (void*)&F, (void*)&x0, (void*)&x, (void*)&iters,
                  (void*)&counter, (void*)&slots, (void*)&pub, (void*)&B, (void*)&X, (void*)&Y,
                  (void*)&X0, (void*)&Y0, (void*)&R, (void*)&tol2_scale, (void*)&maxiter};
  err = cudaLaunchCooperativeKernel((const void*)pcg_stencil_grid_resident_kernel, dim3(nb),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
