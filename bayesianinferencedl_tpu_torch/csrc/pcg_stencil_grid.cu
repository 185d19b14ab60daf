// K4: one sample's Jacobi-PCG on the fin's 2-D grid, a batch of samples per launch.
//
// Replaces the TPU Pallas kernel `_pcg_kernel`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py, launched by `pcg_stencil_batch`),
// the JAX package's "single" layout for meshes above n = 182,044 (res >= 22).
// Same math, one CUDA thread block per sample:
//
//   stencil   acc = v3 p + sum_{s != 3} v_s p[ix+dx_s, iy+dy_s] over the 7 planes of
//             OFFSETS_2D = (-1,-1) (-1,0) (0,-1) (0,0) (0,1) (1,0) (1,1), in that
//             order. The TPU kernel rolls with wrap-around onto zero planes; here
//             reads outside the (X, Y) grid are masked to zero.
//   precond   z = D^-1 r, D^-1 = 0 where the diagonal is 0. No deflation: the
//             JAX package's single layout has none.
//   stopping  ||r||^2 <= tol^2 ||F||^2 tested BEFORE EVERY iteration (a converged
//             warm start returns 0 iterations), under the plain `maxiter` cap;
//             alpha and beta are 0 where their denominators are not positive.
//
// What bounds it on an H100: one f32 vector is X*Y*4 bytes (1.99 MB at res32,
// padded grid 776 x 640), far beyond a block's 227 KB of shared memory, so x, r,
// p and Ap live in global memory (x in the output, r, p, Ap in a (B, 3, X*Y)
// scratch the wrapper allocates) and each iteration streams ~20 f32 values per
// cell: 7 planes, the stencil's p, Ap, x, r, p again. Three fused passes per
// iteration: (Ap = A p, p.Ap); (x and r updates, z on the fly, r.z and r.r
// together); (p = z + beta p). Each thread takes 4 consecutive cells of a grid
// row at a time (Y % 4 == 0), so every plane and vector moves as 16-byte words
// and the row neighbours come from the same words. One block per sample means
// one SM per sample, so the block's own memory parallelism bounds it: a batch
// of 256 fills the card, a single solve uses 1 SM of 132.
//
// Accuracy: the three dot products are summed in float64 (each thread, then
// the block in a fixed order, so the kernel is deterministic). A block sums
// ~500k products per dot at res32; summed in float32 in sequence per thread,
// f32 CG at tol 1e-7 ran clearly more iterations than the plain version's
// tree sums and reached the cap. The vectors stay float32.
//
// Rounding: every product and every sum of the stencil and of the x, r and p
// updates is rounded to float32 on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA), as the plain torch
// version rounds them. f32 CG stops at an accuracy that the stencil's
// rounding sets: at res32, k = (0.5, 2, 1, 3, 0.8), the contracted stencil
// stopped at the same iteration as the plain version but on the other side
// of the exact solution, the QoI 1.6e-3 apart, each ~8e-4 from a float64
// direct solve.
//
// Spreading a sample over a cluster or a cooperative grid, and keeping the
// planes in fewer bits, are later work.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of two values, returned to every thread as float32. The
// leading barrier also makes every global write issued before the call
// visible to the block.
__device__ __forceinline__ float2 block_sum2(double a, double b, double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    double s = lane < kWarps ? red[lane] : 0.0;
    double t = lane < kWarps ? red[kWarps + lane] : 0.0;
    s = warp_sum(s);
    t = warp_sum(t);
    if (lane == 0) {
      red[2 * kWarps] = s;
      red[2 * kWarps + 1] = t;
    }
  }
  __syncthreads();
  return make_float2((float)red[2 * kWarps], (float)red[2 * kWarps + 1]);
}

__device__ __forceinline__ float inv_diag(float d) { return d != 0.f ? 1.f / d : 0.f; }

__device__ __forceinline__ float4 ld4(const float* a, int i) {
  return *reinterpret_cast<const float4*>(a + i);
}

__device__ __forceinline__ void st4(float* a, int i, float4 v) { *reinterpret_cast<float4*>(a + i) = v; }

__device__ __forceinline__ double dot4(float4 a, float4 b) {
  return (double)a.x * b.x + (double)a.y * b.y + (double)a.z * b.z + (double)a.w * b.w;
}

// y + a * x with the product and the sum each rounded (never an FMA)
__device__ __forceinline__ float madd(float y, float a, float x) { return __fadd_rn(y, __fmul_rn(a, x)); }

// acc += v * q, per component, unfused
__device__ __forceinline__ void madd4(float4& acc, float4 v, float4 q) {
  acc.x = madd(acc.x, v.x, q.x);
  acc.y = madd(acc.y, v.y, q.y);
  acc.z = madd(acc.z, v.z, q.z);
  acc.w = madd(acc.w, v.w, q.w);
}

// Cells (ix, iy..iy+3) = flat i..i+3 of the 7-plane stencil applied to p; v =
// this sample's (7, X*Y) planes; iy % 4 == 0. Reads outside the grid are zero.
// Term order follows the plain version.
__device__ __forceinline__ float4 stencil4(const float* __restrict__ v, const float* p, int N, int i,
                                           int ix, int iy, int X, int Y) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool xm = ix > 0, xp = ix + 1 < X, ym = iy > 0, yp = iy + 4 < Y;
  const float4 pc = ld4(p, i);
  const float4 pu = xm ? ld4(p, i - Y) : zero;  // row ix - 1
  const float4 pd = xp ? ld4(p, i + Y) : zero;  // row ix + 1
  const float ul = xm && ym ? p[i - Y - 1] : 0.f;
  const float cl = ym ? p[i - 1] : 0.f;
  const float cr = yp ? p[i + 4] : 0.f;
  const float dr = xp && yp ? p[i + Y + 4] : 0.f;
  const float4 d = ld4(v + 3 * N, i);
  float4 acc = make_float4(__fmul_rn(d.x, pc.x), __fmul_rn(d.y, pc.y), __fmul_rn(d.z, pc.z),
                           __fmul_rn(d.w, pc.w));
  madd4(acc, ld4(v, i), make_float4(ul, pu.x, pu.y, pu.z));       // (-1, -1)
  madd4(acc, ld4(v + N, i), pu);                                   // (-1, 0)
  madd4(acc, ld4(v + 2 * N, i), make_float4(cl, pc.x, pc.y, pc.z));  // (0, -1)
  madd4(acc, ld4(v + 4 * N, i), make_float4(pc.y, pc.z, pc.w, cr));  // (0, 1)
  madd4(acc, ld4(v + 5 * N, i), pd);                               // (1, 0)
  madd4(acc, ld4(v + 6 * N, i), make_float4(pd.y, pd.z, pd.w, dr));  // (1, 1)
  return acc;
}

__device__ __forceinline__ float4 jacobi4(float4 d, float4 r) {
  return make_float4(inv_diag(d.x) * r.x, inv_diag(d.y) * r.y, inv_diag(d.z) * r.z,
                     inv_diag(d.w) * r.w);
}

__global__ void __launch_bounds__(kThreads)
pcg_stencil_grid_kernel(const float* __restrict__ vals2d,  // (B, 7, X, Y)
                        const float* __restrict__ F,       // (X, Y)
                        const float* __restrict__ x0,      // (B, X, Y) or null
                        float* __restrict__ x_out,         // (B, X, Y)
                        int* __restrict__ iters,           // (B,)
                        float* __restrict__ scratch,       // (B, 3, X*Y): r, p, Ap
                        int X, int Y, float tol2_scale, int maxiter) {
  __shared__ double red[2 * kWarps + 2];
  const int N = X * Y;
  const int Y4 = Y / 4;
  const int n4 = X * Y4;  // groups of 4 cells
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* v = vals2d + (size_t)b * 7 * N;
  const float* d = v + 3 * N;
  float* x = x_out + (size_t)b * N;
  float* r = scratch + (size_t)b * 3 * N;
  float* p = r + N;
  float* Ap = p + N;

  double ff = 0.0;
  for (int g = tid; g < n4; g += kThreads) {
    const int i = 4 * g;
    st4(x, i, x0 != nullptr ? ld4(x0 + (size_t)b * N, i) : make_float4(0.f, 0.f, 0.f, 0.f));
    const float4 f = ld4(F, i);
    ff += dot4(f, f);
  }
  const float tol2 = tol2_scale * block_sum2(ff, 0.0, red).x;

  // r = F - A x, p = z = D^-1 r; r.z and r.r
  double s_rz = 0.0, s_rr = 0.0;
  for (int g = tid; g < n4; g += kThreads) {
    const int ix = g / Y4, iy = 4 * (g - ix * Y4), i = 4 * g;
    const float4 ax = stencil4(v, x, N, i, ix, iy, X, Y);
    const float4 f = ld4(F, i);
    const float4 ri = make_float4(f.x - ax.x, f.y - ax.y, f.z - ax.z, f.w - ax.w);
    const float4 zi = jacobi4(ld4(d, i), ri);
    st4(r, i, ri);
    st4(p, i, zi);
    s_rz += dot4(ri, zi);
    s_rr += dot4(ri, ri);
  }
  float2 s = block_sum2(s_rz, s_rr, red);
  float rz = s.x, rr = s.y;

  int it = 0;
  while (it < maxiter && rr > tol2) {
    double s_pap = 0.0;
    for (int g = tid; g < n4; g += kThreads) {
      const int ix = g / Y4, iy = 4 * (g - ix * Y4), i = 4 * g;
      const float4 a = stencil4(v, p, N, i, ix, iy, X, Y);
      st4(Ap, i, a);
      s_pap += dot4(ld4(p, i), a);
    }
    const float pAp = block_sum2(s_pap, 0.0, red).x;
    const float alpha = pAp > 0.f ? rz / pAp : 0.f;
    s_rz = 0.0;
    s_rr = 0.0;
    for (int g = tid; g < n4; g += kThreads) {
      const int i = 4 * g;
      const float4 pi = ld4(p, i), ai = ld4(Ap, i);
      float4 xi = ld4(x, i), ri = ld4(r, i);
      xi.x = madd(xi.x, alpha, pi.x);
      xi.y = madd(xi.y, alpha, pi.y);
      xi.z = madd(xi.z, alpha, pi.z);
      xi.w = madd(xi.w, alpha, pi.w);
      ri.x = __fsub_rn(ri.x, __fmul_rn(alpha, ai.x));
      ri.y = __fsub_rn(ri.y, __fmul_rn(alpha, ai.y));
      ri.z = __fsub_rn(ri.z, __fmul_rn(alpha, ai.z));
      ri.w = __fsub_rn(ri.w, __fmul_rn(alpha, ai.w));
      st4(x, i, xi);
      st4(r, i, ri);
      s_rz += dot4(ri, jacobi4(ld4(d, i), ri));
      s_rr += dot4(ri, ri);
    }
    s = block_sum2(s_rz, s_rr, red);
    const float beta = rz > 0.f ? s.x / rz : 0.f;
    for (int g = tid; g < n4; g += kThreads) {
      const int i = 4 * g;
      const float4 zi = jacobi4(ld4(d, i), ld4(r, i));
      float4 pi = ld4(p, i);
      pi.x = madd(zi.x, beta, pi.x);
      pi.y = madd(zi.y, beta, pi.y);
      pi.z = madd(zi.z, beta, pi.z);
      pi.w = madd(zi.w, beta, pi.w);
      st4(p, i, pi);
    }
    __syncthreads();  // p complete before the next stencil pass reads its neighbours
    rz = s.x;
    rr = s.y;
    ++it;
  }
  if (tid == 0) iters[b] = it;
}

}  // namespace

extern "C" {

cudaError_t pcg_stencil_grid_launch(const float* vals2d, const float* F, const float* x0, float* x,
                                    int* iters, float* scratch, int B, int X, int Y,
                                    float tol2_scale, int maxiter, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (X <= 0 || Y <= 0 || Y % 4 != 0 || maxiter < 0) return cudaErrorInvalidValue;
  if ((long long)X * Y > 0x7fffffffLL / 8) return cudaErrorInvalidValue;
  pcg_stencil_grid_kernel<<<B, kThreads, 0, stream>>>(vals2d, F, x0, x, iters, scratch, X, Y,
                                                      tol2_scale, maxiter);
  return cudaGetLastError();
}

}  // extern "C"
