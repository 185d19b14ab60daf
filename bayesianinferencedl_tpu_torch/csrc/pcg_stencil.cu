// K1: batched, two-level-deflated Jacobi-PCG on the fin's 7-diagonal stencil.
//
// Replaces the TPU Pallas kernel `_pcg_kernel_lanes` + `_jacobi_cg`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py, launched by
// `pcg_stencil_batch_lanes`). Same math, one CUDA thread block per sample:
//
//   stencil   acc_i = v0_i p_i + sum_{o in {o1,o2,o3}} (v_o,i p_{i+o} + v_o,{i-o} p_{i-o})
//             from the 4 upper planes (A is symmetric). The TPU kernel rolls
//             with wrap-around; here reads outside [0, n) are masked to zero.
//   precond   z = D^-1 r  (+ Wt^T bf16(Binv_b (Wt bf16(r))) when deflated),
//             Wt stored bf16, f32 accumulation, inv_diag = 0 where diag == 0.
//   stopping  ||r||^2 <= tol^2 ||F||^2, checked PER SAMPLE every
//             `check_every` iterations, under the plain `maxiter` cap.
//
// What bounds it on an H100: per iteration and sample it streams ~4 stencil
// planes + ~6 vector passes (~40 B/node, 256 KB at res4) plus the deflation
// basis twice (2*m*n bf16 = 3.3 MB at res4, m = 128), and runs a serial
// chain of 3 block reductions + 4 barriers. The design keeps the whole CG loop
// inside the kernel (no host round-trip, no per-iteration launches), keeps the
// bf16 residual copy and the coarse vectors in shared memory, streams Wt as
// 16-byte words (8 bf16 per load, so n % 8 == 0 when deflated), and relies on
// L2 (50 MB) to hold the shared Wt and the per-sample planes/scratch. Tensor
// cores (several samples per CTA, wgmma on the Wt products) and TMA are later
// work.
//
// Plain C interface (built with nvcc, loaded with ctypes); every launch
// function returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRedSlots = 64;  // reduction scratch (kWarps partials + result), floats
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

// Float offset of the bf16 residual copy in shared memory (16-byte aligned).
__host__ __device__ constexpr int rb_offset(int m) { return (kRedSlots + 2 * m + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum, returned to every thread. The leading barrier also makes
// every global/shared write issued before the call visible to the block.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  return red[kWarps];
}

// Row i of the symmetric 4-plane stencil applied to p; v = this sample's
// (4, n) planes [diag, +o1, +o2, +o3]. Term order follows the plain version.
__device__ __forceinline__ float stencil_row(const float* __restrict__ v, const float* p,
                                             int i, int n, int o1, int o2, int o3) {
  float acc = v[i] * p[i];
  const int offs[3] = {o1, o2, o3};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int o = offs[j];
    const float* vo = v + (size_t)(j + 1) * n;
    if (i + o < n) acc += vo[i] * p[i + o];
    if (i - o >= 0) acc += vo[i - o] * p[i - o];
  }
  return acc;
}

// The 8 bf16 values of a 16-byte word, as floats.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// z = M^-1 r for this sample; returns r . z. When deflated, `rb` must already
// hold bf16(r) for the whole sample (the leading barrier completes it), and
// n % 8 == 0 so that Wt rows and rb are read as 16-byte words.
__device__ float precond_rz(const float* __restrict__ v, const float* r, float* z,
                            const __nv_bfloat16* rb, const __nv_bfloat16* __restrict__ Wt,
                            const float* __restrict__ Bi, float* y, float* c, float* red,
                            int n, int m, bool defl) {
  const int tid = threadIdx.x;
  if (defl) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n8 = n / 8;
    const uint4* rb8 = reinterpret_cast<const uint4*>(rb);
    __syncthreads();
    // y = Wt bf16(r): one warp per coarse row, 8 values per load
    for (int j = warp; j < m; j += kWarps) {
      const uint4* w8 = reinterpret_cast<const uint4*>(Wt + (size_t)j * n);
      float s = 0.f;
      for (int q = lane; q < n8; q += 32) {
        float a[8], b[8];
        unpack8(w8[q], a);
        unpack8(rb8[q], b);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += a[e] * b[e];
      }
      s = warp_sum(s);
      if (lane == 0) y[j] = s;
    }
    __syncthreads();
    // c = bf16(Binv_b y): one warp per row of the per-sample coarse inverse
    for (int j = warp; j < m; j += kWarps) {
      const float* row = Bi + (size_t)j * m;
      float s = 0.f;
      for (int k = lane; k < m; k += 32) s += row[k] * y[k];
      s = warp_sum(s);
      if (lane == 0) c[j] = __bfloat162float(__float2bfloat16(s));
    }
    __syncthreads();
    // z <- Wt^T c, 8 consecutive nodes per thread
    for (int q = tid; q < n8; q += kThreads) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < m; ++j) {
        float a[8];
        unpack8(reinterpret_cast<const uint4*>(Wt + (size_t)j * n)[q], a);
        const float cj = c[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += a[e] * cj;
      }
      float4* z4 = reinterpret_cast<float4*>(z + 8 * (size_t)q);
      z4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      z4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
  }
  float s = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float d = v[i];
    float zi = (d != 0.f ? 1.f / d : 0.f) * r[i];
    if (defl) zi += z[i];
    z[i] = zi;
    s += r[i] * zi;
  }
  return block_sum(s, red);
}

__global__ void __launch_bounds__(kThreads)
pcg_stencil_kernel(const float* __restrict__ vals4,       // (B, 4, n)
                   const float* __restrict__ F,           // (n,)
                   const float* __restrict__ x0,          // (B, n) or null
                   const __nv_bfloat16* __restrict__ Wt,  // (m, n) or null
                   const float* __restrict__ Binv,        // (B, m, m) or null
                   float* __restrict__ x_out,             // (B, n)
                   int* __restrict__ iters,               // (B,)
                   float* __restrict__ scratch,           // (B, 4, n): r, p, Ap, z
                   int n, int m, int o1, int o2, int o3,
                   float tol2_scale, int maxiter, int check_every) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;
  float* y = red + kRedSlots;
  float* c = y + m;
  __nv_bfloat16* rb = reinterpret_cast<__nv_bfloat16*>(smem + rb_offset(m));

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool defl = Wt != nullptr && m > 0;
  const float* v = vals4 + (size_t)b * 4 * n;
  const float* Bi = defl ? Binv + (size_t)b * m * m : nullptr;
  float* x = x_out + (size_t)b * n;
  float* r = scratch + (size_t)b * 4 * n;
  float* p = r + n;
  float* Ap = p + n;
  float* z = Ap + n;

  float ff = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    x[i] = x0 != nullptr ? x0[(size_t)b * n + i] : 0.f;
    const float f = F[i];
    ff += f * f;
  }
  const float tol2 = tol2_scale * block_sum(ff, red);

  for (int i = tid; i < n; i += kThreads) {
    const float ri = F[i] - stencil_row(v, x, i, n, o1, o2, o3);
    r[i] = ri;
    if (defl) rb[i] = __float2bfloat16(ri);
  }
  float rz = precond_rz(v, r, z, rb, Wt, Bi, y, c, red, n, m, defl);
  for (int i = tid; i < n; i += kThreads) p[i] = z[i];
  __syncthreads();

  int it = 0;
  for (;;) {
    float s = 0.f;
    for (int i = tid; i < n; i += kThreads) s += r[i] * r[i];
    const float rr = block_sum(s, red);
    if (!(it < maxiter && rr > tol2)) break;
    const int inner = min(check_every, maxiter - it);
    for (int k = 0; k < inner; ++k) {
      float s1 = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        const float a = stencil_row(v, p, i, n, o1, o2, o3);
        Ap[i] = a;
        s1 += p[i] * a;
      }
      const float pAp = block_sum(s1, red);
      const float alpha = pAp > 0.f ? rz / pAp : 0.f;
      for (int i = tid; i < n; i += kThreads) {
        x[i] += alpha * p[i];
        const float ri = r[i] - alpha * Ap[i];
        r[i] = ri;
        if (defl) rb[i] = __float2bfloat16(ri);
      }
      const float rz_new = precond_rz(v, r, z, rb, Wt, Bi, y, c, red, n, m, defl);
      const float beta = rz > 0.f ? rz_new / rz : 0.f;
      for (int i = tid; i < n; i += kThreads) p[i] = z[i] + beta * p[i];
      __syncthreads();
      rz = rz_new;
    }
    it += inner;
  }
  if (tid == 0) iters[b] = it;
}

// Dynamic shared memory one block needs (bytes).
size_t smem_bytes(int n, int m) {
  return (size_t)rb_offset(m) * sizeof(float) + (m > 0 ? (size_t)n * sizeof(__nv_bfloat16) : 0);
}

}  // namespace

extern "C" {

cudaError_t pcg_stencil_launch(const float* vals4, const float* F, const float* x0,
                               const void* Wt, const float* Binv, float* x, int* iters,
                               float* scratch, int B, int n, int m, int o1, int o2, int o3,
                               float tol2_scale, int maxiter, int check_every,
                               cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (n <= 0 || m < 0 || check_every < 1 || maxiter < 0) return cudaErrorInvalidValue;
  if ((Wt == nullptr) != (Binv == nullptr)) return cudaErrorInvalidValue;
  const int m_eff = Wt != nullptr ? m : 0;
  if (m_eff > 0 && n % 8 != 0) return cudaErrorInvalidValue;  // 16-byte Wt / rb words
  const size_t smem = smem_bytes(n, m_eff);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pcg_stencil_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pcg_stencil_kernel<<<B, kThreads, smem, stream>>>(
      vals4, F, x0, static_cast<const __nv_bfloat16*>(Wt), Binv, x, iters, scratch, n, m_eff,
      o1, o2, o3, tol2_scale, maxiter, check_every);
  return cudaGetLastError();
}

}  // extern "C"
