// K5: the shift-cost probe, a fixed-iteration CG loop with and without the stencil shifts.
//
// Replaces the TPU Pallas kernel `make_kernel` (scripts/diag_roll_cost.py, launched
// by `run`), which measured what share of a sublane-tiled PCG iteration the 7
// lane rolls cost. Since K5r (csrc/shift_cost_cluster.cu, each sample resident
// in a thread-block cluster) this kernel runs only where `shift_route` finds no
// cluster that holds a sample (res >= 16 on an H100). The same loop, one CUDA
// thread block per tile of S samples:
//
//   matvec    acc = v3 p + sum_{s != 3} v_s q_s over the 7 planes, in ascending
//             offset order, with q_s[i] = p[i + o_s] read through the generic flat
//             offset o_s (masked to zero outside [0, n): the TPU roll wraps onto
//             zero planes), or, without shifts, q_s = p: the same operations and
//             bytes with no shifted reads. That variant is not a CG of an SPD
//             operator and its values grow without bound.
//   loop      x0 = 0, r0 = F, z = D^-1 r, then exactly `n_iters` CG iterations
//             with alpha and beta guarded; no convergence test.
//
// What bounds it on an H100: the planes of one sample (7 n f32, 700 KB at res8)
// and its vectors stay in global memory and L2; each iteration streams ~20 f32
// values per node and does ~26 f32 operations per node. The S samples of a tile
// advance together (every thread handles node i of all S samples) and their S
// per-sample sums share each block reduction. The gap between the two variants is
// what the masked, misaligned neighbour reads cost on this card.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDiag = 3;

struct Offsets {
  int o[7];  // flat offsets in ascending order, o[kDiag] == 0
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of S per-sample partials, in a fixed order, written back
// into `part` on every thread. The leading barrier also makes every global
// write issued before the call visible to the block.
template <int S>
__device__ __forceinline__ void block_sums(float (&part)[S], float* red, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float w = warp_sum(part[s]);
    if (lane == 0) red[warp * S + s] = w;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * S + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) part[s] = tot[s];
}

__device__ __forceinline__ float inv_diag(float d) { return d != 0.f ? 1.f / d : 0.f; }

template <bool kShift>
__device__ __forceinline__ float matvec_node(const float* __restrict__ v, const float* p, int i,
                                             int n, const Offsets& offs) {
  float acc = v[(size_t)kDiag * n + i] * p[i];
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    if (s == kDiag) continue;
    float q;
    if (kShift) {
      const int j = i + offs.o[s];
      q = (j >= 0 && j < n) ? p[j] : 0.f;
    } else {
      q = p[i];
    }
    acc += v[(size_t)s * n + i] * q;
  }
  return acc;
}

template <int S, bool kShift>
__global__ void __launch_bounds__(kThreads)
shift_cost_kernel(const float* __restrict__ planes,  // (B, 7, n)
                  const float* __restrict__ F,       // (n,)
                  float* __restrict__ x_out,         // (B, n)
                  float* __restrict__ scratch,       // (B, 3, n): r, p, Ap
                  int n, Offsets offs, int n_iters) {
  __shared__ float red[kWarps * S];
  __shared__ float tot[S];
  const int tid = threadIdx.x;
  const size_t b0 = (size_t)blockIdx.x * S;
  const size_t N = (size_t)n;

  float part[S];
#pragma unroll
  for (int s = 0; s < S; ++s) part[s] = 0.f;
  // x = 0, r = F - A 0 = F, p = z = D^-1 r
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* v = planes + (b0 + s) * 7 * N;
      float* r = scratch + (b0 + s) * 3 * N;
      const float ri = F[i];
      const float zi = inv_diag(v[kDiag * N + i]) * ri;
      x_out[(b0 + s) * N + i] = 0.f;
      r[i] = ri;
      r[N + i] = zi;
      part[s] += ri * zi;
    }
  }
  block_sums<S>(part, red, tot);
  float rz[S];
#pragma unroll
  for (int s = 0; s < S; ++s) rz[s] = part[s];

  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int s = 0; s < S; ++s) part[s] = 0.f;
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* v = planes + (b0 + s) * 7 * N;
        float* p = scratch + (b0 + s) * 3 * N + N;
        const float a = matvec_node<kShift>(v, p, i, n, offs);
        p[N + i] = a;
        part[s] += p[i] * a;
      }
    }
    block_sums<S>(part, red, tot);
    float alpha[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      alpha[s] = part[s] > 0.f ? rz[s] / part[s] : 0.f;
      part[s] = 0.f;
    }
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* v = planes + (b0 + s) * 7 * N;
        float* r = scratch + (b0 + s) * 3 * N;
        float* x = x_out + (b0 + s) * N;
        x[i] += alpha[s] * r[N + i];
        const float ri = r[i] - alpha[s] * r[2 * N + i];
        r[i] = ri;
        part[s] += ri * (inv_diag(v[kDiag * N + i]) * ri);
      }
    }
    block_sums<S>(part, red, tot);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float beta = rz[s] > 0.f ? part[s] / rz[s] : 0.f;
      rz[s] = part[s];
      part[s] = beta;
    }
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* v = planes + (b0 + s) * 7 * N;
        float* r = scratch + (b0 + s) * 3 * N;
        r[N + i] = inv_diag(v[kDiag * N + i]) * r[i] + part[s] * r[N + i];
      }
    }
    __syncthreads();  // p complete before the next matvec reads its neighbours
  }
}

template <int S>
cudaError_t launch_tile(const float* planes, const float* F, float* x, float* scratch, int B, int n,
                        const Offsets& offs, int n_iters, int use_shifts, cudaStream_t stream) {
  if (use_shifts)
    shift_cost_kernel<S, true><<<B / S, kThreads, 0, stream>>>(planes, F, x, scratch, n, offs, n_iters);
  else
    shift_cost_kernel<S, false><<<B / S, kThreads, 0, stream>>>(planes, F, x, scratch, n, offs, n_iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t shift_cost_launch(const float* planes, const float* F, float* x, float* scratch, int B,
                              int n, const int* offsets, int tile, int n_iters, int use_shifts,
                              cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (n <= 0 || n_iters < 0 || tile <= 0 || B % tile != 0) return cudaErrorInvalidValue;
  Offsets offs;
  for (int s = 0; s < 7; ++s) offs.o[s] = offsets[s];
  if (offs.o[kDiag] != 0) return cudaErrorInvalidValue;
  switch (tile) {
    case 8: return launch_tile<8>(planes, F, x, scratch, B, n, offs, n_iters, use_shifts, stream);
    case 16: return launch_tile<16>(planes, F, x, scratch, B, n, offs, n_iters, use_shifts, stream);
    case 32: return launch_tile<32>(planes, F, x, scratch, B, n, offs, n_iters, use_shifts, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
