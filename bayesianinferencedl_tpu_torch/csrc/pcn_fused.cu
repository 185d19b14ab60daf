// K2: the whole pCN sampler in one launch (proposal, reduced PCG solve, MLP
// correction, Metropolis accept, burn-in adaptation), for C chains and T steps.
//
// Off the main path: K2r (csrc/pcn_fused_r.cu) computes the same function
// for `run_pcn_fused`, with A(k) assembled once per proposal and held in
// registers. K2 stays built as the record K2r is timed against, reachable
// only through the launcher `_launch(..., kernel="K2")` of
// experimental/pcn_fused.py.
//
// Replaces the TPU Pallas kernel `_kernel` of
// bayesianinferencedl_tpu/experimental/pcn_fused.py (launched by
// `run_pcn_fused`). Same step, same operand packing (see the Python wrapper in
// experimental/pcn_fused.py), with Philox4x32-10 in place of the TPU's
// hardware generator: counter (chain, step, draw, 0), key = seed, each word
// mapped to (bits >> 8) 2^-24 + 2^-25 in float32 as the reference maps its bits.
//
// What bounds it on an H100: arithmetic. The least work per chain and step is
// one assembly A(k) = Bi M + sum_j k_j A_j (2 d r^2 FLOP), cg_iters + 1 products
// A(k) p and as many by P0 (2 r^2 each), plus ~2 (d h + h h + 5 h) for the MLP:
// at r = 40, h = 64, d = 5, cg_iters = 20 that is ~0.17 MFLOP, ~0.17 GFLOP per
// step for 1,024 chains, ~2.6 us at the card's 67 TFLOP/s in float32. This
// version keeps the reference's formulation, the stacked product of 2 r (6r)
// FLOP per application, which is ~3x that work. The chain state is 32 bytes
// and one (C, 8) row leaves per step. The design: one launch for the whole run
// (the step loop runs in the kernel, so there are no per-step launches and no
// host round trips); blocks own
// disjoint groups of chains, one warp per chain, and nothing carries between
// blocks; astack, P0 (transposed), Bhat^T and the MLP are staged once per block
// into shared memory (dynamic, opted in above 48 KB) and read by consecutive
// lanes; the chain's r-vectors live in registers, two entries per lane, with one
// r-vector of shared memory per warp to broadcast the operand of each product.
// Every product is float32 FMAs on the CUDA cores, no TF32 and no bf16: the
// reference runs at Precision.HIGHEST. Each warp re-reads astack from shared
// memory at every operator product, so shared-memory bandwidth, not the FMA
// rate, is the first limit of this version (PERF.md); K2r is the redesign.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // chains per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;  // state row [theta(5) | phi | log beta | accept]
constexpr int kMaxVec = 64;  // r and hidden widths: two entries per lane
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into
constexpr float kTargetAccept = 0.234f;
constexpr float kLogBetaLo = -9.210340371976182f;  // log(1e-4)
constexpr float kLogBetaHi = -1.0000500033334732e-4f;  // log(0.9999)
constexpr float kTwoPi = 6.283185307179586f;

// Float offsets of the shared-memory operands, then the per-warp buffers.
struct Layout {
  int astack, p0t, fhat, bhatT, w1, b1, w2, b2, w3, b3, xnorm, data, warps, per_warp, total;
};

__host__ __device__ inline Layout layout(int r, int h1, int h2) {
  Layout L;
  int o = 0;
  L.astack = o; o += 6 * r * r;
  L.p0t = o; o += r * r;
  L.fhat = o; o += r;
  L.bhatT = o; o += r * kCols;
  L.w1 = o; o += kCols * h1;
  L.b1 = o; o += h1;
  L.w2 = o; o += h1 * h2;
  L.b2 = o; o += h2;
  L.w3 = o; o += h2 * kCols;
  L.b3 = o; o += kCols;
  L.xnorm = o; o += 2 * kCols;
  L.data = o; o += kCols;
  L.warps = o;
  L.per_warp = r + h1 + h2 + 2 * kCols;  // vector, hidden 1, hidden 2, 16 uniforms
  L.total = o + kWarps * L.per_warp;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the bitwise-same sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * 0x1p-24f + 0x1p-25f;
}

// The operands of one block, in shared memory, and this warp's buffers.
struct Ctx {
  const float* s;  // shared operands (Layout offsets)
  float* vec;      // (r,) broadcast buffer of this warp
  float* hid1;     // (h1,)
  float* hid2;     // (h2,)
  float* u;        // (16,) this step's uniforms [u1 | u2]
  Layout L;
  int r, h1, h2, lane;
};

// Write this lane's two entries of an r-vector to the warp's buffer.
__device__ __forceinline__ void put_vec(const Ctx& c, const float (&v)[2]) {
  __syncwarp();  // every lane is done reading the previous contents
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = c.lane + 32 * s;
    if (i < c.r) c.vec[i] = v[s];
  }
  __syncwarp();
}

// out_i = sum_j k_j (v @ A_j)_i for v in the vec buffer (the stacked product).
__device__ __forceinline__ void amat(const Ctx& c, const float (&k)[6], float (&out)[2]) {
  const int r = c.r;
  const float* A = c.s + c.L.astack;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = c.lane + 32 * s;
    out[s] = 0.f;
    if (i >= r) continue;
    float comp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int m = 0; m < r; ++m) {
      const float vm = c.vec[m];
      const float* row = A + (size_t)m * 6 * r + i;
#pragma unroll
      for (int j = 0; j < 6; ++j) comp[j] = fmaf(vm, row[j * r], comp[j]);
    }
    float acc = k[0] * comp[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = acc + k[j] * comp[j];
    out[s] = acc;
  }
}

// out = v @ P0^T for v in the vec buffer (P0 is staged transposed).
__device__ __forceinline__ void prec(const Ctx& c, const float* v, float (&out)[2]) {
  const int r = c.r;
  const float* P = c.s + c.L.p0t;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = c.lane + 32 * s;
    float acc = 0.f;
    if (i < r)
      for (int m = 0; m < r; ++m) acc = fmaf(v[m], P[(size_t)m * r + i], acc);
    out[s] = acc;
  }
}

__device__ __forceinline__ float dot2(const float (&a)[2], const float (&b)[2]) {
  return warp_sum(a[0] * b[0] + a[1] * b[1]);  // entries past r are 0
}

// phi(theta) for theta (8,) with columns >= d zero: the reduced PCG solve, the
// observables, the MLP correction and the misfit. Warp-uniform result.
__device__ float misfit(const Ctx& c, const float (&theta)[kCols], int d, int cg_iters,
                        float inv2n2) {
  const Layout& L = c.L;
  const int lane = c.lane;
  float k[6];
#pragma unroll
  for (int j = 0; j < 5; ++j) k[j] = j < d ? expf(theta[j]) : 0.f;
  k[5] = 1.f;

  // b = fhat; x = P0 b; res = b - A x; z = P0 res; p = z
  float x[2], res[2], z[2], p[2], Ap[2];
  prec(c, c.s + L.fhat, x);
  put_vec(c, x);
  amat(c, k, Ap);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = lane + 32 * s;
    res[s] = i < c.r ? c.s[L.fhat + i] - Ap[s] : 0.f;
  }
  put_vec(c, res);
  prec(c, c.vec, z);
  p[0] = z[0];
  p[1] = z[1];
  float rz = dot2(res, z);
  for (int it = 0; it < cg_iters; ++it) {
    put_vec(c, p);
    amat(c, k, Ap);
    const float pAp = dot2(p, Ap);
    const float alpha = rz / (pAp != 0.f ? pAp : 1.f);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      x[s] = x[s] + alpha * p[s];
      res[s] = res[s] - alpha * Ap[s];
    }
    put_vec(c, res);
    prec(c, c.vec, z);
    const float rz_new = dot2(res, z);
    const float beta = rz_new / (rz != 0.f ? rz : 1.f);
#pragma unroll
    for (int s = 0; s < 2; ++s) p[s] = z[s] + beta * p[s];
    rz = rz_new;
  }

  // MLP: xs = (theta - x_mean) / x_std; h1 = tanh(xs W1 + b1); h2 = tanh(h1 W2 + b2)
  float xs[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) xs[q] = (theta[q] - c.s[L.xnorm + q]) * c.s[L.xnorm + kCols + q];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    if (j < c.h1) {
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) a = fmaf(xs[q], c.s[L.w1 + q * c.h1 + j], a);
      c.hid1[j] = tanhf(a + c.s[L.b1 + j]);
    }
  }
  put_vec(c, x);  // its barriers also publish hid1
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    if (j < c.h2) {
      float a = 0.f;
      for (int q = 0; q < c.h1; ++q) a = fmaf(c.hid1[q], c.s[L.w2 + q * c.h2 + j], a);
      c.hid2[j] = tanhf(a + c.s[L.b2 + j]);
    }
  }
  __syncwarp();
  // lane o < 8: observable o of y_rom = x Bhat^T and of e = h2 W3 + b3
  float sq = 0.f;
  if (lane < kCols) {
    float y = 0.f;
    for (int i = 0; i < c.r; ++i) y = fmaf(c.vec[i], c.s[L.bhatT + i * kCols + lane], y);
    float e = 0.f;
    for (int j = 0; j < c.h2; ++j) e = fmaf(c.hid2[j], c.s[L.w3 + j * kCols + lane], e);
    e = e + c.s[L.b3 + lane];
    const float rr = y + e - c.s[L.data + lane];
    sq = rr * rr;  // padded observables are exact zeros
  }
  return warp_sum(sq) * inv2n2;
}

__global__ void __launch_bounds__(kThreads)
pcn_fused_kernel(const float* __restrict__ theta0,  // (C, 8)
                 const float* __restrict__ astack,  // (r, 6r)
                 const float* __restrict__ P0,      // (r, r)
                 const float* __restrict__ fhat,    // (r,)
                 const float* __restrict__ bhatT,   // (r, 8)
                 const float* __restrict__ w1, const float* __restrict__ b1,  // (8, h1), (h1,)
                 const float* __restrict__ w2, const float* __restrict__ b2,  // (h1, h2), (h2,)
                 const float* __restrict__ w3, const float* __restrict__ b3,  // (h2, 8), (8,)
                 const float* __restrict__ xnorm,  // (2, 8)
                 const float* __restrict__ data,   // (8,)
                 const float* __restrict__ u1_in, const float* __restrict__ u2_in,  // (T, C, 8) or null
                 float* __restrict__ u1_out, float* __restrict__ u2_out,  // (T, C, 8) or null
                 float* __restrict__ out,  // (T, C, 8)
                 int C, int r, int h1, int h2, int d, int T, int n_burn, int cg_iters,
                 float prior_mean, float prior_sigma, float inv2n2, float beta0,
                 uint32_t key0, uint32_t key1) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(r, h1, h2);
  const int tid = threadIdx.x;

  // stage the operands (P0 transposed, so that lanes read consecutive words)
  auto stage = [&](int off, const float* src, int count) {
    for (int q = tid; q < count; q += kThreads) smem[off + q] = src[q];
  };
  stage(L.astack, astack, 6 * r * r);
  for (int q = tid; q < r * r; q += kThreads) smem[L.p0t + (q % r) * r + q / r] = P0[q];
  stage(L.fhat, fhat, r);
  stage(L.bhatT, bhatT, r * kCols);
  stage(L.w1, w1, kCols * h1);
  stage(L.b1, b1, h1);
  stage(L.w2, w2, h1 * h2);
  stage(L.b2, b2, h2);
  stage(L.w3, w3, h2 * kCols);
  stage(L.b3, b3, kCols);
  stage(L.xnorm, xnorm, 2 * kCols);
  stage(L.data, data, kCols);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chain = blockIdx.x * kWarps + warp;
  if (chain >= C) return;  // no block-wide barrier follows
  float* wbuf = smem + L.warps + warp * L.per_warp;
  const Ctx ctx{smem, wbuf, wbuf + r, wbuf + r + h1, wbuf + r + h1 + h2, L, r, h1, h2, lane};

  float theta[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) theta[q] = q < d ? theta0[(size_t)chain * kCols + q] : 0.f;
  float phi = misfit(ctx, theta, d, cg_iters, inv2n2);
  float lbeta = logf(beta0);

  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)t * C + chain) * kCols;
    // this step's 16 uniforms [u1 | u2] into the warp's buffer
    __syncwarp();
    if (u1_in != nullptr) {
      if (lane < 2 * kCols) ctx.u[lane] = (lane < kCols ? u1_in : u2_in)[row + (lane & 7)];
    } else if (lane < 4) {
      const uint4 w = philox4x32_10(make_uint4((uint32_t)chain, (uint32_t)t, (uint32_t)lane, 0u),
                                    key0, key1);
      ctx.u[4 * lane + 0] = uniform24(w.x);
      ctx.u[4 * lane + 1] = uniform24(w.y);
      ctx.u[4 * lane + 2] = uniform24(w.z);
      ctx.u[4 * lane + 3] = uniform24(w.w);
    }
    __syncwarp();
    if (u1_out != nullptr && lane < 2 * kCols)
      (lane < kCols ? u1_out : u2_out)[row + (lane & 7)] = ctx.u[lane];

    // proposal: prior_mean + contract (theta - prior_mean) + beta sigma xi
    const float beta = expf(lbeta);
    const float contract = sqrtf(fmaxf(1.f - beta * beta, 0.f));
    const float bs = beta * prior_sigma;
    float prop[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const float xi = sqrtf(-2.f * logf(ctx.u[q])) * cosf(kTwoPi * ctx.u[kCols + q]);
      prop[q] = q < d ? prior_mean + contract * (theta[q] - prior_mean) + bs * xi : 0.f;
    }
    const float phi_prop = misfit(ctx, prop, d, cg_iters, inv2n2);
    const bool accept = logf(ctx.u[kCols + 7]) < phi - phi_prop;
    if (accept) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) theta[q] = prop[q];
      phi = phi_prop;
    }
    const float acc = accept ? 1.f : 0.f;
    if (t < n_burn) {
      const float decay = expf(-0.6f * logf(1.f + (float)t));
      lbeta = lbeta + 0.5f * decay * (acc - kTargetAccept);
    }
    lbeta = fminf(fmaxf(lbeta, kLogBetaLo), kLogBetaHi);

    if (lane < kCols) {
      float v = theta[0];
#pragma unroll
      for (int q = 1; q < kCols; ++q)
        if (lane == q) v = q < 5 ? theta[q] : (q == 5 ? phi : (q == 6 ? lbeta : acc));
      out[row + lane] = v;
    }
  }
}

}  // namespace

extern "C" {

cudaError_t pcn_fused_launch(const float* theta0, const float* astack, const float* P0,
                             const float* fhat, const float* bhatT, const float* w1,
                             const float* b1, const float* w2, const float* b2, const float* w3,
                             const float* b3, const float* xnorm, const float* data,
                             const float* u1_in, const float* u2_in, float* u1_out,
                             float* u2_out, float* out, int C, int r, int h1, int h2, int d, int T,
                             int n_burn, int cg_iters, float prior_mean, float prior_sigma,
                             float inv2n2, float beta0, unsigned long long seed,
                             cudaStream_t stream) {
  if (C <= 0 || T <= 0) return cudaSuccess;
  if (r < 1 || r > kMaxVec || h1 < 1 || h1 > kMaxVec || h2 < 1 || h2 > kMaxVec || d < 1 ||
      d > 5 || n_burn < 0 || n_burn > T || cg_iters < 0)
    return cudaErrorInvalidValue;
  if ((u1_in == nullptr) != (u2_in == nullptr) || (u1_out == nullptr) != (u2_out == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)layout(r, h1, h2).total * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pcn_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (C + kWarps - 1) / kWarps;
  pcn_fused_kernel<<<blocks, kThreads, smem, stream>>>(
      theta0, astack, P0, fhat, bhatT, w1, b1, w2, b2, w3, b3, xnorm, data, u1_in, u2_in, u1_out,
      u2_out, out, C, r, h1, h2, d, T, n_burn, cg_iters, prior_mean, prior_sigma, inv2n2, beta0,
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

}  // extern "C"
