// K3: batched, two-level-deflated Jacobi-PCG on the fin's 7-diagonal stencil,
// a tile of kS samples per thread block.
//
// Replaces the TPU Pallas kernel `_pcg_kernel_sublanes` + `_jacobi_cg`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py:385 and :169, launched by
// `pcg_stencil_batch_sublanes`, :448), the layout the reference takes for
// meshes too large for its lanes kernel (res >= 8). The math is K1's
// (csrc/pcg_stencil.cu):
//
//   stencil   acc_i = v0_i p_i + sum_{o in {o1,o2,o3}} (v_o,i p_{i+o} + v_o,{i-o} p_{i-o})
//             from the 4 upper planes (A is symmetric). The TPU kernel rolls
//             with wrap-around; here reads outside [0, n) are masked to zero.
//   precond   z = D^-1 r  (+ Wt^T bf16(Binv_b (Wt bf16(r))) when deflated),
//             Wt stored bf16, f32 accumulation, inv_diag = 0 where diag == 0.
//   stopping  ||r||^2 <= tol^2 ||F||^2, checked PER SAMPLE every
//             `check_every` iterations, under the plain `maxiter` cap. A
//             sample that has stopped is frozen (x, r, p untouched) while the
//             rest of its tile iterates; its count is its own. The tile stops
//             when all its samples have stopped or at the cap. x0 may be null
//             (the reference's cold-start variant): x starts at 0, r at F.
//
// What carries over from the sublanes layout is that the kS samples of a tile
// share one pass over the deflation basis: every 16-byte word of Wt (8 bf16)
// is loaded once per tile and applied to all kS samples, in y = Wt bf16(r)
// and in z += Wt^T c. K1 streams the basis twice per sample and iteration
// (2 m n bf16 = 12.8 MB at res8, m = 128); here that traffic falls by kS.
// bf16(r) is rounded on the fly from the f32 residual (__float2bfloat16, the
// plain version's round-to-nearest-even): kS x 2n bytes does not fit a
// block's shared memory at res8. The kS samples' dot products are reduced
// together, one pass per reduction.
//
// What bounds it on an H100: per iteration and tile the stencil state (4
// planes + r, p, Ap, z, x: ~40 bytes per node and sample) streams from HBM,
// 1 GB per iteration at B = 1,024 and res8, beyond the 50 MB L2; the two
// deflation products (m n FMA each per sample) run on the CUDA cores,
// 51 M FMA per tile and iteration at res8; and one tile is one block on one SM, so
// a batch of B samples uses B / 8 SMs. The design: the whole CG loop stays
// in the kernel; every streaming pass issues the loads of 4 items (nodes or
// 4-node vectors) before any store and reads with indices clamped into
// range instead of branches, so that loads are in flight together (the
// scratch rows may alias as far as the compiler knows); the y pass loads
// the next word while it applies the current one, and the z pass keeps two
// groups of 4 coarse rows' words in flight; each pass is its own function,
// so that each gets the registers it needs (384 threads, at most 170
// registers each). Tensor cores (wgmma on the Wt products), TMA, and
// clusters to spread a tile over several SMs are later work. kS = 8, the
// reference's sublane granule: the z pass keeps kS x 8 float accumulators
// per thread, which at kS = 16 would take 128 of its 170 registers.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch
// function returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kS = 8;  // samples per block (one tile)
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 128;        // coarse-space size the kernel is built for
constexpr int kRows = kMaxM / 32;  // coarse rows per lane in y = Wt bf16(r)
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

__host__ __device__ constexpr int align4(int v) { return (v + 3) & ~3; }

// Float offsets into dynamic shared memory (each 16-byte aligned).
struct Layout {
  int red;    // (kWarps + 1) x kS reduction slots
  int rz;     // kS  r.z of the current iteration, per sample
  int its;    // kS  iteration counts (int), per sample
  int y;      // [s][j]   coarse residuals Wt bf16(r_s)
  int c;      // [j][s]   bf16(Binv_s y_s), read as two float4 per j
  int stage;  // [warp][e][s] each warp's 8 staged residual values per sample
  int ypart;  // [warp][s][j] per-warp partial sums of y
  int total;
};

__host__ __device__ inline Layout layout(int m) {
  Layout L;
  L.red = 0;
  L.rz = align4((kWarps + 1) * kS);
  L.its = L.rz + align4(kS);
  L.y = L.its + align4(kS);
  L.c = L.y + align4(kS * m);
  L.stage = L.c + align4(m * kS);
  L.ypart = L.stage + (m > 0 ? kWarps * 8 * kS : 0);
  L.total = L.ypart + kWarps * kS * m;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-sample block sums: v[s] summed over the block, returned to every
// thread, all kS in one pass. The leading barrier also makes every
// global/shared write issued before the call visible to the block.
__device__ __forceinline__ void block_sum_s(float (&v)[kS], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kS; ++s) v[s] = warp_sum(v[s]);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) red[warp * kS + s] = v[s];
  }
  __syncthreads();
  if (threadIdx.x < kS) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * kS + threadIdx.x];
    red[kWarps * kS + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kS; ++s) v[s] = red[kWarps * kS + s];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Value e (0..7, a compile-time constant after unrolling) of the 8 bf16 in
// a 16-byte word, as a float: bf16 is the upper half of a float's bits, and
// value 0 sits in the low half of the first 32-bit lane.
__device__ __forceinline__ float bf16_at(const uint4& u, int e) {
  const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ bool on(unsigned act, int s) { return (act >> s) & 1u; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Items (nodes, or 4-node vectors) each thread keeps in flight in the
// streaming passes: every pass loads all of them before it stores any, so
// the loads of one item do not wait on the stores of the last (the scratch
// rows may alias as far as the compiler knows).
constexpr int kU = 4;

// One tile's operands and state. Sample s of the tile is sample b0 + s of
// the batch; its scratch rows are r, p, Ap, z.
struct Tile {
  const float* __restrict__ vals4;       // (B, 4, n)
  const __nv_bfloat16* __restrict__ Wt;  // (m, n) or null
  const float* __restrict__ Binv;        // (B, m, m) or null
  float* x;                              // (B, n)
  float* scratch;                        // (B, 4, n)
  int b0, n, m, o1, o2, o3;

  __device__ const float* v(int s) const { return vals4 + (size_t)(b0 + s) * 4 * n; }
  __device__ float* r(int s) const { return scratch + (size_t)(b0 + s) * 4 * n; }
  __device__ float* p(int s) const { return r(s) + n; }
  __device__ float* Ap(int s) const { return r(s) + 2 * (size_t)n; }
  __device__ float* z(int s) const { return r(s) + 3 * (size_t)n; }
  __device__ float* xs(int s) const { return x + (size_t)(b0 + s) * n; }

  // Row i (0 <= i < n) of the symmetric 4-plane stencil of sample s
  // applied to q. Term order follows the plain version. Every load is
  // unconditional, at an index clamped into [0, n), and the terms that fall
  // outside are dropped afterwards, so that no load waits on a branch.
  __device__ float stencil_row(int s, const float* q, int i) const {
    const float* w = v(s);
    float acc = __ldg(w + i) * q[i];
    const int offs[3] = {o1, o2, o3};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int o = offs[j];
      const float* wo = w + (size_t)(j + 1) * n;
      const int ip = min(i + o, n - 1), im = max(i - o, 0);
      const float up = __ldg(wo + i) * q[ip];
      const float dn = __ldg(wo + im) * q[im];
      acc = i + o < n ? acc + up : acc;
      acc = i - o >= 0 ? acc + dn : acc;
    }
    return acc;
  }
};

// Ap_s = A_s p_s for the active samples; returns p_s . Ap_s in pAp[s].
// The passes are separate functions so that each gets its own registers.
__device__ __noinline__ void stencil_pass(const Tile& T, unsigned act, float (&pAp)[kS]) {
  const int n = T.n;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    pAp[s] = 0.f;
    if (!on(act, s)) continue;
    const float* p = T.p(s);
    float* Ap = T.Ap(s);
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kThreads) {
      float a[kU], pi[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = min(i0 + u * kThreads, n - 1);
        a[u] = T.stencil_row(s, p, i);
        pi[u] = p[i];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          Ap[i] = a[u];
          pAp[s] += pi[u] * a[u];
        }
      }
    }
  }
}

// x_s += alpha_s p_s and r_s -= alpha_s Ap_s for the active samples, in
// 4-node vectors.
__device__ __noinline__ void update_pass(const Tile& T, unsigned act, const float (&alpha)[kS]) {
  const int n4 = T.n / 4;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (!on(act, s)) continue;
    float* x = T.xs(s);
    float* r = T.r(s);
    const float* p = T.p(s);
    const float* Ap = T.Ap(s);
    const float al = alpha[s];
    for (int k0 = threadIdx.x; k0 < n4; k0 += kU * kThreads) {
      float4 xv[kU], rv[kU], pv[kU], av[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = min(k0 + u * kThreads, n4 - 1);
        xv[u] = ld4(x + 4 * k);
        rv[u] = ld4(r + 4 * k);
        pv[u] = ld4(p + 4 * k);
        av[u] = ld4(Ap + 4 * k);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n4) {
          st4(x + 4 * k, make_float4(xv[u].x + al * pv[u].x, xv[u].y + al * pv[u].y,
                                     xv[u].z + al * pv[u].z, xv[u].w + al * pv[u].w));
          st4(r + 4 * k, make_float4(rv[u].x - al * av[u].x, rv[u].y - al * av[u].y,
                                     rv[u].z - al * av[u].z, rv[u].w - al * av[u].w));
        }
      }
    }
  }
}

// p_s = z_s + beta_s p_s for the active samples, in 4-node vectors.
__device__ __noinline__ void direction_pass(const Tile& T, unsigned act, const float (&beta)[kS]) {
  const int n4 = T.n / 4;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (!on(act, s)) continue;
    float* p = T.p(s);
    const float* z = T.z(s);
    const float be = beta[s];
    for (int k0 = threadIdx.x; k0 < n4; k0 += kU * kThreads) {
      float4 zv[kU], pv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = min(k0 + u * kThreads, n4 - 1);
        zv[u] = ld4(z + 4 * k);
        pv[u] = ld4(p + 4 * k);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n4)
          st4(p + 4 * k, make_float4(zv[u].x + be * pv[u].x, zv[u].y + be * pv[u].y,
                                     zv[u].z + be * pv[u].z, zv[u].w + be * pv[u].w));
      }
    }
  }
}

// rr[s] = r_s . r_s for the active samples (0 for the others).
__device__ __noinline__ void rr_pass(const Tile& T, unsigned act, float (&rr)[kS]) {
  const int n4 = T.n / 4;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    rr[s] = 0.f;
    if (!on(act, s)) continue;
    const float* r = T.r(s);
#pragma unroll 4
    for (int k = threadIdx.x; k < n4; k += kThreads) {
      const float4 v = ld4(r + 4 * k);
      rr[s] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  }
}

// (1) y_s = Wt bf16(r_s) for all samples of the tile at once, into ys
// ([s][j]). Warp w takes a contiguous run of 16-byte words; lane l the
// coarse rows l + 32 t. For each word the warp stages bf16(r) of the kS
// samples ([node][sample]) and every lane applies its Wt words to all of
// them; the next word's residuals and Wt words are loaded while the current
// one is applied. Inactive samples stage zeros.
__device__ __noinline__ void y_pass(const Tile& T, unsigned act, float* smem, const Layout& L) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = T.n, m = T.m, n8 = n / 8;
  float* ys = smem + L.y;
  float* st = smem + L.stage + warp * 8 * kS;
  float* yp = smem + L.ypart;
  float acc[kRows][kS];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[t][s] = 0.f;
  const int q0 = (int)((long long)n8 * warp / kWarps);
  const int q1 = (int)((long long)n8 * (warp + 1) / kWarps);
  const int ss = lane >> 1, hh = lane & 1;  // the residual quarter-word lane < 16 stages
  const bool stager = lane < 2 * kS && on(act, ss & (kS - 1));
  const float* rrow = T.r(ss & (kS - 1)) + 4 * hh;
  auto load_r = [&](int q) {
    return stager ? ld4(rrow + 8 * (size_t)q) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto load_w = [&](int q, uint4 (&w)[kRows]) {  // rows past m load row m - 1, then read as 0
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int j = lane + 32 * t;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(T.Wt + (size_t)min(j, m - 1) * n) + q);
      w[t] = j < m ? u : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
  uint4 w[kRows];
  if (q0 < q1) {
    r4 = load_r(q0);
    load_w(q0, w);
  }
  for (int q = q0; q < q1; ++q) {
    __syncwarp();
    if (lane < 2 * kS) {
      st[(4 * hh + 0) * kS + ss] = bf16_round(r4.x);
      st[(4 * hh + 1) * kS + ss] = bf16_round(r4.y);
      st[(4 * hh + 2) * kS + ss] = bf16_round(r4.z);
      st[(4 * hh + 3) * kS + ss] = bf16_round(r4.w);
    }
    __syncwarp();
    uint4 wn[kRows];
    const int qn = min(q + 1, q1 - 1);
    r4 = load_r(qn);
    load_w(qn, wn);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 ra = ld4(st + e * kS);
      const float4 rb = ld4(st + e * kS + 4);
      const float rs[kS] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const float wf = bf16_at(w[t], e);
#pragma unroll
        for (int s = 0; s < kS; ++s) acc[t][s] += wf * rs[s];
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) w[t] = wn[t];
  }
  // per-warp partials to shared memory, then a fixed-order sum over warps
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int j = lane + 32 * t;
    if (j < m) {
#pragma unroll
      for (int s = 0; s < kS; ++s) yp[(warp * kS + s) * m + j] = acc[t][s];
    }
  }
  __syncthreads();
  for (int k = tid; k < kS * m; k += kThreads) {  // k = s * m + j
    float t = 0.f;
    for (int w2 = 0; w2 < kWarps; ++w2) t += yp[w2 * kS * m + k];
    ys[k] = t;
  }
}

// (2) c_s = bf16(Binv_s y_s) into cs ([j][s]): one warp per (sample, coarse
// row), four rows' loads in flight at a time.
__device__ __noinline__ void c_pass(const Tile& T, unsigned act, float* smem, const Layout& L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = T.m;
  const float* ys = smem + L.y;
  float* cw = smem + L.c;
  for (int row0 = warp; row0 < kS * m; row0 += 4 * kWarps) {
    float bv[4][kMaxM / 32];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = row0 + u * kWarps;
      const int s = row / m, j = row - s * m;
      const bool use = row < kS * m && on(act, s);
      const float* Bi = T.Binv + ((size_t)(T.b0 + s) * m + j) * m;
#pragma unroll
      for (int t = 0; t < kMaxM / 32; ++t) {
        const int k = lane + 32 * t;
        bv[u][t] = use && k < m ? __ldg(Bi + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = row0 + u * kWarps;
      if (row >= kS * m) break;
      const int s = row / m, j = row - s * m;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxM / 32; ++t) {
        const int k = lane + 32 * t;
        if (k < m) sum += bv[u][t] * ys[s * m + k];
      }
      sum = warp_sum(sum);
      if (lane == 0) cw[j * kS + s] = bf16_round(sum);
    }
  }
}

// (3) z_s = D_s^-1 r_s (+ Wt^T c_s when deflated) for the active samples;
// returns this thread's part of r_s . z_s. One thread per 16-byte word; each
// Wt word is loaded once and applied to all kS samples; two groups of four
// coarse rows' words are in flight, one loading while the other is applied.
__device__ __noinline__ void z_pass(const Tile& T, unsigned act, const float* smem, const Layout& L,
                                    float (&part)[kS]) {
  const int n = T.n, m = T.m, n8 = n / 8;
  const float* cs = smem + L.c;
#pragma unroll
  for (int s = 0; s < kS; ++s) part[s] = 0.f;
  for (int q = threadIdx.x; q < n8; q += kThreads) {
    float acc[kS][8];
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[s][e] = 0.f;
    const uint4* w8 = reinterpret_cast<const uint4*>(T.Wt) + q;
    const size_t row = (size_t)n / 8;  // one Wt row, in 16-byte words
    auto load = [&](int j0, uint4 (&w)[4]) {  // rows past m load row m - 1 and are not used
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = __ldg(w8 + (size_t)min(j0 + u, m - 1) * row);
    };
    uint4 w[4], wn[4];
    if (m > 0) load(0, w);
    for (int j0 = 0; j0 < m; j0 += 4) {
      load(min(j0 + 4, m - 1), wn);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u >= m) break;
        const float4 ca = ld4(cs + (j0 + u) * kS);
        const float4 cb = ld4(cs + (j0 + u) * kS + 4);
        const float cj[kS] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float wf = bf16_at(w[u], e);
#pragma unroll
          for (int s = 0; s < kS; ++s) acc[s][e] += wf * cj[s];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = wn[u];
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      if (!on(act, s)) continue;
      const float* d = T.v(s) + 8 * (size_t)q;
      const float* r = T.r(s) + 8 * (size_t)q;
      float* z = T.z(s) + 8 * (size_t)q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 dq = __ldg(reinterpret_cast<const float4*>(d) + hh);
        const float4 rq = ld4(r + 4 * hh);
        const float dv[4] = {dq.x, dq.y, dq.z, dq.w};
        const float rv[4] = {rq.x, rq.y, rq.z, rq.w};
        float zv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          zv[e] = (dv[e] != 0.f ? 1.f / dv[e] : 0.f) * rv[e] + acc[s][4 * hh + e];
          part[s] += rv[e] * zv[e];
        }
        st4(z + 4 * hh, make_float4(zv[0], zv[1], zv[2], zv[3]));
      }
    }
  }
}

// z_s = M^-1 r_s for the tile's active samples; rz[s] = r_s . z_s (0 for the
// others, whose z is left as it was). n % 8 == 0.
__device__ void precond_rz(const Tile& T, unsigned act, float (&rz)[kS], float* smem,
                           const Layout& L) {
  __syncthreads();  // r was written by other threads
  if (T.m > 0) {
    y_pass(T, act, smem, L);
    __syncthreads();
    c_pass(T, act, smem, L);
    __syncthreads();
  }
  z_pass(T, act, smem, L, rz);
  block_sum_s(rz, smem + L.red);
}

__global__ void __launch_bounds__(kThreads, 1)
pcg_stencil_tile_kernel(const float* __restrict__ vals4,       // (B, 4, n)
                        const float* __restrict__ F,           // (n,)
                        const float* __restrict__ x0,          // (B, n) or null
                        const __nv_bfloat16* __restrict__ Wt,  // (m, n) or null
                        const float* __restrict__ Binv,        // (B, m, m) or null
                        float* __restrict__ x_out,             // (B, n)
                        int* __restrict__ iters,               // (B,)
                        float* __restrict__ scratch,           // (B, 4, n): r, p, Ap, z
                        int B, int n, int m, int o1, int o2, int o3,
                        float tol2_scale, int maxiter, int check_every) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(m);
  float* red = smem + L.red;
  float* rz_s = smem + L.rz;  // rz lives in shared memory across the preconditioner
  int* its = reinterpret_cast<int*>(smem + L.its);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kS;
  const int nS = min(kS, B - b0);  // the last tile may be short: its missing samples stay inactive
  const Tile T{vals4, Wt, Binv, x_out, scratch, b0, n, m, o1, o2, o3};
  unsigned act = (1u << nS) - 1u;

  float ff[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) ff[s] = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float f = F[i];
    ff[0] += f * f;
  }
  block_sum_s(ff, red);
  const float tol2 = tol2_scale * ff[0];

  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (on(act, s)) T.xs(s)[i] = x0 != nullptr ? x0[(size_t)(b0 + s) * n + i] : 0.f;
  }
  if (x0 != nullptr) {
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (on(act, s)) T.r(s)[i] = F[i] - T.stencil_row(s, T.xs(s), i);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (on(act, s)) T.r(s)[i] = F[i];
    }
  }
  {
    float rz[kS];
    precond_rz(T, act, rz, smem, L);
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (tid == s) {
        rz_s[s] = rz[s];
        its[s] = 0;
      }
  }
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (on(act, s)) T.p(s)[i] = T.z(s)[i];
  }

  int done = 0;
  for (;;) {
    float rr[kS];
    rr_pass(T, act, rr);
    block_sum_s(rr, red);
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (on(act, s) && !(rr[s] > tol2)) act &= ~(1u << s);
    if (done >= maxiter || act == 0u) break;
    const int inner = min(check_every, maxiter - done);
    for (int k = 0; k < inner; ++k) {
      float pAp[kS];
      stencil_pass(T, act, pAp);
      block_sum_s(pAp, red);
      float alpha[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) alpha[s] = pAp[s] > 0.f ? rz_s[s] / pAp[s] : 0.f;
      update_pass(T, act, alpha);
      float beta[kS];
      precond_rz(T, act, beta, smem, L);  // beta holds rz_new until it is turned into beta
      float rz_new[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        rz_new[s] = beta[s];
        beta[s] = rz_s[s] > 0.f ? rz_new[s] / rz_s[s] : 0.f;
      }
      direction_pass(T, act, beta);
      __syncthreads();  // p is read at neighbouring nodes by the next stencil pass; rz_s below
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (tid == s && on(act, s)) rz_s[s] = rz_new[s];
    }
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (on(act, s)) its[s] += inner;
    }
    done += inner;
  }
  // the counts were last written before the final rr sum's barriers
  if (tid < nS) iters[b0 + tid] = its[tid];
}

}  // namespace

extern "C" {

cudaError_t pcg_stencil_tile_launch(const float* vals4, const float* F, const float* x0,
                                    const void* Wt, const float* Binv, float* x, int* iters,
                                    float* scratch, int B, int n, int m, int o1, int o2, int o3,
                                    float tol2_scale, int maxiter, int check_every,
                                    cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (n <= 0 || n % 8 != 0 || m < 0 || check_every < 1 || maxiter < 0) return cudaErrorInvalidValue;
  if ((Wt == nullptr) != (Binv == nullptr)) return cudaErrorInvalidValue;
  const int m_eff = Wt != nullptr ? m : 0;
  if (m_eff > kMaxM) return cudaErrorInvalidValue;
  const size_t smem = (size_t)layout(m_eff).total * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pcg_stencil_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (B + kS - 1) / kS;
  pcg_stencil_tile_kernel<<<grid, kThreads, smem, stream>>>(
      vals4, F, x0, static_cast<const __nv_bfloat16*>(Wt), Binv, x, iters, scratch, B, n, m_eff,
      o1, o2, o3, tol2_scale, maxiter, check_every);
  return cudaGetLastError();
}

}  // extern "C"
