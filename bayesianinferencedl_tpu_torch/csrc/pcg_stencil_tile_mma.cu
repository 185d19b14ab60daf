// K3r: batched, two-level-deflated Jacobi-PCG on the fin's 7-diagonal stencil,
// a tile of kS = 8 samples per thread-block cluster, the deflation products
// on the tensor cores.
//
// Replaces the TPU Pallas kernel `_pcg_kernel_sublanes` + `_jacobi_cg`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py:385 and :169, launched by
// `pcg_stencil_batch_sublanes`, :448), as K3 (csrc/pcg_stencil_tile.cu) did,
// with K3's C contract (one more argument, the cluster size, and one more
// scratch row per sample):
//
//   stencil   acc_i = v0_i p_i + sum_{o in {o1,o2,o3}} (v_o,i p_{i+o} + v_o,{i-o} p_{i-o})
//             from the 4 upper planes; reads outside [0, n) count as zero.
//   precond   z = D^-1 r  (+ Wt^T bf16(Binv_b (Wt bf16(r))) when deflated),
//             Wt stored bf16, f32 accumulation, D^-1 = 0 where diag == 0.
//   guards    alpha, beta = 0 where their denominators are not positive.
//   stopping  ||r||^2 <= tol^2 ||F||^2, checked per sample every
//             `check_every` iterations under the plain `maxiter` cap; a
//             stopped sample is frozen. x0 may be null (x starts at 0).
//
// What bounds it on an H100. A batch's state (4 planes and x, r, z, Ap, p:
// ~9 n floats a sample, 920 MB at res8 and B = 1,024) is far beyond the
// 50 MB L2 and 132 x 227 KB of shared memory, so every iteration streams it
// from HBM: the bytes bound the kernel, not the operations. K3 ran a tile of
// 8 samples on one SM: a batch of 256 used 32 SMs, and on each SM the two
// deflation products (2 m n FMA per sample) ran on the CUDA cores.
//
// The design:
//   * A tile runs on a cluster of c blocks (c = 1, 2, 4 or 8, chosen by the
//     caller from the batch and how many clusters of each size the card
//     holds, `tile_cluster` in ops/pcg_stencil.py), each owning a contiguous node range of whole
//     16-node row tiles. Per-sample reductions (p.Ap, r.r, r.z and the m x 8
//     partial of y) go to each block's shared memory; after a cluster
//     barrier (release / acquire) every block reads all c partials over
//     distributed shared memory in block order, so all hold the same alpha,
//     beta and stop bits. The vectors live in global memory, written before
//     the cluster barrier that precedes their neighbours' reads.
//   * y = Wt bf16(R) and z += Wt^T bf16(C) are mma.sync m16n8k16 bf16
//     products with f32 sums; N = 8 is the tile's samples in y, and the
//     tile's samples are the rows of z^T = C^T Wt (8 of the MMA's 16). Each warp walks
//     16-node row tiles of its block's range; the m x 16 chunk of Wt is
//     staged in shared memory by cp.async (two stages per warp, the next
//     chunk in flight while the current one is applied) and read by
//     ldmatrix (transposed for Wt^T), with a swizzle that keeps the 8 rows
//     of each 8 x 8 matrix on distinct banks. B = bf16(r_new) is built in
//     registers (__floats2bfloat162_rn, round to nearest even like the plain
//     version's .to(torch.bfloat16)) straight from the r update; C^T is
//     held in registers for the whole z pass, whose output then lands in
//     the update pass's lane layout (float2 accesses per sample).
//   * Three streaming passes per iteration, 64 bytes per node, sample and
//     iteration (K3: ~76):
//       stencil   p = z + beta p_prev computed where it is read (also at the
//                 neighbours, from their z and p_prev), written once; Ap;
//                 p.Ap; and the x update of the previous iteration,
//                 x += alpha_prev p_prev, deferred to where p_prev is read:
//                 planes 16, z 4, p_prev 4, x 4 + 4, p 4, Ap 4 = 40 B
//       update    r -= alpha Ap into the MMA's B fragments and r.r: 12 B
//       z         z = D^-1 r + Wt^T c and r.z: 12 B
//     p is double-buffered (a neighbour still reads p_prev while p is
//     written). A sample that stops gets its last x update in a flush pass.
//     Per iteration also Binv (m^2 floats per sample, split over the
//     cluster) and Wt twice from L2.
//   * 512 threads (16 warps) per block, four items in flight per thread in
//     the stencil pass; in the vector passes each warp keeps its next
//     kAhead row tiles' vectors in registers and the next Wt chunk in
//     shared memory. Deeper Wt pipelines measured slower: shared memory
//     taken from L1 costs the stencil's neighbour reads more than it buys.
//   * Measured on an H100 (PERF.md): the stencil pass streams at ~3/4 of
//     an SM's share of HBM; the update and z passes are held by the L2
//     reads of Wt (2 m bf16 per node and tile, 64 B per node and sample).
// The sums are grouped by block, so their order depends on c: a sample's
// bits may differ between batches that get different cluster sizes.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch
// function returns a cudaError_t, and refuses (without launching) a cluster
// that the card cannot hold.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kS = 8;  // samples per tile (the MMA's N)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 128;          // coarse-space size the kernel is built for
constexpr int kMaxMT = kMaxM / 16;  // 16-row tiles of the coarse space
constexpr int kRow = 16;            // nodes per MMA row tile; block ranges are whole row tiles
constexpr int kStage = kMaxM * kRow * 2;  // bytes of one staged Wt chunk (m x 16 bf16)
constexpr int kStages = 2;                // staged Wt chunks per warp (kStages - 1 in flight)
constexpr int kCPad = kMaxM + 8;          // bf16 row stride of the c arrays
constexpr int kU = 4;                     // items per thread in flight in the stencil pass
constexpr int kAhead = 3;                 // row tiles per warp in flight in the vector passes
constexpr size_t kMaxSmem = 232448;       // 227 KB: the most a block may opt into
constexpr unsigned kFull = 0xffffffffu;

// slots of the per-block partials read by the cluster
constexpr int kPAp = 0, kRR = kS, kRZ = 2 * kS;

// Byte offsets into dynamic shared memory (each 16-byte aligned).
struct Layout {
  int stage;  // [warp][kStages][kStage] staged Wt chunks; after the update pass each warp's y partial
  int yblk;   // [mode][s] float: this block's partial of y
  int ys;     // [s][kMaxM] float: y summed over the cluster
  int cb;     // [s][kCPad] bf16: this block's rows of c = bf16(Binv y)
  int cfull;  // [s][kCPad] bf16: all of c
  int wred;   // [warp][s] float: per-warp partials
  int slots;  // [3][s] float: this block's partials of p.Ap, r.r, r.z
  int total;
};

__host__ __device__ inline Layout layout(int m) {
  Layout L;
  int o = 0;
  L.stage = o;
  o += m > 0 ? kWarps * kStages * kStage : 0;
  L.yblk = o;
  o += kMaxM * kS * 4;
  L.ys = o;
  o += kMaxM * kS * 4;
  L.cb = o;
  o += kS * kCPad * 2;
  L.cfull = o;
  o += kS * kCPad * 2;
  L.wred = o;
  o += kWarps * kS * 4;
  L.slots = o;
  o += 3 * kS * 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool on(unsigned act, int s) { return (act >> s) & 1u; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// d += A (16 x 16, bf16) B (16 x 8, bf16), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even); lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Byte offset of (coarse row, 8-node half) in a staged chunk: 32 bytes a
// row, the halves swapped on rows 4-7 of every 8, so that the 8 rows an
// ldmatrix phase reads fall on distinct banks.
__device__ __forceinline__ int swz(int mode, int half) {
  return mode * 32 + 16 * (half ^ ((mode >> 2) & 1));
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

// One tile's operands, state and node range. Sample s of the tile is sample
// b0 + s of the batch; its scratch rows are r, z, Ap, p0, p1.
struct Tile {
  const float* __restrict__ vals4;       // (B, 4, n)
  const float* __restrict__ F;           // (n,)
  const float* __restrict__ x0;          // (B, n) or null
  const __nv_bfloat16* __restrict__ Wt;  // (m, n) or null
  const float* __restrict__ Binv;        // (B, m, m) or null
  float* x;                              // (B, n)
  float* scratch;                        // (B, 5, n)
  int b0, n, m, mt, o1, o2, o3, lo, hi, rank, c;

  __device__ const float* v(int s) const { return vals4 + (size_t)(b0 + s) * 4 * n; }
  __device__ float* r(int s) const { return scratch + (size_t)(b0 + s) * 5 * n; }
  __device__ float* z(int s) const { return r(s) + n; }
  __device__ float* Ap(int s) const { return r(s) + 2 * (size_t)n; }
  __device__ float* p(int s, int par) const { return r(s) + (3 + par) * (size_t)n; }
  __device__ float* xs(int s) const { return x + (size_t)(b0 + s) * n; }
};

// Copy rows [0, m) of Wt's 16-node chunk at node0 into a stage: lane pairs
// take the two 16-byte halves of one row.
__device__ __forceinline__ void stage_chunk(const Tile& T, unsigned st, int node0, int lane) {
  const int half = lane & 1;
#pragma unroll
  for (int j = 0; j < kMaxMT; ++j) {
    const int mode = (lane >> 1) + 16 * j;
    if (mode < T.m) cp_async16(st + swz(mode, half), T.Wt + (size_t)mode * T.n + node0 + 8 * half);
  }
}

// Per-warp partials [warp][s] summed in warp order into this block's slot.
// The leading barrier makes the warps' partials visible.
__device__ __forceinline__ void block_partial(const float* wred, float* slot) {
  __syncthreads();
  if (threadIdx.x < kS) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += wred[w * kS + threadIdx.x];
    slot[threadIdx.x] = t;
  }
}

// The cluster's sum of slot `off`, in block order, to every thread. Call
// after the cluster barrier that follows the slots' writes.
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cl, float* slots, int off, int c,
                                            float (&v)[kS]) {
  const int lane = threadIdx.x & 31;
  float t = 0.f;
  if (lane < kS)
    for (int q = 0; q < c; ++q) t += cl.map_shared_rank(slots, q)[off + lane];
#pragma unroll
  for (int s = 0; s < kS; ++s) v[s] = __shfl_sync(kFull, t, s);
}

// Row i of the stencil of sample s applied to q (read-only input).
__device__ __forceinline__ float stencil_row(const Tile& T, int s, const float* __restrict__ q, int i) {
  const float* w = T.v(s);
  const int n = T.n;
  float acc = __ldg(w + i) * __ldg(q + i);
  const int offs[3] = {T.o1, T.o2, T.o3};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int o = offs[j];
    const float* wo = w + (size_t)(j + 1) * n;
    const int ip = min(i + o, n - 1), im = max(i - o, 0);
    const float up = __ldg(wo + i) * __ldg(q + ip);
    const float dn = __ldg(wo + im) * __ldg(q + im);
    acc = i + o < n ? acc + up : acc;
    acc = i - o >= 0 ? acc + dn : acc;
  }
  return acc;
}

// x = x0 (or 0) and r = F - A x0 (or F) on the block's range.
__device__ __noinline__ void init_pass(const Tile& T, unsigned act) {
  for (int s = 0; s < kS; ++s) {
    if (!on(act, s)) continue;
    const float* x0s = T.x0 != nullptr ? T.x0 + (size_t)(T.b0 + s) * T.n : nullptr;
    float* x = T.xs(s);
    float* r = T.r(s);
    for (int i = T.lo + threadIdx.x; i < T.hi; i += kThreads) {
      x[i] = x0s != nullptr ? __ldg(x0s + i) : 0.f;
      r[i] = x0s != nullptr ? __ldg(T.F + i) - stencil_row(T, s, x0s, i) : __ldg(T.F + i);
    }
  }
}

// For the active samples: p = z (first iteration) or z + beta p_prev, Ap = A p
// on the block's range, p written once; the deferred x += alpha p_prev; and
// p.Ap into wred. p at a neighbour is computed from its z and p_prev exactly
// as its owner computes it.
__device__ __noinline__ void stencil_pass(const Tile& T, unsigned act, int par, bool first,
                                          const float (&beta)[kS], const float (&alpha)[kS],
                                          float* wred) {
  const int n = T.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int offs[3] = {T.o1, T.o2, T.o3};
#pragma unroll 1
  for (int s = 0; s < kS; ++s) {
    float part = 0.f;
    if (on(act, s)) {
      const float* w = T.v(s);
      const float* z = T.z(s);
      const float* pp = T.p(s, par ^ 1);
      float* pc = T.p(s, par);
      float* Ap = T.Ap(s);
      float* x = T.xs(s);
      const float be = beta[s], al = alpha[s];
      auto pv = [&](int j) { return first ? z[j] : __fmaf_rn(be, pp[j], z[j]); };
      for (int i0 = T.lo + threadIdx.x; i0 < T.hi; i0 += kU * kThreads) {
        float a[kU], pi[kU], ppi[kU], xi[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = min(i0 + u * kThreads, T.hi - 1);
          ppi[u] = first ? 0.f : pp[i];
          xi[u] = first ? 0.f : x[i];
          pi[u] = first ? z[i] : __fmaf_rn(be, ppi[u], z[i]);
          float acc = __ldg(w + i) * pi[u];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int o = offs[j];
            const float* wo = w + (size_t)(j + 1) * n;
            const int ip = min(i + o, n - 1), im = max(i - o, 0);
            const float up = __ldg(wo + i) * pv(ip);
            const float dn = __ldg(wo + im) * pv(im);
            acc = i + o < n ? acc + up : acc;
            acc = i - o >= 0 ? acc + dn : acc;
          }
          a[u] = acc;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = i0 + u * kThreads;
          if (i < T.hi) {
            pc[i] = pi[u];
            Ap[i] = a[u];
            part += pi[u] * a[u];
            if (!first) x[i] = __fmaf_rn(al, ppi[u], xi[u]);
          }
        }
      }
    }
    part = warp_sum(part);
    if (lane == 0) wred[warp * kS + s] = part;
  }
}

// x += alpha p_prev for the samples in `mask` (their deferred last update).
__device__ __noinline__ void flush_x(const Tile& T, unsigned mask, int par, const float (&alpha)[kS]) {
  for (int s = 0; s < kS; ++s) {
    if (!on(mask, s)) continue;
    const float* pp = T.p(s, par ^ 1);
    float* x = T.xs(s);
    const float al = alpha[s];
    for (int i = T.lo + threadIdx.x; i < T.hi; i += kThreads) x[i] = __fmaf_rn(al, pp[i], x[i]);
  }
}

// Lane (g, t) of a warp holds sample g's nodes 2t, 2t+1, 8+2t, 9+2t of a
// 16-node row tile: the B fragment of m16n8k16. With kUpd, r -= alpha Ap
// first (and is stored). r.r goes to wred; with kDefl the warp's y = Wt
// bf16(r) partials are summed over the block into yblk.
template <bool kDefl, bool kUpd>
__device__ __noinline__ void update_y_pass(const Tile& T, unsigned act, const float (&alpha)[kS],
                                           unsigned char* smem, const Layout& L, float* wred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool mine = on(act, g);
  float* r = T.r(g);
  const float* Ap = T.Ap(g);
  const float al = alpha[g];
  const unsigned st0 = smem_u32(smem + L.stage + warp * kStages * kStage);
  float yacc[kMaxMT][4];
#pragma unroll
  for (int t = 0; t < kMaxMT; ++t) yacc[t][0] = yacc[t][1] = yacc[t][2] = yacc[t][3] = 0.f;
  float rr = 0.f;
  const int nch = (T.hi - T.lo) / kRow;
  if (kDefl) {  // the first kStages - 1 chunks' Wt in flight
#pragma unroll
    for (int d = 0; d < kStages - 1; ++d) {
      if (warp + d * kWarps < nch) stage_chunk(T, st0 + d * kStage, T.lo + kRow * (warp + d * kWarps), lane);
      cp_commit();
    }
  }
  // r (and Ap) of the warp's next kAhead chunks in flight in registers
  float2 ring[kAhead][4];
  auto load = [&](int q, float2 (&v)[4]) {
    if (mine && q < nch) {
      const int node0 = T.lo + kRow * q;
      v[0] = ld2(r + node0 + 2 * t4);
      v[1] = ld2(r + node0 + 8 + 2 * t4);
      if (kUpd) {
        v[2] = ld2(Ap + node0 + 2 * t4);
        v[3] = ld2(Ap + node0 + 8 + 2 * t4);
      }
    }
  };
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
#pragma unroll
    for (int h = 0; h < 4; ++h) ring[d][h] = make_float2(0.f, 0.f);
    load(warp + d * kWarps, ring[d]);
  }
  for (int k0 = 0; warp + k0 * kWarps < nch; k0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int k = k0 + d, q = warp + k * kWarps;
      if (q < nch) {
        const int node0 = T.lo + kRow * q;
        if (kDefl) {
          const int qa = q + (kStages - 1) * kWarps;
          if (qa < nch) stage_chunk(T, st0 + ((k + kStages - 1) % kStages) * kStage, T.lo + kRow * qa, lane);
          cp_commit();
        }
        float2 ra = ring[d][0], rb = ring[d][1];
        const float2 aa = ring[d][2], ab = ring[d][3];
        load(q + kAhead * kWarps, ring[d]);
        if (mine) {
          if (kUpd) {
            ra = make_float2(__fmaf_rn(-al, aa.x, ra.x), __fmaf_rn(-al, aa.y, ra.y));
            rb = make_float2(__fmaf_rn(-al, ab.x, rb.x), __fmaf_rn(-al, ab.y, rb.y));
            st2(r + node0 + 2 * t4, ra);
            st2(r + node0 + 8 + 2 * t4, rb);
          }
          rr += ra.x * ra.x + ra.y * ra.y + rb.x * rb.x + rb.y * rb.y;
        }
        if (kDefl) {
          const unsigned b0 = pack_bf16(ra.x, ra.y), b1 = pack_bf16(rb.x, rb.y);
          cp_wait<kStages - 1>();
          __syncwarp();
          const unsigned st = st0 + (k % kStages) * kStage;
          const int row = ((lane >> 3) & 1) * 8 + (lane & 7), half = lane >> 4;
#pragma unroll
          for (int t = 0; t < kMaxMT; ++t) {
            if (t < T.mt) {
              unsigned a[4];
              ldsm_x4(st + swz(16 * t + row, half), a);
              mma_bf16(yacc[t], a, b0, b1);
            }
          }
          __syncwarp();
        }
      }
    }
  }
  rr += __shfl_xor_sync(kFull, rr, 1);
  rr += __shfl_xor_sync(kFull, rr, 2);
  if (t4 == 0) wred[warp * kS + g] = rr;
  if (kDefl) {
    cp_wait<0>();
    __syncwarp();
    float* yp = reinterpret_cast<float*>(smem + L.stage + warp * kStages * kStage);  // [mode][s]
#pragma unroll
    for (int t = 0; t < kMaxMT; ++t) {
      if (t < T.mt) {
        const int mode = 16 * t + g;
        st2(yp + mode * kS + 2 * t4, make_float2(yacc[t][0], yacc[t][1]));
        st2(yp + (mode + 8) * kS + 2 * t4, make_float2(yacc[t][2], yacc[t][3]));
      }
    }
  }
  float* slots = reinterpret_cast<float*>(smem + L.slots);
  block_partial(wred, slots + kRR);
  if (kDefl) {
    float* yb = reinterpret_cast<float*>(smem + L.yblk);
    for (int e = tid; e < T.mt * 16 * kS; e += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w)
        t += reinterpret_cast<const float*>(smem + L.stage + w * kStages * kStage)[e];
      yb[e] = t;
    }
  }
}

// y summed over the cluster into ys; then this block's rows of
// c = bf16(Binv_s y_s), one warp per (row, sample), eight in flight.
// Inactive samples and rows past m get 0.
__device__ __noinline__ void c_pass(const Tile& T, unsigned act, unsigned char* smem, const Layout& L,
                                    cg::cluster_group& cl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = T.mt * 16, m = T.m;
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* yblk = reinterpret_cast<float*>(smem + L.yblk);
  for (int e = tid; e < M * kS; e += kThreads) {
    float t = 0.f;
    for (int q = 0; q < T.c; ++q) t += cl.map_shared_rank(yblk, q)[e];
    ys[(e % kS) * kMaxM + e / kS] = t;
  }
  __syncthreads();
  const int rows = M / T.c, r0 = T.rank * rows;
  __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(smem + L.cb);
  for (int e0 = warp; e0 < rows * kS; e0 += 8 * kWarps) {
    float bv[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kWarps;
      const int s = e % kS, j = r0 + e / kS;
      const bool use = e < rows * kS && on(act, s) && j < m;
      const float* Bi = T.Binv + ((size_t)(T.b0 + s) * m + j) * m;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int kk = 4 * lane + h;
        bv[u][h] = use && kk < m ? __ldg(Bi + kk) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kWarps;
      if (e >= rows * kS) break;
      const int s = e % kS, j = r0 + e / kS;
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int kk = 4 * lane + h;
        if (kk < M) sum += bv[u][h] * ys[s * kMaxM + kk];
      }
      sum = warp_sum(sum);
      if (lane == 0) cb[s * kCPad + j] = __float2bfloat16(sum);
    }
  }
}

// All of c from the cluster's blocks (block q holds rows [q M/c, (q+1) M/c)).
__device__ __noinline__ void gather_c(const Tile& T, unsigned char* smem, const Layout& L,
                                      cg::cluster_group& cl) {
  const int M = T.mt * 16, rows = M / T.c;
  unsigned* cf = reinterpret_cast<unsigned*>(smem + L.cfull);
  unsigned* cb = reinterpret_cast<unsigned*>(smem + L.cb);
  for (int e = threadIdx.x; e < kS * M / 2; e += kThreads) {
    const int s = e / (M / 2), j = 2 * (e % (M / 2));
    const int w = (s * kCPad + j) / 2;
    cf[w] = cl.map_shared_rank(cb, j / rows)[w];
  }
  __syncthreads();
}

// z = D^-1 r (+ Wt^T c) for the active samples on the block's range; r.z
// into wred. The product is computed transposed, z^T = C^T Wt, with the
// samples as the MMA's rows (8 of its 16 used; C^T held in registers for
// the pass) and each 16-node row tile as two 8-node column tiles, so that
// lane (g, t) gets sample g's nodes 2t, 2t+1, 8+2t, 9+2t, as in the update
// pass.
template <bool kDefl>
__device__ __noinline__ void z_pass(const Tile& T, unsigned act, unsigned char* smem, const Layout& L,
                                    float* wred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool mine = on(act, g);
  unsigned ca[kMaxMT][2];  // C^T's A fragments: rows g (sample g), coarse modes 2t, 2t+1 and 8+2t, 9+2t
  if (kDefl) {
    const unsigned* cf = reinterpret_cast<const unsigned*>(smem + L.cfull);
#pragma unroll
    for (int t = 0; t < kMaxMT; ++t) {
      ca[t][0] = t < T.mt ? cf[(g * kCPad + 16 * t + 2 * t4) / 2] : 0u;
      ca[t][1] = t < T.mt ? cf[(g * kCPad + 16 * t + 8 + 2 * t4) / 2] : 0u;
    }
  }
  const float* d = T.v(g);
  const float* r = T.r(g);
  float* z = T.z(g);
  const unsigned st0 = smem_u32(smem + L.stage + warp * kStages * kStage);
  float rz = 0.f;
  const int nch = (T.hi - T.lo) / kRow;
  if (kDefl) {  // the first kStages - 1 chunks' Wt in flight
#pragma unroll
    for (int dd = 0; dd < kStages - 1; ++dd) {
      if (warp + dd * kWarps < nch) stage_chunk(T, st0 + dd * kStage, T.lo + kRow * (warp + dd * kWarps), lane);
      cp_commit();
    }
  }
  // D and r of the warp's next kAhead chunks in flight in registers
  float2 ring[kAhead][4];
  auto load = [&](int q, float2 (&v)[4]) {
    if (mine && q < nch) {
      const int node0 = T.lo + kRow * q;
      v[0] = __ldg(reinterpret_cast<const float2*>(d + node0 + 2 * t4));
      v[1] = __ldg(reinterpret_cast<const float2*>(d + node0 + 8 + 2 * t4));
      v[2] = ld2(r + node0 + 2 * t4);
      v[3] = ld2(r + node0 + 8 + 2 * t4);
    }
  };
#pragma unroll
  for (int dd = 0; dd < kAhead; ++dd) {
#pragma unroll
    for (int h = 0; h < 4; ++h) ring[dd][h] = make_float2(0.f, 0.f);
    load(warp + dd * kWarps, ring[dd]);
  }
  for (int k0 = 0; warp + k0 * kWarps < nch; k0 += kAhead) {
#pragma unroll
    for (int dd = 0; dd < kAhead; ++dd) {
      const int k = k0 + dd, q = warp + k * kWarps;
      if (q < nch) {
        const int node0 = T.lo + kRow * q;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float2 cur[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) cur[h] = ring[dd][h];
        load(q + kAhead * kWarps, ring[dd]);
        if (kDefl) {
          const int qa = q + (kStages - 1) * kWarps;
          if (qa < nch) stage_chunk(T, st0 + ((k + kStages - 1) % kStages) * kStage, T.lo + kRow * qa, lane);
          cp_commit();
          cp_wait<kStages - 1>();
          __syncwarp();
          const unsigned st = st0 + (k % kStages) * kStage;
          const int row = ((lane >> 3) & 1) * 8 + (lane & 7), half = lane >> 4;
#pragma unroll
          for (int t = 0; t < kMaxMT; ++t) {
            if (t < T.mt) {
              unsigned b[4];  // Wt^T's B fragments of nodes 0-7 (b[0], b[1]) and 8-15 (b[2], b[3])
              ldsm_x4_trans(st + swz(16 * t + row, half), b);
              const unsigned a[4] = {ca[t][0], 0u, ca[t][1], 0u};
              mma_bf16(acc[0], a, b[0], b[1]);
              mma_bf16(acc[1], a, b[2], b[3]);
            }
          }
          __syncwarp();
        }
        if (mine) {
          float2 zz[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 dv = cur[h], rv = cur[2 + h];
            zz[h].x = (dv.x != 0.f ? 1.f / dv.x : 0.f) * rv.x + acc[h][0];
            zz[h].y = (dv.y != 0.f ? 1.f / dv.y : 0.f) * rv.y + acc[h][1];
            rz += rv.x * zz[h].x + rv.y * zz[h].y;
          }
          st2(z + node0 + 2 * t4, zz[0]);
          st2(z + node0 + 8 + 2 * t4, zz[1]);
        }
      }
    }
  }
  if (kDefl) cp_wait<0>();
  rz += __shfl_xor_sync(kFull, rz, 1);
  rz += __shfl_xor_sync(kFull, rz, 2);
  if (t4 == 0) wred[warp * kS + g] = rz;
  block_partial(wred, reinterpret_cast<float*>(smem + L.slots) + kRZ);
}

// z = M^-1 r for the active samples over the cluster; rz = r.z (cluster sum).
// Ends after the cluster barrier that publishes z.
template <bool kDefl>
__device__ __forceinline__ void precond(const Tile& T, unsigned act, unsigned char* smem,
                                        const Layout& L, float* wred, cg::cluster_group& cl,
                                        float (&rz)[kS]) {
  if (kDefl) {
    c_pass(T, act, smem, L, cl);
    cl.sync();  // c's rows published
    gather_c(T, smem, L, cl);
  }
  z_pass<kDefl>(T, act, smem, L, wred);
  cl.sync();  // z and the r.z partials published
  cluster_sum(cl, reinterpret_cast<float*>(smem + L.slots), kRZ, T.c, rz);
}

template <bool kDefl>
__global__ void __launch_bounds__(kThreads, 1)
pcg_stencil_tile_mma_kernel(const float* __restrict__ vals4,       // (B, 4, n)
                            const float* __restrict__ F,           // (n,)
                            const float* __restrict__ x0,          // (B, n) or null
                            const __nv_bfloat16* __restrict__ Wt,  // (m, n) or null
                            const float* __restrict__ Binv,        // (B, m, m) or null
                            float* x_out,                          // (B, n)
                            int* __restrict__ iters,               // (B,)
                            float* scratch,                        // (B, 5, n)
                            int B, int n, int m, int o1, int o2, int o3, float tol2_scale,
                            int maxiter, int check_every, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const Layout L = layout(kDefl ? m : 0);
  float* wred = reinterpret_cast<float*>(smem + L.wred);
  float* slots = reinterpret_cast<float*>(smem + L.slots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = (blockIdx.x / c) * kS;
  const int nS = min(kS, B - b0);  // the last tile may be short: its missing samples stay inactive
  const int n16 = n / kRow;  // the block's node range: tile_ranges in ops/pcg_stencil.py
  const int lo = kRow * (int)((long long)n16 * rank / c);
  const int hi = kRow * (int)((long long)n16 * (rank + 1) / c);
  const Tile T{vals4, F, x0, Wt, Binv, x_out, scratch, b0, n, kDefl ? m : 0, kDefl ? m / 16 : 0,
               o1, o2, o3, lo, hi, rank, c};
  unsigned act = (1u << nS) - 1u;

  // ||F||^2 over all of [0, n), the same sum in every block
  float ff = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float f = __ldg(F + i);
    ff += f * f;
  }
  ff = warp_sum(ff);
  if (lane == 0) wred[warp * kS] = ff;
  __syncthreads();
  ff = 0.f;
  for (int w = 0; w < kWarps; ++w) ff += wred[w * kS];
  const float tol2 = tol2_scale * ff;
  __syncthreads();

  init_pass(T, act);
  __syncthreads();  // r was written by other threads
  float alpha[kS], beta[kS], rr[kS], rz[kS], tmp[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) alpha[s] = beta[s] = 0.f;
  update_y_pass<kDefl, false>(T, act, alpha, smem, L, wred);  // r.r and y of r0
  cl.sync();
  cluster_sum(cl, slots, kRR, c, rr);
  precond<kDefl>(T, act, smem, L, wred, cl, rz);

  int done = 0, par = 0, its = 0;
  bool first = true;
  unsigned pend = 0u;  // samples whose last x update is deferred
  for (;;) {
    unsigned next = act;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (on(act, s) && !(rr[s] > tol2)) next &= ~(1u << s);
    const bool stop = done >= maxiter || next == 0u;
    const unsigned flush = stop ? pend : pend & ~next;
    if (flush) flush_x(T, flush, par, alpha);
    act = next;
    if (stop) break;
    const int inner = min(check_every, maxiter - done);
    for (int k = 0; k < inner; ++k) {
      stencil_pass(T, act, par, first, beta, alpha, wred);
      block_partial(wred, slots + kPAp);
      cl.sync();  // p, Ap and the p.Ap partials published
      cluster_sum(cl, slots, kPAp, c, tmp);
#pragma unroll
      for (int s = 0; s < kS; ++s) alpha[s] = tmp[s] > 0.f ? rz[s] / tmp[s] : 0.f;
      update_y_pass<kDefl, true>(T, act, alpha, smem, L, wred);
      cl.sync();  // r and the r.r and y partials published
      cluster_sum(cl, slots, kRR, c, rr);
      precond<kDefl>(T, act, smem, L, wred, cl, tmp);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        beta[s] = rz[s] > 0.f ? tmp[s] / rz[s] : 0.f;
        if (on(act, s)) rz[s] = tmp[s];
      }
      first = false;
      par ^= 1;
    }
    pend = act;
    if (tid < kS && on(act, tid)) its += inner;
    done += inner;
  }
  if (rank == 0 && tid < nS) iters[b0 + tid] = its;
  cl.sync();  // no block leaves while another may read its shared memory
}

}  // namespace

extern "C" {

// Dynamic shared memory one K3r block asks for with a coarse space of m.
int pcg_stencil_tile_mma_smem_bytes(int m) { return layout(m).total; }

static cudaLaunchConfig_t launch_config(int B, int m, int c, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + kS - 1) / kS) * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)layout(m).total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of c blocks (coarse space m) the card can hold at once.
cudaError_t pcg_stencil_tile_mma_max_clusters(int m, int c, int* out) {
  *out = 0;
  if (m < 0 || m > kMaxM || m % 16 != 0 || (c != 1 && c != 2 && c != 4 && c != 8)) return cudaErrorInvalidValue;
  auto kern = m > 0 ? pcg_stencil_tile_mma_kernel<true> : pcg_stencil_tile_mma_kernel<false>;
  const size_t smem = (size_t)layout(m).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(kS, m, c, nullptr, attr);  // one tile's cluster
  return cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(kern), &cfg);
}

cudaError_t pcg_stencil_tile_mma_launch(const float* vals4, const float* F, const float* x0,
                                        const void* Wt, const float* Binv, float* x, int* iters,
                                        float* scratch, int B, int n, int m, int o1, int o2, int o3,
                                        float tol2_scale, int maxiter, int check_every, int c,
                                        cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (n <= 0 || n % kRow != 0 || m < 0 || check_every < 1 || maxiter < 0) return cudaErrorInvalidValue;
  if (c != 1 && c != 2 && c != 4 && c != 8) return cudaErrorInvalidValue;
  if ((Wt == nullptr) != (Binv == nullptr)) return cudaErrorInvalidValue;
  const int m_eff = Wt != nullptr ? m : 0;
  if (m_eff > kMaxM || m_eff % 16 != 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)layout(m_eff).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = m_eff > 0 ? pcg_stencil_tile_mma_kernel<true> : pcg_stencil_tile_mma_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, m_eff, c, stream, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kern), &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the card holds no such cluster
  e = cudaLaunchKernelEx(&cfg, kern, vals4, F, x0, static_cast<const __nv_bfloat16*>(Wt), Binv, x,
                         iters, scratch, B, n, m_eff, o1, o2, o3, tol2_scale, maxiter, check_every, c);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
