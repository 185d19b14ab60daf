// K2r: the whole pCN sampler in one launch (proposal, reduced PCG solve, MLP
// correction, Metropolis accept, burn-in adaptation) for C chains and T steps,
// with each chain's operator A(k) assembled once per proposal and held in
// registers for the whole reduced CG. The main-path kernel of
// experimental/pcn_fused.py (`run_pcn_fused` on CUDA tensors); K2
// (csrc/pcn_fused.cu) computes the same function with the stacked product and
// stays built as the record it is timed against.
//
// Replaces the TPU Pallas kernel `_kernel` of
// bayesianinferencedl_tpu/experimental/pcn_fused.py (launched by
// `run_pcn_fused`). The function is K2's, to the operand packing, the
// (T, C, 8) trace row and the Philox4x32-10 stream (counter (chain, step,
// draw, 0), key = seed, each word mapped to (bits >> 8) 2^-24 + 2^-25 in
// float32): only the order in which sums are rounded differs (A(k) is summed
// before the product, products and dot products in tiles, the MLP's and the
// observables' sums in partial sums). Every product is float32 FMAs on the
// CUDA cores, no TF32 and no bf16: the reference runs at Precision.HIGHEST.
//
// What bounds it on an H100.
//   Operations: the least work per chain and step is one assembly
//     A(k) = Bi M + sum_j k_j A_j (2 d r^2 FLOP), cg_iters + 1 products A(k) p
//     and as many by P0 (2 r^2 each), and the MLP: ~0.17 MFLOP at r = 40,
//     h = 64, cg_iters = 20, 10.3 ms for 4,000 steps of 1,024 chains at the
//     card's 67 TFLOP/s (chip_smoke.py's _k2_bound).
//   Latency: one chain's misfit is a chain of 2 cg_iters + 2 (42 at
//     cg_iters = 20) dependent matrix-vector products, each followed by a dot
//     product summed over the warp, and C = 1,024 chains leave 8 chains
//     (warps) on an SM, 2 per scheduler: too few to hide one chain's latency
//     behind the others' work. A chain alone on an SM runs about as fast as
//     eight (experimental/k2r_phases.py), so latency, not throughput, bounds it.
// What the design does about them.
//   - Assembly once per misfit: each lane builds its tile of A(k) from astack
//     in shared memory (staged zero-padded, with a row stride that spreads one
//     step's 32 reads over the banks), so a product costs r^2 FMAs where K2's
//     stacked form costs 6 r^2 and re-reads astack from shared memory each time.
//   - A(k) and P0 in registers as 2-D tiles: lane cb + 8 rb holds rows
//     rp/4 rb .. and columns rp/8 cb .. (a 10 x 5 tile of each at r = 40,
//     rp = r rounded up to 8; 100 registers, no padded lanes), and entries
//     rp/8 cb .. of every r-vector. A product broadcasts the lane's rp/4
//     operand entries by __shfl_sync from the lanes that own them, sums rp/4
//     FMAs per entry, and adds the 4 row blocks' partial sums by two xor
//     shuffles; a dot product needs 3: 6 dependent shuffles per product and
//     dot. (Whole columns per lane would take 80 registers a matrix at r = 40
//     and r shuffles a product: ptxas spills.) The kernel is a
//     template on rp (8..64), so every register index is static; padded rows
//     and columns are exact zeros, so padded vector entries stay 0. Past
//     rp = 48 (kRegMax) the tiles would not fit the registers and the
//     instance reads A(k) and P0 from shared memory instead.
//   - P0 fhat, the same for every misfit, is computed once per chain.
//   - Every operand is staged zero-padded (r to rp, the hidden widths to 64),
//     so no read needs a bound check and the compiler can batch the loads of
//     the assembly and the MLP; Box-Muller runs one normal per lane.
//   - One warp per chain; the wrapper picks the warps per block
//     (k2r_plan in experimental/pcn_fused.py) so that C = 1,024 covers all
//     132 SMs; one launch for the whole run, as K2.

// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;  // chains per block
constexpr int kCols = 8;  // state row [theta(5) | phi | log beta | accept]
constexpr int kMaxVec = 64;  // r and hidden widths
constexpr int kRegMax = 48;  // A(k) and P0 in registers up to this padded r, else in shared memory
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTargetAccept = 0.234f;
constexpr float kLogBetaLo = -9.210340371976182f;  // log(1e-4)
constexpr float kLogBetaHi = -1.0000500033334732e-4f;  // log(0.9999)
constexpr float kTwoPi = 6.283185307179586f;

__host__ __device__ constexpr int pad8(int r) { return (r + 7) / 8 * 8; }

// The row stride of astack in shared memory, where it is held zero-padded to
// (rp, 6 rp), component j at columns j rp .. (j + 1) rp: the least S >= 6 rp
// for which the 32 lanes' reads of one assembly step (lane cb + 8 rb at word
// rp/4 rb S + rp/8 cb) fall on the fewest words of one bank.
__host__ __device__ inline int astack_stride(int r) {
  const int rp = pad8(r), hr = rp / 4, wc = rp / 8;
  int best = 6 * rp, best_ways = 33;
  for (int S = 6 * rp; S < 6 * rp + 32; ++S) {
    int count[32] = {0}, ways = 0;
    for (int l = 0; l < 32; ++l) {
      const int bank = (hr * (l >> 3) * S + wc * (l & 7)) & 31;
      ways = ++count[bank] > ways ? count[bank] : ways;
    }
    if (ways < best_ways) best = S, best_ways = ways;
  }
  return best;
}

// The offset of a section of n floats at o, which then moves past it to the
// next 16-byte boundary.
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += (n + 3) / 4 * 4;
  return at;
}

// Float offsets of the shared-memory operands, then the per-warp buffers.
// experimental/pcn_fused.py's k2r_smem_bytes mirrors this count.
struct Layout {
  int astack, p0t, fhat, bhatT, w1, b1, w2, b2, w3, b3, xnorm, data, warps;
  int u, amat, per_warp, total;
};

__host__ __device__ inline Layout layout(int r, int h1, int h2, int warps) {
  const int rp = pad8(r);
  const bool shared_mats = rp > kRegMax;
  Layout L;
  int o = 0;
  // every operand zero-padded (r to rp, h1 and h2 to 64), so that no read
  // needs a bound check
  L.astack = take(o, rp * astack_stride(r));
  L.p0t = take(o, shared_mats ? rp * rp : 0);  // P0^T, (rp, rp)
  L.fhat = take(o, rp);
  L.bhatT = take(o, rp * kCols);
  L.w1 = take(o, kCols * kMaxVec);
  L.b1 = take(o, kMaxVec);
  L.w2 = take(o, kMaxVec * kMaxVec);
  L.b2 = take(o, kMaxVec);
  L.w3 = take(o, kMaxVec * kCols);
  L.b3 = take(o, kCols);
  L.xnorm = take(o, 2 * kCols);
  L.data = take(o, kCols);
  L.warps = o;
  o = 0;
  L.u = take(o, 2 * kCols);  // this step's 16 uniforms [u1 | u2]
  L.amat = take(o, shared_mats ? rp * rp : 0);  // this chain's A(k), (rp, rp)
  L.per_warp = o;
  L.total = L.warps + warps * L.per_warp;
  return L;
}

// The register tile of an instance: lane l = cb + 8 rb holds the entries
// (m, i) = (HR rb + t, WC cb + c), t < HR, c < WC, of an rp x rp matrix (m
// the input index of a product, i the output index), and entries WC cb + c of
// every r-vector, the same in the 4 lanes of each cb.
template <int RP>
struct Tile {
  static constexpr int kWC = RP / 8;  // vector entries (matrix columns) per lane
  static constexpr int kHR = RP / 4;  // matrix rows per lane
  static constexpr bool kReg = RP <= kRegMax;
};

// A matrix tile held in registers; empty when the instance keeps it in shared memory.
template <int RP, bool ON = Tile<RP>::kReg>
struct RegTile {
  float v[Tile<RP>::kHR][Tile<RP>::kWC];
};
template <int RP>
struct RegTile<RP, false> {};

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the bitwise-same sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
  const float *astack, *p0t, *fhat, *bhatT, *w1, *b1, *w2, *b2, *w3, *b3, *xnorm, *data;
  float* u;     // (16,) this step's uniforms [u1 | u2]
  float* amat;  // (rp, rp) this chain's A(k) where it is not in registers
  int r, h1, h2, lane, cb, rb, astride;
};

// out_i = sum_m v_m M[m][i] for the lane's entries i = WC cb + c. Each lane
// takes v_m for its HR rows m from the lane that owns it (by shuffle), sums
// its tile's WC partial products in order of m, and the 4 lanes of a cb add
// their partial sums (xor 8, then xor 16: the same bits in all 4). M is the
// register tile, or Mt[m * rp + i] in shared memory.
template <int RP, class Mat>
__device__ __forceinline__ void product(const Mat& M, const float* Mt, const Ctx& c,
                                        const float (&v)[Tile<RP>::kWC],
                                        float (&out)[Tile<RP>::kWC]) {
  constexpr int WC = Tile<RP>::kWC, HR = Tile<RP>::kHR;
  float q[HR];
#pragma unroll
  for (int t = 0; t < HR; ++t) q[t] = __shfl_sync(kFull, v[t % WC], 2 * c.rb + t / WC);
#pragma unroll
  for (int e = 0; e < WC; ++e) out[e] = 0.f;
#pragma unroll
  for (int t = 0; t < HR; ++t)
#pragma unroll
    for (int e = 0; e < WC; ++e) {
      float a;
      if constexpr (Tile<RP>::kReg)
        a = M.v[t][e];
      else
        a = Mt[(HR * c.rb + t) * RP + WC * c.cb + e];
      out[e] = fmaf(q[t], a, out[e]);
    }
#pragma unroll
  for (int e = 0; e < WC; ++e) out[e] += __shfl_xor_sync(kFull, out[e], 8);
#pragma unroll
  for (int e = 0; e < WC; ++e) out[e] += __shfl_xor_sync(kFull, out[e], 16);
}

// sum_i a_i b_i over the r-vectors: each lane's WC entries, then the 8 lanes
// of its rb (xor 1, 2, 4), whose entries cover the vector once. The same bits
// in every lane.
template <int RP>
__device__ __forceinline__ float dot(const float (&a)[Tile<RP>::kWC], const float (&b)[Tile<RP>::kWC]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < Tile<RP>::kWC; ++e) s = fmaf(a[e], b[e], s);  // entries past r are 0
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Entry (m, i) of A(k) = sum_j k_j astack[m, j r + i] (k_5 = 1: Bi M), 0
// outside r x r (the padding of the staged astack).
template <int RP>
__device__ __forceinline__ float entry(const Ctx& c, const float (&k)[6], int m, int i) {
  const float* src = c.astack + m * c.astride + i;
  float a = k[0] * src[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) a = fmaf(k[j], src[j * RP], a);
  return a;
}

// This lane's tile of A(k), into registers or the warp's shared A(k) (each lane
// writes and later reads only its own tile, so no barrier).
template <int RP>
__device__ __forceinline__ void assemble(const Ctx& c, const float (&k)[6], RegTile<RP>& A) {
  constexpr int WC = Tile<RP>::kWC, HR = Tile<RP>::kHR;
#pragma unroll
  for (int t = 0; t < HR; ++t)
#pragma unroll
    for (int e = 0; e < WC; ++e) {
      const int m = HR * c.rb + t, i = WC * c.cb + e;
      if constexpr (Tile<RP>::kReg)
        A.v[t][e] = entry<RP>(c, k, m, i);
      else
        c.amat[m * RP + i] = entry<RP>(c, k, m, i);
    }
}

// phi(theta) for theta (8,) with columns >= d zero: the reduced PCG solve from
// x0 = P0 fhat, the observables, the MLP correction and the misfit.
// Warp-uniform result.
template <int RP>
__device__ __forceinline__ float misfit(const Ctx& c, RegTile<RP>& A, const RegTile<RP>& P,
                                        const float (&x0)[Tile<RP>::kWC],
                                        const float (&fh)[Tile<RP>::kWC],
                                        const float (&theta)[kCols], int d, int cg_iters,
                                        float inv2n2) {
  constexpr int WC = Tile<RP>::kWC;
  const int lane = c.lane;
  float k[6];
#pragma unroll
  for (int j = 0; j < 5; ++j) k[j] = j < d ? expf(theta[j]) : 0.f;
  k[5] = 1.f;
  assemble<RP>(c, k, A);

  // res = fhat - A x0; z = P0 res; p = z
  float x[WC], res[WC], z[WC], p[WC], Ap[WC];
  product<RP>(A, c.amat, c, x0, Ap);
#pragma unroll
  for (int e = 0; e < WC; ++e) {
    x[e] = x0[e];
    res[e] = fh[e] - Ap[e];
  }
  product<RP>(P, c.p0t, c, res, z);
#pragma unroll
  for (int e = 0; e < WC; ++e) p[e] = z[e];
  float rz = dot<RP>(res, z);
  for (int it = 0; it < cg_iters; ++it) {
    product<RP>(A, c.amat, c, p, Ap);
    const float pAp = dot<RP>(p, Ap);
    const float alpha = rz / (pAp != 0.f ? pAp : 1.f);
#pragma unroll
    for (int e = 0; e < WC; ++e) {
      x[e] = x[e] + alpha * p[e];
      res[e] = res[e] - alpha * Ap[e];
    }
    product<RP>(P, c.p0t, c, res, z);
    const float rz_new = dot<RP>(res, z);
    const float beta = rz_new / (rz != 0.f ? rz : 1.f);
#pragma unroll
    for (int e = 0; e < WC; ++e) p[e] = z[e] + beta * p[e];
    rz = rz_new;
  }

  // MLP: xs = (theta - x_mean) / x_std; h1 = tanh(xs W1 + b1); h2 = tanh(h1 W2 + b2),
  // entries j = lane + 32 s of both hidden layers in registers
  float xs[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) xs[q] = (theta[q] - c.xnorm[q]) * c.xnorm[kCols + q];
  // (padded entries are tanh(0) = 0)
  float h1v[2], h2v[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < kCols; ++q) a = fmaf(xs[q], c.w1[q * kMaxVec + j], a);
    h1v[s] = tanhf(a + c.b1[j]);
  }
  // h1 W2: entry q of h1 by shuffle from its lane, four partial sums over q mod 4
  float acc[2][4] = {};
#pragma unroll 8
  for (int q = 0; q < kMaxVec; ++q) {
    const float hq = __shfl_sync(kFull, h1v[q >> 5], q & 31);
#pragma unroll
    for (int s = 0; s < 2; ++s) acc[s][q & 3] = fmaf(hq, c.w2[q * kMaxVec + lane + 32 * s], acc[s][q & 3]);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
    h2v[s] = tanhf(((acc[s][0] + acc[s][1]) + (acc[s][2] + acc[s][3])) + c.b2[lane + 32 * s]);
  // observable o: y_rom = x Bhat^T and e = h2 W3 + b3, each lane's share of
  // both sums (x's entries from the lanes of rb 0, which hold each once), then
  // the 8 sums over the warp together (the same bits in every lane)
  float part[kCols];
#pragma unroll
  for (int o = 0; o < kCols; ++o) part[o] = 0.f;
#pragma unroll
  for (int e = 0; e < WC; ++e) {
    const float xe = c.rb == 0 ? x[e] : 0.f;
#pragma unroll
    for (int o = 0; o < kCols; ++o) part[o] = fmaf(xe, c.bhatT[(WC * c.cb + e) * kCols + o], part[o]);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int o = 0; o < kCols; ++o)
      part[o] = fmaf(h2v[s], c.w3[(lane + 32 * s) * kCols + o], part[o]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
#pragma unroll
    for (int o = 0; o < kCols; ++o) part[o] += __shfl_xor_sync(kFull, part[o], w);
  float sq = 0.f;
#pragma unroll
  for (int o = 0; o < kCols; ++o) {
    const float rr = (part[o] + c.b3[o]) - c.data[o];
    sq = fmaf(rr, rr, sq);  // padded observables are exact zeros
  }
  return sq * inv2n2;
}

struct Args {
  const float* theta0;  // (C, 8)
  const float* astack;  // (r, 6r)
  const float* P0;      // (r, r)
  const float* fhat;    // (r,)
  const float* bhatT;   // (r, 8)
  const float *w1, *b1, *w2, *b2, *w3, *b3;  // (8, h1), (h1,), (h1, h2), (h2,), (h2, 8), (8,)
  const float* xnorm;   // (2, 8)
  const float* data;    // (8,)
  const float *u1_in, *u2_in;  // (T, C, 8) or null
  float *u1_out, *u2_out;      // (T, C, 8) or null
  float* out;                  // (T, C, 8)
  int C, r, h1, h2, d, T, n_burn, cg_iters, warps;
  float prior_mean, prior_sigma, inv2n2, beta0;
  uint32_t key0, key1;
};

template <int RP>
__global__ void __launch_bounds__(32 * kMaxWarps) pcn_fused_r_kernel(const Args a) {
  constexpr int WC = Tile<RP>::kWC, HR = Tile<RP>::kHR;
  extern __shared__ __align__(16) float smem[];
  const int r = a.r;
  const Layout L = layout(r, a.h1, a.h2, a.warps);
  const int astride = astack_stride(r);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // stage the operands, zero-padded: astack (rp rows of astride, component j
  // at columns j rp ..), P0 transposed, the MLP to 64 wide
  // (rows, cols) of src into a (rows_to, cols_to) section at off
  auto stage = [&](int off, const float* src, int rows, int cols, int rows_to, int cols_to) {
    for (int q = tid; q < rows_to * cols_to; q += nthreads) {
      const int i = q / cols_to, j = q % cols_to;
      smem[off + q] = (i < rows && j < cols) ? src[i * cols + j] : 0.f;
    }
  };
  for (int q = tid; q < RP * astride; q += nthreads) {
    const int m = q / astride, col = q % astride, j = col / RP, i = col % RP;
    smem[L.astack + q] = (m < r && j < 6 && i < r) ? a.astack[(size_t)m * 6 * r + j * r + i] : 0.f;
  }
  if constexpr (!Tile<RP>::kReg) {
    for (int q = tid; q < RP * RP; q += nthreads) {
      const int m = q / RP, i = q % RP;
      smem[L.p0t + q] = (m < r && i < r) ? a.P0[(size_t)i * r + m] : 0.f;
    }
  }
  stage(L.fhat, a.fhat, 1, r, 1, RP);
  stage(L.bhatT, a.bhatT, r, kCols, RP, kCols);
  stage(L.w1, a.w1, kCols, a.h1, kCols, kMaxVec);
  stage(L.b1, a.b1, 1, a.h1, 1, kMaxVec);
  stage(L.w2, a.w2, a.h1, a.h2, kMaxVec, kMaxVec);
  stage(L.b2, a.b2, 1, a.h2, 1, kMaxVec);
  stage(L.w3, a.w3, a.h2, kCols, kMaxVec, kCols);
  stage(L.b3, a.b3, 1, kCols, 1, kCols);
  stage(L.xnorm, a.xnorm, 2, kCols, 2, kCols);
  stage(L.data, a.data, 1, kCols, 1, kCols);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chain = blockIdx.x * a.warps + warp;
  if (chain >= a.C) return;  // no block-wide barrier follows
  float* wbuf = smem + L.warps + warp * L.per_warp;
  const Ctx ctx{smem + L.astack, smem + L.p0t, smem + L.fhat,  smem + L.bhatT, smem + L.w1,
                smem + L.b1,     smem + L.w2,  smem + L.b2,    smem + L.w3,    smem + L.b3,
                smem + L.xnorm,  smem + L.data, wbuf + L.u,    wbuf + L.amat,  r,
                a.h1,            a.h2,         lane,           lane & 7,       lane >> 3,
                astride};

  // this lane's tile of P0 (P0[i][m] at (m, i)), in registers where the instance has room
  RegTile<RP> P;
  if constexpr (Tile<RP>::kReg) {
#pragma unroll
    for (int t = 0; t < HR; ++t)
#pragma unroll
      for (int e = 0; e < WC; ++e) {
        const int m = HR * ctx.rb + t, i = WC * ctx.cb + e;
        P.v[t][e] = (i < r && m < r) ? a.P0[(size_t)i * r + m] : 0.f;
      }
  }
  RegTile<RP> A;
  float fh[WC], x0[WC];
#pragma unroll
  for (int e = 0; e < WC; ++e) fh[e] = ctx.fhat[WC * ctx.cb + e];
  product<RP>(P, ctx.p0t, ctx, fh, x0);  // P0 fhat: one vector for the whole run

  float theta[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) theta[q] = q < a.d ? a.theta0[(size_t)chain * kCols + q] : 0.f;
  float phi = 0.f;
  float lbeta = logf(a.beta0);

  // t = -1 computes the initial misfit: one call site keeps one inlined copy
  for (int t = -1; t < a.T; ++t) {
    float prop[kCols];
    const size_t row = ((size_t)(t < 0 ? 0 : t) * a.C + chain) * kCols;
    if (t < 0) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) prop[q] = theta[q];
    } else {
      // this step's 16 uniforms [u1 | u2] into the warp's buffer
      __syncwarp();
      if (a.u1_in != nullptr) {
        if (lane < 2 * kCols) ctx.u[lane] = (lane < kCols ? a.u1_in : a.u2_in)[row + (lane & 7)];
      } else if (lane < 4) {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)chain, (uint32_t)t, (uint32_t)lane, 0u), a.key0, a.key1);
        ctx.u[4 * lane + 0] = uniform24(w.x);
        ctx.u[4 * lane + 1] = uniform24(w.y);
        ctx.u[4 * lane + 2] = uniform24(w.z);
        ctx.u[4 * lane + 3] = uniform24(w.w);
      }
      __syncwarp();
      if (a.u1_out != nullptr && lane < 2 * kCols)
        (lane < kCols ? a.u1_out : a.u2_out)[row + (lane & 7)] = ctx.u[lane];

      // proposal: prior_mean + contract (theta - prior_mean) + beta sigma xi,
      // normal q by Box-Muller on lane q, then to every lane
      const float beta = expf(lbeta);
      const float contract = sqrtf(fmaxf(1.f - beta * beta, 0.f));
      const float bs = beta * a.prior_sigma;
      const int ql = lane & 7;
      const float xi_l = sqrtf(-2.f * logf(ctx.u[ql])) * cosf(kTwoPi * ctx.u[kCols + ql]);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float xi = __shfl_sync(kFull, xi_l, q);
        prop[q] = q < a.d ? a.prior_mean + contract * (theta[q] - a.prior_mean) + bs * xi : 0.f;
      }
    }
    const float phi_prop = misfit<RP>(ctx, A, P, x0, fh, prop, a.d, a.cg_iters, a.inv2n2);
    if (t < 0) {
      phi = phi_prop;
      continue;
    }
    const bool accept = logf(ctx.u[kCols + 7]) < phi - phi_prop;
    if (accept) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) theta[q] = prop[q];
      phi = phi_prop;
    }
    const float acc = accept ? 1.f : 0.f;
    if (t < a.n_burn) {
      const float decay = expf(-0.6f * logf(1.f + (float)t));
      lbeta = lbeta + 0.5f * decay * (acc - kTargetAccept);
    }
    lbeta = fminf(fmaxf(lbeta, kLogBetaLo), kLogBetaHi);

    if (lane < kCols) {
      float v = theta[0];
#pragma unroll
      for (int q = 1; q < kCols; ++q)
        if (lane == q) v = q < 5 ? theta[q] : (q == 5 ? phi : (q == 6 ? lbeta : acc));
      a.out[row + lane] = v;
    }
  }
}

using KernelFn = void (*)(const Args);

KernelFn kernel_for(int r) {
  switch (pad8(r)) {
    case 8: return pcn_fused_r_kernel<8>;
    case 16: return pcn_fused_r_kernel<16>;
    case 24: return pcn_fused_r_kernel<24>;
    case 32: return pcn_fused_r_kernel<32>;
    case 40: return pcn_fused_r_kernel<40>;
    case 48: return pcn_fused_r_kernel<48>;
    case 56: return pcn_fused_r_kernel<56>;
    case 64: return pcn_fused_r_kernel<64>;
    default: return nullptr;
  }
}

bool shape_ok(int r, int h1, int h2, int warps) {
  return r >= 1 && r <= kMaxVec && h1 >= 1 && h1 <= kMaxVec && h2 >= 1 && h2 <= kMaxVec &&
         warps >= 1 && warps <= kMaxWarps;
}

}  // namespace

extern "C" {

// The dynamic shared memory of one block, in bytes, or -1 for a shape the
// kernel does not take.
long long pcn_fused_r_smem_bytes(int r, int h1, int h2, int warps) {
  if (!shape_ok(r, h1, h2, warps)) return -1;
  return (long long)layout(r, h1, h2, warps).total * (long long)sizeof(float);
}

// How many blocks of the instance for r an SM holds at once.
cudaError_t pcn_fused_r_blocks_per_sm(int r, int h1, int h2, int warps, int* blocks) {
  if (!shape_ok(r, h1, h2, warps)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)pcn_fused_r_smem_bytes(r, h1, h2, warps);
  KernelFn fn = kernel_for(r);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, 32 * warps, smem);
}

cudaError_t pcn_fused_r_launch(const float* theta0, const float* astack, const float* P0,
                               const float* fhat, const float* bhatT, const float* w1,
                               const float* b1, const float* w2, const float* b2, const float* w3,
                               const float* b3, const float* xnorm, const float* data,
                               const float* u1_in, const float* u2_in, float* u1_out,
                               float* u2_out, float* out, int C, int r, int h1, int h2, int d,
                               int T, int n_burn, int cg_iters, int warps, float prior_mean,
                               float prior_sigma, float inv2n2, float beta0,
                               unsigned long long seed, cudaStream_t stream) {
  if (C <= 0 || T <= 0) return cudaSuccess;
  if (!shape_ok(r, h1, h2, warps) || d < 1 || d > 5 || n_burn < 0 || n_burn > T || cg_iters < 0)
    return cudaErrorInvalidValue;
  if ((u1_in == nullptr) != (u2_in == nullptr) || (u1_out == nullptr) != (u2_out == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)pcn_fused_r_smem_bytes(r, h1, h2, warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  KernelFn fn = kernel_for(r);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const Args a{theta0, astack, P0,    fhat,     bhatT,    w1,       b1,
               w2,     b2,     w3,    b3,       xnorm,    data,     u1_in,
               u2_in,  u1_out, u2_out, out,     C,        r,        h1,
               h2,     d,      T,     n_burn,   cg_iters, warps,    prior_mean,
               prior_sigma, inv2n2, beta0, (uint32_t)(seed & 0xffffffffull),
               (uint32_t)(seed >> 32)};
  const int blocks = (C + warps - 1) / warps;
  fn<<<blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
