// K4c: one sample's Jacobi-PCG on the fin's 2-D grid per thread-block cluster
// of c blocks (c = 1, 2, 4, 8 or 16), the state streamed from device memory
// over the true grid only; persistent clusters take the batch's samples in turn.
//
// Replaces the TPU Pallas kernel `_pcg_kernel`
// (bayesianinferencedl_tpu/ops/pcg_stencil.py:58, launched at :157 by
// `pcg_stencil_batch`) on grids whose row strips do not fit the card's shared
// memory (`grid_route` in ops/pcg_stencil.py: res >= 39 on an H100; res22-38
// take K4r, csrc/pcg_stencil_grid_resident.cu). K4 (csrc/pcg_stencil_grid.cu)
// computed it before, one block per sample; it stays built, off the main
// path. K4c keeps K4's contract and its operations:
//
//   stencil   acc = v3 p + sum_{s != 3} v_s p[ix+dx_s, iy+dy_s] over the 7 planes of
//             OFFSETS_2D = (-1,-1) (-1,0) (0,-1) (0,0) (0,1) (1,0) (1,1), in that
//             order; reads outside the true (X0, Y0) grid are zero.
//   precond   z = D^-1 r, D^-1 = 0 where the diagonal is 0; no deflation.
//   stopping  ||r||^2 <= tol^2 ||F||^2 tested before every iteration, under the
//             plain `maxiter` cap; alpha and beta are 0 where their denominators
//             are not positive. x0 = null starts from zero; counts per sample.
//   rounding  every product and sum of the stencil and of the x, r, p updates
//             rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: no FMA), as
//             the plain torch version rounds them; the dots summed in float64
//             (float32 sums reach the cap at these sizes).
//   output    x over the whole padded (X, Y) grid, zero outside the true grid.
//
// What bounds it on an H100. One sample's state at res40 (7 planes, x, r, two
// p, Ap over 961 x 641 nodes: ~29 MB) is far beyond 227 KB of shared memory a
// block, and a batch's far beyond the 50 MB L2, so every iteration streams it
// from HBM: the bytes bound it. K4 ran a sample on one 512-thread block, one
// SM: a batch of 8 used 8 of 132 SMs, each at ~40-45 GB/s, and it streamed
// ~80 B per padded cell in three passes (17% of them zero padding at res40).
//
// The design:
//   * A sample per cluster. Block j of a cluster of c owns the true rows
//     [j X0 / c, (j + 1) X0 / c) (`grid_strips` in ops/pcg_stencil.py). The grid
//     holds as many clusters as the card runs at once (at most B); each takes
//     the next sample from a counter in device memory when it is done with one,
//     so a sample that stops early frees its cluster. The wrapper picks c
//     from the batch and the card's cluster capacity (`grid_cluster`); 16 is
//     Hopper's non-portable maximum.
//   * Agreement. Each block sums its threads' float64 partials in a fixed order
//     into its shared memory; after a cluster barrier (barrier.cluster
//     arrive.release / wait.acquire, a hardware barrier: no poll, no trap)
//     every warp of every block sums the c blocks' partials over distributed
//     shared memory in block order. So every block holds the same alpha, beta,
//     r.r and stop decision bit for bit, and takes the same number of trips.
//     The sums are grouped by block, so a sample's bits may depend on c (and
//     so on the batch it came in); for one c they are the same from run to run.
//   * Two passes per iteration, two cluster barriers, over the true grid only
//     (rows [0, X0), 4-cell groups up to ceil(Y0 / 4): the padded cells are
//     never read; x's get zeros once per sample):
//       stencil  in chunks of kChunk rows: first p = z + beta p_prev
//                (z = D^-1 r; p = z on the first iteration) on the chunk's
//                rows and the row above and below, into a shared-memory tile,
//                the halo rows with the owner's arithmetic (so the same bits);
//                p written once for the next iteration; x += alpha_prev p_prev,
//                deferred from the previous iteration to where p_prev is read.
//                Then Ap = A p from the tile and the planes, and p.Ap.
//                Reads planes 28, r 4, p_prev 4, x 4; writes p 4, x 4, Ap 4.
//       update   r -= alpha Ap, z = D^-1 r, r.z and r.r beside it.
//                Reads Ap 4, r 4, the diagonal 4; writes r 4.
//     68 B per true node and iteration (K4: ~80 B per padded cell), the halo
//     rows of each chunk (2 in 16) read again from L2. p is double-buffered: a
//     neighbouring block still reads p_prev at this block's edge rows while p
//     is written. A sample that stops gets its last x update in a flush.
//   * Visibility. The vectors other blocks read (r, p_prev) are written before
//     the cluster barrier that precedes the read and loaded through L2
//     (__ldcg). The partial slots: p.Ap's and r.z / r.r's are separate, so a
//     slot is rewritten only after a barrier that every reader of its last
//     value has reached.
//   * 1,024 threads a block, one block per SM (at most 64 registers), a
//     thread a 4-cell group at a time: every plane and vector moves in 16-byte
//     words.
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns a cudaError_t, and refuses (without launching) a cluster size it is
// not built for or one the card cannot hold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // <= 32: warp 0 sums one partial per warp
constexpr int kChunk = 16;             // rows of p formed in shared memory at a time
constexpr int kPad = 4;                // tile cells left of column 0 (keeps float4 alignment)
constexpr size_t kMaxSmem = 232448;    // 227 KB: the most a block may opt into
constexpr unsigned kFull = 0xffffffffu;

enum Slot { kFF = 0, kPAP = 1, kRZ = 2, kRR = 3, kSlots = 4 };  // a block's partials

// Shared memory: the reduction scratch (2 kWarps doubles), the slots (kSlots
// doubles), the sample index (16 bytes), then the p tile of kChunk + 2 rows of
// stride tile_stride. ops/pcg_stencil.py's cluster_bytes() counts the same.
constexpr int kHeadBytes = (2 * kWarps + kSlots) * 8 + 16;

__host__ __device__ inline int tile_stride(int Y0) { return 4 * ((Y0 + 3) / 4) + 2 * kPad; }

__host__ __device__ inline size_t smem_bytes(int Y0) {
  return (size_t)kHeadBytes + (size_t)(kChunk + 2) * tile_stride(Y0) * sizeof(float);
}

__host__ __device__ inline bool valid_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8 || c == 16;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sums a (into slot sa) and b (into slot sb, where sb >= 0) over the cluster in
// float64: each block's threads by warp and lane into its slot, a cluster
// barrier, then every warp the c slots in block order. Returns the sums,
// rounded to float32, to every thread of every block, the same bits in each.
__device__ float2 cluster_sum2(cg::cluster_group& cl, double a, double b, int sa, int sb, double* red,
                               double* slots, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const double s = warp_sum(lane < kWarps ? red[lane] : 0.0);
    const double t = warp_sum(lane < kWarps ? red[kWarps + lane] : 0.0);
    if (lane == 0) {
      slots[sa] = s;
      if (sb >= 0) slots[sb] = t;
    }
  }
  cl.sync();  // the slots published (release / acquire over the cluster)
  double va = 0.0, vb = 0.0;
  if (lane < c) {
    const double* q = cl.map_shared_rank(slots, lane);
    va = q[sa];
    vb = sb >= 0 ? q[sb] : 0.0;
  }
  double s = 0.0, t = 0.0;
  for (int q = 0; q < c; ++q) {
    s += __shfl_sync(kFull, va, q);
    t += __shfl_sync(kFull, vb, q);
  }
  return make_float2((float)s, (float)t);
}

__device__ __forceinline__ float inv_diag(float d) { return d != 0.f ? 1.f / d : 0.f; }

__device__ __forceinline__ float4 ldg4(const float* a, size_t i) {  // read-only inputs
  return __ldg(reinterpret_cast<const float4*>(a + i));
}
__device__ __forceinline__ float4 ldcg4(const float* a, size_t i) {  // vectors other blocks write
  return __ldcg(reinterpret_cast<const float4*>(a + i));
}
__device__ __forceinline__ float4 lds4(const float* a) { return *reinterpret_cast<const float4*>(a); }
__device__ __forceinline__ void st4(float* a, size_t i, float4 v) { *reinterpret_cast<float4*>(a + i) = v; }

__device__ __forceinline__ double dot4(float4 a, float4 b) {
  return (double)a.x * b.x + (double)a.y * b.y + (double)a.z * b.z + (double)a.w * b.w;
}

// y + a * x with the product and the sum each rounded (never an FMA)
__device__ __forceinline__ float madd(float y, float a, float x) { return __fadd_rn(y, __fmul_rn(a, x)); }

__device__ __forceinline__ float4 madd4(float4 y, float a, float4 x) {
  return make_float4(madd(y.x, a, x.x), madd(y.y, a, x.y), madd(y.z, a, x.z), madd(y.w, a, x.w));
}

// acc += v * q, per component, unfused
__device__ __forceinline__ void madd4v(float4& acc, float4 v, float4 q) {
  acc.x = madd(acc.x, v.x, q.x);
  acc.y = madd(acc.y, v.y, q.y);
  acc.z = madd(acc.z, v.z, q.z);
  acc.w = madd(acc.w, v.w, q.w);
}

__device__ __forceinline__ float4 jacobi4(float4 d, float4 r) {
  return make_float4(__fmul_rn(inv_diag(d.x), r.x), __fmul_rn(inv_diag(d.y), r.y),
                     __fmul_rn(inv_diag(d.z), r.z), __fmul_rn(inv_diag(d.w), r.w));
}

// The 7-plane stencil at cells (ix, iy..iy+3), flat i, of this sample's planes
// v (7 planes of N cells), given p there (pc), on the rows above (pu) and below
// (pd), and the four corner and side values. Term order follows the plain
// version and K4.
__device__ __forceinline__ float4 stencil4(const float* __restrict__ v, size_t N, size_t i, float4 pc,
                                           float4 pu, float4 pd, float ul, float cl, float cr, float dr) {
  const float4 d = ldg4(v + 3 * N, i);
  float4 acc = make_float4(__fmul_rn(d.x, pc.x), __fmul_rn(d.y, pc.y), __fmul_rn(d.z, pc.z),
                           __fmul_rn(d.w, pc.w));
  madd4v(acc, ldg4(v, i), make_float4(ul, pu.x, pu.y, pu.z));           // (-1, -1)
  madd4v(acc, ldg4(v + N, i), pu);                                      // (-1, 0)
  madd4v(acc, ldg4(v + 2 * N, i), make_float4(cl, pc.x, pc.y, pc.z));   // (0, -1)
  madd4v(acc, ldg4(v + 4 * N, i), make_float4(pc.y, pc.z, pc.w, cr));   // (0, 1)
  madd4v(acc, ldg4(v + 5 * N, i), pd);                                  // (1, 0)
  madd4v(acc, ldg4(v + 6 * N, i), make_float4(pd.y, pd.z, pd.w, dr));   // (1, 1)
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
pcg_stencil_grid_cluster_kernel(const float* __restrict__ vals2d,  // (B, 7, X, Y)
                                const float* __restrict__ F,       // (X, Y)
                                const float* __restrict__ x0,      // (B, X, Y) or null
                                float* x_out,                      // (B, X, Y)
                                int* __restrict__ iters,           // (B,)
                                float* scratch,                    // (B, 4, X, Y): r, p0, p1, Ap
                                int* next,                         // 1, zero at launch
                                int B, int X, int Y, int X0, int Y0, float tol2_scale, int maxiter) {
  extern __shared__ __align__(16) double smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), j = (int)cl.block_rank(), tid = threadIdx.x;
  double* red = smem;                                   // (2, kWarps)
  double* slots = red + 2 * kWarps;                     // (kSlots)
  int* s_next = reinterpret_cast<int*>(slots + kSlots);  // the cluster's current sample (rank 0's)
  float* tile = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + kHeadBytes);
  const int G4 = (Y0 + 3) / 4, W = 4 * G4, P = W + 2 * kPad;
  const int row0 = (int)((long long)j * X0 / c), row1 = (int)((long long)(j + 1) * X0 / c);
  const int cells = (row1 - row0) * G4;  // this block's 4-cell groups
  const size_t N = (size_t)X * Y;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the tile's border columns stay zero for the whole launch
  for (int t = tid; t < kChunk + 2; t += kThreads) tile[t * P + kPad - 1] = tile[t * P + kPad + W] = 0.f;

  double ff = 0.0;
  for (int e = tid; e < cells; e += kThreads) {
    const int ix = row0 + e / G4, iy = 4 * (e % G4);
    const float4 f = ldg4(F, (size_t)ix * Y + iy);
    ff += dot4(f, f);
  }
  const float tol2 = tol2_scale * cluster_sum2(cl, ff, 0.0, kFF, -1, red, slots, c).x;

  for (;;) {
    if (j == 0 && tid == 0) *s_next = atomicAdd(next, 1);
    cl.sync();
    const int b = *cl.map_shared_rank(s_next, 0);
    if (b >= B) break;  // every block reads the same b

    const float* v = vals2d + (size_t)b * 7 * N;
    const float* dg = v + 3 * N;
    const float* xb0 = x0 != nullptr ? x0 + (size_t)b * N : nullptr;
    float* xb = x_out + (size_t)b * N;
    float* r = scratch + (size_t)b * 4 * N;
    float* const p0 = r + N;
    float* const p1 = r + 2 * N;
    float* Ap = r + 3 * N;

    // zeros in x's padding: each block its rows past the groups, the last
    // block the padded rows too
    {
      const int padc = Y - W, row_end = j == c - 1 ? X : row1;
      const int n1 = (row1 - row0) * padc, n2 = (row_end - row1) * Y;
      for (int e = tid; e < n1; e += kThreads) xb[(size_t)(row0 + e / padc) * Y + W + e % padc] = 0.f;
      for (int e = tid; e < n2; e += kThreads) xb[(size_t)row1 * Y + e] = 0.f;
    }
    // x = x0, r = F - A x0 (F where x0 is null), z = D^-1 r; r.z and r.r
    double s_rz = 0.0, s_rr = 0.0;
    for (int e = tid; e < cells; e += kThreads) {
      const int ix = row0 + e / G4, iy = 4 * (e % G4);
      const size_t i = (size_t)ix * Y + iy;
      float4 ri = ldg4(F, i);
      if (xb0 != nullptr) {
        const bool xm = ix > 0, xp = ix + 1 < X0, ym = iy > 0, yp = iy + 4 < W;
        const float4 pc = ldg4(xb0, i);
        const float4 pu = xm ? ldg4(xb0, i - Y) : zero;
        const float4 pd = xp ? ldg4(xb0, i + Y) : zero;
        const float ul = xm && ym ? __ldg(xb0 + i - Y - 1) : 0.f;
        const float cl_ = ym ? __ldg(xb0 + i - 1) : 0.f;
        const float cr = yp ? __ldg(xb0 + i + 4) : 0.f;
        const float dr = xp && yp ? __ldg(xb0 + i + Y + 4) : 0.f;
        const float4 ax = stencil4(v, N, i, pc, pu, pd, ul, cl_, cr, dr);
        ri = make_float4(__fsub_rn(ri.x, ax.x), __fsub_rn(ri.y, ax.y), __fsub_rn(ri.z, ax.z),
                         __fsub_rn(ri.w, ax.w));
        st4(xb, i, pc);
      } else {
        st4(xb, i, zero);
      }
      st4(r, i, ri);
      const float4 zi = jacobi4(ldg4(dg, i), ri);
      s_rz += dot4(ri, zi);
      s_rr += dot4(ri, ri);
    }
    float2 s = cluster_sum2(cl, s_rz, s_rr, kRZ, kRR, red, slots, c);
    float rz = s.x, rr = s.y, alpha = 0.f, beta = 0.f;

    int it = 0, par = 0;
    // rr and it are the same in every block of the cluster: all take the
    // same trips and reach the same barriers
    while (it < maxiter && rr > tol2) {
      const float* pprev = par ? p0 : p1;
      float* pcur = par ? p1 : p0;
      double s_pap = 0.0;
      for (int a = row0; a < row1; a += kChunk) {
        const int a1 = min(a + kChunk, row1);
        // p on rows [a - 1, a1 + 1) into the tile (zero outside the true grid);
        // on the chunk's own rows p is stored and x takes its deferred update
        const int n1 = (a1 - a + 2) * G4;
        for (int e = tid; e < n1; e += kThreads) {
          const int t = e / G4, iy = 4 * (e - t * G4), ix = a - 1 + t;
          float4 pv = zero;
          if (ix >= 0 && ix < X0) {
            const size_t i = (size_t)ix * Y + iy;
            const float4 zi = jacobi4(ldg4(dg, i), ldcg4(r, i));
            const bool own = ix >= a && ix < a1;
            if (it == 0) {
              pv = zi;
            } else {
              const float4 pp = ldcg4(pprev, i);
              pv = madd4(zi, beta, pp);
              if (own) st4(xb, i, madd4(ldcg4(xb, i), alpha, pp));
            }
            if (own) st4(pcur, i, pv);
          }
          *reinterpret_cast<float4*>(tile + t * P + kPad + iy) = pv;
        }
        __syncthreads();
        // Ap = A p on the chunk's rows, from the tile; p.Ap
        const int n2 = (a1 - a) * G4;
        for (int e = tid; e < n2; e += kThreads) {
          const int t = e / G4, iy = 4 * (e - t * G4);
          const size_t i = (size_t)(a + t) * Y + iy;
          const float* q = tile + (t + 1) * P + kPad + iy;
          const float4 pc = lds4(q);
          const float4 acc = stencil4(v, N, i, pc, lds4(q - P), lds4(q + P), q[-P - 1], q[-1], q[4],
                                      q[P + 4]);
          st4(Ap, i, acc);
          s_pap += dot4(pc, acc);
        }
        __syncthreads();  // the tile is rewritten by the next chunk
      }
      const float pAp = cluster_sum2(cl, s_pap, 0.0, kPAP, -1, red, slots, c).x;
      alpha = pAp > 0.f ? rz / pAp : 0.f;
      // r -= alpha Ap, z = D^-1 r; r.z and r.r
      s_rz = 0.0;
      s_rr = 0.0;
      for (int e = tid; e < cells; e += kThreads) {
        const int ix = row0 + e / G4, iy = 4 * (e % G4);
        const size_t i = (size_t)ix * Y + iy;
        const float4 ai = ldcg4(Ap, i);
        float4 ri = ldcg4(r, i);
        ri.x = __fsub_rn(ri.x, __fmul_rn(alpha, ai.x));
        ri.y = __fsub_rn(ri.y, __fmul_rn(alpha, ai.y));
        ri.z = __fsub_rn(ri.z, __fmul_rn(alpha, ai.z));
        ri.w = __fsub_rn(ri.w, __fmul_rn(alpha, ai.w));
        st4(r, i, ri);
        const float4 zi = jacobi4(ldg4(dg, i), ri);
        s_rz += dot4(ri, zi);
        s_rr += dot4(ri, ri);
      }
      s = cluster_sum2(cl, s_rz, s_rr, kRZ, kRR, red, slots, c);
      beta = rz > 0.f ? s.x / rz : 0.f;
      rz = s.x;
      rr = s.y;
      ++it;
      par ^= 1;
    }
    // the flush: the last iteration's x += alpha p
    if (it > 0) {
      const float* plast = par ? p0 : p1;  // the last iteration's p
      for (int e = tid; e < cells; e += kThreads) {
        const int ix = row0 + e / G4, iy = 4 * (e % G4);
        const size_t i = (size_t)ix * Y + iy;
        st4(xb, i, madd4(ldcg4(xb, i), alpha, ldcg4(plast, i)));
      }
    }
    if (j == 0 && tid == 0) iters[b] = it;
    cl.sync();  // this sample's reads done before the next one's writes
  }
  cl.sync();  // no block leaves while another may read its shared memory
}

cudaError_t prepare(int Y0, size_t* bytes) {
  *bytes = smem_bytes(Y0);
  if (*bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pcg_stencil_grid_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(pcg_stencil_grid_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(int clusters, int c, size_t bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The dynamic shared memory of one block for a true grid Y0 cells wide.
long long pcg_stencil_grid_cluster_smem_bytes(int Y0) { return Y0 > 0 ? (long long)smem_bytes(Y0) : -1; }

// How many clusters of c blocks, for a true grid Y0 cells wide, the card holds at once.
cudaError_t pcg_stencil_grid_cluster_max_clusters(int c, int Y0, int* out) {
  *out = 0;
  if (!valid_cluster(c) || Y0 <= 0) return cudaErrorInvalidValue;
  size_t bytes = 0;
  cudaError_t e = prepare(Y0, &bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, c, bytes, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(pcg_stencil_grid_cluster_kernel),
                                        &cfg);
}

// min(B, the card's capacity) clusters of c blocks solve the B samples, each
// cluster one sample at a time. next: one int, zero; scratch: (B, 4, X, Y) float32.
cudaError_t pcg_stencil_grid_cluster_launch(const float* vals2d, const float* F, const float* x0, float* x,
                                            int* iters, float* scratch, int* next, int B, int X, int Y,
                                            int X0, int Y0, int c, float tol2_scale, int maxiter,
                                            cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (!valid_cluster(c)) return cudaErrorInvalidValue;
  if (X0 < c || Y0 <= 0 || X0 > X || Y0 > Y || Y % 4 != 0 || maxiter < 0) return cudaErrorInvalidValue;
  size_t bytes = 0;
  cudaError_t e = prepare(Y0, &bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, c, bytes, stream, attr);
  int held = 0;
  e = cudaOccupancyMaxActiveClusters(&held, reinterpret_cast<const void*>(pcg_stencil_grid_cluster_kernel), &cfg);
  if (e != cudaSuccess) return e;
  if (held < 1) return cudaErrorLaunchOutOfResources;  // the card holds no such cluster
  cfg = launch_config(held < B ? held : B, c, bytes, stream, attr);
  e = cudaLaunchKernelEx(&cfg, pcg_stencil_grid_cluster_kernel, vals2d, F, x0, x, iters, scratch, next, B, X,
                         Y, X0, Y0, tol2_scale, maxiter);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
