// K5r: the shift-cost probe with each sample resident in a thread-block
// cluster, its state in the blocks' shared memory and registers.
//
// Replaces the TPU Pallas kernel `make_kernel` (scripts/diag_roll_cost.py:27,
// launched by `run` at :90) wherever one sample's state fits a cluster of at
// most 16 blocks (`shift_route` in experimental/shift_cost.py: res <= 12 on an
// H100). K5 (csrc/shift_cost.cu) computed it first, one block per tile of
// samples streamed through device memory; it stays built for larger meshes.
// K5r keeps K5's contract:
//
//   matvec    acc = v3 p + sum_{s != 3} v_s q_s over the 7 planes, in ascending
//             offset order, with q_s[i] = p[i + o_s] (zero outside [0, n)), or,
//             without shifts, q_s = p.
//   loop      x0 = 0, r0 = F, z = D^-1 r (D^-1 = 0 where the diagonal is 0),
//             p = z, then exactly `n_iters` CG iterations with alpha and beta 0
//             where their denominators are not positive; no convergence test.
//   rounding  every product and sum of the matvec and of the x, r, z and p
//             updates rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: no
//             FMA), in the plain version's order; the dots p.Ap and r.z summed
//             in float64 and rounded to float32.
//
// What bounds it on an H100. The work is ~24 f32 operations a node and
// iteration on 7 planes that never change: 64 samples at res8 are 0.15 ms of
// arithmetic at the card's peak. K5 streamed each tile's state (~8.8 MB, all
// tiles ~70 MB: past the 50 MB L2) through one SM per tile, four passes an
// iteration, 8 of 132 SMs busy. K5r reads the planes from device memory once
// per sample and keeps the state on chip, so an iteration costs its
// shared-memory traffic (14 words a node: the planes and the shifted p) and
// its two cluster-wide reductions, whose latency no other work hides.
//
// The design:
//   * A sample per cluster, resident. Block j of a cluster of c owns the nodes
//     [j L, min((j + 1) L, n)), L = ceil(n / c), thread t the nodes t, t + T, ...
//     (NPT of them, 1, 2 or 4, the fewest that 1,024 threads cover, 896 with
//     4, on the fewest warps T / 32 that hold them: no warp idles while another
//     works its last node). A thread keeps its nodes' 1/diag, r, p, x and Ap in
//     registers; the block keeps their 7 planes, p again with a halo of H =
//     max |o| nodes on either side (for the matvec's shifted reads) and the
//     neighbours' z on the halo in shared memory: 4 (8 L + 4 H) bytes and the
//     reduction's scratch (`k5r_bytes` in experimental/shift_cost.py counts the
//     same). Every chunk holds at least H nodes, so the halo lies in ranks
//     j - 1 and j + 1 only. The caller picks the number of clusters (`k5r_plan`:
//     as many as the card runs at once, at most B); cluster q takes samples q,
//     q + clusters, ... in turn (every sample takes the same n_iters
//     iterations, so a fixed order balances). Clusters never wait on each
//     other, so more clusters than the card holds are still correct.
//   * Two cluster-wide reductions an iteration, p.Ap and r.z, each a barrier
//     of the cluster: every block sums its threads' float64 partials in a fixed
//     order and stores its sum into a slot of every block of the cluster with
//     st.async, which signals the receiver's mbarrier as the bytes land; a
//     block waits on its own mbarrier for all c sums and adds them in block
//     order, so every block holds the same alpha and beta. This needs no
//     memory fence; a cluster barrier (barrier.cluster arrive.release /
//     wait.acquire) orders all of a thread's earlier writes, and costs more
//     (kFloor == 2 measures the reductions that way).
//   * The halo without remote reads. In the r.z pass each block also stores the
//     new z = D^-1 r of its first and last H nodes into the neighbours' halo
//     buffers with st.async, counted by the same mbarrier; after the wait a
//     block forms p = z + beta p_old on its halo from those z and its own copy
//     of the halo's old p, with the owner's operations in the owner's order, so
//     the same bits: p needs no exchange of its own. Without shifts no halo is
//     formed, but the z still travel, so both variants move the same bytes
//     between blocks.
//   * Hazards. A block stores into another block's slots or halo buffer only
//     after a wait that needs that block's next sum, which it sends only when
//     every one of its threads is past its reads of them. No block reads
//     another's shared memory. Within a block the two reductions' barriers
//     separate the matvec's reads of p from the next iteration's writes, so p
//     needs one buffer. One cluster barrier ends each sample, and one follows
//     the mbarriers' initialisation.
//   * kFloor: the same launch with the per-node work of the iterations
//     removed (no halo exchange), the reductions kept: what an iteration costs
//     before it does any arithmetic; 1 with the mbarrier exchange, 2 with each
//     reduction's exchange closed by a cluster barrier instead (and no st.async
//     at all, so no mbarrier counts bytes it never waits for).
//
// Plain C interface (built with nvcc, loaded with ctypes); the launch function
// returns a cudaError_t and refuses, without launching, a plan outside its
// contract (cluster size, number of clusters, a chunk narrower than the halo
// or over 3,584 nodes, more shared memory than a block can have).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDiag = 3;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into on Hopper
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kPAP = 0, kRZ = 1 };

// Shared memory: two mbarriers (16 bytes), the block's reduction scratch
// (kWarps doubles), the slots (2 kinds, c doubles), then 7 L planes, p with
// its halo (L + 2 H) and the neighbours' z on the left and right halo (H
// each). 1/diag, r, p, x and Ap stay in registers.
__host__ __device__ inline size_t head_bytes(int c) {
  return 16 + (size_t)kWarps * sizeof(double) + (size_t)2 * c * sizeof(double);
}

__host__ __device__ inline size_t smem_bytes(int L, int H, int c) {
  return head_bytes(c) + (size_t)(8LL * L + 4LL * H) * sizeof(float);
}

__host__ __device__ inline bool valid_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8 || c == 16;
}

struct Offsets {
  int o[7];  // flat offsets in ascending order, o[kDiag] == 0
};

// The launch's shape for a chunk of L nodes: NPT nodes a thread (1, 2 or 4,
// the fewest that 1,024 threads cover; 896 with 4, so that each thread has
// 72 registers) on the fewest warps that hold them.
__host__ __device__ constexpr int max_threads(int NPT) { return NPT == 4 ? 896 : kThreads; }
constexpr int kMaxNodes = 4 * max_threads(4);  // a block's nodes: 3,584
__host__ __device__ inline int nodes_per_thread(int L) {
  return L <= kThreads ? 1 : L <= 2 * kThreads ? 2 : 4;
}
__host__ __device__ inline int block_threads(int L) {
  const int per_warp = 32 * nodes_per_thread(L);
  return 32 * ((L + per_warp - 1) / per_warp);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of this block's shared-memory word `addr` in block `rank` of the cluster
__device__ __forceinline__ unsigned remote(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// stores into another block's shared memory, completing bytes on its mbarrier
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               :: "r"(addr), "l"(__double_as_longlong(v)), "r"(mbar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(mbar), "r"(1u) : "memory");
}

// the one arrival of a phase, with the bytes the phase waits for
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  }
}

// The block-wide float64 sum of part, in a fixed order (lanes, then warps).
// Every thread of warp 0 returns it; the leading barrier also orders the
// block's shared-memory writes before it.
__device__ __forceinline__ double block_sum(double part, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double w = warp_sum(part);
  if (lane == 0) red[warp] = w;
  __syncthreads();
  if (warp == 0) part = warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0);
  return part;
}

// One cluster-wide reduction of kind `kind` (its mbarrier `mbar`, its phase
// parity `parity`): the block's sum into slot (kind, j) of every block, then,
// once the phase's `bytes` have landed here, the c sums added in block order.
// Returns the sum rounded to float32, the same bits in every thread of every
// block. kBarrier: plain remote stores and a cluster barrier in place of
// st.async and the mbarrier.
template <bool kBarrier>
__device__ __forceinline__ float cluster_sum(double part, int kind, double* red, double* slots, unsigned mbar,
                                             unsigned parity, unsigned bytes, int c, int j) {
  part = block_sum(part, red);
  const int lane = threadIdx.x & 31;
  if (kBarrier) {
    cg::cluster_group cl = cg::this_cluster();
    if (threadIdx.x < 32 && lane < c) *cl.map_shared_rank(slots + kind * c + j, lane) = part;
    cl.sync();
  } else {
    if (threadIdx.x < 32 && lane < c) st_async(remote(smem_addr(slots + kind * c + j), lane), part,
                                               remote(mbar, lane));
    if (threadIdx.x == 0) mbar_expect(mbar, bytes);
    mbar_wait(mbar, parity);
  }
  const double* q = slots + kind * c;
  double t = 0.0;
  for (int b = 0; b < c; ++b) t += q[b];
  return (float)t;
}

// y + a * x with the product and the sum each rounded (never an FMA)
__device__ __forceinline__ float madd(float y, float a, float x) { return __fadd_rn(y, __fmul_rn(a, x)); }

// p on one node from its z, the owner's arithmetic: z on the first
// iteration, else z + beta p_old
__device__ __forceinline__ float new_p(float z, float p_old, float beta, bool first) {
  return first ? z : madd(z, beta, p_old);
}

template <bool kShift, int kFloor, int NPT>
__global__ void __launch_bounds__(max_threads(NPT), 1)
shift_cost_cluster_kernel(const float* __restrict__ vals,  // (B, n, 7)
                          const float* __restrict__ F,     // (n,)
                          float* __restrict__ x_out,       // (B, n)
                          int B, int n, int L, int H, Offsets offs, int n_iters) {
  extern __shared__ __align__(16) double smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), j = (int)cl.block_rank(), tid = threadIdx.x;
  const int T = (int)blockDim.x;           // NPT T >= L: thread t the nodes t, t + T, ...
  const unsigned mbar0 = smem_addr(smem);  // kPAP's; kRZ's 8 bytes on
  double* red = smem + 2;                   // (kWarps,)
  double* slots = red + kWarps;             // (2, c)
  float* v = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + head_bytes(c));  // (7, L) planes
  float* ps = v + 7 * L + H;  // p on the own nodes [0, L), the halo at [-H, 0) and [len, len + H)
  float* zl = v + 8 * L + 2 * H;  // (H,) z on the left halo, from rank j - 1
  float* zr = zl + H;             // (H,) z on the right halo, from rank j + 1
  const int start = j * L;
  const int len = min(L, n - start);  // this block's nodes, >= H
  const int cid = (int)blockIdx.x / c, clusters = (int)gridDim.x / c;
  // the bytes a phase of each kind waits for: c sums, and for r.z the z of H
  // nodes from each neighbour (the floor's iterations send none)
  const int nbrs = (j > 0) + (j < c - 1);
  const unsigned pap_bytes = 8u * c;
  const unsigned init_bytes = pap_bytes + 4u * H * nbrs;
  const unsigned rz_bytes = kFloor ? pap_bytes : init_bytes;
  unsigned pap_phase = 0, rz_phase = 0;

  if (tid == 0) {
    mbar_init(mbar0);
    mbar_init(mbar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();  // every block's mbarriers ready before any st.async reaches them

  // z of node l to the neighbours whose halo holds it (the first and last H
  // nodes of the chunk), completing bytes on their r.z mbarrier
  auto send_z = [&](int l, float z) {
    if (l < H && j > 0) st_async(remote(smem_addr(zr + l), j - 1), z, remote(mbar0 + 8, j - 1));
    if (l >= len - H && j < c - 1) st_async(remote(smem_addr(zl + l - (len - H)), j + 1), z, remote(mbar0 + 8, j + 1));
  };

  for (int b = cid; b < B; b += clusters) {
    // load: the planes (B, n, 7) de-interleaved into (7, L); x = 0, r = F,
    // z = D^-1 r to the neighbours' halo, r.z
    float inv[NPT], r[NPT], p[NPT], x[NPT], ap[NPT];
    const float* vb = vals + ((size_t)b * n + start) * 7;
    for (int e = tid; e < 7 * len; e += T) {
      const int l = e / 7;
      v[(e - 7 * l) * L + l] = __ldg(vb + e);
    }
    __syncthreads();
    double part = 0.0;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int l = tid + k * T;
      inv[k] = r[k] = p[k] = x[k] = 0.f;
      if (l >= len) continue;
      const float d = v[kDiag * L + l];
      inv[k] = d != 0.f ? __fdiv_rn(1.f, d) : 0.f;
      r[k] = __ldg(F + start + l);
      const float zi = __fmul_rn(inv[k], r[k]);
      part += (double)r[k] * (double)zi;
      if (kFloor != 2) send_z(l, zi);
    }
    float rz = cluster_sum<kFloor == 2>(part, kRZ, red, slots, mbar0 + 8, rz_phase++ & 1, init_bytes, c, j);
    float alpha = 0.f, beta = 0.f;

    for (int it = 0; it < n_iters; ++it) {
      const bool first = it == 0;
      part = 0.0;
      if (!kFloor) {
        // p on this block's nodes (x += alpha_prev p_prev, deferred from the
        // last iteration to where p_prev is replaced) and, with shifts, on
        // the halo from the neighbours' z and the halo's old p: thread t < 2 H
        // the halo node t (left for t < H, right for the rest; zero outside
        // [0, n))
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const int l = tid + k * T;
          if (l >= len) continue;
          const float po = p[k];
          p[k] = new_p(__fmul_rn(inv[k], r[k]), po, beta, first);
          if (!first) x[k] = madd(x[k], alpha, po);
          if (kShift) ps[l] = p[k];
        }
        if (kShift && tid < 2 * H) {
          const bool left = tid < H;
          const int h = left ? tid - H : len + (tid - H);  // the halo node's index in ps
          const bool live = left ? j > 0 : j < c - 1;      // else outside [0, n)
          ps[h] = live ? new_p(left ? zl[tid] : zr[tid - H], ps[h], beta, first) : 0.f;
        }
      }
      if (kShift) __syncthreads();
      if (!kFloor) {
        // Ap = A p on this block's nodes; p.Ap
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const int l = tid + k * T;
          if (l >= len) continue;
          const float pl = p[k];
          float acc = __fmul_rn(v[kDiag * L + l], pl);
#pragma unroll
          for (int q = 0; q < 7; ++q) {
            if (q == kDiag) continue;
            acc = madd(acc, v[q * L + l], kShift ? ps[l + offs.o[q]] : pl);
          }
          ap[k] = acc;
          part += (double)pl * (double)acc;
        }
      }
      const float pap = cluster_sum<kFloor == 2>(part, kPAP, red, slots, mbar0, pap_phase++ & 1, pap_bytes, c, j);
      // r -= alpha Ap, z = D^-1 r (its edges to the neighbours' halo); r.z
      alpha = pap > 0.f ? __fdiv_rn(rz, pap) : 0.f;
      part = 0.0;
      if (!kFloor) {
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const int l = tid + k * T;
          if (l >= len) continue;
          r[k] = __fsub_rn(r[k], __fmul_rn(alpha, ap[k]));
          const float zi = __fmul_rn(inv[k], r[k]);
          part += (double)r[k] * (double)zi;
          send_z(l, zi);
        }
      }
      const float rz_new = cluster_sum<kFloor == 2>(part, kRZ, red, slots, mbar0 + 8, rz_phase++ & 1, rz_bytes, c, j);
      beta = rz > 0.f ? __fdiv_rn(rz_new, rz) : 0.f;
      rz = rz_new;
    }
    // the last iteration's x += alpha p, then x out
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int l = tid + k * T;
      if (l >= len) continue;
      x_out[(size_t)b * n + start + l] = n_iters > 0 && !kFloor ? madd(x[k], alpha, p[k]) : x[k];
    }
    cl.sync();  // every block past this sample's slots and halos before the next sample's stores
  }
}

// The function's attributes, set once per device: the card's opt-in shared
// memory as the most a launch may ask for, and clusters of 16 allowed.
template <bool kShift, int kFloor, int NPT>
cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(shift_cost_cluster_kernel<kShift, kFloor, NPT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(shift_cost_cluster_kernel<kShift, kFloor, NPT>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return e;
}

cudaLaunchConfig_t launch_config(int clusters, int c, int threads, size_t bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * c), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
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

// How many clusters of c blocks of this instance the card holds at once.
template <bool kShift, int kFloor, int NPT>
cudaError_t capacity(int c, int threads, size_t bytes, int* out) {
  *out = 0;
  cudaError_t e = prepare<kShift, kFloor, NPT>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, c, threads, bytes, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(shift_cost_cluster_kernel<kShift, kFloor, NPT>), &cfg);
}

template <bool kShift, int kFloor, int NPT>
cudaError_t launch(const float* vals, const float* F, float* x, int B, int n, int L, int H,
                   const Offsets& offs, int c, int clusters, int n_iters, cudaStream_t stream) {
  cudaError_t e = prepare<kShift, kFloor, NPT>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(clusters, c, block_threads(L), smem_bytes(L, H, c), stream, attr);
  e = cudaLaunchKernelEx(&cfg, shift_cost_cluster_kernel<kShift, kFloor, NPT>, vals, F, x, B, n, L, H, offs,
                         n_iters);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kShift, int kFloor>
cudaError_t launch_npt(const float* vals, const float* F, float* x, int B, int n, int L, int H,
                       const Offsets& offs, int c, int clusters, int n_iters, cudaStream_t stream) {
  switch (nodes_per_thread(L)) {
    case 1: return launch<kShift, kFloor, 1>(vals, F, x, B, n, L, H, offs, c, clusters, n_iters, stream);
    case 2: return launch<kShift, kFloor, 2>(vals, F, x, B, n, L, H, offs, c, clusters, n_iters, stream);
    default: return launch<kShift, kFloor, 4>(vals, F, x, B, n, L, H, offs, c, clusters, n_iters, stream);
  }
}

// The contract's checks; fills L and H.
cudaError_t check_plan(int n, const int* offsets, int c, Offsets* offs, int* L, int* H) {
  if (n <= 0 || !valid_cluster(c)) return cudaErrorInvalidValue;
  for (int k = 0; k < 7; ++k) offs->o[k] = offsets[k];
  if (offs->o[kDiag] != 0) return cudaErrorInvalidValue;
  for (int k = 1; k < 7; ++k)
    if (offs->o[k] < offs->o[k - 1]) return cudaErrorInvalidValue;
  *L = (n + c - 1) / c;
  *H = -offs->o[0] > offs->o[6] ? -offs->o[0] : offs->o[6];
  if (*L > kMaxNodes) return cudaErrorInvalidValue;                         // at most 4 nodes a thread
  if (n - (c - 1) * *L < (*H > 0 ? *H : 1)) return cudaErrorInvalidValue;  // every chunk holds the halo
  if (2 * *H > block_threads(*L)) return cudaErrorInvalidValue;             // a thread for each halo node
  if (smem_bytes(*L, *H, c) > kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The dynamic shared memory of one block: n nodes on clusters of c, halo H.
long long shift_cost_cluster_smem_bytes(int n, int c, int H) {
  if (n <= 0 || c <= 0 || H < 0) return -1;
  return (long long)smem_bytes((n + c - 1) / c, H, c);
}

// The threads of one block for n nodes on clusters of c.
int shift_cost_cluster_threads(int n, int c) { return n > 0 && c > 0 ? block_threads((n + c - 1) / c) : -1; }

// The shared memory a block of CUDA device `device` can opt in to.
cudaError_t shift_cost_cluster_smem_optin(int device, int* out) {
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// How many clusters of c blocks (one sample, n nodes, halo H) the card holds
// at once; 0 where such a block does not fit.
cudaError_t shift_cost_cluster_max_clusters(int n, int c, int H, int* out) {
  *out = 0;
  if (n <= 0 || !valid_cluster(c) || H < 0) return cudaErrorInvalidValue;
  const int L = (n + c - 1) / c;
  const size_t bytes = smem_bytes(L, H, c);
  if (bytes > kMaxSmem || L > kMaxNodes) return cudaSuccess;
  const int threads = block_threads(L);
  switch (nodes_per_thread(L)) {
    case 1: return capacity<true, 0, 1>(c, threads, bytes, out);
    case 2: return capacity<true, 0, 2>(c, threads, bytes, out);
    default: return capacity<true, 0, 4>(c, threads, bytes, out);
  }
}

// `clusters` clusters of c blocks (1 to B, `k5r_plan`'s count) run the B
// samples, one at a time per cluster. floor_only: 0, or the reductions
// without the per-node work, 1 with the mbarrier exchange, 2 with cluster
// barriers.
cudaError_t shift_cost_cluster_launch(const float* vals, const float* F, float* x, int B, int n,
                                      const int* offsets, int c, int clusters, int n_iters, int use_shifts,
                                      int floor_only, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (n_iters < 0 || clusters < 1 || clusters > B) return cudaErrorInvalidValue;
  Offsets offs;
  int L = 0, H = 0;
  cudaError_t e = check_plan(n, offsets, c, &offs, &L, &H);
  if (e != cudaSuccess) return e;
#define K5R_LAUNCH(SH_, FL_) launch_npt<SH_, FL_>(vals, F, x, B, n, L, H, offs, c, clusters, n_iters, stream)
  if (floor_only == 1) return K5R_LAUNCH(true, 1);
  if (floor_only == 2) return K5R_LAUNCH(true, 2);
  if (floor_only != 0) return cudaErrorInvalidValue;
  return use_shifts ? K5R_LAUNCH(true, 0) : K5R_LAUNCH(false, 0);
#undef K5R_LAUNCH
}

}  // extern "C"
