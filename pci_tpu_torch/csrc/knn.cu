// Exact k-nearest neighbours: for each query, the k keys with the least
// squared distance, ascending, ties to the lower key index.
//
// Replaces pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells on the
// transformer's self-kNN (65,536 x 65,536, k = 16).  The TPU kernel is
// approximate (Morton-sorted chunks, a few ranked chunks a query tile,
// bucket winners; recall about 0.97); this kernel computes the exact
// function that pci_tpu.ops.knn(..., exact=True) and the port's plain knn
// define, with distances (dx*dx + dy*dy) + dz*dz rounded op by op
// (common.cuh sqdist3), so indices and distances equal the plain version's
// bit for bit.  It takes queries and keys separately, so it also serves a
// cross-cloud kNN.
//
// It also replaces pci_tpu/ops/pallas_kernels/knn_tpu.py:knn_pallas, the
// flat kNN with an optional key prefix valid_n [B] (the chamfer loss's
// nearest neighbour, k = 1, and ops.knn with valid_n): keys at or after valid_n
// are never scanned, and when valid_n < k the surplus slots hold the
// sentinel distance 1e30 with the indices valid_n, valid_n + 1, ..., as a
// stable sort of the plain version's masked distances orders them.
//
// What bounds it on the H100: operations.  An exhaustive scan is 8 flops
// per (query, key) pair, 3.4e10 at 65,536 x 65,536, about 0.5 ms at the
// card's 67 TFLOP/s fp32; the bytes (786 KB of keys) are nothing.
//
// k >= 2 (knn_kernel): one thread a query, the keys streamed through shared
// memory in index order as float4 tiles (one broadcast load a key for the
// whole block), and the query's sorted top list in registers (fully
// unrolled, so no local memory).  A key enters only when strictly nearer
// than the current k-th, so among equal distances the earlier (lower) index
// stays ahead, as a stable sort keeps it.  Above k = 64 (up to knn_pallas's
// 128) the list no longer fits in registers: it lives in local memory
// (L1-cached) and the insertion is a loop with the same compares in the
// same order.  csrc/knn_cells.cu serves the large self kNNs.
//
// k = 1 (nearest_kernel, the chamfer's two searches a training step and an
// eval window: 2 x 16,000 queries over 16,000 keys at a step, 5.1e8 pairs):
//   - a thread-block cluster of C CTAs (C <= 8, the portable size, chosen at
//     launch so that the grid holds about NN_FILL CTAs an SM while a rank
//     keeps NN_MIN_RANGE keys) takes a tile of NN_QTILE queries; CTA `rank`
//     scans the rank-th contiguous range of the valid keys;
//   - the range streams through a two-deep cp.async ring of NN_TK keys,
//     each tile packed as (x, y, z, |k|^2) with its largest |k|^2;
//   - the keys sit in registers, the queries in shared memory: each lane
//     holds NN_KL keys of a block of 32 NN_KL, and the warp walks its 32
//     queries NN_QS at a time, one broadcast load of (-2 q, the query's
//     limit) feeding NN_KL pairs a lane.  A pair costs three FMAs
//     (common.cuh mark_dot) and a min;
//   - a query whose least mark_dot over the block falls below its limit on
//     some lane (a warp vote, so the rare hot step is warp-uniform and no
//     lane waits on another's query) has its marked keys measured by
//     sqdist3; two warp min reductions (redux) give the least (distance,
//     index) of them, folded into the query's minimum, one 64-bit integer
//     (distance bits, index) in shared memory that only the owning warp
//     writes.  A distance is never negative, so the integer minimum is the
//     exact scan's (least distance, lowest index).  The limits
//     (common.cuh mark_limit of the minimum, with the tile's largest
//     |k|^2) are refreshed after each block, one query a lane;
//   - after cluster.sync() each rank merges NN_QTILE / C of the tile's
//     queries: the least of every rank's integer through distributed
//     shared memory, which is the range-order merge that keeps strictly
//     smaller distances (ties on the lower index).  One launch, no global
//     scratch and no memset.
//   The first form of this kernel gave each thread 2 queries and built a
//   32-key mark mask a query (one broadcast LDS.128 a key, three FMAs, a
//   compare and the mask's bit a pair): no faster at a training step, its
//   compares, selects and shared loads outweighing the FMAs (PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tf32.cuh"  // cp.async

namespace cg = cooperative_groups;

#define PCI_KNN_TILE 1024

template <int KM>
__global__ void __launch_bounds__(128)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           const int* __restrict__ valid_n, float* __restrict__ out_d,
           long long* __restrict__ out_i, int N, int S, int k) {
  __shared__ float4 keys[PCI_KNN_TILE];
  const int b = blockIdx.y;
  const int Nb = valid_n ? max(0, min(valid_n[b], N)) : N;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int ss = min(s, S - 1);
  const float* QX = query + ((size_t)b * S + ss) * 3;
  const float qx = QX[0], qy = QX[1], qz = QX[2];
  const float* P = points + (size_t)b * N * 3;

  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = 0x7fffffff;
  }
  for (int base = 0; base < Nb; base += PCI_KNN_TILE) {
    const int n = min(PCI_KNN_TILE, Nb - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* p = P + (size_t)(base + t) * 3;
      keys[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4 p = keys[t];
      const float d = sqdist3(p.x, p.y, p.z, qx, qy, qz);
      if (d < bd[KM - 1]) {
        // bubble the new pair into place by (distance, index); every held
        // index is lower than base + t, so it goes after equal distances
        float cd = d;
        int ci = base + t;
#define PCI_KNN_STEP                                          \
  if (cd < bd[i] || (cd == bd[i] && ci < bi[i])) {            \
    const float td = bd[i];                                   \
    const int ti = bi[i];                                     \
    bd[i] = cd;                                               \
    bi[i] = ci;                                               \
    cd = td;                                                  \
    ci = ti;                                                  \
  }
        if constexpr (KM <= 64) {
#pragma unroll
          for (int i = 0; i < KM; ++i) { PCI_KNN_STEP }
        } else {
#pragma unroll 1
          for (int i = 0; i < KM; ++i) { PCI_KNN_STEP }
        }
#undef PCI_KNN_STEP
      }
    }
  }
  if (s < S) {
    float* od = out_d + ((size_t)b * S + s) * k;
    long long* oi = out_i + ((size_t)b * S + s) * k;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i < k) {
        // slots past the prefix: the masked keys in index order
        od[i] = i < Nb ? bd[i] : 1e30f;
        oi[i] = i < Nb ? bi[i] : i;
      }
    }
  }
}

template <int KM>
static cudaError_t launch_knn(const float* q, const float* p, const int* vn,
                              float* od, long long* oi, int B, int N, int S,
                              int k, cudaStream_t stream) {
  dim3 grid((S + 127) / 128, B);
  knn_kernel<KM><<<grid, 128, 0, stream>>>(q, p, vn, od, oi, N, S, k);
  return cudaGetLastError();
}

// ---- k = 1: the nearest neighbour on a thread-block cluster ---------------

#define NN_WARPS 4                       // warps a CTA
#define NN_THREADS (NN_WARPS * 32)
#define NN_QTILE (NN_WARPS * 32)         // queries a cluster: 32 a warp, one owned a lane
#define NN_KL 8                          // keys a lane holds: a block of 32 NN_KL keys
#define NN_BLOCK (32 * NN_KL)
#define NN_QS 4                          // queries a warp takes a step
#define NN_TK 1024                       // keys a ring stage (whole blocks)
#define NN_MAX_C 8                       // CTAs a cluster at most (portable)
#define NN_MIN_RANGE 1024                // keys a rank at least, where C > 1
#define NN_FILL 3                        // CTAs an SM the grid C is chosen to reach

struct NearestParams {
  const float* query;             // [B][S][3]
  const float* points;            // [B][N][3]
  const int* valid_n;             // [B] or null
  float* out_d;                   // [B][S]
  long long* out_i;               // [B][S]
  unsigned long long* marked;     // [1]: keys measured exactly (STATS), or null
  unsigned long long* stamps;     // [grid][2]: a CTA's start, end ns (STATS), or null
  int N, S;
};

// Keys [k0, k0 + kn) of P (xyz interleaved) into `dst` as one cp.async
// group, 16 bytes a copy where the rows allow it.
__device__ __forceinline__ void nn_stage(const float* __restrict__ P, int k0, int kn,
                                         float* dst) {
  const float* src = P + (size_t)k0 * 3;
  const int n = kn * 3;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += NN_THREADS) cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = 4 * n4 + threadIdx.x; e < n; e += NN_THREADS) cp_async4(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += NN_THREADS) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The least of v[0..n) by a pairwise tree (depth log2 n).
template <int n>
__device__ __forceinline__ float min_tree(const float (&v)[n]) {
  float t[n];
#pragma unroll
  for (int j = 0; j < n; ++j) t[j] = v[j];
#pragma unroll
  for (int w = n / 2; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fminf(t[j], t[j + w]);
  return t[0];
}

// A (distance, index) pair as one integer: a distance is never negative,
// so the integers order as (distance, index) pairs, ties to the lower index.
__device__ __forceinline__ unsigned long long nn_pack(float d, int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)i;
}

// One query's hot step (some lane's least mark_dot below the query's
// limit): each lane measures its marked keys by sqdist3, the warp takes the
// least (distance, index) of them by two 32-bit min reductions (distance
// bits, then the index among the lanes at that distance), and lane 0 folds
// it into the query's minimum `qb` (only this warp touches its queries).
// Returns the keys measured (STATS).
template <bool STATS>
__device__ __forceinline__ int nn_hot(const float4 (&kk)[NN_KL], const float (&a)[NN_KL],
                                      float4 Q, unsigned long long* qb, int j0) {
  const float qx = -0.5f * Q.x, qy = -0.5f * Q.y, qz = -0.5f * Q.z;  // exact: q2 = -2 q
  float cd = CUDART_INF_F;
  int ci = 0, measured = 0;
#pragma unroll
  for (int j = 0; j < NN_KL; ++j) {
    if (a[j] < Q.w) {
      const float d = sqdist3(kk[j].x, kk[j].y, kk[j].z, qx, qy, qz);
      if (STATS) ++measured;
      if (d < cd) {  // j ascending: the lane's keys in index order
        cd = d;
        ci = j0 + 32 * j;
      }
    }
  }
  const unsigned db = __float_as_uint(cd);  // a distance is never negative
  const unsigned dmin = __reduce_min_sync(0xffffffffu, db);
  const unsigned imin = __reduce_min_sync(0xffffffffu, db == dmin ? (unsigned)ci : 0xffffffffu);
  const unsigned long long v = ((unsigned long long)dmin << 32) | imin;
  if ((threadIdx.x & 31) == 0 && __uint_as_float(dmin) < CUDART_INF_F && v < *qb) *qb = v;
  return measured;
}

// A CTA takes one tile of NN_QTILE queries and its rank's key range (see
// the file's head).  Shared state a query: qs = (-2 q, its mark limit), qb
// = its minimum as nn_pack; warp w owns queries 32 w .. 32 w + 31 and only
// it touches them, lane l keeping query 32 w + l's |q|^2 and tile r2 in
// registers and refreshing its limit after each block.
template <bool STATS>
__global__ void __launch_bounds__(NN_THREADS)
nearest_kernel(const __grid_constant__ NearestParams p) {
  __shared__ __align__(16) float raw[2][3 * NN_TK];  // the ring, xyz rows
  __shared__ float4 kp[NN_TK];                      // the tile packed (x, y, z, |k|^2)
  __shared__ float4 qs[NN_QTILE];
  __shared__ unsigned long long qb[NN_QTILE];
  __shared__ float wmax[NN_WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  unsigned long long t_start = 0;
  if (STATS) t_start = global_ns();
  const int b = blockIdx.y, tile = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, S = p.S;
  const int Nb = p.valid_n ? max(0, min(p.valid_n[b], N)) : N;
  // this rank's keys [a, e): contiguous ranges in rank order, 4-key aligned
  const int chunk = round_up((Nb + C - 1) / C, 4);
  const int a = min(rank * chunk, Nb), e = min(a + chunk, Nb);
  const float* P = p.points + (size_t)b * N * 3;
  // this lane's own query: its coordinates and state
  float qq, qn, r2 = 0.f;
  {
    const int s = min(tile * NN_QTILE + tid, S - 1);
    const float* Q = p.query + ((size_t)b * S + s) * 3;
    const float qx = Q[0], qy = Q[1], qz = Q[2];
    qq = (qx * qx + qy * qy) + qz * qz;
    qn = sqrtf(qq);
    qs[tid] = make_float4(-2.f * qx, -2.f * qy, -2.f * qz, CUDART_INF_F);
    qb[tid] = nn_pack(CUDART_INF_F, -1);
  }
  unsigned long long measured = 0;
  const int tiles = (e - a + NN_TK - 1) / NN_TK;
  if (tiles > 0) nn_stage(P, a, min(NN_TK, e - a), raw[0]);
  for (int m = 0; m < tiles; ++m) {
    cp_async_wait<0>();
    __syncthreads();  // tile m is in; every warp is done with tile m - 1
    const int k0 = a + m * NN_TK, tn = min(NN_TK, e - k0);
    if (m + 1 < tiles) nn_stage(P, k0 + NN_TK, min(NN_TK, e - k0 - NN_TK), raw[(m + 1) & 1]);
    const float* kt = raw[m & 1];
    float mx = 0.f;
    for (int t = tid; t < tn; t += NN_THREADS) {
      const float x = kt[3 * t], y = kt[3 * t + 1], z = kt[3 * t + 2];
      const float kk = (x * x + y * y) + z * z;
      kp[t] = make_float4(x, y, z, kk);
      mx = fmaxf(mx, kk);
    }
    // keys past the tile's end: |k|^2 = inf, never marked
    for (int t = tn + tid; t < round_up(tn, NN_BLOCK); t += NN_THREADS)
      kp[t] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();  // packed
    float km = wmax[0];
#pragma unroll
    for (int w = 1; w < NN_WARPS; ++w) km = fmaxf(km, wmax[w]);
    const float rk = sqrtf(km) + qn;
    r2 = rk * rk;
    for (int blk = 0; blk < tn; blk += NN_BLOCK) {
      // this lane's query's limit, from its minimum after the last block
      qs[tid].w = mark_limit(__uint_as_float((unsigned)(qb[tid] >> 32)), qq, r2);
      __syncwarp();
      float4 kk[NN_KL];
#pragma unroll
      for (int j = 0; j < NN_KL; ++j) kk[j] = kp[blk + 32 * j + lane];
      const int j0 = k0 + blk + lane;
      for (int i = 0; i < 32; i += NN_QS) {  // NN_QS queries a step, in flight together
        float4 Q[NN_QS];
        float av[NN_QS][NN_KL], mn[NN_QS];
#pragma unroll
        for (int u = 0; u < NN_QS; ++u) {
          Q[u] = qs[32 * warp + i + u];  // one broadcast load feeds NN_KL pairs a lane
#pragma unroll
          for (int j = 0; j < NN_KL; ++j) av[u][j] = mark_dot(kk[j], Q[u].x, Q[u].y, Q[u].z);
          mn[u] = min_tree<NN_KL>(av[u]);
        }
#pragma unroll
        for (int u = 0; u < NN_QS; ++u)
          if (__any_sync(0xffffffffu, mn[u] < Q[u].w))
            measured += nn_hot<STATS>(kk, av[u], Q[u], &qb[32 * warp + i + u], j0);
      }
      __syncwarp();  // the block's minima are in before the limits are refreshed
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // every rank's minima are in its shared memory
  // this rank's share of the tile's queries, merged over the ranks: the
  // least (distance, index) over them, which is the range-order merge
  // keeping strictly smaller distances (ties on the lower index)
  const int per = NN_QTILE / C;
  for (int r = tid; r < per; r += NN_THREADS) {
    const int qi = rank * per + r;
    const int s = tile * NN_QTILE + qi;
    unsigned long long v = ~0ull;
    for (int o = 0; o < C; ++o) v = min(v, cluster.map_shared_rank(qb, o)[qi]);
    if (s < S) {
      // no valid key: the sentinel and index 0, as a stable sort of the
      // plain version's masked distances gives
      p.out_d[(size_t)b * S + s] = Nb > 0 ? __uint_as_float((unsigned)(v >> 32)) : 1e30f;
      p.out_i[(size_t)b * S + s] = Nb > 0 ? (int)(unsigned)v : 0;
    }
  }
  if (STATS) {
#pragma unroll
    for (int o = 16; o; o >>= 1) measured += __shfl_xor_sync(0xffffffffu, measured, o);
    if (lane == 0 && measured) atomicAdd(p.marked, measured);
  }
  cluster.sync();  // no rank leaves while another may read its shared memory
  if (STATS && tid == 0) {
    unsigned long long* st = p.stamps + 2 * ((size_t)b * gridDim.x + blockIdx.x);
    st[0] = t_start;
    st[1] = global_ns();
  }
}

// The launch's cluster size: the least power of two C <= NN_MAX_C whose
// grid (B x query tiles x C CTAs) reaches NN_FILL CTAs an SM, keeping at
// least NN_MIN_RANGE keys a rank.
static int nearest_cluster(int B, int N, int S, int sms) {
  const long long tiles = (long long)B * ((S + NN_QTILE - 1) / NN_QTILE);
  int C = 1;
  while (C < NN_MAX_C && tiles * C < (long long)NN_FILL * sms && N / (2 * C) >= NN_MIN_RANGE)
    C *= 2;
  return C;
}

static cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

static cudaError_t launch_nearest(const NearestParams& p, int B, cudaStream_t stream) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int C = nearest_cluster(B, p.N, p.S, sms);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(((p.S + NN_QTILE - 1) / NN_QTILE) * C, B);
  cfg.blockDim = dim3(NN_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (p.marked || p.stamps) {
    if (!(p.marked && p.stamps)) return cudaErrorInvalidValue;
    return cudaLaunchKernelEx(&cfg, nearest_kernel<true>, p);
  }
  return cudaLaunchKernelEx(&cfg, nearest_kernel<false>, p);
}

// query [B, S, 3], points [B, N, 3] fp32, valid_n [B] int32 or null ->
// out_d [B, S, k] fp32, out_i [B, S, k] int64; 2 <= k <= min(128, N).
// k = 1 is pci_nearest.
extern "C" int pci_knn(const void* query, const void* points,
                       const void* valid_n, void* out_d, void* out_i, int B,
                       int N, int S, int k, void* stream) {
  if (k < 2 || k > 128 || k > N || S < 1) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  const int* vn = static_cast<const int*>(valid_n);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 4) return (int)launch_knn<4>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 8) return (int)launch_knn<8>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 16) return (int)launch_knn<16>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 32) return (int)launch_knn<32>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 64) return (int)launch_knn<64>(q, p, vn, od, oi, B, N, S, k, st);
  return (int)launch_knn<128>(q, p, vn, od, oi, B, N, S, k, st);
}

// The k = 1 kNN, with or without its measurement outputs: marked [1] uint64 (zeroed)
// gains the pairs the mark sent to the exact test, stamps [grid][2] uint64
// each CTA's start and end (%globaltimer ns); both or neither.
extern "C" int pci_nearest(const void* query, const void* points, const void* valid_n,
                           void* out_d, void* out_i, int B, int N, int S, void* marked,
                           void* stamps, void* stream) {
  if (N < 1 || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const NearestParams np = {static_cast<const float*>(query), static_cast<const float*>(points),
                            static_cast<const int*>(valid_n), static_cast<float*>(out_d),
                            static_cast<long long*>(out_i),
                            static_cast<unsigned long long*>(marked),
                            static_cast<unsigned long long*>(stamps), N, S};
  cudaError_t e = launch_nearest(np, B, static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The k = 1 launch's shape: out = {C, CTAs in the grid, the SMs' count}.
extern "C" int pci_nearest_shape(int B, int N, int S, int* out) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  out[0] = nearest_cluster(B, N, S, sms);
  out[1] = B * ((S + NN_QTILE - 1) / NN_QTILE) * out[0];
  out[2] = sms;
  return 0;
}

// The k = 1 kernel's resources (common.cuh's kernel_attrs).
extern "C" int pci_nearest_attrs(int* out) {
  return kernel_attrs(nearest_kernel<false>, 0, out, NN_THREADS);
}
