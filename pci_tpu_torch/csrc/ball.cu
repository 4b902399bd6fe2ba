// Multi-scale ball query: for each query and each (radius, K) scale, the
// first K keys in radius IN INDEX ORDER, all scales in one scan of the keys.
//
// Replaces pci_tpu/ops/pallas_kernels/ball_tpu.py:ball_query_pallas plus
// its finish_ball_idx.  Semantics are those of pci_tpu/ops/ball.py:
// in radius means (dx*dx + dy*dy) + dz*dz <= r*r in fp32 (every product
// and sum rounded on its own, csrc/common.cuh sqdist3); a never-filled
// slot repeats the first hit; a query with no hit at all holds N - 1 in
// every slot (the JAX package's clip of its sentinel).
//
// What bounds it on the H100: neither bytes (the keys of PointNet++'s sa1,
// 65,536 points, are 786 KB; the indices out are 393 KB) nor operations
// (about ten per key scanned: the mean query stops within the first few
// thousand keys), but the scan's tail.  The TPU kernel counted in-radius
// prefixes with a [TK, TK] triangular matmul on its matrix unit; here a
// warp's ballot and popc give the prefix in two instructions
// (common.cuh ball_place).  sa1's queries are FPS picks, the cloud's
// extremes: a few never hold K keys in a ball and walk every key.  On one
// warp that is N / 32 dependent steps, and a block that waits for its
// slowest query keeps its SM waiting.  So the scan runs in two phases:
//   1. ball_prefix_kernel: one warp a query over the first BALL_PREFIX
//      keys, staged once per block of 8 queries in shared memory; each
//      warp stops as soon as its own query is full (the block has no
//      later tile to wait for).  Most queries fill here.  A query that is
//      not full, when keys remain, is appended to a list (a device
//      counter), with its hit counts;
//   2. ball_task_kernel (launched only when N > BALL_PREFIX): persistent
//      blocks whose warps take tasks (listed query, key range of
//      BALL_RANGE keys) from a device counter, so the few long scans
//      spread over every SM instead of serialising on one warp each.  A
//      task stages its range through the warp's own two-deep cp.async
//      ring, places its own hits per scale by ballot and popc, at most
//      the K - (prefix hits) that any merge can take from one range, and
//      stops once its range holds that many for every scale.  The warp
//      that finishes a query's last task (an arrival counter) merges: per
//      scale the prefix hits, then each range's in range order until K,
//      then the padding.  Exact: a range's first K - c hits are all that
//      the first K of the whole scan can hold from it.
// Nothing of size S x N is formed.
#include <cstring>

#include "mma_tf32.cuh"  // cp.async

#define PCI_BALL_MAX_SCALES 8
#define BALL_PREFIX 2048  // keys the first phase scans, one tile
#define BALL_RANGE 1024   // keys a task
#define BALL_SUB 256      // keys a stage of a task's ring
#define BALL_TASK_WARPS 4
#define BALL_INFO (2 + PCI_BALL_MAX_SCALES)  // a listed query: row, arrivals, prefix hits
#define BALL_STAMPS 4

struct BallScales {
  int n;
  int sumK;
  float r2[PCI_BALL_MAX_SCALES];
  int K[PCI_BALL_MAX_SCALES];
  int koff[PCI_BALL_MAX_SCALES];       // scale s's first slot in a task's hit record
  long long off[PCI_BALL_MAX_SCALES];  // scale s's [B, S, K_s] block in `out`
};

// The scratch of one launch (int32): [0] listed queries, [1] the task
// counter, then info [B * S][BALL_INFO], then a record a task, [B * S]
// [nranges][n + sumK]: the range's hit counts a scale (capped at what the
// merge can take), then its hits, scale s's at koff[s].
struct BallScratch {
  int* ctr;
  int* info;
  int* rec;
  int nranges;
};

__global__ void __launch_bounds__(256)
ball_prefix_kernel(const float* __restrict__ xyz, const float* __restrict__ qxyz,
                   long long* __restrict__ out, BallScales sc, BallScratch bs, int N, int S,
                   unsigned long long* __restrict__ stamps) {
  __shared__ float4 keys[BALL_PREFIX];
  const unsigned long long t_start = stamps ? global_ns() : 0ull;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = q < S;
  const int qq = min(q, S - 1);
  const float* X = xyz + (size_t)b * N * 3;
  const float* QX = qxyz + ((size_t)b * S + qq) * 3;
  const float qx = QX[0], qy = QX[1], qz = QX[2];
  const int n = min(BALL_PREFIX, N);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float* p = X + (size_t)t * 3;
    keys[t] = make_float4(p[0], p[1], p[2], 0.f);
  }
  __syncthreads();

  int count[PCI_BALL_MAX_SCALES];
  long long* id[PCI_BALL_MAX_SCALES];
#pragma unroll
  for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
    count[s] = 0;
    id[s] = out + (s < sc.n ? sc.off[s] + ((size_t)b * S + qq) * sc.K[s] : 0);
  }
  bool done = !active;
  for (int t0 = 0; t0 < n && !done; t0 += 32) {  // warp-uniform exit
    const int t = t0 + lane;
    float d = CUDART_INF_F;
    if (t < n) {
      const float4 p = keys[t];
      d = sqdist3(p.x, p.y, p.z, qx, qy, qz);
    }
    done = true;
#pragma unroll
    for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
      if (s < sc.n) {
        count[s] = ball_place(t < n && d <= sc.r2[s], t, count[s], sc.K[s], id[s]);
        done = done && count[s] >= sc.K[s];
      }
    }
  }
  if (active && !done) {
    if (N <= BALL_PREFIX) {
#pragma unroll
      for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s)
        if (s < sc.n) ball_pad(id[s], count[s], sc.K[s], (long long)(N - 1));
    } else {  // the rest of its keys as tasks
      int u = 0;
      if (lane == 0) u = atomicAdd(bs.ctr, 1);
      u = __shfl_sync(0xffffffffu, u, 0);
      int* info = bs.info + (size_t)u * BALL_INFO;
      if (lane == 0) {
        info[0] = b * S + q;
        info[1] = 0;
      }
      if (lane < sc.n) {
#pragma unroll
        for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s)
          if (s == lane) info[2 + s] = min(count[s], sc.K[s]);
      }
    }
  }
  if (stamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long* st = stamps + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * BALL_STAMPS;
      st[0] = t_start;
      st[1] = global_ns();
    }
  }
}

// Keys [k0, k0 + kn) of X (xyz interleaved) into the warp's ring stage
// `dst` as one cp.async group, 16 bytes a copy where the rows allow it.
__device__ __forceinline__ void ball_stage(const float* __restrict__ X, int k0, int kn,
                                           float* dst, int lane) {
  const float* src = X + (size_t)k0 * 3;
  const int n = kn * 3;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = lane; e < n4; e += 32) cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = 4 * n4 + lane; e < n; e += 32) cp_async4(dst + e, src + e);
  } else {
    for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The merge of listed query u, by the warp that finished its last task:
// per scale, the prefix's hits are in place; each range's follow in range
// order until K; then the padding.
__device__ void ball_merge(long long* __restrict__ out, const BallScales& sc,
                           const BallScratch& bs, int u, int N, int S, int lane) {
  const int* info = bs.info + (size_t)u * BALL_INFO;
  const int bq = info[0];
  const int tr = sc.n + sc.sumK;
  const int* rec = bs.rec + (size_t)u * bs.nranges * tr;
  for (int s = 0; s < sc.n; ++s) {
    const int K = sc.K[s];
    long long* id = out + sc.off[s] + (size_t)bq * K;
    int c = info[2 + s];
    for (int r = 0; r < bs.nranges && c < K; ++r) {
      const int* rr = rec + (size_t)r * tr;
      // other warps wrote the records: read them from L2, past this SM's L1
      const int take = min(__ldcg(rr + s), K - c);
      for (int i = lane; i < take; i += 32) id[c + i] = __ldcg(rr + sc.n + sc.koff[s] + i);
      c += take;
    }
    ball_pad(id, c, K, (long long)(N - 1));
  }
}

__global__ void __launch_bounds__(BALL_TASK_WARPS * 32)
ball_task_kernel(const float* __restrict__ xyz, const float* __restrict__ qxyz,
                 long long* __restrict__ out, BallScales sc, BallScratch bs, int N, int S,
                 unsigned long long* __restrict__ stamps) {
  __shared__ __align__(16) float ring[BALL_TASK_WARPS][2][BALL_SUB * 3];
  const unsigned long long t_start = stamps ? global_ns() : 0ull;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = sc.n + sc.sumK;
  const int ntasks = *(volatile int*)bs.ctr * bs.nranges;
  int tasks = 0, merges = 0;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(bs.ctr + 1, 1);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= ntasks) break;
    ++tasks;
    const int u = t / bs.nranges, r = t - u * bs.nranges;
    int* info = bs.info + (size_t)u * BALL_INFO;
    const int bq = info[0];
    const int b = bq / S;
    const float* X = xyz + (size_t)b * N * 3;
    const float* QX = qxyz + (size_t)bq * 3;
    const float qx = QX[0], qy = QX[1], qz = QX[2];
    int* rec = bs.rec + ((size_t)u * bs.nranges + r) * tr;
    int need[PCI_BALL_MAX_SCALES], count[PCI_BALL_MAX_SCALES];
    bool done = true;
#pragma unroll
    for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
      need[s] = s < sc.n ? sc.K[s] - info[2 + s] : 0;
      count[s] = 0;
      done = done && count[s] >= need[s];
    }
    const int lo = BALL_PREFIX + r * BALL_RANGE, hi = min(N, lo + BALL_RANGE);
    const int stages = (hi - lo + BALL_SUB - 1) / BALL_SUB;
    float* buf0 = ring[warp][0];
    if (!done) ball_stage(X, lo, min(BALL_SUB, hi - lo), buf0, lane);
    for (int m = 0; m < stages && !done; ++m) {  // warp-uniform exit
      const int k0 = lo + m * BALL_SUB, kn = min(BALL_SUB, hi - k0);
      if (m + 1 < stages)
        ball_stage(X, k0 + BALL_SUB, min(BALL_SUB, hi - k0 - BALL_SUB), ring[warp][(m + 1) & 1],
                   lane);
      else
        cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // stage m is in for every lane
      const float* kb = ring[warp][m & 1];
      for (int t0 = 0; t0 < kn && !done; t0 += 32) {
        const int e = t0 + lane;
        float d = CUDART_INF_F;
        if (e < kn) d = sqdist3(kb[3 * e], kb[3 * e + 1], kb[3 * e + 2], qx, qy, qz);
        done = true;
#pragma unroll
        for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
          if (s < sc.n) {
            count[s] = ball_place(e < kn && d <= sc.r2[s], k0 + e, count[s], need[s],
                                  rec + sc.n + sc.koff[s]);
            done = done && count[s] >= need[s];
          }
        }
      }
      __syncwarp();  // every lane is done with the stage the next copy reuses
    }
    cp_async_wait<0>();
    __syncwarp();
    if (lane < sc.n) {
#pragma unroll
      for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s)
        if (s == lane) rec[s] = min(count[s], need[s]);
    }
    __threadfence();  // this task's record before its arrival
    int arrived = 0;
    if (lane == 0) arrived = atomicAdd(info + 1, 1);
    arrived = __shfl_sync(0xffffffffu, arrived, 0);
    if (arrived == bs.nranges - 1) {  // the query's last task: merge it
      __threadfence();
      ball_merge(out, sc, bs, u, N, S, lane);
      ++merges;
    }
  }
  if (stamps && lane == 0) {
    unsigned long long* st =
        stamps + ((size_t)blockIdx.x * BALL_TASK_WARPS + warp) * BALL_STAMPS;
    st[0] = t_start;
    st[1] = global_ns();
    st[2] = tasks;
    st[3] = merges;
  }
}

static int ball_ranges(int N) {
  return N > BALL_PREFIX ? (N - BALL_PREFIX + BALL_RANGE - 1) / BALL_RANGE : 0;
}

// The task kernel's grid (blocks), and the stamp rows a launch takes:
// one a prefix block, then one a task warp.
static int ball_task_grid() {
  static int sms[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 132 * 8;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132 * 8;
  return sms[dev] * 8;
}

extern "C" int pci_ball_stamp_rows(int B, int S) {
  return ((S + 7) / 8) * B + ball_task_grid() * BALL_TASK_WARPS;
}

// scales: n_scales squared radii (as float bits) then n_scales budgets,
// int32 on the host; out: one int64 buffer holding the scales' [B, S,
// K_s] blocks back to back; scratch: when N > BALL_PREFIX, 2 + B S
// BALL_INFO + B S nranges (n_scales + sum K) int32 (ball_cuda.scratch_ints;
// its two counters are zeroed here), else null; stamps: null, or
// pci_ball_stamp_rows x BALL_STAMPS zeroed int64 (a prefix block's start
// and end; a task warp's start, end, tasks and merges).
extern "C" int pci_ball(const void* xyz, const void* qxyz, void* out, const int* scales,
                        int n_scales, int B, int N, int S, void* scratch, void* stamps,
                        void* stream) {
  if (n_scales < 1 || n_scales > PCI_BALL_MAX_SCALES || N < 1 || S < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  BallScales sc;
  sc.n = n_scales;
  sc.sumK = 0;
  long long off = 0;
  for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
    const bool on = s < n_scales;
    sc.r2[s] = 0.f;
    if (on) std::memcpy(&sc.r2[s], &scales[s], sizeof(float));
    sc.K[s] = on ? scales[n_scales + s] : 0;
    if (on && sc.K[s] < 1) return (int)cudaErrorInvalidValue;
    sc.koff[s] = sc.sumK;
    sc.off[s] = off;
    sc.sumK += sc.K[s];
    off += on ? (long long)B * S * sc.K[s] : 0;
  }
  const int nr = ball_ranges(N);
  if (nr > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  BallScratch bs;
  bs.nranges = nr;
  bs.ctr = static_cast<int*>(scratch);
  bs.info = bs.ctr ? bs.ctr + 2 : nullptr;
  bs.rec = bs.info ? bs.info + (size_t)B * S * BALL_INFO : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nr > 0 && (e = cudaMemsetAsync(bs.ctr, 0, 2 * sizeof(int), st)) != cudaSuccess)
    return (int)e;
  const float* x = static_cast<const float*>(xyz);
  const float* qx = static_cast<const float*>(qxyz);
  long long* o = static_cast<long long*>(out);
  unsigned long long* stp = static_cast<unsigned long long*>(stamps);
  dim3 grid((S + 7) / 8, B);
  ball_prefix_kernel<<<grid, 256, 0, st>>>(x, qx, o, sc, bs, N, S, stp);
  if (nr > 0) {
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ball_task_kernel<<<ball_task_grid(), BALL_TASK_WARPS * 32, 0, st>>>(
        x, qx, o, sc, bs, N, S, stp ? stp + (size_t)grid.x * B * BALL_STAMPS : nullptr);
  }
  return (int)cudaGetLastError();
}
