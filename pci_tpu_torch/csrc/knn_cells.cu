// Exact k-nearest neighbours over a large cloud by box pruning: for each
// query, the k keys with the least squared distance, ascending, ties to the
// lower key index -- csrc/knn.cu's function, scanning only the chunks of
// keys that can hold a neighbour.
//
// Replaces pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells
// (_knn_cells_impl) on its large-cloud use, the transformer's self-kNN over
// the flow cloud (65,536 x 65,536, k = 16), and the cross case.  The TPU
// kernel is approximate (it scans the M chunks with the best box bounds and
// keeps bucket winners); this one skips only chunks that provably hold no
// neighbour, so indices and distances equal the flat kernel's and the plain
// version's bit for bit (distances rounded op by op, common.cuh sqdist3).
//
// What bounds it on the H100: the flat scan is 8 operations a pair, 4.3e9
// pairs at 65,536 points; on ISAPCInet's flow clouds a query needs about 3%
// of the pairs (the keys of the chunks whose box lies within its final k-th
// distance), so operations still, at a thirtieth of the flat count; in
// practice the latency of the slowest tile's walk (PERF.md).  Design:
// outside the kernel (torch, ops/cuda_kernels/knn_cuda.py:knn_cells_plan)
// the keys are Morton-sorted and cut into chunks of C keys, each with its
// box; the queries (the same sort in the self case) into tiles of TQ, each
// with its chunks in ascending order of the tile's box bound (those of
// bound 0 nearest first).  One block a tile walks that order, one thread a
// query, its sorted list of k (distance, index) in registers.  The chunks
// are staged into shared memory as (x, y, z, index) rows, with their box, by
// cp.async, KC_STAGES deep, so each staged chunk serves the whole tile; a
// query skips a chunk whose round-down box bound (cells.cuh:box_bound_rd,
// never above the rounded distance of any key in the box) exceeds its
// current k-th distance; the block stops, by a vote at the barrier that
// hands over each chunk, once the tile bound exceeds every query's k-th
// (with a margin for the torch bound's rounding).  A lane scans 32 keys at
// a time with a branch-free filter, then inserts the keys it marked, so a
// warp pays for the most inserts of one lane, not for every key some lane
// inserts; a chunk that at most KC_SPARSE lanes of a warp need is scanned by
// the whole warp for each of them, one key a lane.  Keys arrive out of
// index order, so the lists order by (distance, index).  Each query writes
// its own original row: no un-permute pass.  Pad keys are NaN rows (no
// comparison passes), pad queries have an index >= S.
#include "cells.cuh"
#include "mma_tf32.cuh"  // cp.async

#define KC_STAGES 3  // chunks in the shared-memory ring
#define KC_SPARSE 4  // lanes a warp at most for the whole warp to scan a chunk for each
#define KC_STAMPS 5  // a tile's stamps: start, end (%globaltimer ns), chunks walked, inserts, pairs

struct KnnCellsParams {
  const float4* keys;   // [B][Np] sorted keys (x, y, z, original index bits)
  const float4* qry;    // [B][Sp] sorted queries (x, y, z, original row bits)
  const float4* boxes;  // [B][nc][2]: each chunk's lo, hi over its real keys
  const int* order;     // [B][nt][nc] chunk ids by ascending tile bound
  const float* lbs;     // [B][nt][nc] their sort keys (the bound; below 0 for a bound of 0)
  float* out_d;         // [B][S][k]
  long long* out_i;     // [B][S][k]
  unsigned long long* scanned;  // (query, key) pairs scanned, or null
  unsigned long long* stamps;   // [B][nt][KC_STAMPS], or null
  int S, Np, Sp, C, TQ, nc, nt, k;
};

// The tile's stamps: its start and end (thread 0), the chunks it walked,
// the list inserts its threads made and the pairs they scanned.
__device__ __forceinline__ void stamp_tile(const KnnCellsParams& p, unsigned long long t0,
                                           int walked, unsigned ins, unsigned nscan) {
  if (!p.stamps) return;
  unsigned long long* s = p.stamps + ((size_t)blockIdx.y * p.nt + blockIdx.x) * KC_STAMPS;
  const unsigned w = __reduce_add_sync(FULL, ins);
  const unsigned n = __reduce_add_sync(FULL, nscan);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(s + 3, (unsigned long long)w);
    atomicAdd(s + 4, (unsigned long long)n);
  }
  if (threadIdx.x) return;
  s[0] = t0;
  s[1] = global_ns();
  s[2] = (unsigned long long)walked;
}

// Chunk m of the tile's order into ring slot m % KC_STAGES (C keys, then
// the chunk's lo and hi rows), by every thread of the block, then one
// commit (an empty group past the order's end).
__device__ __forceinline__ void stage_chunk(const KnnCellsParams& p, const float4* K,
                                            const float4* BX, const int* ord, float4* ring,
                                            int m) {
  if (m < p.nc) {
    const int c = ord[m];
    const float4* src = K + (size_t)c * p.C;
    float4* dst = ring + (m % KC_STAGES) * (p.C + 2);
    for (int j = threadIdx.x; j < p.C + 2; j += blockDim.x)
      cp_async16(dst + j, j < p.C ? src + j : BX + 2 * c + (j - p.C));
  }
  cp_async_commit();
}

// True when no key of the chunks from sort key `lb` on can enter a list
// whose k-th distance is thd: the margin covers the torch bound's
// round-to-nearest against the rounded distances (a key below 0 stands for
// a bound of 0).
__device__ __forceinline__ bool tile_done(float lb, float thd) {
  return lb > thd * 1.00001f + 1e-30f;
}

// One thread a query: KM >= k list entries in registers, the first KM - k
// held at -inf so that the last entry is the k-th.
template <int KM>
__global__ void __launch_bounds__(128)
knn_cells_kernel(const __grid_constant__ KnnCellsParams p) {
  extern __shared__ float4 ring[];
  const unsigned long long t0 = p.stamps ? global_ns() : 0ull;
  const int b = blockIdx.y, t = blockIdx.x, lane = threadIdx.x & 31;
  const float4 q = p.qry[(size_t)b * p.Sp + (size_t)t * p.TQ + threadIdx.x];
  const int qid = __float_as_int(q.w);
  const bool real = qid < p.S;
  const int front = KM - p.k;
  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    bd[i] = i < front ? -CUDART_INF_F : CUDART_INF_F;
    bi[i] = i < front ? -1 : CELL_EMPTY;
  }
  const size_t tile = (size_t)b * p.nt + t;
  const int* ord = p.order + tile * p.nc;
  const float* lbt = p.lbs + tile * p.nc;
  const float4* K = p.keys + (size_t)b * p.Np;
  const float4* BX = p.boxes + (size_t)b * p.nc * 2;
  for (int m = 0; m < KC_STAGES - 1; ++m) stage_chunk(p, K, BX, ord, ring, m);
  unsigned nscan = 0, ins = 0;
  int m = 0;
  for (; m < p.nc; ++m) {
    cp_async_wait<KC_STAGES - 2>();  // this thread's part of chunk m is in
    const float thd = bd[KM - 1];
    const bool done = !real || tile_done(lbt[m], thd);
    if (__syncthreads_and(done)) break;  // every part in; slot m - 1 read
    stage_chunk(p, K, BX, ord, ring, m + KC_STAGES - 1);
    const float4* kb = ring + (m % KC_STAGES) * (p.C + 2);
    const bool need = !done && box_bound_rd(kb[p.C], kb[p.C + 1], q.x, q.y, q.z) <= thd;
    nscan += need ? p.C : 0;
    const unsigned needers = __ballot_sync(FULL, need);
    const bool few = __popc(needers) <= KC_SPARSE;  // warp-uniform
    // a chunk that few lanes need: the warp scans it for each of them, one
    // key a lane, and hands that lane the keys before its k-th
    for (unsigned left = few ? needers : 0u; left; left &= left - 1) {
      const int ql = __ffs(left) - 1;
      const float sx = __shfl_sync(FULL, q.x, ql), sy = __shfl_sync(FULL, q.y, ql),
                  sz = __shfl_sync(FULL, q.z, ql);
      for (int base = 0; base < p.C; base += 32) {
        const float bar = __shfl_sync(FULL, bd[KM - 1], ql);
        const int bari = __shfl_sync(FULL, bi[KM - 1], ql);
        const float4 kk = kb[base + lane];
        const float d = sqdist3(kk.x, kk.y, kk.z, sx, sy, sz);
        const int id = __float_as_int(kk.w);
        for (unsigned mask = __ballot_sync(FULL, lex_less(d, id, bar, bari)); mask;
             mask &= mask - 1) {  // a NaN pad row never passes
          const int src = __ffs(mask) - 1;
          const float dn = __shfl_sync(FULL, d, src);
          const int jn = __shfl_sync(FULL, id, src);
          if (lane == ql && lex_less(dn, jn, bd[KM - 1], bi[KM - 1])) {
            list_insert<KM>(bd, bi, dn, jn);
            ++ins;
          }
        }
      }
    }
    if (need && !few) {
      // 32 keys at a time: a branch-free pass marks the keys before the
      // list's k-th (distance, index) as it stood (by index too: a cloud's
      // exact duplicates at the k-th distance would all pass a distance
      // test), then the lane inserts the marked ones, each checked again
      // against the k-th as it moves
      for (int base = 0; base < p.C; base += 32) {
        const float bar = bd[KM - 1];
        const int bari = bi[KM - 1];
        unsigned mask = 0;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const float4 kk = kb[base + u];
          const float d = sqdist3(kk.x, kk.y, kk.z, q.x, q.y, q.z);
          mask |= (unsigned)lex_less(d, __float_as_int(kk.w), bar, bari) << u;
        }
        for (; mask; mask &= mask - 1) {  // a NaN pad row is never marked
          const float4 kk = kb[base + __ffs(mask) - 1];
          const float d = sqdist3(kk.x, kk.y, kk.z, q.x, q.y, q.z);
          const int id = __float_as_int(kk.w);
          if (lex_less(d, id, bd[KM - 1], bi[KM - 1])) {
            list_insert<KM>(bd, bi, d, id);
            ++ins;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (p.scanned) {
    const unsigned w = __reduce_add_sync(FULL, nscan);
    if (lane == 0) atomicAdd(p.scanned, (unsigned long long)w);
  }
  stamp_tile(p, t0, m, ins, nscan);
  if (real) {
    float* od = p.out_d + ((size_t)b * p.S + qid) * p.k;
    long long* oi = p.out_i + ((size_t)b * p.S + qid) * p.k;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i >= front) {
        od[i - front] = bd[i];
        oi[i - front] = bi[i];
      }
    }
  }
}

template <int KM>
static cudaError_t launch_knn_cells(const KnnCellsParams& p, int B, cudaStream_t st) {
  const size_t smem = (size_t)KC_STAGES * (p.C + 2) * sizeof(float4);
  cudaError_t e = allow_smem(knn_cells_kernel<KM>, smem);
  if (e != cudaSuccess) return e;
  knn_cells_kernel<KM><<<dim3(p.nt, B), p.TQ, smem, st>>>(p);
  return cudaGetLastError();
}

// keys [B, Np, 4] and qry [B, Sp, 4] fp32 rows (x, y, z, index bits), boxes
// [B, nc, 2, 4], order (int32) and lbs [B, Sp / TQ, nc] (nc = Np / C), all on
// the device -> out_d [B, S, k] fp32, out_i [B, S, k] int64; scanned: an
// unsigned 64-bit counter that gains the pairs scanned, or null; stamps:
// [B, Sp / TQ, KC_STAMPS] unsigned 64-bit (zeroed), or null.  TQ threads a
// block (32 <= TQ <= 128).
extern "C" int pci_knn_cells(const void* keys, const void* qry, const void* boxes,
                             const void* order, const void* lbs, void* out_d, void* out_i,
                             void* scanned, void* stamps, int B, int S, int Np, int Sp, int C,
                             int TQ, int k, void* stream) {
  if (k < 1 || k > 64 || S < 1 || Sp < S || C < 32 || C % 32 || Np % C || TQ < 32 ||
      TQ % 32 || Sp % TQ || TQ > 128)
    return (int)cudaErrorInvalidValue;
  KnnCellsParams p;
  p.keys = static_cast<const float4*>(keys);
  p.qry = static_cast<const float4*>(qry);
  p.boxes = static_cast<const float4*>(boxes);
  p.order = static_cast<const int*>(order);
  p.lbs = static_cast<const float*>(lbs);
  p.out_d = static_cast<float*>(out_d);
  p.out_i = static_cast<long long*>(out_i);
  p.scanned = static_cast<unsigned long long*>(scanned);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.S = S, p.Np = Np, p.Sp = Sp, p.C = C, p.TQ = TQ, p.nc = Np / C, p.nt = Sp / TQ, p.k = k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return (int)launch_knn_cells<1>(p, B, st);
  if (k <= 4) return (int)launch_knn_cells<4>(p, B, st);
  if (k <= 8) return (int)launch_knn_cells<8>(p, B, st);
  if (k <= 16) return (int)launch_knn_cells<16>(p, B, st);
  if (k <= 32) return (int)launch_knn_cells<32>(p, B, st);
  return (int)launch_knn_cells<64>(p, B, st);
}
