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
//
// The segment form (knn_cells_seg_kernel; knn_cells_tpu.py's key_valid and
// emit_resi, the F-segment fusion kNN of pci_tpu/nn/fusion.py:
// _cells_fusion_knn and ops.knn_self_resi): the same walk over a plan whose
// invalid keys are NaN rows (so no comparison passes and the scan needs no
// new test), whose chunk boxes cover the valid keys only, and whose chunks
// with no valid key carry a NaN sort key, sorted last: a tile stops at the
// first (a query whose segment holds fewer valid keys than its budget keeps
// an infinite k-th, and would walk every empty chunk).  A batch row's
// budget comes from a device array: the list's front, its first KM - budget
// entries, is held at -inf, so each row prunes against its own budget's
// k-th, and the list size KM is chosen per block by that budget.  A row
// writes its slots [col0, col0 + budget) of a ks-slot output row; a slot
// with no valid key left is the query's own row, distance KC_SENTINEL and
// a zero residual (the fusion's unfilled-slot convention); with `fill`,
// the slots past the budget are written so too.  With kpts, each slot's
// exact residual key - query (__fsub_rn: the plain version's subtraction).
#include "cells.cuh"
#include "mma_tf32.cuh"  // cp.async

#define KC_STAGES 3  // chunks in the shared-memory ring
#define KC_SPARSE 4  // lanes a warp at most for the whole warp to scan a chunk for each
#define KC_STAMPS 5  // a tile's stamps: start, end (%globaltimer ns), chunks walked, inserts, pairs
#define KC_SENTINEL 1e30f  // the distance of a slot with no valid key left

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
  // the segment form only
  const float* kpts;    // [B][N][3] the keys in original order (residuals), or null
  const int* bud;       // [B] a row's budget (<= k), or null: k
  const int* col0;      // [B] a row's first slot, or null: 0
  float* out_r;         // [B][S][ks][3], or null
  int N, ks, fill;      // keys; slots an output row; write the slots past the budget
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

// A slot with no valid key left (or, with `fill`, past the budget): the
// query's own row, distance KC_SENTINEL, a zero residual.
__device__ __forceinline__ void write_unfilled(const KnnCellsParams& p, size_t o, int qid) {
  if (p.out_d) p.out_d[o] = KC_SENTINEL;
  p.out_i[o] = qid;
  if (p.out_r) p.out_r[o * 3] = p.out_r[o * 3 + 1] = p.out_r[o * 3 + 2] = 0.f;
}

// The tile's walk for this thread's query (q, its original row qid; real
// false for a pad row): KM >= kq list entries in registers, the first KM -
// kq held at -inf so that the last entry is the kq-th; then its writes.
// SEG: the segment form (a NaN sort key ends the walk; the writes at the
// row's slots, with the sentinel and the residuals).
template <int KM, bool SEG>
__device__ __forceinline__ void cells_walk(const KnnCellsParams& p, float4* ring, int b, int t,
                                           float4 q, int qid, bool real, int kq,
                                           unsigned long long t0) {
  const int lane = threadIdx.x & 31;
  const int front = KM - kq;
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
    // SEG: a NaN sort key is a chunk with no valid key, and every later one too
    const bool done = !real || tile_done(lbt[m], thd) || (SEG && lbt[m] != lbt[m]);
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
  if (!real) return;
  if constexpr (!SEG) {
    float* od = p.out_d + ((size_t)b * p.S + qid) * p.k;
    long long* oi = p.out_i + ((size_t)b * p.S + qid) * p.k;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i >= front) {
        od[i - front] = bd[i];
        oi[i - front] = bi[i];
      }
    }
  } else {
    const int c0 = p.col0 ? p.col0[b] : 0;
    const size_t row = ((size_t)b * p.S + qid) * p.ks;
    const float* P = p.kpts + (size_t)b * p.N * 3;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      const int c = c0 + i - front;
      if (i < front || c >= p.ks) continue;
      const size_t o = row + c;
      if (bi[i] == CELL_EMPTY) {  // the segment held fewer valid keys than the budget
        write_unfilled(p, o, qid);
        continue;
      }
      if (p.out_d) p.out_d[o] = bd[i];
      p.out_i[o] = bi[i];
      if (p.out_r) {
        const float* kp = P + (size_t)bi[i] * 3;
        p.out_r[o * 3] = __fsub_rn(kp[0], q.x);
        p.out_r[o * 3 + 1] = __fsub_rn(kp[1], q.y);
        p.out_r[o * 3 + 2] = __fsub_rn(kp[2], q.z);
      }
    }
    if (p.fill)
      for (int c = c0 + kq; c < p.ks; ++c) write_unfilled(p, row + c, qid);
  }
}

// One thread a query: KM >= k list entries in registers, the first KM - k
// held at -inf so that the last entry is the k-th.
template <int KM>
__global__ void __launch_bounds__(128)
knn_cells_kernel(const __grid_constant__ KnnCellsParams p) {
  extern __shared__ float4 ring[];
  const unsigned long long t0 = p.stamps ? global_ns() : 0ull;
  const int b = blockIdx.y, t = blockIdx.x;
  const float4 q = p.qry[(size_t)b * p.Sp + (size_t)t * p.TQ + threadIdx.x];
  const int qid = __float_as_int(q.w);
  cells_walk<KM, false>(p, ring, b, t, q, qid, qid < p.S, p.k, t0);
}

// The segment form: the row's budget (block-uniform: a block is one tile of
// one row) picks the list size, up to KMAX; a budget of 0 returns at once.
template <int KMAX>
__global__ void __launch_bounds__(128)
knn_cells_seg_kernel(const __grid_constant__ KnnCellsParams p) {
  extern __shared__ float4 ring[];
  const unsigned long long t0 = p.stamps ? global_ns() : 0ull;
  const int b = blockIdx.y, t = blockIdx.x;
  const float4 q = p.qry[(size_t)b * p.Sp + (size_t)t * p.TQ + threadIdx.x];
  const int qid = __float_as_int(q.w);
  const bool real = qid < p.S;
  const int kq = p.bud ? max(0, min(p.bud[b], p.k)) : p.k;
  if (kq == 0) {
    if (real && p.fill) {
      const size_t row = ((size_t)b * p.S + qid) * p.ks;
      for (int c = p.col0 ? p.col0[b] : 0; c < p.ks; ++c) write_unfilled(p, row + c, qid);
    }
    return;
  }
  if (kq <= 4) {
    cells_walk<4, true>(p, ring, b, t, q, qid, real, kq, t0);
  } else if (kq <= 8) {
    cells_walk<8, true>(p, ring, b, t, q, qid, real, kq, t0);
  } else if (kq <= 16 || KMAX <= 16) {
    cells_walk<16, true>(p, ring, b, t, q, qid, real, kq, t0);
  } else if constexpr (KMAX >= 32) {
    if (kq <= 32 || KMAX <= 32) cells_walk<32, true>(p, ring, b, t, q, qid, real, kq, t0);
    else if constexpr (KMAX >= 64) cells_walk<64, true>(p, ring, b, t, q, qid, real, kq, t0);
  }
}

template <class Kernel>
static cudaError_t launch_knn_cells(Kernel kernel, const KnnCellsParams& p, int B,
                                    cudaStream_t st) {
  const size_t smem = (size_t)KC_STAGES * (p.C + 2) * sizeof(float4);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.nt, B), p.TQ, smem, st>>>(p);
  return cudaGetLastError();
}

static bool plan_ok(int B, int S, int Np, int Sp, int C, int TQ, int k) {
  return B >= 1 && k >= 1 && k <= 64 && S >= 1 && Sp >= S && C >= 32 && C % 32 == 0 &&
         Np % C == 0 && TQ >= 32 && TQ % 32 == 0 && Sp % TQ == 0 && TQ <= 128;
}

static KnnCellsParams make_params(const void* keys, const void* qry, const void* boxes,
                                  const void* order, const void* lbs, void* out_d,
                                  void* out_i, void* scanned, void* stamps, int S, int Np,
                                  int Sp, int C, int TQ, int k) {
  KnnCellsParams p = {};
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
  p.ks = k;
  return p;
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
  if (!plan_ok(B, S, Np, Sp, C, TQ, k)) return (int)cudaErrorInvalidValue;
  const KnnCellsParams p = make_params(keys, qry, boxes, order, lbs, out_d, out_i, scanned,
                                       stamps, S, Np, Sp, C, TQ, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return (int)launch_knn_cells(knn_cells_kernel<1>, p, B, st);
  if (k <= 4) return (int)launch_knn_cells(knn_cells_kernel<4>, p, B, st);
  if (k <= 8) return (int)launch_knn_cells(knn_cells_kernel<8>, p, B, st);
  if (k <= 16) return (int)launch_knn_cells(knn_cells_kernel<16>, p, B, st);
  if (k <= 32) return (int)launch_knn_cells(knn_cells_kernel<32>, p, B, st);
  return (int)launch_knn_cells(knn_cells_kernel<64>, p, B, st);
}

// The segment form, on a plan whose invalid keys are NaN rows, whose boxes
// cover the valid keys and whose empty chunks carry a NaN sort key, with qry
// the queries' own rows (x, y, z, original row bits): as pci_knn_cells
// (no stamps), plus kpts [B, N, 3] fp32 the keys in original order (with out_r), bud and
// col0 [B] int32 on the device or null (k, 0), out_d [B, S, ks] fp32 or
// null, out_i [B, S, ks] int64, out_r [B, S, ks, 3] fp32 or null; a row
// writes its slots [col0, col0 + min(bud, k)) (and with fill the rest of
// the row) and nothing for a budget of 0.  k <= ks.
extern "C" int pci_knn_cells_seg(const void* keys, const void* qry, const void* boxes,
                                 const void* order, const void* lbs, const void* kpts,
                                 const void* bud, const void* col0, void* out_d, void* out_i,
                                 void* out_r, void* scanned, int B, int S, int N, int Np, int Sp,
                                 int C, int TQ, int k, int ks, int fill, void* stream) {
  if (!plan_ok(B, S, Np, Sp, C, TQ, k) || ks < k || N < 1 || Np < N || !out_i ||
      (out_r && !kpts))
    return (int)cudaErrorInvalidValue;
  KnnCellsParams p = make_params(keys, qry, boxes, order, lbs, out_d, out_i, scanned, nullptr,
                                 S, Np, Sp, C, TQ, k);
  p.kpts = static_cast<const float*>(kpts);
  p.bud = static_cast<const int*>(bud);
  p.col0 = static_cast<const int*>(col0);
  p.out_r = static_cast<float*>(out_r);
  p.N = N, p.ks = ks, p.fill = fill != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 16) return (int)launch_knn_cells(knn_cells_seg_kernel<16>, p, B, st);
  if (k <= 32) return (int)launch_knn_cells(knn_cells_seg_kernel<32>, p, B, st);
  return (int)launch_knn_cells(knn_cells_seg_kernel<64>, p, B, st);
}

// The kernels' resources (common.cuh's kernel_attrs) at chunks of 256 keys
// and tiles of 64 queries: the plain form at k = 16 (the transformer's),
// the segment form at k <= 64.
extern "C" int pci_knn_cells_attrs(int* out) {
  return kernel_attrs(knn_cells_kernel<16>, (size_t)KC_STAGES * (256 + 2) * sizeof(float4), out,
                      64);
}
extern "C" int pci_knn_cells_seg_attrs(int* out) {
  return kernel_attrs(knn_cells_seg_kernel<64>, (size_t)KC_STAGES * (256 + 2) * sizeof(float4),
                      out, 64);
}
