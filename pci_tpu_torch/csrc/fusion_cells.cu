// The fusion's budgeted two-segment self-kNN over a Morton-sorted, chunked
// cloud, scanning only the chunks that can hold a neighbour; one-shot mode
// adds the attention head (the fused rows, and a payload's weighted sums),
// residual mode writes idx and resi.
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_cells_tpu.py:knn_fusion_cells
// (and knn_fusion_cells_grad's forward), the JAX package's fusion route at
// N >= 32,768 points.  The function is the one of csrc/fusion_knn.cu: each
// query takes its exact k1 nearest keys in segment A = rows [0, N1) and its
// exact k2 nearest in B = rows [N1, N), ties to the lower combined-cloud
// index, slots [0, k1) from A and [k1, k1 + k2) from B; a slot its segment
// cannot fill is a zero residual (the row itself).  The TPU kernel is an
// approximation (it scans the M best chunks by box bound and keeps
// `winners` packed-key minima a bucket); this one prunes only chunks that
// provably hold no neighbour, so it gives the flat kernel's neighbours.
//
// What bounds it on the H100: at 65,536 points the flat scan is 4.3e9
// pairs; here a query scans the few chunks whose box bound does not exceed
// its current k_s-th distance (a few thousand pairs), so the one-shot
// mode's score MLP (65,536 x 32 slots x 12.3k multiply-adds, ~52 GFLOP,
// three TF32 products a multiply-add) dominates: operations.  Design:
// outside the kernel (torch, ops/cuda_kernels/fusion_cells_cuda.py, replayed
// from a CUDA graph) the cloud is Morton-sorted and cut into chunks of C
// keys, (x, y, z, original index bits) rows, with a box a segment, and for
// each tile of TQ = 64 consecutive sorted queries the chunks are ordered by
// the tile's box bound min(lbA, lbB).  Here:
//   - persistent blocks, one an SM (16 warps; in one-shot mode the score MLP,
//     split for the tensor cores, 101 KB, loaded into shared memory once),
//     as 8 groups of two warps, each group taking tiles of 64 sorted
//     queries from a counter until none is left (clouds are skewed, so
//     tiles are handed out as groups free up, not striped), the widest
//     tile boxes first (the plan's torder: a wide tile holds sparse
//     queries with far neighbours and walks longest);
//   - a tile's walk is shared by its 64 queries (csrc/knn_cells.cu's, with
//     two lists): the chunks arrive in bound order through the group's
//     cp.async ring (FC_STAGES deep, each chunk's keys and its two segment
//     boxes), so a staged chunk serves the whole tile; one thread a query
//     keeps its A and B lists of (distance, index) in registers
//     (cells.cuh:list_insert, since keys arrive out of index order; 16 + 16
//     entries, or 32 for a segment whose budget passes 16), skips a chunk
//     whose round-down box bound for a segment (cells.cuh:box_bound_rd)
//     exceeds that segment's k_s-th, scans 32 keys at a time with a
//     branch-free filter and then inserts the keys it marked (a warp pays
//     for the most inserts of one lane, not for every key a lane inserts;
//     a chunk few lanes need is scanned by the whole warp for each); the
//     group stops, by a vote at the barrier that hands over each chunk,
//     once the tile bound exceeds every query's k_s-th (with a margin for
//     the torch bound's rounding).  Among the chunks of bound 0 the plan
//     puts the tile's own chunk first, then its neighbours in the sorted
//     order, so the lists fill from the nearest keys and later keys rarely
//     enter (inserts, not scans, cost the walk: this order cut them from
//     ~360 to ~130 a query at 65,536 points).  A warp-per-query walk (one
//     lane a slot) was measured first: its inserts, a warp-wide shuffle
//     chain a key, made the residual mode 2x slower than the earlier
//     per-query kernel (PERF.md);
//   - the slots go through shared memory to one warp a query (lane L slot
//     L) for the head (fusion_head.cuh:fused_row, csrc/fusion_knn.cu's) on
//     the tensor cores in 3xTF32: the same rows as the flat one-shot
//     kernel for the same neighbours; then a payload's weighted sums
//     (fusion_head.cuh:payload_sums), each slot reading its neighbour's
//     channels by original row (the slots hold original rows, so the
//     payload never rides the Morton sort), an unfilled slot the query's.
// Residual mode runs the same walk and writes idx and resi.  Each query
// writes its own original row: no un-permute pass.
//
// k <= 64 (KMAX = 64, chosen by k at launch: an instantiation of its own,
// so that k <= 32 keeps its code, registers and shared memory): a
// segment's budget can reach 64 and both reach 32 at t = 0.5, so the list
// pair is chosen per tile by its row's budgets from (32, 32), (64, 16),
// (48, 32), (32, 48) and (16, 64), each covering its budgets in at most 80
// entries.  Two such lists take 160 registers, past the 128 a thread of a
// 16-warp block may hold, so this instantiation runs 8 warps a block (4
// groups; up to 255 registers a thread) rather than moving a list to shared
// memory (64 queries x 80 entries x 8 bytes a group would not fit beside
// the score MLP).  Its slot rows are [FC_TQ][65] ints, 16.6 KB a group,
// larger than the ring they replace, so a group's region is the larger of
// the two; the head is fusion_head.cuh's k <= 64 one (fused_row2, two slots
// a lane, up to four 16-slot tiles, one softmax over both halves), as the
// flat one-shot kernel's.
#include "fusion_head.cuh"
#include "cells.cuh"

#define FC_TQ 64      // queries a tile: a group of two warps, one thread a query
#define FC_STAGES 3   // chunks in a group's shared-memory ring
#define FC_SPARSE 4   // lanes a warp at most for the whole warp to scan a chunk for each
#define FC_STAMPS 8   // a tile's stamps: start, walk end, end (%globaltimer ns), chunks walked,
                      // pairs, list inserts, warp-chunks scanned lane by lane, and for each needer

// The block's shape by the instantiation's largest k: KMAX = 32, 16 warps;
// KMAX = 64, 8 warps (the two lists' registers).  SS: a query's slot row.
template <int KMAX>
struct CellsShape {
  static constexpr int warps = KMAX > 32 ? 8 : 16;
  static constexpr int groups = warps * 32 / FC_TQ;
  static constexpr int ss = KMAX + 1;  // odd: no bank conflicts
  // a group's region in float4s: its ring, which the slot rows take after the walk
  static __host__ __device__ int region(int C) {
    const int ring = FC_STAGES * (C + 4);
    const int rows = (FC_TQ * ss + 3) / 4;
    if constexpr (KMAX > 32) return ring > rows ? ring : rows;
    return ring;
  }
};

struct CellsParams {
  const float* pts;     // combined [B][N][3], original order
  const float4* keys;   // [B][Np] sorted keys (x, y, z, original id bits; pads id N)
  const float4* boxes;  // [B][nc][4]: lo A, hi A, lo B, hi B (xyz, pad)
  const int* order;     // [B][nt][nc] chunk ids by ascending tile bound
  const float* lbs;     // [B][nt][nc] their sort keys (the bound; below 0 for a bound of 0)
  const int* torder;    // [B * nt] tiles in the order they are handed out
  const int* seg;       // [B][4] = (N1, N, k1, k2)
  const float* wtc;     // the split score MLP (one-shot mode), or null
  const float* payload; // one-shot: [B][N][Cp] by original row, or null (Cp == 0)
  float* out;           // one-shot: fused [B][N][3 + Cp]
  long long* out_i;     // residual: idx [B][N][k]
  float* out_r;         // residual: resi [B][N][k][3]
  unsigned long long* scanned;  // pairs scanned, or null
  unsigned long long* stamps;   // [B][nt][FC_STAMPS], or null
  int* next;            // the tile counter, zeroed
  int B, N, Np, C, nc, nt, k, Cp;
};

// The group's barrier (id 1 + group, FC_TQ threads), and the same with a
// vote: true when `pred` holds on every thread of the group.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(FC_TQ) : "memory");
}
__device__ __forceinline__ bool group_all(int id, bool pred) {
  unsigned r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
      " bar.red.and.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((unsigned)pred), "r"(id), "r"(FC_TQ)
      : "memory");
  return r != 0;
}

// Chunk m of the tile's order into ring slot m % FC_STAGES (C keys, then
// its four box rows), by the group's threads, then one commit (an empty
// group past the order's end).
__device__ __forceinline__ void stage_chunk(const CellsParams& p, const float4* K,
                                            const float4* BX, const int* ord, float4* ring,
                                            int m, int gt) {
  if (m < p.nc) {
    const int c = ord[m];
    const float4* src = K + (size_t)c * p.C;
    float4* dst = ring + (m % FC_STAGES) * (p.C + 4);
    for (int j = gt; j < p.C + 4; j += FC_TQ)
      cp_async16(dst + j, j < p.C ? src + j : BX + 4 * c + (j - p.C));
  }
  cp_async_commit();
}

// Key (d, id) into this thread's lists when it passes the segment's k-th
// entry (checked again: the bar moves as keys go in).
template <int KA, int KB>
__device__ __forceinline__ bool insert2(float (&dA)[KA], int (&iA)[KA], float (&dB)[KB],
                                        int (&iB)[KB], float d, int id, int N1) {
  if (id < N1) {
    if (!lex_less(d, id, dA[KA - 1], iA[KA - 1])) return false;
    list_insert<KA>(dA, iA, d, id);
  } else {
    if (!lex_less(d, id, dB[KB - 1], iB[KB - 1])) return false;
    list_insert<KB>(dB, iB, d, id);
  }
  return true;
}

// The tile's walk: this thread's query (sorted row s of the tile; `real`
// false for a pad row) keeps its A and B lists in registers, KA and KB
// entries with the first KA - k1 (KB - k2) held at -inf, so that the
// last entry is the k_s-th (a segment with no budget: every entry -inf,
// nothing passes).  Chunks come through the group's ring; a query skips a
// chunk whose round-down box bound for a segment exceeds that segment's
// k_s-th; the group stops by a vote once the tile bound passes every
// query's larger k_s-th.  A lane scans 32 keys at a time with a
// branch-free filter, then inserts the keys it marked; a chunk that at
// most FC_SPARSE lanes of a warp need is scanned by the whole warp for
// each of them.  On return the slot ids (slot e: A's (e+1)-th for e < k1,
// then B's; -1 unfilled or past k1 + k2) are in `slots` [FC_TQ][SS] (the
// ring's space) and the chunks walked in `walked`.
template <int KA, int KB, int SS>
__device__ __forceinline__ void tile_walk(const CellsParams& p, int b, int tile, float4 q,
                                          bool real, int N1, int k1, int k2, float4* ring,
                                          int* slots, int bar, int gt, unsigned& nscan,
                                          int& walked, unsigned (&cnt)[3]) {
  const int lane = threadIdx.x & 31, N = p.N;
  float dA[KA], dB[KB];
  int iA[KA], iB[KB];
#pragma unroll
  for (int i = 0; i < KA; ++i) {
    dA[i] = i < KA - k1 ? -CUDART_INF_F : CUDART_INF_F;
    iA[i] = i < KA - k1 ? -1 : CELL_EMPTY;
  }
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    dB[i] = i < KB - k2 ? -CUDART_INF_F : CUDART_INF_F;
    iB[i] = i < KB - k2 ? -1 : CELL_EMPTY;
  }
  const int* ord = p.order + (size_t)tile * p.nc;
  const float* lbt = p.lbs + (size_t)tile * p.nc;
  const float4* K = p.keys + (size_t)b * p.Np;
  const float4* BX = p.boxes + (size_t)b * p.nc * 4;
  for (int m = 0; m < FC_STAGES - 1; ++m) stage_chunk(p, K, BX, ord, ring, m, gt);
  int m = 0;
  for (; m < p.nc; ++m) {
    cp_async_wait<FC_STAGES - 2>();  // this thread's part of chunk m is in
    // every later chunk's tile bound is at least this one's; the margin
    // covers the torch bound's round-to-nearest against the round-down here
    const float thA = dA[KA - 1], thB = dB[KB - 1];
    const bool done = !real || lbt[m] > fmaxf(thA, thB) * 1.00001f + 1e-30f;
    if (group_all(bar, done)) break;  // every part in; slot m - 1 read
    stage_chunk(p, K, BX, ord, ring, m + FC_STAGES - 1, gt);
    const float4* kb = ring + (m % FC_STAGES) * (p.C + 4);
    const float4 loA = kb[p.C], hiA = kb[p.C + 1], loB = kb[p.C + 2], hiB = kb[p.C + 3];
    const bool needA = !done && k1 > 0 && loA.x <= hiA.x &&
                       box_bound_rd(loA, hiA, q.x, q.y, q.z) <= thA;
    const bool needB = !done && k2 > 0 && loB.x <= hiB.x &&
                       box_bound_rd(loB, hiB, q.x, q.y, q.z) <= thB;
    const bool need = needA || needB;
    nscan += need ? p.C : 0;
    const unsigned needers = __ballot_sync(FULL, need);
    const bool few = __popc(needers) <= FC_SPARSE;  // warp-uniform
    // a chunk that few lanes need: the warp scans it for each of them, one
    // key a lane, and hands that lane the keys before its k_s-th
    for (unsigned left = few ? needers : 0u; left; left &= left - 1) {
      const int ql = __ffs(left) - 1;
      const float sx = __shfl_sync(FULL, q.x, ql), sy = __shfl_sync(FULL, q.y, ql),
                  sz = __shfl_sync(FULL, q.z, ql);
      const bool nA = __shfl_sync(FULL, needA, ql), nB = __shfl_sync(FULL, needB, ql);
      for (int base = 0; base < p.C; base += 32) {
        const float bA = __shfl_sync(FULL, dA[KA - 1], ql), bB = __shfl_sync(FULL, dB[KB - 1], ql);
        const int biA = __shfl_sync(FULL, iA[KA - 1], ql), biB = __shfl_sync(FULL, iB[KB - 1], ql);
        const float4 kk = kb[base + lane];
        const float d = sqdist3(kk.x, kk.y, kk.z, sx, sy, sz);
        const int id = __float_as_int(kk.w);
        const bool pass = id < N1 ? nA && lex_less(d, id, bA, biA)
                                  : id < N && nB && lex_less(d, id, bB, biB);
        for (unsigned mask = __ballot_sync(FULL, pass); mask; mask &= mask - 1) {
          const int src = __ffs(mask) - 1;
          const float dn = __shfl_sync(FULL, d, src);
          const int jn = __shfl_sync(FULL, id, src);
          if (lane == ql) cnt[0] += insert2<KA, KB>(dA, iA, dB, iB, dn, jn, N1);
        }
      }
    }
    if (lane == 0 && needers) ++cnt[few ? 2 : 1];
    if (need && !few) {
      // 32 keys at a time: a branch-free pass marks the keys before the
      // segment's k_s-th (distance, index) as it stood, then the lane
      // inserts the marked ones, each checked again as the bar moves
      for (int base = 0; base < p.C; base += 32) {
        const float bA = dA[KA - 1], bB = dB[KB - 1];
        const int biA = iA[KA - 1], biB = iB[KB - 1];
        unsigned mask = 0;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const float4 kk = kb[base + u];
          const float d = sqdist3(kk.x, kk.y, kk.z, q.x, q.y, q.z);
          const int id = __float_as_int(kk.w);
          const bool pass = id < N1 ? needA && lex_less(d, id, bA, biA)
                                    : id < N && needB && lex_less(d, id, bB, biB);
          mask |= (unsigned)pass << u;
        }
        for (; mask; mask &= mask - 1) {
          const float4 kk = kb[base + __ffs(mask) - 1];
          cnt[0] += insert2<KA, KB>(dA, iA, dB, iB, sqdist3(kk.x, kk.y, kk.z, q.x, q.y, q.z),
                                    __float_as_int(kk.w), N1);
        }
      }
    }
  }
  cp_async_wait<0>();
  walked = m;
  group_sync(bar);  // the group is done with the ring: the slots take its space
  int* mine = slots + gt * SS;
#pragma unroll
  for (int i = 0; i < SS - 1; ++i) mine[i] = -1;
#pragma unroll
  for (int i = 0; i < KA; ++i)
    if (i >= KA - k1) mine[i - (KA - k1)] = iA[i] == CELL_EMPTY ? -1 : iA[i];
#pragma unroll
  for (int i = 0; i < KB; ++i)
    if (i >= KB - k2) mine[k1 + i - (KB - k2)] = iB[i] == CELL_EMPTY ? -1 : iB[i];
  group_sync(bar);
}

// Persistent blocks of groups of two warps: each group takes a tile of
// FC_TQ sorted queries from the counter, walks it (one thread a query),
// then its two warps finish its queries, 32 each, one warp a query (lane L
// slot L, and 32 + L at KMAX = 64): the tensor-core head in one-shot mode,
// idx and resi in residual mode.  The lists' sizes are chosen per tile by
// its row's budgets: at KMAX = 32, 16 and 16, or 32 for the segment with
// more than 16; at KMAX = 64 the pairs above.  PAY (one-shot only): the
// instantiation with a payload's weighted sums.
template <bool ONESHOT, bool PAY, int KMAX>
__global__ void __launch_bounds__(CellsShape<KMAX>::warps * 32, 1)
fusion_cells_kernel(const __grid_constant__ CellsParams p) {
  using Shape = CellsShape<KMAX>;
  constexpr int SS = Shape::ss;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int grp = threadIdx.x / FC_TQ, gt = threadIdx.x % FC_TQ, bar = 1 + grp;
  // (k <= 32: the parent's expression, so the instantiation keeps its code)
  float4* ring = smem4 + (ONESHOT ? ONE_NW / 4 : 0) +
                 (KMAX > 32 ? grp * Shape::region(p.C) : grp * FC_STAGES * (p.C + 4));
  int* slots = reinterpret_cast<int*>(ring);  // after the walk: [FC_TQ][SS]
  __shared__ int tile_s[Shape::groups];
  if (ONESHOT) {
    for (int e = threadIdx.x; e < ONE_NW / 4; e += blockDim.x)
      smem4[e] = reinterpret_cast<const float4*>(p.wtc)[e];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, half = gt >> 5;
  for (;;) {
    if (gt == 0) {
      const int n = atomicAdd(p.next, 1);
      tile_s[grp] = n < p.B * p.nt ? p.torder[n] : -1;
    }
    group_sync(bar);
    const int tile = tile_s[grp];
    if (tile < 0) break;  // group-uniform
    const unsigned long long t0 = p.stamps ? global_ns() : 0ull;
    const int b = tile / p.nt;
    const float* P = p.pts + (size_t)b * p.N * 3;
    const int N = p.N, N1 = p.seg[b * 4];
    const int k1 = max(0, min(p.seg[b * 4 + 2], KMAX));
    const int k2 = max(0, min(p.seg[b * 4 + 3], KMAX - k1));
    const float4 q = p.keys[(size_t)b * p.Np + (size_t)(tile - b * p.nt) * FC_TQ + gt];
    const int qid = __float_as_int(q.w);
    unsigned nscan = 0, cnt[3] = {0u, 0u, 0u};
    int walked = 0;
    if constexpr (KMAX <= 32) {
      if (k1 <= 16 && k2 <= 16)
        tile_walk<16, 16, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else if (k1 > 16)
        tile_walk<32, 16, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else
        tile_walk<16, 32, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
    } else {
      if (k1 <= 32 && k2 <= 32)
        tile_walk<32, 32, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else if (k1 > 48)  // k2 <= 15
        tile_walk<64, 16, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else if (k1 > 32)  // k2 <= 31
        tile_walk<48, 32, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else if (k1 > 16)  // 32 < k2 <= 47
        tile_walk<32, 48, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
      else               // 32 < k2 <= 64
        tile_walk<16, 64, SS>(p, b, tile, q, qid < N, N1, k1, k2, ring, slots, bar, gt, nscan, walked, cnt);
    }
    const unsigned long long t1 = p.stamps ? global_ns() : 0ull;
    if (p.scanned || p.stamps) {
      const unsigned w = __reduce_add_sync(FULL, nscan);
      if (lane == 0 && p.scanned) atomicAdd(p.scanned, (unsigned long long)w);
      if (lane == 0 && p.stamps)
        atomicAdd(p.stamps + (size_t)tile * FC_STAMPS + 4, (unsigned long long)w);
    }
    if (p.stamps) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const unsigned w = __reduce_add_sync(FULL, cnt[i]);
        if (lane == 0) atomicAdd(p.stamps + (size_t)tile * FC_STAMPS + 5 + i, (unsigned long long)w);
      }
    }
    // this warp's 32 queries, one after another: lane L holds query L's
    // row and, in the slots, reads slot L of each
#pragma unroll 1
    for (int i = 0; i < 32; ++i) {
      const int qi = __shfl_sync(FULL, qid, i);
      if (qi >= N) continue;  // a pad row (warp-uniform)
      const float x = __shfl_sync(FULL, q.x, i), y = __shfl_sync(FULL, q.y, i),
                  z = __shfl_sync(FULL, q.z, i);
      if constexpr (KMAX > 32) {
        // slots lane and 32 + lane: the k <= 64 head (fused_row2)
        const int* row = slots + (32 * half + i) * SS;
        if (ONESHOT) {
          const int kk = k1 + k2;
          const bool act0 = lane < kk, act1 = 32 + lane < kk;
          const int j0 = row[lane], j1 = row[32 + lane];
          float rx0 = 0.f, ry0 = 0.f, rz0 = 0.f, rx1 = 0.f, ry1 = 0.f, rz1 = 0.f;
          if (act0 && j0 >= 0) {
            rx0 = P[(size_t)j0 * 3] - x;
            ry0 = P[(size_t)j0 * 3 + 1] - y;
            rz0 = P[(size_t)j0 * 3 + 2] - z;
          }
          if (act1 && j1 >= 0) {
            rx1 = P[(size_t)j1 * 3] - x;
            ry1 = P[(size_t)j1 * 3 + 1] - y;
            rz1 = P[(size_t)j1 * 3 + 2] - z;
          }
          float w0, w1, wsum;
          const float3 o = fused_row2(sw, x, y, z, rx0, ry0, rz0, rx1, ry1, rz1, act0, act1,
                                      max((kk + 15) / 16, 1), w0, w1, wsum);
          float* dst = p.out + ((size_t)b * N + qi) * (PAY ? 3 + p.Cp : 3);
          if (lane == 0) {
            dst[0] = o.x;
            dst[1] = o.y;
            dst[2] = o.z;
          }
          if constexpr (PAY) {
            // the payload by original row: an unfilled active slot takes row qi's own
            const int s0 = row[lane], s1 = row[32 + lane];
            const float* x0 = p.payload + ((size_t)b * N + (s0 >= 0 ? s0 : qi)) * p.Cp;
            const float* x1 = p.payload + ((size_t)b * N + (s1 >= 0 ? s1 : qi)) * p.Cp;
            payload_sums2(w0, w1, wsum, act0, act1, p.Cp,
                          [&](int c, int h) { return __ldg((h ? x1 : x0) + c); }, dst + 3);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = 32 * h + lane;
            if (s >= p.k) continue;
            const int j = row[s] >= 0 ? row[s] : qi;  // unfilled slot: the row itself
            const size_t o = ((size_t)b * N + qi) * p.k + s;
            p.out_i[o] = j;
            p.out_r[o * 3] = __fsub_rn(P[(size_t)j * 3], x);
            p.out_r[o * 3 + 1] = __fsub_rn(P[(size_t)j * 3 + 1], y);
            p.out_r[o * 3 + 2] = __fsub_rn(P[(size_t)j * 3 + 2], z);
          }
        }
        continue;
      }
      const int idx = slots[(32 * half + i) * SS + lane];
      if (ONESHOT) {
        const bool active = lane < k1 + k2;
        float rx = 0.f, ry = 0.f, rz = 0.f;
        if (active && idx >= 0) {
          rx = P[(size_t)idx * 3] - x;
          ry = P[(size_t)idx * 3 + 1] - y;
          rz = P[(size_t)idx * 3 + 2] - z;
        }
        float w, wsum;
        const float3 o = fused_row(sw, x, y, z, rx, ry, rz, active, w, wsum);
        float* dst = p.out + ((size_t)b * N + qi) * (PAY ? 3 + p.Cp : 3);
        if (lane == 0) {
          dst[0] = o.x;
          dst[1] = o.y;
          dst[2] = o.z;
        }
        if constexpr (PAY) {
          // the payload by original row: an unfilled active slot takes row qi's own
          // (the slot read again: kept in a register across the head, it spills)
          const int src = slots[(32 * half + i) * SS + lane];
          const float* xp = p.payload + ((size_t)b * N + (src >= 0 ? src : qi)) * p.Cp;
          payload_sums(w, wsum, active, p.Cp, [&](int c) { return __ldg(xp + c); }, dst + 3);
        }
      } else if (lane < p.k) {
        const int j = idx >= 0 ? idx : qi;  // unfilled slot: the row itself
        const size_t o = ((size_t)b * N + qi) * p.k + lane;
        p.out_i[o] = j;
        p.out_r[o * 3] = __fsub_rn(P[(size_t)j * 3], x);
        p.out_r[o * 3 + 1] = __fsub_rn(P[(size_t)j * 3 + 1], y);
        p.out_r[o * 3 + 2] = __fsub_rn(P[(size_t)j * 3 + 2], z);
      }
    }
    group_sync(bar);  // the group is done with the slots before the next tile stages
    if (p.stamps && gt == 0) {
      unsigned long long* s = p.stamps + (size_t)tile * FC_STAMPS;
      s[0] = t0;
      s[1] = t1;
      s[2] = global_ns();
      s[3] = (unsigned long long)walked;
    }
  }
}

template <int KMAX>
static size_t cells_smem(bool oneshot, int C) {
  return sizeof(float) * (oneshot ? ONE_NW : 0) +
         sizeof(float4) * CellsShape<KMAX>::groups * CellsShape<KMAX>::region(C);
}

template <bool ONESHOT, bool PAY, int KMAX>
static cudaError_t launch_cells(const CellsParams& p, cudaStream_t st) {
  const auto kernel = fusion_cells_kernel<ONESHOT, PAY, KMAX>;
  constexpr int threads = CellsShape<KMAX>::warps * 32;
  const size_t smem = cells_smem<KMAX>(ONESHOT, p.C);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)p.B * p.nt;
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, tiles));
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int KMAX>
static cudaError_t launch_cells_mode(const CellsParams& p, cudaStream_t st) {
  return !p.wtc ? launch_cells<false, false, KMAX>(p, st)
                : p.Cp ? launch_cells<true, true, KMAX>(p, st)
                       : launch_cells<true, false, KMAX>(p, st);
}

// pts [B, N, 3]; keys [B, Np, 4] (x, y, z, original id bits; pads id N),
// boxes [B, nc, 4, 4], order and lbs [B, Np / TQ, nc] (nc = Np / C), torder
// [B * Np / TQ] a permutation of the tiles (the order they are taken), seg
// [B, 4] = (N1, N, k1, k2), next one zeroed int32, all on the device; TQ =
// 64; 1 <= k <= 64 (the instantiation by k: KMAX = 32 up to 32, else 64).
// One-shot mode when wtc is not null (the score MLP 4 -> h1 -> h2 ->
// h3 split by _build.pack_tf32(..., chain=True)), with a payload [B, N, Cp]
// fp32 in the original row order (0 <= Cp <= PAYLOAD_MAX, null for Cp ==
// 0): out [B, N, 3 + Cp]; else (Cp == 0) out_i [B, N, k] int64 and out_r
// [B, N, k, 3].  scanned: an unsigned 64-bit
// counter of the key pairs scanned, or null; stamps: [B, Np / TQ,
// FC_STAMPS] unsigned 64-bit (zeroed), or null.
extern "C" int pci_fusion_cells(const void* pts, const void* keys, const void* boxes,
                                const void* order, const void* lbs, const void* torder,
                                const void* seg,
                                const void* wtc, int h1, int h2, int h3,
                                const void* payload, int Cp, void* out,
                                void* out_i, void* out_r, void* scanned, void* stamps,
                                void* next, int B, int N, int Np, int C, int TQ, int k,
                                void* stream) {
  if (N < 1 || B < 1 || Np < N || C < 32 || C % 32 || Np % C || TQ != FC_TQ ||
      Np % TQ || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  if (wtc && (h1 != ONE_H1 || h2 != ONE_H2 || h3 != ONE_H3)) return (int)cudaErrorInvalidValue;
  if (Cp < 0 || Cp > PAYLOAD_MAX || (Cp > 0 && (payload == nullptr || wtc == nullptr)))
    return (int)cudaErrorInvalidValue;
  CellsParams p;
  p.pts = static_cast<const float*>(pts);
  p.keys = static_cast<const float4*>(keys);
  p.boxes = static_cast<const float4*>(boxes);
  p.order = static_cast<const int*>(order);
  p.lbs = static_cast<const float*>(lbs);
  p.torder = static_cast<const int*>(torder);
  p.seg = static_cast<const int*>(seg);
  p.wtc = static_cast<const float*>(wtc);
  p.payload = static_cast<const float*>(payload);
  p.out = static_cast<float*>(out);
  p.out_i = static_cast<long long*>(out_i);
  p.out_r = static_cast<float*>(out_r);
  p.scanned = static_cast<unsigned long long*>(scanned);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.next = static_cast<int*>(next);
  p.B = B, p.N = N, p.Np = Np, p.C = C, p.nc = Np / C, p.nt = Np / TQ, p.k = k, p.Cp = Cp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(k > 32 ? launch_cells_mode<64>(p, st) : launch_cells_mode<32>(p, st));
}

// The kernel's resources at chunks of 256 keys (common.cuh's kernel_attrs):
// one-shot without and with the payload, and residual, at k <= 32 and k <= 64.
template <bool ONESHOT, bool PAY, int KMAX>
static int cells_attrs(int* out) {
  return kernel_attrs(fusion_cells_kernel<ONESHOT, PAY, KMAX>, cells_smem<KMAX>(ONESHOT, 256),
                      out, CellsShape<KMAX>::warps * 32);
}
extern "C" int pci_fusion_cells_attrs(int* out) { return cells_attrs<true, false, 32>(out); }
extern "C" int pci_fusion_cells_payload_attrs(int* out) { return cells_attrs<true, true, 32>(out); }
extern "C" int pci_fusion_cells_resi_attrs(int* out) { return cells_attrs<false, false, 32>(out); }
extern "C" int pci_fusion_cells64_attrs(int* out) { return cells_attrs<true, false, 64>(out); }
extern "C" int pci_fusion_cells64_payload_attrs(int* out) {
  return cells_attrs<true, true, 64>(out);
}
extern "C" int pci_fusion_cells_resi64_attrs(int* out) {
  return cells_attrs<false, false, 64>(out);
}
