// The annealed Gauss-Seidel auction of the EMD assignment: one bidding
// pass over every query row (auction_pass_kernel) and the serial
// displacement chain that follows it (auction_chase_kernel).
//
// Replaces pci_tpu/ops/pallas_kernels/auction_tpu.py:_auction_pass (the
// pass kernel, :201) and :_auction_chase (the chase kernel, :323), driven
// from the host by ops/cuda_kernels/auction_cuda.py:auction as
// _auction_impl drives them.  Costs are normalised squared distances
// d = (dx*dx + dy*dy) + dz*dz rounded op by op (common.cuh sqdist3) and a
// row's value of column j is V = d + price[j]; no [n, m] matrix exists.
//
// The pass runs query tiles of 256 rows IN ORDER: tile t + 1 bids against
// the prices and owners that tile t left.  That order is the function (a
// Jacobi auction, every tile at once, does not converge at 16k points;
// pci_tpu/ops/emd.py:118-123).  Within a tile:
//   (AB) every row computes exactly v1 (its least V), i1 (its column, the
//        lowest index on ties) and v2 (the least V over the other
//        columns), then bids when it is unassigned, evicted
//        (owner[assign] != row) or violates eps-complementary slackness
//        (V of its column > (v1 + 1.0001 eps) + 1e-5).  A bid is
//        incr = min(v2 - v1, 1e30) + eps on column i1, entered with a
//        64-bit atomicMax of (bits of incr) << 32 | ~row: incr > 0, so the
//        largest key is the highest bid, ties to the lowest row;
//   (C)  each bidder reads its column's key: the winner raises the price
//        by its incr, takes the column and is assigned; a loser is
//        unassigned.  A previous owner learns of its eviction lazily, when
//        its own tile comes round.
// The TPU kernel packs V's low 11 mantissa bits with the column for its
// argmin and incr's low 8 with the row for the bid; both selections here
// are exact, so the kernel equals its plain version (auction_pass_plain)
// bit for bit.
//
// What bounds it on the H100: operations, ~8 a (row, column) pair a pass
// (n * m a pass: 2.1e9 at 16,384 points, 0.03 ms at 67 TFLOP/s), but a
// pass is 64 dependent tiles, each two grid barriers apart, so barrier
// and L2 latency set its time.  Design: one cooperative launch a pass
// (stages.cuh grid_sync); a tile's rows go two to a block, each block
// streams all m keys (through L1/L2) and prices (L2) once for
// both rows; block-wide top-2 reductions; the column keys are double
// buffered by tile parity, so a tile clears its predecessor's entries
// while it bids into the other buffer, and the buffers are zero again when
// the launch ends.  Mutable state (price, owner, assign, the keys) is read
// with ld.global.cg, from L2, never from a stale L1 line.
//
// The chase is one block of 1,024 threads.  A hop takes the lowest-index
// flagged row (a bitmask in shared memory, searched by warp 0), scans its
// exact V over all m keys (block-wide top-2), bids on its argmin column,
// raises the price, takes the column and flags the previous owner only if
// that row is still assigned to the column (a stale owner entry left by a
// pass-side rebid must not reopen an assigned row); it stops when nothing
// is flagged or after max_hops hops.  Its bound: 8 operations a key a hop;
// its time is the hop's latency (three block barriers and a 16-key scan a
// thread at 16,384 points).
#include "stages.cuh"

#define AUC_TQ 256        // query rows a tile: the Gauss-Seidel step
#define AUC_GROUPS 128    // AUC_TQ / 2: a block scans two rows at once
#define AUC_CHASE_THREADS 1024

struct Top2 {
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 top2_empty() { return {CUDART_INF_F, 0x7fffffff, CUDART_INF_F}; }

// One more column j, scanned in increasing j: a tie with v1 keeps the
// earlier index and makes v2 == v1.
__device__ __forceinline__ void top2_push(Top2& t, float v, int j) {
  if (v < t.v1) {
    t.v2 = t.v1;
    t.v1 = v;
    t.i1 = j;
  } else {
    t.v2 = fminf(t.v2, v);
  }
}

// Merge of two disjoint column sets: (v1, i1) the lexicographic least,
// v2 the least of everything else.  Exact and order-free.
__device__ __forceinline__ void top2_merge(Top2& t, float w1, int j1, float w2) {
  if (w1 < t.v1 || (w1 == t.v1 && j1 < t.i1)) {
    t.v2 = fminf(t.v1, w2);
    t.v1 = w1;
    t.i1 = j1;
  } else {
    t.v2 = fminf(t.v2, w1);
  }
}

__device__ __forceinline__ void top2_warp(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float w1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
    const int j1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    const float w2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
    top2_merge(t, w1, j1, w2);
  }
}

struct Pt {
  float x, y, z;
};

__device__ __forceinline__ Pt load_pt(const float* xyz, int i) {
  return {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
}

__device__ __forceinline__ float value(Pt q, Pt k, float price) {
  return __fadd_rn(sqdist3(q.x, q.y, q.z, k.x, k.y, k.z), price);
}

__device__ __forceinline__ float bid_incr(const Top2& t, float eps) {
  return __fadd_rn(fminf(__fsub_rn(t.v2, t.v1), 1e30f), eps);
}

struct AuctionPassParams {
  const float* q;             // [n][3] normalised queries
  const float* k;             // [m][3] normalised keys
  float* price;               // [m]
  int* assign;                // [n], -1 unassigned
  int* owner;                 // [m], -1 none
  unsigned long long* best;   // [2][m], zero: the column keys by tile parity
  unsigned int* bar;          // [2]: the grid barrier's counter (zeroed), bidders
  int n, m;
  float eps, cs;              // eps and 1.0001f * eps, rounded once
};

__global__ void __launch_bounds__(256) auction_pass_kernel(const __grid_constant__ AuctionPassParams p) {
  __shared__ float sv1[2][8], sv2[2][8];
  __shared__ int si1[2][8];
  __shared__ unsigned long long s_key[AUC_TQ];  // this tile's bids by local row
  __shared__ int s_col[AUC_TQ];
  __shared__ unsigned char s_bid[AUC_TQ];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned int passed = 0, bidders = 0;
  for (int lr = threadIdx.x; lr < AUC_TQ; lr += blockDim.x) s_bid[lr] = 0;
  __syncthreads();
  const int tiles = (p.n + AUC_TQ - 1) / AUC_TQ;
  for (int t = 0; t < tiles; ++t) {
    const int r0 = t * AUC_TQ;
    unsigned long long* best = p.best + (size_t)(t & 1) * p.m;
    unsigned long long* prev = p.best + (size_t)((t + 1) & 1) * p.m;
    // ---- AB: exact top-2 of two rows a group, the bidding mask, the bids
    for (int g = blockIdx.x; 2 * g < AUC_TQ && r0 + 2 * g < p.n; g += gridDim.x) {
      const int ra = r0 + 2 * g;
      const bool has_b = ra + 1 < p.n;
      const Pt qa = load_pt(p.q, ra);
      const Pt qb = load_pt(p.q, has_b ? ra + 1 : ra);
      // the row's held column, owner and value: fixed during this phase,
      // so they are fetched while the block scans
      int held = -1, own = -1;
      Pt kh = {0.f, 0.f, 0.f};
      float ph = 0.f;
      const int me = warp == 0 ? 0 : (warp == 1 && has_b ? 1 : -1);
      if (lane == 0 && me >= 0) {
        const int lr = 2 * g + me;
        if (s_bid[lr]) __stcg(prev + s_col[lr], 0ull);  // the previous tile's bid
        held = __ldcg(p.assign + r0 + lr);
        if (held >= 0) {
          own = __ldcg(p.owner + held);
          kh = load_pt(p.k, held);
          ph = __ldcg(p.price + held);
        }
      }
      Top2 ta = top2_empty(), tb = top2_empty();
      for (int j = threadIdx.x; j < p.m; j += blockDim.x) {
        const Pt kj = load_pt(p.k, j);
        const float pj = __ldcg(p.price + j);
        top2_push(ta, value(qa, kj, pj), j);
        top2_push(tb, value(qb, kj, pj), j);
      }
      top2_warp(ta);
      top2_warp(tb);
      if (lane == 0) {
        sv1[0][warp] = ta.v1, si1[0][warp] = ta.i1, sv2[0][warp] = ta.v2;
        sv1[1][warp] = tb.v1, si1[1][warp] = tb.i1, sv2[1][warp] = tb.v2;
      }
      __syncthreads();
      if (lane == 0 && me >= 0) {
        const int lr = 2 * g + me, r = r0 + lr;
        Top2 t2 = top2_empty();
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
          top2_merge(t2, sv1[me][w], si1[me][w], sv2[me][w]);
        bool bidding = held < 0 || own != r;
        if (!bidding) {
          const Pt q = me ? qb : qa;
          bidding = value(q, kh, ph) > __fadd_rn(__fadd_rn(t2.v1, p.cs), 1e-5f);
        }
        s_bid[lr] = bidding;
        if (bidding) {
          const float incr = bid_incr(t2, p.eps);
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(incr) << 32) | (unsigned int)(~r);
          s_key[lr] = key;
          s_col[lr] = t2.i1;
          atomicMax(best + t2.i1, key);
          ++bidders;
        }
      }
      __syncthreads();  // the partials are rewritten by the next group
    }
    grid_sync(p.bar, passed);
    // ---- C: each column's highest bid wins
    for (int g = blockIdx.x; 2 * g < AUC_TQ && r0 + 2 * g < p.n; g += gridDim.x) {
      const int me = warp == 0 ? 0 : (warp == 1 ? 1 : -1);
      const int lr = 2 * g + me, r = r0 + lr;
      if (lane == 0 && me >= 0 && r < p.n && s_bid[lr]) {
        const int c = s_col[lr];
        const unsigned long long key = s_key[lr];
        if (__ldcg(best + c) == key) {
          const float incr = __uint_as_float((unsigned int)(key >> 32));
          __stcg(p.price + c, __fadd_rn(__ldcg(p.price + c), incr));
          __stcg(p.owner + c, r);
          __stcg(p.assign + r, c);
        } else {
          __stcg(p.assign + r, -1);
        }
      }
    }
    grid_sync(p.bar, passed);
  }
  // the bids no later tile cleared (the last tile's, and the tile before's
  // for rows past n in the last tile) back to zero, in either buffer: no
  // block reads them any more
  for (int g = blockIdx.x; 2 * g < AUC_TQ; g += gridDim.x) {
    const int me = warp == 0 ? 0 : (warp == 1 ? 1 : -1);
    if (lane == 0 && me >= 0 && s_bid[2 * g + me]) {
      const int c = s_col[2 * g + me];
      __stcg(p.best + c, 0ull);
      __stcg(p.best + p.m + c, 0ull);
    }
  }
  if (lane == 0 && bidders) atomicAdd(p.bar + 1, bidders);
}

__global__ void __launch_bounds__(AUC_CHASE_THREADS)
auction_chase_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     float* price, int* assign, int* owner, int* hops_out, int n,
                     int m, float eps, int max_hops) {
  extern __shared__ unsigned int flags[];  // one bit a row: needs a bid
  __shared__ float wv1[32], wv2[32];
  __shared__ int wi1[32];
  __shared__ int s_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int words = (n + 31) >> 5;
  for (int w = threadIdx.x; w < words; w += blockDim.x) flags[w] = 0u;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int a = assign[r];
    if (a < 0 || owner[a] != r) atomicOr(flags + (r >> 5), 1u << (r & 31));
  }
  __syncthreads();
  int hops = 0;
  for (; hops < max_hops; ++hops) {
    if (warp == 0) {
      int cand = 0x7fffffff;
      for (int w = lane; w < words; w += 32) {
        const unsigned int f = flags[w];
        if (f) {
          cand = w * 32 + __ffs(f) - 1;
          break;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, off));
      if (lane == 0) s_row = cand;
    }
    __syncthreads();
    const int r = s_row;
    if (r == 0x7fffffff) break;
    const Pt qr = load_pt(q, r);
    Top2 t = top2_empty();
    for (int j = threadIdx.x; j < m; j += blockDim.x) top2_push(t, value(qr, load_pt(k, j), price[j]), j);
    top2_warp(t);
    if (lane == 0) wv1[warp] = t.v1, wi1[warp] = t.i1, wv2[warp] = t.v2;
    __syncthreads();
    if (threadIdx.x == 0) {
      Top2 b = top2_empty();
      for (int w = 0; w < nwarps; ++w) top2_merge(b, wv1[w], wi1[w], wv2[w]);
      const int j1 = b.i1;
      price[j1] = __fadd_rn(price[j1], bid_incr(b, eps));
      const int old = owner[j1];
      owner[j1] = r;
      assign[r] = j1;
      if (old >= 0 && old != r && assign[old] == j1) flags[old >> 5] |= 1u << (old & 31);
      flags[r >> 5] &= ~(1u << (r & 31));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *hops_out = hops;
}

// q [n][3], k [m][3] fp32, normalised; price [m] fp32,
// assign [n] and owner [m] int32, updated in place; best [2][m] uint64
// all zero (left zero); counters [2] uint32 zeroed: the grid barrier and
// the pass's bidder count.  n >= 1, m >= 2.
extern "C" int pci_auction_pass(const void* q, const void* k, void* price,
                                void* assign, void* owner, void* best,
                                void* counters, int n, int m, float eps,
                                float cs, void* stream) {
  if (n < 1 || m < 2) return (int)cudaErrorInvalidValue;
  AuctionPassParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.price = static_cast<float*>(price);
  p.assign = static_cast<int*>(assign);
  p.owner = static_cast<int*>(owner);
  p.best = static_cast<unsigned long long*>(best);
  p.bar = static_cast<unsigned int*>(counters);
  p.n = n, p.m = m, p.eps = eps, p.cs = cs;
  return launch_cooperative(auction_pass_kernel, p, 0, AUC_GROUPS,
                            static_cast<cudaStream_t>(stream));
}

// As pci_auction_pass's state; hops [1] int32 receives the hops made.
extern "C" int pci_auction_chase(const void* q, const void* k, void* price,
                                 void* assign, void* owner, void* hops, int n,
                                 int m, float eps, int max_hops, void* stream) {
  if (n < 1 || m < 2 || max_hops < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned int) * (size_t)((n + 31) / 32);
  cudaError_t e = allow_smem(auction_chase_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  auction_chase_kernel<<<1, AUC_CHASE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(price), static_cast<int*>(assign), static_cast<int*>(owner),
      static_cast<int*>(hops), n, m, eps, max_hops);
  return (int)cudaGetLastError();
}
