// The annealed Gauss-Seidel auction of the EMD assignment: one bidding
// pass over every query row (auction_pass_kernel) and the serial
// displacement chain that follows it (auction_chase_cluster_kernel, and
// auction_chase_kernel above its size limit).
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
// are exact, so the kernels equal their plain versions
// (auction_pass_plain, auction_chase_plain) bit for bit.
//
// The pass on the H100.  Its work bound is ~8 operations a (row, column)
// pair (2.1e9 a pass at 16,384 points, 0.03 ms at 67 TFLOP/s), but a pass
// is 64 dependent tiles, each two grid barriers apart, so latency sets
// its time.  In the earlier design most of a tile was its scan, whose
// iterations each waited on an L2 round trip for a price and a
// 12-byte-stride key.  Design: one cooperative launch a pass, one block
// of 512 threads an SM; each block stages the keys in shared memory once
// a launch (x, y, z arrays; past AUC_STAGED keys the rest are read from
// L1/L2); a thread's next AUC_PB prices are loaded together before their
// arithmetic and the scan has no branch (scan_pair); a row's held column
// is read a tile ahead (no earlier tile of a pass moves it); a tile's
// rows go two to a block; the grid barrier is stages.cuh grid_sync.  The
// column keys are double buffered by tile parity, so a tile clears its
// predecessor's entries while it bids into the other buffer, and the
// buffers are zero again when the launch ends.  Mutable state (price,
// owner, assign, the keys) is read with ld.global.cg, from L2, never from
// a stale L1 line.  chip_smoke.py's `stages auction` line splits a tile
// and a chase hop by the kernels' optional %globaltimer stamps.
//
// The chase.  A hop takes the lowest-index flagged row r, scans its exact
// V over all m columns (top-2), bids on its argmin column j1, raises the
// price, takes the column and flags the previous owner only if that row
// is still assigned to j1 (a stale owner entry left by a pass-side rebid
// must not reopen an assigned row); it stops when nothing is flagged or
// after max_hops hops.  Its work bound is 8 operations a key a hop, but
// the hops form one serial chain: a hop's latency is its time.
//
// auction_chase_cluster_kernel runs the chain on one thread-block cluster
// of C CTAs (16, or 8 where the card refuses 16), one an SM, with no
// global memory access inside the hop loop:
//   - CTA c holds columns j = c, c + C, ... in shared memory: keys, price,
//     owner and the owner's query point (so an evicted row's point comes
//     with its column), loaded once a launch and written back at the end;
//     and query rows c, c + C, ..., read by the others through
//     distributed shared memory;
//   - every CTA holds a replica of assign [n] (16 bits a row) and of the
//     flag bitmap with a summary level (one bit a word), applies the same
//     update each hop and so picks the same row without a message;
//   - a hop: each of the 8 scanning warps takes its columns for r (up to
//     4 a thread at 16,384 points), reduces them (top2_warp: three
//     integer reductions) and sends its partial (v1, i1, v2, owner[i1]
//     before this hop and that owner's point) to a slot of every CTA
//     with st.async, counted on that CTA's mbarrier (two, by hop
//     parity); meanwhile a helper warp finds r2, the lowest flagged row
//     above r, with two __ffs, and fetches its point from its CTA; then
//     ONE cluster barrier and the wait for the hop's C * 8 partials;
//     every warp merges them (top2_merge: exact, order-free) into j1, the
//     bid and old = the winning partial's owner; every CTA sets
//     assign[r] = j1, clears r's flag and flags old when it is evicted;
//     the thread that scans column j1 in the CTA that holds it raises its
//     price and sets its owner.  The next row is old when old is evicted
//     and below r2, else r2: no search on the critical path, and no block
//     barrier in the hop.
//   - the cluster barrier is relaxed: arrive.release compiles to a
//     GPU-scope memory barrier (MEMBAR.ALL.GPU), which in a development
//     measurement cost more than the rest of the barrier; the partials'
//     visibility is the mbarrier's (st.async's complete_tx, waited with
//     acquire at cluster scope), and the barrier keeps every CTA within
//     one hop of the others, so a slot and its mbarrier phase are reused
//     only after every CTA has read them.
// It serves n, m <= CHASE_CLUSTER_MAX_N = 32,768 (the two-level flag
// search covers 32^3 rows; the replicas and the column share take 156 KB
// a CTA at 32,768 with C = 16).  auction_chase_kernel, one block of 1,024
// threads with its state in global memory and its flags in shared
// memory, serves larger clouds: the host picks the route from the sizes
// before the launch (auction_cuda.chase_cluster_ok).
#include <cooperative_groups.h>

#include "stages.cuh"

namespace cg = cooperative_groups;

#define AUC_TQ 256        // query rows a tile: the Gauss-Seidel step
#define AUC_GROUPS 128    // AUC_TQ / 2: a block scans two rows at once
#define AUC_THREADS 512   // the pass's block
#define AUC_WARPS (AUC_THREADS / 32)
#define AUC_PB 8          // columns a thread whose prices load together
#define AUC_STAGED 18432  // keys a pass block stages in shared memory (216 KB)
#define AUC_PASS_STAMPS 5 // a pass block's phase sums, ns: scan, merge + bid, barrier, C, barrier
#define AUC_CHASE_THREADS 1024
#define CHASE_WARPS 8     // the cluster chase's scanning warps a CTA
#define CHASE_SCAN (CHASE_WARPS * 32)
#define CHASE_THREADS (CHASE_SCAN + 32)  // and one helper warp
#define CHASE_MAX_C 16
#define CHASE_UNROLL 4    // a scanning thread's columns in flight together
#define CHASE_CLUSTER_MAX_N 32768
#define CHASE_STAMPS 6    // the cluster chase's phase sums, ns: scan, publish, barrier + partials, merge + update, helper's search + fetch, merge
#define NO_ROW 0x7fffffff

struct Top2 {
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 top2_empty() { return {CUDART_INF_F, NO_ROW, CUDART_INF_F}; }

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

// The warp's (v1, i1, v2) over its lanes' disjoint column sets: V >= 0,
// so a value's bits order as the value, and three integer reductions give
// the exact result (the lowest column among the lanes holding the least
// value; v2 the least of the winner's v2 and every other lane's v1).
__device__ __forceinline__ void top2_warp(Top2& t) {
  const unsigned int b1 = __reduce_min_sync(0xffffffffu, __float_as_uint(t.v1));
  const int k1 = (int)__reduce_min_sync(
      0xffffffffu, __float_as_uint(t.v1) == b1 ? (unsigned int)t.i1 : (unsigned int)NO_ROW);
  const unsigned int b2 = __reduce_min_sync(
      0xffffffffu, __float_as_uint(t.i1 == k1 ? t.v2 : t.v1));
  t = {__uint_as_float(b1), k1, __uint_as_float(b2)};
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
  unsigned long long* stamps; // [grid][AUC_PASS_STAMPS] ns, or null
  int n, m, ks;               // ks = min(m, AUC_STAGED) keys in shared memory
  float eps, cs;              // eps and 1.0001f * eps, rounded once
};

// One row pair's exact top-2 over the columns [j0, j1) a thread scans
// (j = tid, tid + AUC_THREADS, ...: increasing), AUC_PB at a time: their
// prices are loaded together before the arithmetic, and a column past j1
// takes the price +inf (a value that changes no top-2) and a clamped key,
// so the loop has no branch.  `key(j)` gives column j's point.
template <typename Key>
__device__ __forceinline__ void scan_pair(const float* price, int j0, int j1, Pt qa, Pt qb,
                                          Top2& ta, Top2& tb, Key key) {
  for (int jb = j0 + (int)threadIdx.x; jb < j1; jb += AUC_PB * AUC_THREADS) {
    float pj[AUC_PB];
#pragma unroll
    for (int i = 0; i < AUC_PB; ++i) {
      const int j = jb + i * AUC_THREADS;
      pj[i] = j < j1 ? __ldcg(price + j) : CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < AUC_PB; ++i) {
      const int j = jb + i * AUC_THREADS;
      const Pt kj = key(j < j1 ? j : jb);
      top2_push(ta, value(qa, kj, pj[i]), j);
      top2_push(tb, value(qb, kj, pj[i]), j);
    }
  }
}

__global__ void __launch_bounds__(AUC_THREADS, 1) auction_pass_kernel(const __grid_constant__ AuctionPassParams p) {
  extern __shared__ float skey[];  // [3][ks]: the staged keys' x, y, z
  __shared__ float sv1[2][AUC_WARPS], sv2[2][AUC_WARPS];
  __shared__ int si1[2][AUC_WARPS];
  __shared__ unsigned long long s_key[AUC_TQ];  // this tile's bids by local row
  __shared__ int s_col[AUC_TQ];
  __shared__ unsigned char s_bid[AUC_TQ];
  __shared__ int s_held[AUC_TQ];  // the next tile's rows' columns (no tile before theirs moves them)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = p.ks;
  float* skx = skey;
  float* sky = skey + ks;
  float* skz = skey + 2 * ks;
  unsigned int passed = 0, bidders = 0;
  for (int j = threadIdx.x; j < ks; j += AUC_THREADS) {
    skx[j] = __ldg(p.k + 3 * j);
    sky[j] = __ldg(p.k + 3 * j + 1);
    skz[j] = __ldg(p.k + 3 * j + 2);
  }
  for (int lr = threadIdx.x; lr < AUC_TQ; lr += AUC_THREADS) {
    s_bid[lr] = 0;
    s_held[lr] = lr < p.n ? __ldcg(p.assign + lr) : -1;
  }
  __syncthreads();
  const bool timed = p.stamps != nullptr && threadIdx.x == 0;
  unsigned long long acc[AUC_PASS_STAMPS] = {0, 0, 0, 0, 0}, t0 = 0, t1 = 0;
  const int tiles = (p.n + AUC_TQ - 1) / AUC_TQ;
  for (int t = 0; t < tiles; ++t) {
    if (timed) t0 = global_ns();
    const int r0 = t * AUC_TQ;
    unsigned long long* best = p.best + (size_t)(t & 1) * p.m;
    unsigned long long* prev = p.best + (size_t)((t + 1) & 1) * p.m;
    // ---- AB: exact top-2 of two rows a group, the bidding mask, the bids
    for (int g = blockIdx.x; 2 * g < AUC_TQ && r0 + 2 * g < p.n; g += gridDim.x) {
      const int ra = r0 + 2 * g;
      const bool has_b = ra + 1 < p.n;
      const Pt qa = load_pt(p.q, ra);
      const Pt qb = load_pt(p.q, has_b ? ra + 1 : ra);
      // the row's held column (read a tile ahead), its owner, key and
      // price: fixed during this phase, so fetched with the scan's prices
      int held = -1, own = -1, held_next = -1;
      Pt kh = {0.f, 0.f, 0.f};
      float ph = 0.f;
      const int me = warp == 0 ? 0 : (warp == 1 && has_b ? 1 : -1);
      if (lane == 0 && me >= 0) {
        const int lr = 2 * g + me;
        if (s_bid[lr]) __stcg(prev + s_col[lr], 0ull);  // the previous tile's bid
        held = s_held[lr];
        const int hc = max(held, 0);
        own = __ldcg(p.owner + hc);
        ph = __ldcg(p.price + hc);
        kh = hc < ks ? Pt{skx[hc], sky[hc], skz[hc]} : load_pt(p.k, hc);
        if (r0 + AUC_TQ + lr < p.n) held_next = __ldcg(p.assign + r0 + AUC_TQ + lr);
      }
      Top2 ta = top2_empty(), tb = top2_empty();
      scan_pair(p.price, 0, ks, qa, qb, ta, tb, [&](int j) { return Pt{skx[j], sky[j], skz[j]}; });
      if (ks < p.m)  // past the staged keys: from L1/L2
        scan_pair(p.price, ks, p.m, qa, qb, ta, tb, [&](int j) { return load_pt(p.k, j); });
      top2_warp(ta);
      top2_warp(tb);
      if (timed) t1 = global_ns(), acc[0] += t1 - t0, t0 = t1;
      if (lane == 0) {
        sv1[0][warp] = ta.v1, si1[0][warp] = ta.i1, sv2[0][warp] = ta.v2;
        sv1[1][warp] = tb.v1, si1[1][warp] = tb.i1, sv2[1][warp] = tb.v2;
      }
      __syncthreads();
      if (me >= 0) {  // warp 0 finishes row a, warp 1 row b
        Top2 t2 = lane < AUC_WARPS ? Top2{sv1[me][lane], si1[me][lane], sv2[me][lane]} : top2_empty();
        top2_warp(t2);
        if (lane == 0) {
          const int lr = 2 * g + me, r = r0 + lr;
          s_held[lr] = held_next;
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
      }
      __syncthreads();  // the partials are rewritten by the next group
      if (timed) t1 = global_ns(), acc[1] += t1 - t0, t0 = t1;
    }
    grid_sync(p.bar, passed);
    if (timed) t1 = global_ns(), acc[2] += t1 - t0, t0 = t1;
    // ---- C: each column's highest bid wins
    for (int g = blockIdx.x; 2 * g < AUC_TQ && r0 + 2 * g < p.n; g += gridDim.x) {
      const int me = warp == 0 ? 0 : (warp == 1 ? 1 : -1);
      const int lr = 2 * g + me, r = r0 + lr;
      if (lane == 0 && me >= 0 && r < p.n && s_bid[lr]) {
        const int c = s_col[lr];
        const unsigned long long key = s_key[lr];
        const unsigned long long top = __ldcg(best + c);
        const float pc = __ldcg(p.price + c);  // read with the key: one round trip
        if (top == key) {
          const float incr = __uint_as_float((unsigned int)(key >> 32));
          __stcg(p.price + c, __fadd_rn(pc, incr));
          __stcg(p.owner + c, r);
          __stcg(p.assign + r, c);
        } else {
          __stcg(p.assign + r, -1);
        }
      }
    }
    if (timed) t1 = global_ns(), acc[3] += t1 - t0, t0 = t1;
    grid_sync(p.bar, passed);
    if (timed) t1 = global_ns(), acc[4] += t1 - t0;
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
  if (timed)
    for (int i = 0; i < AUC_PASS_STAMPS; ++i) p.stamps[(size_t)blockIdx.x * AUC_PASS_STAMPS + i] = acc[i];
}

// ---- the chase on one block (above the cluster kernel's size limit) ----

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
      int cand = NO_ROW;
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
    if (r == NO_ROW) break;
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

// ---- the chase on a thread-block cluster ----

// A CTA's partial of one hop, written into a slot of every CTA.
struct __align__(16) ChasePart {
  float v1;
  int i1;
  float v2;
  int old;   // owner[i1] before this hop
  float qx, qy, qz;  // that owner's query point
  int pad;
};

struct ChaseParams {
  const float* q;   // [n][3]
  const float* k;   // [m][3]
  float* price;     // [m]
  int* assign;      // [n]
  int* owner;       // [m]
  int* hops_out;    // [1]
  unsigned long long* stamps;  // [CHASE_STAMPS] ns (CTA 0's threads 0 and CHASE_SCAN), or null
  int n, m;
  int mc, nr;       // columns and query rows a CTA
  float eps;
  int max_hops;
};

// The lowest flagged row above `after` (NO_ROW if none), by one warp:
// the word of after + 1 masked, then the summary's lowest set bit among
// the later words (one ballot: n <= 32 * 32 * 32).
__device__ __forceinline__ int flag_search(const unsigned int* flags, const unsigned int* summ,
                                           int after, int n, int lane) {
  const int a = after + 1;
  if (a >= n) return NO_ROW;
  const int w0 = a >> 5;
  const unsigned int f0 = flags[w0] & (~0u << (a & 31));
  if (f0) return (w0 << 5) + __ffs(f0) - 1;
  const int w1 = w0 + 1, sw = w1 >> 5;
  unsigned int s = summ[lane];
  s = lane < sw ? 0u : (lane == sw ? s & (~0u << (w1 & 31)) : s);
  const unsigned int any = __ballot_sync(0xffffffffu, s != 0u);
  if (!any) return NO_ROW;
  const int l = __ffs(any) - 1;
  const int w = (l << 5) + __ffs(__shfl_sync(0xffffffffu, s, l)) - 1;
  return (w << 5) + __ffs(flags[w]) - 1;
}

__device__ __forceinline__ void flag_set(unsigned int* flags, unsigned int* summ, int r) {
  flags[r >> 5] |= 1u << (r & 31);
  summ[r >> 10] |= 1u << ((r >> 5) & 31);
}

__device__ __forceinline__ void flag_clear(unsigned int* flags, unsigned int* summ, int r) {
  if ((flags[r >> 5] &= ~(1u << (r & 31))) == 0u) summ[r >> 10] &= ~(1u << ((r >> 5) & 31));
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (this CTA's) in CTA `rank`.
__device__ __forceinline__ unsigned int cluster_addr(unsigned int addr, int rank) {
  unsigned int out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into CTA-remote shared memory, counted on that CTA's mbarrier.
__device__ __forceinline__ void st_async16(unsigned int addr, unsigned int bar, int a, int b, int c,
                                           int d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned int bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// The phase's one arrival, announcing `bytes` of st.async to come.
__device__ __forceinline__ void mbar_expect(unsigned int bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned int bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}" ::"r"(bar), "r"(parity) : "memory");
}

// Dynamic shared bytes of the cluster chase at C CTAs.
static inline size_t chase_cluster_smem(int n, int m, int C) {
  const size_t mc = (m + C - 1) / C, nr = (n + C - 1) / C;
  const size_t words = (n + 31) / 32;
  return 32 * mc + 12 * nr + 2 * (size_t)((n + 1) & ~1) + 4 * words + 4 * 32;
}

__global__ void __launch_bounds__(CHASE_THREADS, 1)
auction_chase_cluster_kernel(const __grid_constant__ ChaseParams p) {
  extern __shared__ __align__(16) float dyn[];
  // the hop's partials by hop parity: warp w of CTA c writes slot c * W + w
  __shared__ ChasePart slots[2][CHASE_MAX_C * CHASE_WARPS];
  __shared__ __align__(8) unsigned long long bars[2];  // their arrival, by hop parity
  __shared__ int s_r2[2];
  __shared__ float s_q2[2][3];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int lc = __ffs(C) - 1;  // C is 8 or 16
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool helper = warp == CHASE_WARPS;
  const int n = p.n, m = p.m, MC = p.mc, NR = p.nr;
  const int words = (n + 31) >> 5;
  const int bytes = C * CHASE_WARPS * (int)sizeof(ChasePart);  // a hop's partials into a CTA
  float* kx = dyn;
  float* ky = kx + MC;
  float* kz = ky + MC;
  float* pr = kz + MC;
  int* ow = reinterpret_cast<int*>(pr + MC);
  float* qox = reinterpret_cast<float*>(ow + MC);
  float* qoy = qox + MC;
  float* qoz = qoy + MC;
  float* qs = qoz + MC;  // [NR][3]: this CTA's rows of the query cloud
  // assign's replica in 16 bits (m <= 32,768 columns; 0xffff is -1)
  unsigned short* asg = reinterpret_cast<unsigned short*>(qs + 3 * NR);
  unsigned int* flags = reinterpret_cast<unsigned int*>(asg + ((n + 1) & ~1));
  unsigned int* summ = flags + words;  // 32 words
  // column j and query row r live in CTA j % C (r % C) at j / C (r / C)
  const int cn = m > c ? (m - c + C - 1) >> lc : 0;
  const int rn = n > c ? (n - c + C - 1) >> lc : 0;

  // ---- load: the CTA's columns and query rows, the replicas
  for (int l = tid; l < cn; l += CHASE_THREADS) {
    const int j = c + (l << lc);
    kx[l] = p.k[3 * j], ky[l] = p.k[3 * j + 1], kz[l] = p.k[3 * j + 2];
    pr[l] = p.price[j];
    const int o = p.owner[j];
    ow[l] = o;
    const Pt qo = o >= 0 ? load_pt(p.q, o) : Pt{0.f, 0.f, 0.f};
    qox[l] = qo.x, qoy[l] = qo.y, qoz[l] = qo.z;
  }
  for (int l = tid; l < rn; l += CHASE_THREADS) {
    const Pt qv = load_pt(p.q, c + (l << lc));
    qs[3 * l] = qv.x, qs[3 * l + 1] = qv.y, qs[3 * l + 2] = qv.z;
  }
  for (int w = tid; w < words; w += CHASE_THREADS) flags[w] = 0u;
  if (tid < 32) summ[tid] = 0u;
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&bars[0]), bytes);  // hops 0 and 1
    mbar_expect(smem_addr(&bars[1]), bytes);
  }
  __syncthreads();
  for (int r = tid; r < n; r += CHASE_THREADS) {
    const int a = p.assign[r];
    asg[r] = (unsigned short)a;
    if (a < 0 || p.owner[a] != r) atomicOr(flags + (r >> 5), 1u << (r & 31));
  }
  __syncthreads();
  for (int w = tid; w < words; w += CHASE_THREADS)
    if (flags[w]) atomicOr(summ + (w >> 5), 1u << (w & 31));
  cluster.sync();  // every CTA's query rows, replicas and mbarriers are in place

  int r = flag_search(flags, summ, -1, n, lane);
  Pt qr = {0.f, 0.f, 0.f};
  if (r != NO_ROW) qr = load_pt(cluster.map_shared_rank(qs, r & (C - 1)), r >> lc);
  // lane l < C of a scanning warp sends to CTA l: its slot and mbarrier there
  const int to = lane < C ? lane : 0, slot = c * CHASE_WARPS + (helper ? 0 : warp);
  const unsigned int dst0 = cluster_addr(smem_addr(&slots[0][slot]), to);
  const unsigned int dst1 = cluster_addr(smem_addr(&slots[1][slot]), to);
  const unsigned int bar0 = cluster_addr(smem_addr(&bars[0]), to);
  const unsigned int bar1 = cluster_addr(smem_addr(&bars[1]), to);
  const bool timed = p.stamps != nullptr && c == 0 && (tid == 0 || tid == CHASE_SCAN);
  unsigned long long acc[CHASE_STAMPS] = {0, 0, 0, 0, 0, 0}, t0 = 0, t1 = 0;
  int hops = 0;
  for (; hops < p.max_hops && r != NO_ROW; ++hops) {
    if (timed) t0 = global_ns();
    const int par = hops & 1;
    if (helper) {  // the next row but one, and its point, while the others scan
      const int r2 = flag_search(flags, summ, r, n, lane);
      if (lane == 0) {
        const Pt q2 = r2 != NO_ROW ? load_pt(cluster.map_shared_rank(qs, r2 & (C - 1)), r2 >> lc)
                                   : Pt{0.f, 0.f, 0.f};
        s_r2[par] = r2;
        s_q2[par][0] = q2.x, s_q2[par][1] = q2.y, s_q2[par][2] = q2.z;
        if (timed) t1 = global_ns(), acc[4] += t1 - t0, t0 = t1;
      }
    } else {  // the warp's columns, its partial into slot c * W + warp of every CTA
      Top2 t = top2_empty();
      for (int l0 = tid; l0 < cn; l0 += CHASE_UNROLL * CHASE_SCAN) {
#pragma unroll
        for (int u = 0; u < CHASE_UNROLL; ++u) {  // no branch: +inf past the end
          const int l = l0 + u * CHASE_SCAN, lv = l < cn ? l : l0;
          const float pl = l < cn ? pr[lv] : CUDART_INF_F;
          top2_push(t, value(qr, Pt{kx[lv], ky[lv], kz[lv]}, pl), c + (l << lc));
        }
      }
      top2_warp(t);
      if (timed) t1 = global_ns(), acc[0] += t1 - t0, t0 = t1;
      int old = -1;
      Pt qo = {0.f, 0.f, 0.f};
      if (t.i1 != NO_ROW) {
        const int l = t.i1 >> lc;
        old = ow[l];
        qo = Pt{qox[l], qoy[l], qoz[l]};
      }
      if (lane < C) {
        const unsigned int dst = par ? dst1 : dst0, bar = par ? bar1 : bar0;
        st_async16(dst, bar, __float_as_int(t.v1), t.i1, __float_as_int(t.v2), old);
        st_async16(dst + 16, bar, __float_as_int(qo.x), __float_as_int(qo.y), __float_as_int(qo.z), 0);
      }
    }
    __syncwarp();
    if (timed) t1 = global_ns(), acc[1] += t1 - t0, t0 = t1;
    // the hop's one cluster barrier (relaxed: the partials' arrival is the
    // mbarrier's); it keeps every CTA within one hop of the others, so a
    // slot is rewritten only after each CTA has read it
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    mbar_wait(smem_addr(&bars[par]), (hops >> 1) & 1);
    if (tid == 0 && hops >= 1) mbar_expect(smem_addr(&bars[par ^ 1]), bytes);  // for hop + 1
    if (timed) t1 = global_ns(), acc[2] += t1 - t0, t0 = t1;
    // every warp: the partials merged, the bid, the eviction, the next row
    static_assert(CHASE_MAX_C * CHASE_WARPS == 4 * 32, "four partials a lane");
    Top2 g4[4];  // the lane's partials: loaded, then merged as a tree
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = lane + 32 * u;
      const int4 e = *reinterpret_cast<const int4*>(&slots[par][i < C * CHASE_WARPS ? i : 0]);
      g4[u] = i < C * CHASE_WARPS ? Top2{__int_as_float(e.x), e.y, __int_as_float(e.z)} : top2_empty();
    }
    top2_merge(g4[0], g4[1].v1, g4[1].i1, g4[1].v2);
    top2_merge(g4[2], g4[3].v1, g4[3].i1, g4[3].v2);
    top2_merge(g4[0], g4[2].v1, g4[2].i1, g4[2].v2);
    Top2 g = g4[0];
    top2_warp(g);
    if (timed) acc[5] += global_ns() - t0;
    const int j1 = g.i1, cw = j1 & (C - 1), l1 = j1 >> lc;
    const ChasePart& win = slots[par][cw * CHASE_WARPS + ((l1 % CHASE_SCAN) >> 5)];
    const int old = win.old;
    const bool evict = old >= 0 && old != r && (int)asg[old] == j1;
    const int rb = s_r2[par];
    const bool to_old = evict && old < rb;
    const Pt qn = to_old ? Pt{win.qx, win.qy, win.qz} : Pt{s_q2[par][0], s_q2[par][1], s_q2[par][2]};
    if (cw == c && l1 % CHASE_SCAN == tid) {  // the thread that scans column j1
      pr[l1] = __fadd_rn(pr[l1], bid_incr(g, p.eps));
      ow[l1] = r;
      qox[l1] = qr.x, qoy[l1] = qr.y, qoz[l1] = qr.z;
    }
    if (helper && lane == 0) {
      asg[r] = (unsigned short)j1;
      if (evict) flag_set(flags, summ, old);
      flag_clear(flags, summ, r);
    }
    __syncwarp();  // a column's next reader, and the helper's next search, are in this warp
    if (timed) t1 = global_ns(), acc[3] += t1 - t0;
    r = to_old ? old : rb;
    qr = qn;
  }
  // ---- write back: the CTA's columns and its share of the assignment
  __syncthreads();
  for (int l = tid; l < cn; l += CHASE_THREADS) {
    const int j = c + (l << lc);
    p.price[j] = pr[l];
    p.owner[j] = ow[l];
  }
  for (int r = c + (tid << lc); r < n; r += CHASE_THREADS << lc) {
    const int a = asg[r];
    p.assign[r] = a == 0xffff ? -1 : a;
  }
  if (c == 0 && tid == 0) *p.hops_out = hops;
  if (timed && tid == 0)
    for (int i = 0; i < 4; ++i) p.stamps[i] = acc[i];
  if (timed && tid != 0) p.stamps[4] = acc[4], p.stamps[5] = acc[5];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// The cluster chase's launch shape for n rows and m columns: C = 16 CTAs
// where the card schedules a cluster of 16 with this shared memory, else
// 8; out = {C, dynamic shared bytes a CTA, clusters the card can hold}.
// An error when neither fits, or the sizes pass the kernel's limit.
// The last shape found is kept (the auction asks once a pass, same sizes).
static int chase_cluster_shape(int n, int m, int* out) {
  if (n < 1 || m < 2 || n > CHASE_CLUSTER_MAX_N || m > CHASE_CLUSTER_MAX_N)
    return (int)cudaErrorInvalidValue;
  static std::mutex mu;
  static int last[6] = {-1, -1, -1, 0, 0, 0};  // device, n, m -> C, smem, clusters
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  if (last[0] == dev && last[1] == n && last[2] == m) {
    out[0] = last[3], out[1] = last[4], out[2] = last[5];
    return 0;
  }
  e = cudaFuncSetAttribute(auction_chase_cluster_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  for (int C = CHASE_MAX_C; C >= 8; C /= 2) {
    const size_t smem = chase_cluster_smem(n, m, C);
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (smem + sizeof(ChasePart) * 2 * CHASE_MAX_C * CHASE_WARPS + 1024 > (size_t)optin) continue;
    if ((e = allow_smem(auction_chase_cluster_kernel, smem)) != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(CHASE_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, auction_chase_cluster_kernel, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a refused cluster size: try the next
      continue;
    }
    if (clusters >= 1) {
      out[0] = C, out[1] = (int)smem, out[2] = clusters;
      last[0] = dev, last[1] = n, last[2] = m, last[3] = C, last[4] = (int)smem, last[5] = clusters;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

static size_t pass_last_smem = sizeof(float) * 3 * AUC_STAGED;  // the last pass launch's

// q [n][3], k [m][3] fp32, normalised; price [m] fp32,
// assign [n] and owner [m] int32, updated in place; best [2][m] uint64
// all zero (left zero); counters [2] uint32 zeroed: the grid barrier and
// the pass's bidder count; stamps: null, or [grid][AUC_PASS_STAMPS] uint64
// (AUC_GROUPS blocks at most).  n >= 1, m >= 2.
extern "C" int pci_auction_pass(const void* q, const void* k, void* price,
                                void* assign, void* owner, void* best,
                                void* counters, void* stamps, int n, int m, float eps,
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
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.n = n, p.m = m, p.ks = std::min(m, AUC_STAGED), p.eps = eps, p.cs = cs;
  pass_last_smem = sizeof(float) * 3 * (size_t)p.ks;
  return launch_cooperative(auction_pass_kernel, p, sizeof(float) * 3 * (size_t)p.ks, AUC_GROUPS,
                            static_cast<cudaStream_t>(stream), AUC_THREADS);
}

// As pci_auction_pass's state; hops [1] int32 receives the hops made.
// One block: the route above the cluster kernel's size limit.
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

static int chase_last_n = 16384;  // the last cluster launch's max(n, m)

// The cluster chase's shape (chase_cluster_shape) without a launch.
extern "C" int pci_auction_cluster_shape(int n, int m, int* out) {
  return chase_cluster_shape(n, m, out);
}

// As pci_auction_chase, on one cluster (n, m <= CHASE_CLUSTER_MAX_N);
// stamps: null, or CHASE_STAMPS uint64 (zeroed).  A cluster the card
// refuses is an error, never another route.
extern "C" int pci_auction_chase_cluster(const void* q, const void* k, void* price,
                                         void* assign, void* owner, void* hops,
                                         void* stamps, int n, int m, float eps,
                                         int max_hops, void* stream) {
  if (max_hops < 0) return (int)cudaErrorInvalidValue;
  int shape[3];
  const int err = chase_cluster_shape(n, m, shape);
  if (err) return err;
  chase_last_n = std::max(n, m);
  const int C = shape[0];
  ChaseParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.price = static_cast<float*>(price);
  p.assign = static_cast<int*>(assign);
  p.owner = static_cast<int*>(owner);
  p.hops_out = static_cast<int*>(hops);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.n = n, p.m = m, p.mc = (m + C - 1) / C, p.nr = (n + C - 1) / C;
  p.eps = eps, p.max_hops = max_hops;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(CHASE_THREADS);
  cfg.dynamicSmemBytes = (size_t)shape[1];
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, auction_chase_cluster_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernels' resources at their last launch's shared memory (the
// cluster chase: its last shape's; common.cuh's kernel_attrs).
extern "C" int pci_auction_pass_attrs(int* out) {
  return kernel_attrs(auction_pass_kernel, pass_last_smem, out, AUC_THREADS);
}

extern "C" int pci_auction_chase_attrs(int* out) {
  int shape[3];
  const int err = chase_cluster_shape(chase_last_n, chase_last_n, shape);
  if (err) return err;
  return kernel_attrs(auction_chase_cluster_kernel, (size_t)shape[1], out, CHASE_THREADS);
}
