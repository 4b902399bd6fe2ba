// Fused set-conv tail (kernel row 2): ball query (first K in-radius keys in
// index order) + row gather + folded-BN MLP + max over the K slots.
//
// Replaces pci_tpu/ops/pallas_kernels/setconv_tpu.py:setconv_fused.
// Semantics are those of pci_tpu/ops/ball.py:ball_query: the first K hits
// by key index, a shortfall padded with the first hit, an empty query
// reading key 0.  The MLP input of a slot is [key_xyz - query, key_feats];
// every layer ends in ReLU; the output is the max over the slots.
//
// What bounds it on the H100: on FlowNet3D's four stages it moves under
// 1 MB and does under 0.15 GFLOP a call, so neither bytes nor operations:
// latency.  set_conv1's ball scan leads its time (every ball of the
// synthetic 16,384-point cloud at r = 0.5 walks all N keys, 16.8 M
// distance tests); the other stages wait on their MLPs' weights (set_conv4's
// chain, 259 -> 256 -> 256 -> 512, is 2 MB split for 3xTF32).
//
// Two tiles, both with the MLP on the tensor cores in 3xTF32 (mma_tf32.cuh:
// m16n8k8, the weights split once on the host by _build.pack_tf32), chosen
// by the plan before the launch (setconv_plan_launch):
// - ball_conv_tile<TensorMlp> (stages.cuh, the tile of rows 5 and 6; one
//   warp a centre scanning its keys in index order) wherever its keys fit
//   one of its scan chunks and its tiles fill at least a quarter of the SMs:
//   FlowNet3D's set_conv2 and set_conv3, and set_conv4 at 8 streams;
// - the cluster tile (setconv_kernel below) past either: set_conv1 (16,384
//   keys and more) and one stream's set_conv4 (16 centres).
// The split was measured on the H100 (chip_smoke.py's `stages setconv`
// lines): each tile is the faster one of the two where it is chosen.
//
// The cluster tile.  A tile takes Q <= 8 centres (Q K <= 64 rows where one
// wave of tiles fills the SMs, more centres a tile where it would not).
// The scan: keys staged a chunk of up to 4,096 at a time by cp.async (the
// next chunk in flight), so the block's barriers and merges come a few
// times a scan; every warp takes its slice of the chunk for all Q centres,
// forms each key's |k|^2 once, marks it by common.cuh's three-FMA test
// against every centre (a superset of the keys within the radius), one
// vote for all centres, then the exact sqdist3 test on the marked keys
// alone; a warp's hits go to its own list a centre (at most the slots the
// ball has left) and each centre's lists are appended in slice order: the
// first K hits by index.  Each k-step's hi*hi product is added in fp32
// apart from the two small ones.  The tiles of a small stage spread over
// thread-block clusters of C <= 8 blocks: every block of a cluster scans
// and gathers the same rows, then computes 1/C of each layer's output
// n-tiles and stores them into every block's buffer through distributed
// shared memory (one cluster barrier a layer), so the next layer reads
// whole rows locally; the last layer's columns are pooled and written by
// their own block.  A layer's weights for a group of one n-tile a warp are
// staged into shared memory by every thread at once (a stage in flight
// together), then each warp takes its n-tile and a share of the row tiles
// (slab_dense).  It takes optional %globaltimer stamps: a block's scan,
// gather, MLP and pool time, its whole time and its tile count (a
// measurement launch only).
#include <cooperative_groups.h>

#include "stages.cuh"

namespace cg = cooperative_groups;

#define SETCONV_THREADS 256
#define SETCONV_WARPS (SETCONV_THREADS / 32)
#define SETCONV_MAX_C 8  // blocks a cluster: the portable cluster size
#define SETCONV_SMEM (227 * 1024)
#define SETCONV_STAMPS 6  // scan, gather, mlp, pool, whole (ns), tiles

struct SetconvParams {
  BallConvStage st;             // keys, centres, weights and the tile plan
  unsigned long long* stamps;  // [blocks][SETCONV_STAMPS], or null
  int C;                        // blocks a cluster
  int kc4;                      // keys a staged chunk (a multiple of 512)
  int ball;                     // 1: the launch runs ball_conv_tile<TensorMlp>
};

#define SETCONV_MAX_Q 8  // centres a tile

// The n-tiles [nt0, nt1) of a layer of `cout` outputs that rank `rank` of
// C computes: the layer's ceil(cout / 8) n-tiles split as evenly as they go.
__device__ __forceinline__ void rank_ntiles(int cout, int rank, int C, int& nt0, int& nt1) {
  const int NT = (cout + 7) / 8;
  nt0 = rank * NT / C;
  nt1 = (rank + 1) * NT / C;
}

// A warp's accumulators (m-tiles [m0, m1)) of n-tile column pair c plus
// the bias, ReLU, stored into `hout` of each of the cluster's C blocks
// when `share` (distributed shared memory), else into this block's alone.
template <int MT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][4], const float (&small)[MT][4],
                                           int m0, int m1, int c, float b0, float b1,
                                           float* hout, int ldo, int g, int C, bool share) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < m0 || m >= m1) continue;
    const float v0 = fmaxf((acc[m][0] + small[m][0]) + b0, 0.f);
    const float v1 = fmaxf((acc[m][1] + small[m][1]) + b1, 0.f);
    const float v2 = fmaxf((acc[m][2] + small[m][2]) + b0, 0.f);
    const float v3 = fmaxf((acc[m][3] + small[m][3]) + b1, 0.f);
    const int r = m * 16 + g;
    float* top = hout + (size_t)r * ldo + c;
    float* bot = hout + (size_t)(r + 8) * ldo + c;
    for (int o = 0; o < (share ? C : 1); ++o) {
      float* t0 = share ? cluster.map_shared_rank(top, o) : top;
      float* t1 = share ? cluster.map_shared_rank(bot, o) : bot;
      *reinterpret_cast<float2*>(t0) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(t1) = make_float2(v2, v3);
    }
  }
}

// One dense layer (+ bias, ReLU) over the tile's rows in shared memory,
// the block's n-tiles [nt0, nt1) of it, in groups of one n-tile a warp:
// a group's slice of the weights (mma_tf32.cuh's split layout) is staged
// into `slab` by every thread, as many k-steps at once as it holds, so a
// whole stage is in flight together (a per-warp ring of a few k-steps
// keeps too few bytes in flight to cover L2's latency); then each warp
// multiplies its n-tile over its share of the row tiles (the row tiles
// split over the warps a group's n-tiles leave idle), its accumulators
// kept across the stages.  The caller synchronises (a cluster barrier
// after a shared layer).
template <int MT>
__device__ __forceinline__ void slab_dense(const float* __restrict__ wf,
                                           const float* __restrict__ bias, const float* hin,
                                           int ldi, float* hout, int ldo, int cin, int cout,
                                           float* slab, int slab_f4, int nt0, int nt1, int C,
                                           bool share) {
  const int KT = round_up(cin, 8) / 8, NT = round_up(cout, 8) / 8;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float4* wf4 = reinterpret_cast<const float4*>(wf);
  float4* sl = reinterpret_cast<float4*>(slab);
  for (int ga = nt0; ga < nt1; ga += nwarps) {
    const int NS = min(nwarps, nt1 - ga);  // the group's n-tiles
    int msplit = 1;
    while (2 * msplit <= MT && NS * 2 * msplit <= nwarps) msplit *= 2;
    const int mper = MT / msplit;
    const bool active = warp < NS * msplit;
    const int j = warp / msplit;  // this warp's n-tile, of the group's
    const int m0 = (warp % msplit) * mper, m1 = m0 + mper;
    const int kstage = max(1, slab_f4 / (NS * 32));  // k-steps a stage
    float acc[MT][4], small[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = small[m][e] = 0.f;
    const int c = (ga + j) * 8 + 2 * t;
    const float b0 = active ? __ldg(bias + c) : 0.f, b1 = active ? __ldg(bias + c + 1) : 0.f;
    for (int k0 = 0; k0 < KT; k0 += kstage) {
      const int kn = min(kstage, KT - k0);
      for (int i = threadIdx.x; i < kn * NS * 32; i += blockDim.x) {
        const int kt = i / (NS * 32);
        cp_async16(sl + i, wf4 + ((size_t)(k0 + kt) * NT + ga) * 32 + (i - kt * NS * 32));
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the stage is in
      if (active) {
        for (int kt = 0; kt < kn; ++kt) {
          const float4 w = sl[(kt * NS + j) * 32 + lane];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < m0 || m >= m1) continue;
            uint32_t ahi[4], alo[4];
            load_a_split(hin, ldi, m * 16, (k0 + kt) * 8, ahi, alo);
            mma_3xtf32_apart(acc[m], small[m], ahi, alo, w);
          }
        }
      }
      __syncthreads();  // every warp is done with the stage
    }
    if (active) store_tile<MT>(acc, small, m0, m1, c, b0, b1, hout, ldo, g, C, share);
  }
}

// The chain over R rows on the tensor cores (mma_tf32.cuh's buffers, the
// weight ring's space as the slab), each layer's n-tiles split over the
// cluster's C blocks; every layer but the last is shared and ends in a
// cluster barrier, the last stays in this block (its columns are pooled
// here).  Returns the buffer that holds the last layer's output and its
// stride.
__device__ __forceinline__ float* slice_mlp(const float* __restrict__ w, const MlpSpec& m,
                                            float* a, int lda, float* b, int ldb, int R,
                                            MmaRing ring, int rank, int C, int& ld_out) {
  const int slab_f4 = MMA_RING_FLOATS(ring.ntw) / 4;
  for (int l = 0; l < m.n; ++l) {
    int nt0, nt1;
    rank_ntiles(m.dims[l + 1], rank, C, nt0, nt1);
    const bool share = C > 1 && l < m.n - 1;
    const float* wf = w + m.woff[l];
    const float* bias = w + m.boff[l];
    if (R <= 16)
      slab_dense<1>(wf, bias, a, lda, b, ldb, m.dims[l], m.dims[l + 1], ring.buf, slab_f4, nt0,
                    nt1, C, share);
    else if (R <= 32)
      slab_dense<2>(wf, bias, a, lda, b, ldb, m.dims[l], m.dims[l + 1], ring.buf, slab_f4, nt0,
                    nt1, C, share);
    else
      slab_dense<4>(wf, bias, a, lda, b, ldb, m.dims[l], m.dims[l + 1], ring.buf, slab_f4, nt0,
                    nt1, C, share);
    if (share)
      cg::this_cluster().sync();  // every block's next input is whole
    else
      __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
    const int tl = lda;
    lda = ldb;
    ldb = tl;
  }
  ld_out = lda;
  return a;
}

// The stamps a block keeps on thread 0 (a measurement launch).
struct TileClock {
  unsigned long long last, sum[4];
};

__device__ __forceinline__ void clock_mark(const SetconvParams& p, TileClock& c, int part) {
  if (p.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long now = global_ns();
    c.sum[part] += now - c.last;
    c.last = now;
  }
}

// Centres q0 .. q0 + Q - 1 of stream b, the columns of cluster rank `rank`
// (a tail tile repeats the last centre and writes only the real ones).
__device__ __forceinline__ void setconv_tile(const SetconvParams& p, int b, int q0, int rank,
                                             float* smem, TileClock& clk) {
  const BallConvStage& st = p.st;
  const int C = p.C;
  const int Q = st.Q, K = st.K, N = st.N, S = st.S, D = st.D, ld = st.ld;
  const int R = st.R, RR = round_up(R, 16);
  const int cout = st.m.dims[st.m.n];
  const int ldb = st.ldb;
  const int kc = p.kc4;
  float* bufA = smem;
  float* bufB = bufA + (size_t)RR * ld;
  const int front = max(RR * (ld + ldb), 6 * kc);
  float* best = smem + front;
  int* sidx = reinterpret_cast<int*>(best + round_up(Q * cout, 4));
  float* ring = reinterpret_cast<float*>(sidx + round_up(Q * K, 4));
  // the scan's: each centre's (-2 q, mark limit) and (q, -), a warp's hits
  // [warps][Q][K] and their counts [warps][Q], each centre's count
  float4* cq = reinterpret_cast<float4*>(ring + MMA_RING_FLOATS(st.ring_ntw));
  float4* cx = cq + SETCONV_MAX_Q;
  int* parts = reinterpret_cast<int*>(cx + SETCONV_MAX_Q);
  int* gots = parts + round_up(SETCONV_WARPS * Q * K, 4);
  int* cnt = gots + SETCONV_WARPS * SETCONV_MAX_Q;
  const float* X = st.xyz + (size_t)b * N * 3;
  const float* F = st.feats + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // 1. ball query: the first K keys within the radius by index.
  const int nch = (N + kc - 1) / kc;
  // Keys staged as [kc][3] floats by cp.async, the next chunk in flight.
  // Every warp scans its slice of the chunk for all Q centres, |k|^2 formed
  // once a key (a key past the chunk's end: inf, never marked): the
  // three-FMA mark (common.cuh mark_dot below mark_limit, with the
  // in-radius keys' (|k| + |q|)^2 <= (2 |q| + r)^2: a superset of the
  // keys within the radius), then sqdist3 <= r^2 on the marked keys
  // alone, a warp's hits into its own list a centre (at most the slots
  // the ball has left); warp qi appends centre qi's lists in slice
  // order, so the slots are the first K hits by index.  The block stops
  // after the chunk that fills every ball.
  auto issue = [&](int c) {  // chunk c's [n][3] floats into buffer c % 2
    if (c < nch) {
      const int n3 = 3 * min(kc, N - c * kc);
      float* dst = smem + (c & 1) * 3 * kc;
      const float* src = X + (size_t)c * kc * 3;
      for (int i = threadIdx.x; i < n3; i += blockDim.x) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };
  if (threadIdx.x < Q) {
    const int q = min(q0 + (int)threadIdx.x, S - 1);
    const float x = QX[q * 3], y = QX[q * 3 + 1], z = QX[q * 3 + 2];
    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    const float reach = 2.f * sqrtf(qq) + sqrtf(st.r2);
    cq[threadIdx.x] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                                  mark_limit(st.r2, qq, 1.001f * reach * reach));
    cx[threadIdx.x] = make_float4(x, y, z, 0.f);
    cnt[threadIdx.x] = 0;
  }
  issue(0);
  int count = 0;  // warp qi < Q: centre qi's hits so far
  int room[SETCONV_MAX_Q], got[SETCONV_MAX_Q];
  float4 cqr[SETCONV_MAX_Q];
  for (int c = 0; c < nch; ++c) {
    issue(c + 1);  // into buffer (c + 1) % 2: chunk c - 1's, scanned
    cp_async_wait<1>();
    // chunk c is in; every merge of chunk c - 1 is done
    if (__syncthreads_and(warp >= Q || count >= K)) break;
    unsigned open = 0;  // bits 2i, 2i + 1: centre i still takes hits
#pragma unroll
    for (int i = 0; i < SETCONV_MAX_Q; ++i) {
      room[i] = i < Q ? K - cnt[i] : 0;
      got[i] = 0;
      cqr[i] = i < Q ? cq[i] : make_float4(0.f, 0.f, 0.f, -CUDART_INF_F);
      open |= room[i] > 0 ? 3u << (2 * i) : 0u;
    }
    const float* kb = smem + (c & 1) * 3 * kc;
    const int n = min(kc, N - c * kc), span = round_up((n + SETCONV_WARPS - 1) / SETCONV_WARPS, 64);
    auto key = [&](int j) {  // key j of the chunk with |k|^2, past n never marked
      const int a = min(j, n - 1);
      const float x = kb[a * 3], y = kb[a * 3 + 1], z = kb[a * 3 + 2];
      const float kk = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      return make_float4(x, y, z, j < n ? kk : CUDART_INF_F);
    };
    for (int g = warp * span; g < (warp + 1) * span && open; g += 64) {
      const float4 k0 = key(g + lane), k1 = key(g + 32 + lane);
      unsigned mk = 0;  // every centre's marks at once: one vote for all
#pragma unroll
      for (int i = 0; i < SETCONV_MAX_Q; ++i) {
        mk |= (mark_dot(k0, cqr[i].x, cqr[i].y, cqr[i].z) < cqr[i].w ? 1u : 0u) << (2 * i);
        mk |= (mark_dot(k1, cqr[i].x, cqr[i].y, cqr[i].z) < cqr[i].w ? 1u : 0u) << (2 * i + 1);
      }
      mk &= open;
      if (__any_sync(0xffffffffu, mk != 0)) {  // rare: the exact test on the marked keys
#pragma unroll
        for (int i = 0; i < SETCONV_MAX_Q; ++i) {
          if (!((open >> (2 * i)) & 1u)) continue;
          const bool m0 = (mk >> (2 * i)) & 1u, m1 = (mk >> (2 * i + 1)) & 1u;
          if (!__any_sync(0xffffffffu, m0 | m1)) continue;
          const float4 x = cx[i];
          const bool h0 = m0 && sqdist3(k0.x, k0.y, k0.z, x.x, x.y, x.z) <= st.r2;
          const bool h1 = m1 && sqdist3(k1.x, k1.y, k1.z, x.x, x.y, x.z) <= st.r2;
          int* list = parts + (warp * Q + i) * K;
          got[i] = ball_place(h0, c * kc + g + lane, got[i], room[i], list);
          got[i] = ball_place(h1, c * kc + g + 32 + lane, got[i], room[i], list);
          if (got[i] >= room[i]) open &= ~(3u << (2 * i));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SETCONV_MAX_Q; ++i)
      if (i < Q && lane == 0) gots[warp * SETCONV_MAX_Q + i] = got[i];
    __syncthreads();  // the lists are in, and buffer c % 2 is free
    if (warp < Q && count < K) {
      int* id = sidx + warp * K;
      for (int w = 0; w < SETCONV_WARPS && count < K; ++w) {
        const int take = min(gots[w * SETCONV_MAX_Q + warp], K - count);
        const int* list = parts + (w * Q + warp) * K;
        for (int t = lane; t < take; t += 32) id[count + t] = list[t];
        count += take;
      }
      if (lane == 0) cnt[warp] = count;
    }
  }
  cp_async_wait_all();  // a chunk issued before the break lands before the buffers are reused
  if (warp < Q) ball_pad(sidx + warp * K, count, K, 0);  // an empty ball reads key 0
  for (int t = threadIdx.x; t < Q * cout; t += blockDim.x) best[t] = -CUDART_INF_F;
  clock_mark(p, clk, 0);
  __syncthreads();

  // 2. gather [dxyz | feats] rows chunk by chunk (zeros up to the first
  // layer's padded width), MLP, running max of this block's columns
  int nt0, nt1;
  rank_ntiles(cout, rank, C, nt0, nt1);
  const int c0 = nt0 * 8, wdt = min(cout, nt1 * 8) - c0;
  const int Cin = 3 + D;
  const int CP = round_up(Cin, 8);
  const int rows = Q * K;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    // a warp a row, the feature copies all in flight
    for (int r = warp; r < nr; r += nwarps) {
      const int row = r0 + r;
      const int qq = min(q0 + row / K, S - 1);
      const int j = sidx[row];
      float* dst = bufA + (size_t)r * ld;
      for (int c = lane; c < CP; c += 32) {
        if (c < 3) dst[c] = X[j * 3 + c] - QX[qq * 3 + c];
        else if (c < Cin) cp_async4(dst + c, F + (size_t)j * D + (c - 3));
        else dst[c] = 0.f;
      }
    }
    cp_async_wait_all();
    // the rows are in; with C > 1 also: every block of the cluster is past
    // its scan and its last pool, so its buffers take the shared layers
    if (C > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    clock_mark(p, clk, 1);
    int ldh;
    const float* h = slice_mlp(st.w, st.m, bufA, ld, bufB, ldb, nr, {ring, st.ring_ntw}, rank, C, ldh);
    clock_mark(p, clk, 2);
    const int qa = r0 / K, qb = (r0 + nr - 1) / K;
    for (int e = threadIdx.x; e < (qb - qa + 1) * wdt; e += blockDim.x) {
      const int qi = qa + e / wdt, o = c0 + e % wdt;
      const int ra = max(qi * K, r0) - r0, rb = min(qi * K + K, r0 + nr) - r0;
      float m = best[qi * cout + o];
      for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ldh + o]);
      best[qi * cout + o] = m;
    }
    __syncthreads();
    clock_mark(p, clk, 3);
  }
  for (int e = threadIdx.x; e < Q * wdt; e += blockDim.x) {
    const int qi = e / wdt, o = c0 + e % wdt;
    if (q0 + qi < S) st.out[((size_t)b * S + q0 + qi) * cout + o] = best[qi * cout + o];
  }
}

__global__ void __launch_bounds__(SETCONV_THREADS) setconv_kernel(const __grid_constant__ SetconvParams p) {
  extern __shared__ float4 smem4[];
  TileClock clk = {0, {0, 0, 0, 0}};
  unsigned long long start = 0;
  if (p.stamps != nullptr && threadIdx.x == 0) clk.last = start = global_ns();
  setconv_tile(p, blockIdx.y, (blockIdx.x / p.C) * p.st.Q, (int)(blockIdx.x % p.C),
               reinterpret_cast<float*>(smem4), clk);
  if (p.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long* s =
        p.stamps + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * SETCONV_STAMPS;
    for (int i = 0; i < 4; ++i) s[i] = clk.sum[i];
    s[4] = global_ns() - start;
    s[5] = 1;
  }
}

// ball_conv_tile<TensorMlp> over the stage, one block a tile of Q centres.
__global__ void __launch_bounds__(SETCONV_THREADS) setconv_ball_kernel(const __grid_constant__ BallConvStage st) {
  extern __shared__ float4 smem4[];
  ball_conv_tile<TensorMlp>(st, blockIdx.y, blockIdx.x * st.Q, reinterpret_cast<float*>(smem4));
}

// The cluster tile's keys a staged chunk: a multiple of 64 a warp, at most
// 4,096 (96 KB double-buffered).
static int setconv_chunk(int N) { return std::min(4096, round_up(N, 512)); }

// The cluster tile's shared bytes (setconv_tile's layout): the MLP buffers,
// whose space the scan's two [kc][3] key chunks take first, the running
// max, the slots, the weight ring, the centres' marks, the warps' lists.
static size_t setconv_smem(const BallConvStage& s) {
  const size_t front = std::max((size_t)round_up(s.R, 16) * (s.ld + s.ldb),
                                (size_t)6 * setconv_chunk(s.N));
  const size_t ints = round_up(SETCONV_WARPS * s.Q * s.K, 4) + SETCONV_WARPS * SETCONV_MAX_Q +
                      SETCONV_MAX_Q;
  return sizeof(float) * (front + round_up(s.Q * s.m.dims[s.m.n], 4) + round_up(s.Q * s.K, 4) +
                          MMA_RING_FLOATS(s.ring_ntw) + 8 * SETCONV_MAX_Q + ints);
}

// Host side: the cluster tile's plan: Q = the most centres (a power
// of 2, at most 8) whose Q K <= 64 rows and 4-n-tile weight ring fit the
// shared memory, halved until they do; R and the ring by tc_fit if one
// centre still does not fit; then C, doubled up to SETCONV_MAX_C while
// twice the tiles' blocks still fit on the SMs and every layer keeps an
// n-tile a block.
static bool setconv_plan(BallConvStage& s, int B, int sms, int& C) {
  C = 1;
  if (s.m.n < 1 || s.m.n > PCI_MAX_LAYERS || s.m.dims[0] != 3 + s.D || s.K < 1) return false;
  s.tc = 1;
  s.ld = tc_ld(chain_width(s.m, true));
  s.ldb = tc_ld(chain_width(s.m, false));
  int q = 1;
  while (q < SETCONV_MAX_Q && 2 * q * s.K <= 64) q *= 2;
  // one block an SM: more centres a tile (R-row chunks) rather than a
  // second wave of tiles
  while (q < SETCONV_MAX_Q && (long long)B * ((s.S + q - 1) / q) > sms) q *= 2;
  for (;; q /= 2) {
    s.Q = q;
    s.R = std::min(64, round_up(q * s.K, 16));
    s.ring_ntw = MMA_NTW;
    if (setconv_smem(s) <= SETCONV_SMEM || q == 1) break;
  }
  tc_fit(s, SETCONV_SMEM, setconv_smem);
  if (setconv_smem(s) > SETCONV_SMEM) return false;
  int min_nt = 1 << 30;
  for (int l = 1; l <= s.m.n; ++l) min_nt = std::min(min_nt, (s.m.dims[l] + 7) / 8);
  const long long tiles = (long long)B * ((s.S + s.Q - 1) / s.Q);
  while (C < SETCONV_MAX_C && tiles * C * 2 <= sms && 2 * C <= min_nt) C *= 2;
  return true;
}

// Host side: the launch's tile and plan.  ball_conv_tile<TensorMlp> at
// ball_conv_plan's tensor plan where its keys fit one scan chunk and its
// tiles number at least a quarter of the SMs, else the cluster tile.
static bool setconv_plan_launch(SetconvParams& p, int B, int sms) {
  BallConvStage& st = p.st;
  BallConvStage b = st;
  p.ball = ball_conv_plan(b, B, SETCONV_SMEM) && ball_conv_smem(b) <= SETCONV_SMEM &&
           st.N <= ball_conv_chunk(b) && 4LL * B * ((st.S + b.Q - 1) / b.Q) >= sms;
  if (p.ball) {
    st = b;
    p.C = 1;
    return true;
  }
  p.kc4 = setconv_chunk(st.N);
  return setconv_plan(st, B, sms, p.C);
}

// dynamic shared bytes of each tile's last launch
static size_t last_smem = 0, last_ball_smem = 0;

static int fill(SetconvParams& p, const void* xyz, const void* feats, const void* qxyz,
                const void* wbuf, const int* dims, int n_layers, void* out, int B, int N,
                int S, int D, float r2, int K, size_t& smem) {
  if (n_layers < 1 || n_layers > PCI_MAX_LAYERS || S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  BallConvStage& st = p.st;
  st.xyz = static_cast<const float*>(xyz);
  st.feats = static_cast<const float*>(feats);
  st.qxyz = static_cast<const float*>(qxyz);
  st.w = static_cast<const float*>(wbuf);
  st.out = static_cast<float*>(out);
  st.m = make_tf32_spec(dims, n_layers, 0);
  st.N = N, st.S = S, st.D = D, st.K = K, st.r2 = r2;
  if (!setconv_plan_launch(p, B, sms)) return (int)cudaErrorInvalidValue;
  smem = p.ball ? ball_conv_smem(st) : setconv_smem(st);
  return 0;
}

// dims: host array of the n+1 layer widths (dims[0] == 3 + D); wbuf: the
// folded MLP split for the tensor cores (_build.pack_tf32); stamps:
// null, or SETCONV_STAMPS unsigned 64-bit ints for each block of the
// grid (pci_setconv_plan's out[5]), written by the cluster tile only.
extern "C" int pci_setconv(const void* xyz, const void* feats, const void* qxyz,
                           const void* wbuf, const int* dims, int n_layers,
                           void* out, int B, int N, int S, int D, float r2,
                           int K, void* stamps, void* stream) {
  SetconvParams p;
  size_t smem = 0;
  int err = fill(p, xyz, feats, qxyz, wbuf, dims, n_layers, out, B, N, S, D, r2, K, smem);
  if (err != 0) return err;
  p.stamps = static_cast<unsigned long long*>(stamps);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (p.ball) {
    cudaError_t e = allow_smem(setconv_ball_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    last_ball_smem = smem;
    setconv_ball_kernel<<<dim3((S + p.st.Q - 1) / p.st.Q, B), SETCONV_THREADS, smem, strm>>>(p.st);
    return (int)cudaGetLastError();
  }
  cudaError_t e = allow_smem(setconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(((S + p.st.Q - 1) / p.st.Q) * p.C, B);
  cfg.blockDim = dim3(SETCONV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = strm;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  last_smem = smem;
  e = cudaLaunchKernelEx(&cfg, setconv_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan pci_setconv takes for these shapes: out = {Q centres a tile, C
// blocks a cluster, R MLP rows a chunk, the ring's n-tiles a k-step,
// dynamic shared bytes a block, blocks in the grid, 1 for the cluster tile
// or 0 for ball_conv_tile}.
extern "C" int pci_setconv_plan(const int* dims, int n_layers, int B, int N, int S, int D,
                                int K, int* out) {
  SetconvParams p;
  size_t smem = 0;
  int err = fill(p, nullptr, nullptr, nullptr, nullptr, dims, n_layers, nullptr, B, N, S, D,
                 1.f, K, smem);
  if (err != 0) return err;
  out[0] = p.st.Q;
  out[1] = p.C;
  out[2] = p.st.R;
  out[3] = p.st.ring_ntw;
  out[4] = (int)smem;
  out[5] = B * ((S + p.st.Q - 1) / p.st.Q) * p.C;
  out[6] = !p.ball;
  return 0;
}

// Each tile's resources at its last launch's shared memory (common.cuh's
// kernel_attrs): the cluster tile's, and ball_conv_tile's.
extern "C" int pci_setconv_attrs(int* out) {
  return kernel_attrs(setconv_kernel, last_smem, out, SETCONV_THREADS);
}

extern "C" int pci_setconv_ball_attrs(int* out) {
  return kernel_attrs(setconv_ball_kernel, last_ball_smem, out, SETCONV_THREADS);
}
