// FlowNet3D's stage bodies, shared by the per-stage kernels (csrc/fps.cu,
// csrc/setconv.cu, csrc/knnconv.cu) and the megakernels that chain them in
// one launch (csrc/flowenc.cu, csrc/flowmid.cu), so that both routes pick the
// same points:
//   - fps_warp_chain: exact greedy farthest point sampling by one warp,
//     with no block barrier; fps_group_chain: the same picks by a few
//     warps, one named barrier an iteration;
//     fps_centres: a block's centres by the one-warp chain or the group
//     chain by length (the megakernels' FPS);
//   - ball_conv_tile: a set-conv's ball group + MLP + max for Q centres;
//   - knn_conv_tile: a kNN-conv's group + MLP1 + max + skip + MLP2 for Q
//     queries; knn_interp_tile: its 3-NN interpolation + skip + MLP2;
//   - grid_sync: the barrier between the stages of a cooperative launch.
// A tile function is called by every thread of a block; it begins with a
// __syncthreads(), so a block can run one tile after another on the same
// shared memory.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

// ---- greedy FPS ----------------------------------------------------------

// Exact greedy FPS over L <= 32 * PPL points (p[j] = (x, y, z, -) in shared
// memory, 32 * PPL slots) by ONE warp, with no block barrier: lane l keeps
// the distances of points l, l + 32, ... in registers, -1 for a slot past L
// (fminf keeps it, and it is below every distance).  An iteration hands
// its pick to emit(it, index) on lane 0, relaxes all the lane's distances
// with sqdist3 (rounded op by op; no branch, so the 32 loads and chains
// overlap), takes the lane's first maximum, then the largest distance by a
// warp max over its bits (a non-negative fp32 orders as its uint32 bits)
// and the lowest index among the lanes at it by a warp min:
// jnp.argmax's picks (its first maximum; index 0 again once every
// distance is 0), bit for bit.
template <int PPL, typename Emit>
__device__ void fps_warp_chain(const float4* p, int L, int npick, int far, Emit emit) {
  const int lane = threadIdx.x & 31;
  float dist[PPL];
#pragma unroll
  for (int t = 0; t < PPL; ++t) dist[t] = lane + 32 * t < L ? CUDART_INF_F : -1.f;
  for (int it = 0; it < npick; ++it) {
    if (lane == 0) emit(it, far);
    const float4 c = p[far];
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      const float4 q = p[lane + 32 * t];
      dist[t] = fminf(dist[t], sqdist3(q.x, q.y, q.z, c.x, c.y, c.z));
    }
    float bd = dist[0];
    int bt = 0;
#pragma unroll
    for (int t = 1; t < PPL; ++t)
      if (dist[t] > bd) bd = dist[t], bt = t;  // a tie keeps the lower index
    const unsigned bits = bd < 0.f ? 0u : __float_as_uint(bd);  // a lane with no point: 0
    const unsigned top = __reduce_max_sync(0xffffffffu, bits);
    const unsigned bi = bd < 0.f ? 0x7fffffffu : (unsigned)(lane + 32 * bt);
    far = (int)__reduce_min_sync(0xffffffffu, bits == top ? bi : 0x7fffffffu);
  }
}

// A barrier for the `threads` threads (a multiple of 32) that name `id`
// (1 .. 15; 0 is __syncthreads), so a group of warps can synchronise while
// the block's other warps do not take part.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Exact greedy FPS over the L points (sx, sy, sz) in shared memory (each
// array padded with zeros to 32 * nw * PPL) by a group of nw warps, threads
// g = 0 .. 32 nw - 1 of the group: thread g owns points g + 32 nw t, t <
// PPL, their distances in registers (-1 past L, which fminf keeps, so the
// relax loop has no branch) and, for REGS, their coordinates too; without
// REGS it reads them from shared memory each iteration.  An iteration hands
// its pick to emit(it, index) on g == 0, reads the centre from shared
// memory, relaxes with sqdist3 (rounded op by op), takes each thread's
// first maximum and each warp's (bits, index) as fps_warp_chain does (a
// warp max over the distance bits, then a warp min over the indices at
// it); the warps then trade their pairs through double-buffered slots
// [2][nw] (uint2) with ONE named barrier `bar` an iteration, and every
// warp reduces the nw slots itself the same way: no second barrier and no
// broadcast of the pick.  A warp writes slot buffer it & 1 only after the
// barrier of iteration it - 1, which every warp passes only after reading
// buffer it & 1 of iteration it - 2.  The picks are fps_warp_chain's
// (jnp.argmax's first maximum; index 0 again once every distance is 0),
// bit for bit.
template <int PPL, bool REGS, typename Emit>
__device__ void fps_group_chain(const float* sx, const float* sy, const float* sz, int L,
                                int npick, int far, int g, int nw, int bar, uint2* slots,
                                Emit emit) {
  const int lane = g & 31, warp = g >> 5, stride = 32 * nw;
  float px[REGS ? PPL : 1], py[REGS ? PPL : 1], pz[REGS ? PPL : 1];
  float dist[PPL];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int j = g + stride * t;
    dist[t] = j < L ? CUDART_INF_F : -1.f;
    if (REGS) {
      px[t] = sx[j];
      py[t] = sy[j];
      pz[t] = sz[j];
    }
  }
  for (int it = 0; it < npick; ++it) {
    if (g == 0) emit(it, far);
    const float cx = sx[far], cy = sy[far], cz = sz[far];
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      const int j = g + stride * t;
      const float d = REGS ? sqdist3(px[t], py[t], pz[t], cx, cy, cz)
                           : sqdist3(sx[j], sy[j], sz[j], cx, cy, cz);
      dist[t] = fminf(dist[t], d);
    }
    float bd = dist[0];
    int bt = 0;
#pragma unroll
    for (int t = 1; t < PPL; ++t)
      if (dist[t] > bd) bd = dist[t], bt = t;  // a tie keeps the lower index
    const unsigned bits = bd < 0.f ? 0u : __float_as_uint(bd);  // no point: 0
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    const unsigned bi = bd < 0.f ? 0x7fffffffu : (unsigned)(g + stride * bt);
    unsigned win = __reduce_min_sync(0xffffffffu, bits == top ? bi : 0x7fffffffu);
    if (nw > 1) {
      uint2* sl = slots + (it & 1) * nw;
      if (lane == 0) sl[warp] = make_uint2(top, win);
      named_barrier(bar, stride);
      const uint2 o = lane < nw ? sl[lane] : make_uint2(0u, 0x7fffffffu);
      top = __reduce_max_sync(0xffffffffu, o.x);
      win = __reduce_min_sync(0xffffffffu, o.x == top ? o.y : 0x7fffffffu);
    }
    far = (int)win;
  }
}

// fps_centres by the calling warp alone (L <= 1,024): the warp stages X
// [L][3] into fps_warp_slots(L) float4s of shared memory (zeros past L)
// and runs fps_warp_chain; the block's other warps take no part (a later
// tile's __syncthreads() waits for it before the buffers are reused).
__host__ __device__ inline int fps_warp_slots(int L) {
  int slots = 32;
  while (slots < L) slots *= 2;
  return slots;
}

__device__ __forceinline__ void fps_centres_warp(const float* X, int L, int npick,
                                                 float* out, float* smem) {
  float4* p = reinterpret_cast<float4*>(smem);
  for (int j = threadIdx.x & 31; j < fps_warp_slots(L); j += 32)
    p[j] = j < L ? make_float4(X[j * 3], X[j * 3 + 1], X[j * 3 + 2], 0.f)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  auto emit = [&](int it, int f) {
    out[it * 3] = p[f].x;
    out[it * 3 + 1] = p[f].y;
    out[it * 3 + 2] = p[f].z;
  };
  if (L <= 32) fps_warp_chain<1>(p, L, npick, 0, emit);
  else if (L <= 64) fps_warp_chain<2>(p, L, npick, 0, emit);
  else if (L <= 128) fps_warp_chain<4>(p, L, npick, 0, emit);
  else if (L <= 256) fps_warp_chain<8>(p, L, npick, 0, emit);
  else if (L <= 512) fps_warp_chain<16>(p, L, npick, 0, emit);
  else fps_warp_chain<32>(p, L, npick, 0, emit);
}

// Greedy FPS from index 0 over the L points X [L][3] (device memory) by
// one block, called by every thread: the npick centres' coordinates go to
// out [npick][3], visible to the whole block on return.  Up to
// FPS_CENTRES_WARP_MAX points the block's first warp runs fps_centres_warp
// (no block barrier an iteration; the other warps wait at the closing
// barrier); above, every warp runs fps_group_chain (one named barrier an
// iteration), L <= 16 * blockDim.x.  The picks are the chains', bit for
// bit: jnp.argmax's from index 0.  Shared memory: fps_centres_smem(L, blockDim.x) bytes.
#define FPS_CENTRES_WARP_MAX 256
#define FPS_CENTRES_BAR 1  // the group chain's named barrier

__host__ __device__ inline int fps_centres_ppl(int L, int threads) {
  int ppl = 1;
  while (ppl * threads < L) ppl *= 2;
  return ppl;
}

__host__ __device__ inline size_t fps_centres_smem(int L, int threads) {
  if (L <= FPS_CENTRES_WARP_MAX) return sizeof(float4) * (size_t)fps_warp_slots(L);
  return sizeof(float) * 3 * (size_t)fps_centres_ppl(L, threads) * threads +
         sizeof(uint2) * 2 * (size_t)(threads / 32);
}

__device__ __forceinline__ void fps_centres(const float* X, int L, int npick, float* out,
                                            float* smem) {
  __syncthreads();  // the block is done with smem, and X's writes (thread 0's) are visible
  if (L <= FPS_CENTRES_WARP_MAX) {
    if (threadIdx.x < 32) fps_centres_warp(X, L, npick, out, smem);
  } else {
    const int ppl = fps_centres_ppl(L, blockDim.x), Lp = ppl * blockDim.x;
    float* sx = smem;
    float* sy = sx + Lp;
    float* sz = sy + Lp;
    uint2* slots = reinterpret_cast<uint2*>(sz + Lp);
    for (int j = threadIdx.x; j < Lp; j += blockDim.x) {
      sx[j] = j < L ? X[j * 3] : 0.f;
      sy[j] = j < L ? X[j * 3 + 1] : 0.f;
      sz[j] = j < L ? X[j * 3 + 2] : 0.f;
    }
    __syncthreads();
    auto emit = [&](int it, int f) {
      out[it * 3] = sx[f];
      out[it * 3 + 1] = sy[f];
      out[it * 3 + 2] = sz[f];
    };
    const int nw = blockDim.x >> 5;
    if (ppl <= 1)
      fps_group_chain<1, true>(sx, sy, sz, L, npick, 0, threadIdx.x, nw, FPS_CENTRES_BAR, slots, emit);
    else if (ppl <= 2)
      fps_group_chain<2, true>(sx, sy, sz, L, npick, 0, threadIdx.x, nw, FPS_CENTRES_BAR, slots, emit);
    else if (ppl <= 4)
      fps_group_chain<4, true>(sx, sy, sz, L, npick, 0, threadIdx.x, nw, FPS_CENTRES_BAR, slots, emit);
    else if (ppl <= 8)
      fps_group_chain<8, true>(sx, sy, sz, L, npick, 0, threadIdx.x, nw, FPS_CENTRES_BAR, slots, emit);
    else
      fps_group_chain<16, true>(sx, sy, sz, L, npick, 0, threadIdx.x, nw, FPS_CENTRES_BAR, slots, emit);
  }
  __syncthreads();
}

// ---- the MLP routine a tile runs -----------------------------------------

// ball_conv_tile takes its MLP routine as a template parameter: every
// caller (the megakernels and the per-stage set-conv kernel's
// setconv_ball_kernel) passes TensorMlp (csrc/mma_tf32.cuh, 3xTF32 on the
// tensor cores, weights split in make_tf32_spec's layout).  run() returns
// the buffer holding the chain's output and its row stride.  The kNN-conv
// tiles run TensorMlp's routine.

// Host side, the tensor-core plans: a row stride % 8 == 4 (conflict-free A
// fragments) that holds `w` columns padded to 8.
static inline int tc_ld(int w) { return round_up(w, 8) + 4; }

// Host side: the queries (centres) a tensor-core tile takes: the most of
// qmax, qmax / 2, ... (a power of 2, at most 8) that still leaves 128
// tiles over the B streams' S rows (about one an SM), else 1.  A tile
// streams its stage's weights once, so fewer, fuller tiles read less; but
// a stage with fewer tiles than SMs leaves SMs idle.
static inline int tc_queries(int B, int S, int qmax) {
  for (int q = qmax; q > 1; q /= 2)
    if ((long long)B * ((S + q - 1) / q) >= 128) return q;
  return 1;
}

// Host side, the tensor-core plans' budget: the most MLP rows a chunk (each
// chunk streams the weights again), halved down to 16, with the widest
// weight ring (4 n-tiles, else 2) that fits; else 16 rows and a ring of 1.
template <typename Stage, typename Smem>
static inline void tc_fit(Stage& s, size_t budget, Smem smem) {
  for (int R = s.R;; R = std::max(16, round_up(R / 2, 16))) {
    for (int ntw = MMA_NTW; ntw >= 2; ntw /= 2) {
      s.R = R, s.ring_ntw = ntw;
      if (smem(s) <= budget) return;
    }
    if (R == 16) break;
  }
  s.R = 16, s.ring_ntw = 1;
}

// The widest layer input (even = true: dims[0], dims[2], ...) or output
// (dims[1], dims[3], ...) of a chain: what its ping-pong buffers a / b hold.
static inline int chain_width(const MlpSpec& m, bool even) {
  int w = 0;
  for (int l = even ? 0 : 1; l <= m.n; l += 2) w = std::max(w, m.dims[l]);
  return w;
}

// ---- set-conv: ball group + MLP + max ------------------------------------

// One set-conv stage over B streams.  Semantics of
// pci_tpu/ops/pallas_kernels/setconv_tpu.py: each centre takes the first K
// keys within the radius in index order, a shortfall repeats the first hit,
// an empty ball reads key 0; a slot's MLP input is [key_xyz - centre,
// key_feats]; every layer ends in ReLU; the output is the max over slots.
struct BallConvStage {
  const float* xyz;    // keys [B][N][3]
  const float* feats;  // key features [B][N][D]
  const float* qxyz;   // centres [B][S][3]
  const float* w;      // the folded MLP, in the layout of the tile's MLP routine
  float* out;          // [B][S][cout]
  MlpSpec m;
  int N, S, D, K;
  int Q, R, ld;  // centres a tile (at most 8, a warp each), MLP rows a chunk,
                 // floats a buffer row
  int tc, ldb;   // TensorMlp's plan: buffer B's own row stride (ld is A's),
  int ring_ntw;  // and the n-tiles a k-step of its weight ring holds
  float r2;
};

// The tile's layout: the MLP buffers A [RR][ld] and B [RR][ldb] (RR: R
// rounded up to the MLP routine's rows), whose space the ball scan's two
// key chunks take first, the running max [Q][cout], the indices [Q][K],
// the weight ring.  Keys a chunk: as many as fill half that space, a
// multiple of 32, at least 32, at most N rounded up to 32.
__host__ __device__ inline int ball_conv_chunk(const BallConvStage& s) {
  const int mlp = round_up(s.R, s.tc ? 16 : 8) * (s.ld + s.ldb);
  const int fit = mlp / 6 / 32 * 32, all = round_up(s.N, 32);
  return fit < 32 ? 32 : (fit < all ? fit : all);
}

static inline size_t ball_conv_smem(const BallConvStage& s) {
  const int cout = s.m.dims[s.m.n];
  const size_t front = std::max((size_t)round_up(s.R, s.tc ? 16 : 8) * (s.ld + s.ldb),
                                (size_t)6 * ball_conv_chunk(s));
  return sizeof(float) * (front + round_up(s.Q * cout, 4) + round_up(s.Q * s.K, 4) +
                          (s.tc ? MMA_RING_FLOATS(s.ring_ntw) : 0));
}

// Host side: checks the widths and plans the tiles for B streams (the
// TensorMlp plan): Q = tc_queries centres (up to 8: every warp scans),
// R <= 64 rows in 16-row tiles, fitted to `budget` bytes by tc_fit.
static inline bool ball_conv_plan(BallConvStage& s, int B, size_t budget) {
  if (s.m.n < 1 || s.m.n > PCI_MAX_LAYERS || s.m.dims[0] != 3 + s.D || s.K < 1)
    return false;
  s.tc = 1;
  s.ld = tc_ld(chain_width(s.m, true));
  s.ldb = tc_ld(chain_width(s.m, false));
  s.Q = tc_queries(B, s.S, 8);
  s.R = std::min(64, round_up(s.Q * s.K, 16));
  tc_fit(s, budget, ball_conv_smem);
  return true;
}

// Centres q0 .. q0 + Q - 1 of stream b (a tail tile repeats the last
// centre and writes only the real ones).
template <typename Mlp>
__device__ __forceinline__ void ball_conv_tile(const BallConvStage& st, int b,
                                               int q0, float* smem) {
  const int Q = st.Q, K = st.K, N = st.N, S = st.S, D = st.D, ld = st.ld;
  const int R = st.R, RR = round_up(R, Mlp::kRows);
  const int cout = st.m.dims[st.m.n];
  const int ldb = Mlp::kTensor ? st.ldb : ld;
  const int kc = ball_conv_chunk(st);
  float* bufA = smem;
  float* bufB = bufA + (size_t)RR * ld;
  float* best = smem + (RR * (ld + ldb) > 6 * kc ? RR * (ld + ldb) : 6 * kc);
  int* sidx = reinterpret_cast<int*>(best + round_up(Q * cout, 4));
  float* ring = Mlp::kTensor ? reinterpret_cast<float*>(sidx + round_up(Q * K, 4)) : nullptr;
  const float* X = st.xyz + (size_t)b * N * 3;
  const float* F = st.feats + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers

  // 1. ball query: warp qi scans for centre qi, keys in index order.  The
  // keys come in chunks of kc through shared memory (two buffers in the
  // MLP buffers' space, the next chunk's cp.async in flight while the
  // warps scan this one), so each key is read from L2 once a tile, not
  // once a centre; a warp tests four groups of 32 keys at once, places
  // their hits only when one of them has any, and checks for a full ball
  // after them (ball_place drops hits past K, so the slots are the same);
  // the chunks stop once every centre's ball is full.
  const int nch = (N + kc - 1) / kc;
  auto issue = [&](int c) {  // chunk c's [n][3] floats into buffer c % 2
    if (c < nch) {
      const int n3 = 3 * min(kc, N - c * kc);
      float* dst = smem + (c & 1) * 3 * kc;
      const float* src = X + (size_t)c * kc * 3;
      for (int i = threadIdx.x; i < n3; i += blockDim.x) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };
  const bool mine = warp < Q;
  int* id = sidx + warp * K;
  const int q = min(q0 + warp, S - 1);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (mine) qx = QX[q * 3], qy = QX[q * 3 + 1], qz = QX[q * 3 + 2];
  int count = 0;
  issue(0);
  for (int c = 0; c < nch; ++c) {
    issue(c + 1);
    cp_async_wait<1>();
    __syncthreads();  // chunk c is in, for every warp
    if (mine && count < K) {
      const float* kb = smem + (c & 1) * 3 * kc;
      const int n = min(kc, N - c * kc);
      for (int g = 0; g < n && count < K; g += 128) {
        bool hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // no branch: the four groups' loads overlap
          const int j = g + 32 * u + lane, jj = min(j, n - 1);
          const float d = sqdist3(kb[jj * 3], kb[jj * 3 + 1], kb[jj * 3 + 2], qx, qy, qz);
          hit[u] = (j < n) & (d <= st.r2);
        }
        if (__any_sync(0xffffffffu, hit[0] | hit[1] | hit[2] | hit[3])) {  // most groups miss
#pragma unroll
          for (int u = 0; u < 4; ++u) count = ball_place(hit[u], c * kc + g + 32 * u + lane, count, K, id);
        }
      }
    }
    // every warp is done with buffer c % 2 before chunk c + 2 goes there
    if (__syncthreads_and(!mine || count >= K)) break;
  }
  cp_async_wait_all();  // a chunk issued before the break lands before the buffers are reused
  if (mine) ball_pad(id, count, K, 0);  // an empty ball reads key 0
  for (int t = threadIdx.x; t < Q * cout; t += blockDim.x) best[t] = -CUDART_INF_F;
  __syncthreads();

  // 2. gather [dxyz | feats] rows chunk by chunk (TensorMlp: zeros up to
  // the first layer's padded width), MLP, running max
  const int C = 3 + D;
  const int CP = round_up(C, 8);  // TensorMlp: zeros up to the padded width
  const int rows = Q * K;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    if constexpr (Mlp::kTensor) {  // a warp a row, the feature copies all in flight
      for (int r = warp; r < nr; r += nwarps) {
        const int row = r0 + r;
        const int q = min(q0 + row / K, S - 1);
        const int j = sidx[row];
        float* dst = bufA + (size_t)r * ld;
        for (int c = lane; c < CP; c += 32) {
          if (c < 3) dst[c] = X[j * 3 + c] - QX[q * 3 + c];
          else if (c < C) cp_async4(dst + c, F + (size_t)j * D + (c - 3));
          else dst[c] = 0.f;
        }
      }
      cp_async_wait_all();
    } else {
      for (int e = threadIdx.x; e < nr * C; e += blockDim.x) {
        const int r = e / C, c = e - r * C;
        const int row = r0 + r;
        const int q = min(q0 + row / K, S - 1);
        const int j = sidx[row];
        bufA[(size_t)r * ld + c] =
            c < 3 ? X[j * 3 + c] - QX[q * 3 + c] : F[(size_t)j * D + (c - 3)];
      }
    }
    __syncthreads();
    int ldh;
    const float* h = Mlp::run(st.w, st.m, bufA, ld, bufB, ldb, nr, 0,
                              {ring, st.ring_ntw}, ldh);
    const int qa = r0 / K, qb = (r0 + nr - 1) / K;
    for (int e = threadIdx.x; e < (qb - qa + 1) * cout; e += blockDim.x) {
      const int qi = qa + e / cout, o = e % cout;
      const int ra = max(qi * K, r0) - r0, rb = min(qi * K + K, r0 + nr) - r0;
      float m = best[qi * cout + o];
      for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ldh + o]);
      best[qi * cout + o] = m;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < Q * cout; e += blockDim.x) {
    const int q = q0 + e / cout;
    if (q < S) st.out[((size_t)b * S + q) * cout + (e % cout)] = best[e];
  }
}

// ---- kNN-conv: kNN group + MLP1 + max + skip + MLP2 ----------------------

// One kNN-conv stage over B streams (pci_tpu/ops/pallas_kernels/
// knnconv_tpu.py).  Each query takes its exact k nearest keys, ties to the
// lower index; a slot's MLP1 input is [key_xyz - query, key_feats,
// query_feats]; the max over slots, then [pooled, skip, skip2] through MLP2,
// whose last n_final layers are linear (a regression head riding the chain).
// interp: pool by 3-NN inverse distance instead (k = 3, no MLP1), weights
// from the chosen keys' distances, 1 / max(d, 1e-10) or (recip_eps)
// 1 / (d + 1e-8).  Both MLPs run on the tensor cores (TensorMlp, weights in
// make_tf32_spec's layout).
struct KnnConvStage {
  const float* qxyz;   // queries [B][S][3]
  const float* kxyz;   // keys [B][N][3]
  const float* kfeat;  // key features [B][N][D]
  const float* qfeat;  // [B][S][C1], appended to every slot, or null
  const float* skip;   // [B][S][Cs] after the pooled features, or null
  const float* skip2;  // [B][S][Cs2] after skip, or null
  const float* w1;     // the folded MLP1, split for the tensor cores
  const float* w2;     // the folded MLP2, split for the tensor cores
  float* out;          // [B][S][cout]
  MlpSpec m1, m2;
  int N, S, D, C1, Cs, Cs2, k, interp, recip_eps, n_final;
  int Q, R, ld1, ld2;  // queries a tile, MLP1 rows a chunk, buffer rows
  int ld1b, ld2b;      // the B buffers' own row strides
  int ring_ntw;        // the n-tiles a k-step of the weight ring holds
  int kstage;          // interp: the keys staged in shared memory
};

// The grouped tile's layout: MLP1's buffers A [RR][ld1] and B [RR][ld1b],
// whose space MLP2's B buffer [QR][ld2b] reuses once the slots are pooled,
// then the pooled rows [QR][ld2], indices, the weight ring.
__host__ __device__ inline size_t knn_conv_front(const KnnConvStage& s) {
  const size_t mlp1 = (size_t)round_up(s.R, 16) * (s.ld1 + s.ld1b);
  const size_t mlp2b = (size_t)round_up(s.Q, 16) * s.ld2b;
  return mlp1 > mlp2b ? mlp1 : mlp2b;
}

static inline size_t knn_conv_smem(const KnnConvStage& s) {
  return sizeof(float) * (knn_conv_front(s) + (size_t)round_up(s.Q, 16) * s.ld2 +
                          round_up(s.Q * s.k, 4) + MMA_RING_FLOATS(s.ring_ntw));
}

// Host side: the widths chain, k fits the keys, interp is 3-NN with no MLP1.
static inline bool knn_conv_check(const KnnConvStage& s) {
  const int n1 = s.m1.n, n2 = s.m2.n;
  if (n1 < 0 || n1 > PCI_MAX_LAYERS || n2 < 0 || n2 > PCI_MAX_LAYERS || s.k < 1 ||
      s.k > s.N || (s.interp && (n1 || s.C1 || s.k != 3)) || s.n_final < 0 ||
      s.n_final > n2)
    return false;
  const int C0 = 3 + s.D + s.C1;
  if (n1 && s.m1.dims[0] != C0) return false;
  const int cm = s.interp ? s.D : (n1 ? s.m1.dims[n1] : C0);
  return !n2 || s.m2.dims[0] == cm + s.Cs + s.Cs2;
}

// Host side, the grouped plan for B streams: Q = tc_queries queries a tile,
// R <= 64 MLP1 rows a chunk in 16-row tiles, fitted to `budget` bytes by
// tc_fit.
static inline bool knn_conv_plan(KnnConvStage& s, size_t budget, int B) {
  if (s.interp || !knn_conv_check(s)) return false;
  const int n1 = s.m1.n, n2 = s.m2.n, C0 = 3 + s.D + s.C1;
  const int cin2 = (n1 ? s.m1.dims[n1] : C0) + s.Cs + s.Cs2;
  s.ld1 = tc_ld(n1 ? chain_width(s.m1, true) : C0);
  s.ld1b = n1 ? tc_ld(chain_width(s.m1, false)) : 0;
  s.ld2 = tc_ld(n2 ? std::max(cin2, chain_width(s.m2, true)) : cin2);
  s.ld2b = n2 ? tc_ld(chain_width(s.m2, false)) : 0;
  s.Q = tc_queries(B, s.S, std::min(8, 64 / s.k));  // Q * k <= 64 MLP1 rows
  s.R = std::min(64, round_up(s.Q * s.k, 16));
  s.kstage = 0;
  tc_fit(s, budget, knn_conv_smem);
  return true;
}

// Queries q0 .. q0 + Q - 1 of stream b, grouped (a tail tile repeats the
// last query and writes only the real ones).
__device__ __forceinline__ void knn_conv_tile(const KnnConvStage& st, int b, int q0,
                                              float* smem) {
  const int Q = st.Q, R = st.R, k = st.k, N = st.N, S = st.S, D = st.D;
  const int C1 = st.C1, Cs = st.Cs, Cs2 = st.Cs2, ld1 = st.ld1, ld2 = st.ld2;
  const int ld1b = st.ld1b, ld2b = st.ld2b;
  const int RR = round_up(R, 16), QR = round_up(Q, 16);
  float* bufA = smem;                                   // [RR][ld1] MLP1 rows
  float* bufB = bufA + (size_t)RR * ld1;                // [RR][ld1b]
  float* h2b = smem;                                    // [QR][ld2b], after MLP1
  float* h2a = smem + knn_conv_front(st);            // [QR][ld2] pooled | skips
  int* sidx = reinterpret_cast<int*>(h2a + (size_t)QR * ld2);  // [Q][k]
  float* ring = reinterpret_cast<float*>(sidx) + round_up(Q * k, 4);
  const float* KX = st.kxyz + (size_t)b * N * 3;
  const float* KF = st.kfeat + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers

  // 1. exact kNN: one warp a query, k lexicographic argmin rounds over
  // (squared distance, key index), each after the previous winner.  For
  // k > 16 (FlowEmbedding's 64 of 256, one query a tile), where the tile's
  // distances fit in the MLP1 buffer, every thread ranks one (query, key)
  // pair by (distance, index) among the query's keys instead, and a pair
  // of rank s < k is slot s: the same slots as the rounds, in one pass over
  // the block's threads, not k rounds of a warp
  bool ranked = false;
  if (k > 16 && (size_t)Q * N <= (size_t)RR * ld1) {
    float* dist = bufA;
    for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
      const int qi = e / N, j = e - qi * N;
      const int q = min(q0 + qi, S - 1);
      dist[e] = sqdist3(KX[j * 3], KX[j * 3 + 1], KX[j * 3 + 2], QX[q * 3], QX[q * 3 + 1],
                        QX[q * 3 + 2]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
      const int qi = e / N, j = e - qi * N;
      const float* dq = dist + (size_t)qi * N;
      const float d = dq[j];
      int rank = 0;
      for (int i = 0; i < N; ++i) {
        const float di = dq[i];
        rank += (di < d) | ((di == d) & (i < j));
      }
      if (rank < k) sidx[qi * k + rank] = j;
    }
    ranked = true;
  }
  for (int qi = warp; qi < Q && !ranked; qi += nwarps) {
    const int q = min(q0 + qi, S - 1);
    const float qx = QX[q * 3], qy = QX[q * 3 + 1], qz = QX[q * 3 + 2];
    float pd = -1.f;
    int pi = -1;
    for (int s = 0; s < k; ++s) {
      float bd = CUDART_INF_F;
      int bi = 0x7fffffff;
      for (int j = lane; j < N; j += 32) {
        const float d = sqdist3(KX[j * 3], KX[j * 3 + 1], KX[j * 3 + 2], qx, qy, qz);
        const bool after = d > pd || (d == pd && j > pi);
        if (after && d < bd) {  // j grows per lane: equal d keeps the lower j
          bd = d;
          bi = j;
        }
      }
      warp_argmin(bd, bi);
      if (lane == 0) sidx[qi * k + s] = bi;
      pd = bd;
      pi = bi;
    }
  }
  __syncthreads();

  // 2. gather [dxyz | key feats | query feats] rows chunk by chunk (zeros up
  // to MLP1's padded input width), MLP1, running max into h2a[:, 0:cm]
  const int C0 = 3 + D + C1;
  const int CP = st.m1.n ? round_up(C0, 8) : C0;
  const int cm = st.m1.n ? st.m1.dims[st.m1.n] : C0;
  for (int e = threadIdx.x; e < Q * cm; e += blockDim.x)
    h2a[(size_t)(e / cm) * ld2 + (e % cm)] = -CUDART_INF_F;
  const int rows = Q * k;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    __syncthreads();
    for (int r = warp; r < nr; r += nwarps) {  // a warp a row, the copies all in flight
      const int row = r0 + r;
      const int q = min(q0 + row / k, S - 1);
      const int j = sidx[row];
      float* dst = bufA + (size_t)r * ld1;
      for (int c = lane; c < CP; c += 32) {
        if (c < 3) dst[c] = KX[j * 3 + c] - QX[q * 3 + c];
        else if (c < 3 + D) cp_async4(dst + c, KF + (size_t)j * D + (c - 3));
        else if (c < C0) cp_async4(dst + c, st.qfeat + ((size_t)b * S + q) * C1 + (c - 3 - D));
        else dst[c] = 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    int ldh;
    const float* h = mma_mlp_rows(st.w1, st.m1, bufA, ld1, bufB, ld1b, nr, 0,
                                  {ring, st.ring_ntw}, ldh);
    const int qa = r0 / k, qb = (r0 + nr - 1) / k;
    for (int e = threadIdx.x; e < (qb - qa + 1) * cm; e += blockDim.x) {
      const int qi = qa + e / cm, o = e % cm;
      const int ra = max(qi * k, r0) - r0, rb = min(qi * k + k, r0 + nr) - r0;
      float m = h2a[(size_t)qi * ld2 + o];
      for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ldh + o]);
      h2a[(size_t)qi * ld2 + o] = m;
    }
  }
  // 3. skip concats (zeros up to MLP2's padded input width), MLP2 over the
  // tile's Q rows
  for (int e = threadIdx.x; e < Q * Cs; e += blockDim.x) {
    const int qi = e / Cs, c = e - qi * Cs;
    const int q = min(q0 + qi, S - 1);
    h2a[(size_t)qi * ld2 + cm + c] = st.skip[((size_t)b * S + q) * Cs + c];
  }
  for (int e = threadIdx.x; e < Q * Cs2; e += blockDim.x) {
    const int qi = e / Cs2, c = e - qi * Cs2;
    const int q = min(q0 + qi, S - 1);
    h2a[(size_t)qi * ld2 + cm + Cs + c] = st.skip2[((size_t)b * S + q) * Cs2 + c];
  }
  const int cin2 = cm + Cs + Cs2, pad = round_up(cin2, 8) - cin2;
  for (int e = threadIdx.x; e < Q * pad && st.m2.n; e += blockDim.x)
    h2a[(size_t)(e / pad) * ld2 + cin2 + (e % pad)] = 0.f;
  __syncthreads();
  int ldh;
  const float* h = mma_mlp_rows(st.w2, st.m2, h2a, ld2, h2b, ld2b, Q, st.n_final,
                                {ring, st.ring_ntw}, ldh);
  const int cout = st.m2.n ? st.m2.dims[st.m2.n] : cin2;
  for (int e = threadIdx.x; e < Q * cout; e += blockDim.x) {
    const int qi = e / cout, o = e - qi * cout;
    const int q = q0 + qi;
    if (q < S) st.out[((size_t)b * S + q) * cout + o] = h[(size_t)qi * ldh + o];
  }
}

// ---- kNN-conv, interp: 3-NN inverse distance + skip + MLP2 ---------------

// The interp tile's layout: the front (the staged keys [N][3] until the
// pooling, then MLP2's B buffer [QR][ld2b]), the pooled rows [QR][ld2], the
// 3-NN weights and indices, the weight ring.
__host__ __device__ inline size_t knn_interp_front(const KnnConvStage& s) {
  const size_t mlp2b = (size_t)round_up(s.Q, 16) * s.ld2b;
  const size_t keys = s.kstage ? (size_t)round_up(3 * s.N, 4) : 0;
  return mlp2b > keys ? mlp2b : keys;
}

static inline size_t knn_interp_smem(const KnnConvStage& s) {
  return sizeof(float) * (knn_interp_front(s) + (size_t)round_up(s.Q, 16) * s.ld2 +
                          2 * round_up(s.Q * 3, 4) +
                          (s.m2.n ? MMA_RING_FLOATS(s.ring_ntw) : 0));
}

// Host side, the interp plan: Q = 64 queries a tile, so MLP2 streams its
// split weights once for 64 rows (the FeaturePropagation + classifier chain
// of FlowNet3D, 1.3 MB, once a tile), the keys staged in shared memory
// where their 3 N floats take at most 48 KB; then the weight ring's
// n-tiles, then Q, halved (Q down to 16) while the tile exceeds `budget`.
static inline bool knn_interp_plan(KnnConvStage& s, size_t budget) {
  if (!s.interp || !knn_conv_check(s)) return false;
  const int n2 = s.m2.n, cin2 = s.D + s.Cs + s.Cs2;
  s.R = s.ld1 = s.ld1b = 0;
  s.ld2 = tc_ld(n2 ? std::max(cin2, chain_width(s.m2, true)) : cin2);
  s.ld2b = n2 ? tc_ld(chain_width(s.m2, false)) : 0;
  s.kstage = (size_t)s.N * 3 * sizeof(float) <= 48 * 1024;
  for (s.Q = 64;; s.Q /= 2) {
    // mma_dense_rows: 2 n-tiles an item over 4 row tiles, else 4
    s.ring_ntw = n2 ? (s.Q > 32 ? 2 : MMA_NTW) : 0;
    while (knn_interp_smem(s) > budget && s.ring_ntw > 1) s.ring_ntw /= 2;
    if (knn_interp_smem(s) <= budget || s.Q == 16) break;
  }
  return knn_interp_smem(s) <= budget;
}

// Queries q0 .. q0 + Q - 1 of stream b in the interp mode, MLP2 on the
// tensor cores (kMlp) or none.  The 3-NN is one warp a query in one pass
// over the keys: each lane keeps its three least (distance, index) pairs
// in order (its keys come in index order, so an equal distance stays
// behind the earlier key), then three warp argmin rounds over the lanes'
// heads take the query's three least pairs in (distance, index) order:
// the slots of knn_conv_tile's three rounds over all keys.
template <bool kMlp>
__device__ __forceinline__ void knn_interp_tile(const KnnConvStage& st, int b, int q0,
                                                float* smem) {
  const int Q = st.Q, N = st.N, S = st.S, D = st.D, Cs = st.Cs, Cs2 = st.Cs2;
  const int ld2 = st.ld2, QR = round_up(Q, 16);
  float* h2b = smem;                                 // [QR][ld2b], MLP2's B buffer
  float* h2a = smem + knn_interp_front(st);          // [QR][ld2] pooled | skips
  float* wts = h2a + (size_t)QR * ld2;               // [Q][3] interp weights
  int* sidx = reinterpret_cast<int*>(wts + round_up(Q * 3, 4));  // [Q][3]
  float* ring = wts + 2 * round_up(Q * 3, 4);
  const float* KX = st.kxyz + (size_t)b * N * 3;
  const float* KF = st.kfeat + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers
  const float* keys = KX;
  if (st.kstage) {  // the keys [N][3] into the front (a lane's stride-3 reads hit 32 banks)
    for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) cp_async4(smem + i, KX + i);
    cp_async_wait_all();
    __syncthreads();
    keys = smem;
  }

  // 1. 3-NN and the interp weights
  for (int qi = warp; qi < Q; qi += nwarps) {
    const int q = min(q0 + qi, S - 1);
    const float qx = QX[q * 3], qy = QX[q * 3 + 1], qz = QX[q * 3 + 2];
    float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
    int i0 = 0x7fffffff, i1 = 0x7fffffff, i2 = 0x7fffffff;
#pragma unroll 4
    for (int j = lane; j < N; j += 32) {
      const float d = sqdist3(keys[j * 3], keys[j * 3 + 1], keys[j * 3 + 2], qx, qy, qz);
      if (d < d2) {  // rare after the first keys: a branch beats three selects
        if (d < d1) {
          d2 = d1, i2 = i1;
          if (d < d0) {
            d1 = d0, i1 = i0;
            d0 = d, i0 = j;
          } else {
            d1 = d, i1 = j;
          }
        } else {
          d2 = d, i2 = j;
        }
      }
    }
    for (int s = 0; s < 3; ++s) {
      float bd = d0;
      int bi = i0;
      warp_argmin(bd, bi);
      if (lane == 0) {
        sidx[qi * 3 + s] = bi;
        wts[qi * 3 + s] = st.recip_eps ? 1.f / (bd + 1e-8f) : 1.f / fmaxf(bd, 1e-10f);
      }
      if (i0 == bi) {  // the winning lane pops its head
        d0 = d1, i0 = i1;
        d1 = d2, i1 = i2;
        d2 = CUDART_INF_F, i2 = 0x7fffffff;
      }
    }
  }
  __syncthreads();

  // 2. pooled features into h2a[:, 0:D] (float4 columns where D and the
  // features' alignment allow), then the skip concats and (kMlp) zeros up
  // to MLP2's padded input width
  if ((D & 3) == 0 && (reinterpret_cast<size_t>(st.kfeat) & 15) == 0) {
    const int D4 = D >> 2;
    for (int e = threadIdx.x; e < Q * D4; e += blockDim.x) {
      const int qi = e / D4, c = (e - qi * D4) * 4;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
      float den = 0.f;
      for (int s = 0; s < 3; ++s) {
        const float w = wts[qi * 3 + s];
        const float4 f = *reinterpret_cast<const float4*>(KF + (size_t)sidx[qi * 3 + s] * D + c);
        num.x += w * f.x, num.y += w * f.y, num.z += w * f.z, num.w += w * f.w;
        den += w;
      }
      *reinterpret_cast<float4*>(h2a + (size_t)qi * ld2 + c) =
          make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
    }
  } else {
    for (int e = threadIdx.x; e < Q * D; e += blockDim.x) {
      const int qi = e / D, c = e - qi * D;
      float num = 0.f, den = 0.f;
      for (int s = 0; s < 3; ++s) {
        const float w = wts[qi * 3 + s];
        num += w * KF[(size_t)sidx[qi * 3 + s] * D + c];
        den += w;
      }
      h2a[(size_t)qi * ld2 + c] = num / den;
    }
  }
  for (int e = threadIdx.x; e < Q * Cs; e += blockDim.x) {
    const int qi = e / Cs, c = e - qi * Cs;
    const int q = min(q0 + qi, S - 1);
    h2a[(size_t)qi * ld2 + D + c] = st.skip[((size_t)b * S + q) * Cs + c];
  }
  for (int e = threadIdx.x; e < Q * Cs2; e += blockDim.x) {
    const int qi = e / Cs2, c = e - qi * Cs2;
    const int q = min(q0 + qi, S - 1);
    h2a[(size_t)qi * ld2 + D + Cs + c] = st.skip2[((size_t)b * S + q) * Cs2 + c];
  }
  const int cin2 = D + Cs + Cs2;
  if constexpr (kMlp) {
    const int pad = round_up(cin2, 8) - cin2;
    for (int e = threadIdx.x; e < Q * pad; e += blockDim.x)
      h2a[(size_t)(e / pad) * ld2 + cin2 + (e % pad)] = 0.f;
  }
  __syncthreads();

  // 3. MLP2 over the tile's Q rows, the real rows out
  int ldh = ld2;
  const float* h = h2a;
  if constexpr (kMlp)
    h = mma_mlp_rows(st.w2, st.m2, h2a, ld2, h2b, st.ld2b, Q, st.n_final,
                     {ring, st.ring_ntw}, ldh);
  const int cout = kMlp ? st.m2.dims[st.m2.n] : cin2;
  for (int e = threadIdx.x; e < Q * cout; e += blockDim.x) {
    const int qi = e / cout, o = e - qi * cout;
    const int q = q0 + qi;
    if (q < S) st.out[((size_t)b * S + q) * cout + o] = h[(size_t)qi * ldh + o];
  }
}

// ---- cooperative launches ------------------------------------------------

// Barrier across the whole grid of a cooperative launch (every block is
// resident): `bar` is a device counter zeroed before the launch, `passed`
// counts (per thread, identically in all) the arrivals this block waits
// for.  Thread 0's release add and acquire poll, with the block barriers
// around them, make each block's writes before the barrier visible to
// every block after it; stage outputs are read with plain loads, never
// through the read-only cache.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int& passed) {
  __syncthreads();
  passed += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
    } while (v < passed);
  }
  __syncthreads();
}

// Tiles of Q rows over B streams of S rows, strided over the grid.
template <typename Tile>
__device__ __forceinline__ void grid_tiles(int B, int S, int Q, int first,
                                           Tile tile) {
  const int t = (S + Q - 1) / Q;
  for (int it = (int)blockIdx.x - first; it < B * t; it += gridDim.x)
    if (it >= 0) tile(it / t, (it % t) * Q);
}

// Launches `kernel(params)` cooperatively with `threads`-thread blocks: as
// many blocks as can be resident at once (occupancy x SMs), at most
// `items`.  Returns a CUDA error code; a grid that cannot be co-resident is
// an error, never a smaller or per-stage launch.
template <typename Params>
static inline int launch_cooperative(void (*kernel)(Params), const Params& p,
                                     size_t smem, int items, cudaStream_t stream,
                                     int threads = 256) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::max(1, std::min(per_sm * sms, items));
  Params copy = p;
  void* args[] = {&copy};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
