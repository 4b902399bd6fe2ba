// FlowNet3D's stage bodies, shared by the per-stage kernels (csrc/fps.cu,
// csrc/setconv.cu, csrc/knnconv.cu) and the megakernels that chain them in
// one launch (csrc/flowenc.cu, csrc/flowmid.cu), so that both routes run the
// same arithmetic and pick the same points:
//   - fps_chain: exact greedy farthest point sampling by one block;
//   - ball_conv_tile: a set-conv's ball group + MLP + max for Q centres;
//   - knn_conv_tile: a kNN-conv's group + MLP1 + max + skip + MLP2 (or 3-NN
//     interpolation + skip + MLP2) for Q queries;
//   - grid_sync: the barrier between the stages of a cooperative launch.
// A tile function is called by every thread of a block; it begins with a
// __syncthreads(), so a block can run one tile after another on the same
// shared memory.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

// ---- greedy FPS ----------------------------------------------------------

// Exact greedy FPS over the L points (sx, sy, sz) in shared memory, by every
// thread of the block (PPT points a thread), starting at local index `far`.
// Iteration `it` hands its pick to emit(it, index) on thread 0, then relaxes
// every distance with (dx*dx + dy*dy) + dz*dz rounded op by op and takes
// the first maximum, as jnp.argmax does; once every distance is 0 (npick >
// L) the pick is index 0 again.
template <int PPT, typename Emit>
__device__ void fps_chain(const float* sx, const float* sy, const float* sz,
                          int L, int npick, int far, Emit emit) {
  __shared__ float wd[32];
  __shared__ int wi[32];
  __shared__ int far_s;
  float dist[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) dist[t] = CUDART_INF_F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int it = 0; it < npick; ++it) {
    if (threadIdx.x == 0) emit(it, far);
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float bd = -1.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const int j = threadIdx.x + t * blockDim.x;
      if (j < L) {
        const float d = sqdist3(sx[j], sy[j], sz[j], cx, cy, cz);
        dist[t] = fminf(dist[t], d);
        if (dist[t] > bd) {  // j grows with t: the first maximum is kept
          bd = dist[t];
          bi = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od > bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (lane == 0) {
      wd[warp] = bd;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < nwarps ? wd[lane] : -1.f;
      bi = lane < nwarps ? wi[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od > bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
    far = far_s;
  }
}

// Greedy FPS from index 0 over the L points X [L][3] (device memory), by one
// block: the npick centres' coordinates go to out [npick][3].  Needs 3 * L
// floats of shared memory and L <= 16 * blockDim.x.
__device__ __forceinline__ void fps_centres(const float* X, int L, int npick,
                                            float* out, float* smem) {
  float* sx = smem;
  float* sy = sx + L;
  float* sz = sy + L;
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    sx[j] = X[j * 3];
    sy[j] = X[j * 3 + 1];
    sz[j] = X[j * 3 + 2];
  }
  __syncthreads();
  auto emit = [&](int it, int f) {
    out[it * 3] = sx[f];
    out[it * 3 + 1] = sy[f];
    out[it * 3 + 2] = sz[f];
  };
  const int ppt = (L + blockDim.x - 1) / blockDim.x;
  if (ppt <= 1) fps_chain<1>(sx, sy, sz, L, npick, 0, emit);
  else if (ppt <= 2) fps_chain<2>(sx, sy, sz, L, npick, 0, emit);
  else if (ppt <= 4) fps_chain<4>(sx, sy, sz, L, npick, 0, emit);
  else if (ppt <= 8) fps_chain<8>(sx, sy, sz, L, npick, 0, emit);
  else fps_chain<16>(sx, sy, sz, L, npick, 0, emit);
}

// ---- the MLP routine a tile runs -----------------------------------------

// The tiles below take their MLP routine as a template parameter: ScalarMlp
// (common.cuh's mlp_rows, scalar fp32, weights in common.cuh's layout) for
// the per-stage kernels, the encoder megakernel and their default, or
// TensorMlp (csrc/mma_tf32.cuh, 3xTF32 on the tensor cores, weights split
// in make_tf32_spec's layout) for the decode megakernel.  run() returns
// the buffer holding the chain's output and its row stride.
struct ScalarMlp {
  static constexpr bool kTensor = false;
  static constexpr int kRows = 8;  // rows a buffer holds a multiple of
  __device__ static __forceinline__ float* run(const float* __restrict__ w, const MlpSpec& m,
                                               float* a, int lda, float* b, int, int R,
                                               int n_linear, MmaRing, int& ld_out) {
    ld_out = lda;
    return mlp_rows(w, m, a, b, lda, R, n_linear);
  }
};

// Host side, the tensor-core plans: a row stride % 8 == 4 (conflict-free A
// fragments) that holds `w` columns padded to 8.
static inline int tc_ld(int w) { return round_up(w, 8) + 4; }

// Host side: the queries (centres) a tensor-core tile takes: the most of 8,
// 4, 2 that keeps 64 MLP rows a tile (q * k <= 64) and still leaves 128
// tiles over the B streams' S rows (about one an SM), else 1.  A tile
// streams its stage's weights once, so fewer, fuller tiles read less; but
// a stage with fewer tiles than SMs leaves SMs idle.
static inline int tc_queries(int B, int S, int k) {
  for (int q = std::min(8, 64 / std::max(k, 1)); q > 1; q /= 2)
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
  int Q, R, ld;  // centres a tile, MLP rows a chunk, floats a buffer row
  int tc, ldb;   // TensorMlp's plan: buffer B's own row stride (ld is A's),
  int ring_ntw;  // and the n-tiles a k-step of its weight ring holds
  float r2;
};

static inline size_t ball_conv_smem(const BallConvStage& s) {
  const int cout = s.m.dims[s.m.n];
  if (s.tc)
    return sizeof(float) * ((size_t)round_up(s.R, 16) * (s.ld + s.ldb) +
                            round_up(s.Q * cout, 4) + round_up(s.Q * s.K, 4) +
                            MMA_RING_FLOATS(s.ring_ntw));
  return sizeof(float) * (2 * (size_t)round_up(s.R, 8) * s.ld +
                          round_up(s.Q * cout, 4)) +
         sizeof(int) * (size_t)s.Q * s.K;
}

// Host side: checks the widths and plans the tiles for B streams: Q = 4
// centres a tile once there are 512 centres in all, else 1; R <= 64 rows in
// 96 KB of MLP buffers and no more than a tile's Q * K rows, then halved
// while the tile's shared memory exceeds `budget` bytes.  tensor (the
// TensorMlp plan): Q = tc_queries centres, R <= 64 rows in 16-row tiles,
// fitted to the budget by tc_fit.
static inline bool ball_conv_plan(BallConvStage& s, int B, size_t budget,
                                  bool tensor = false) {
  if (s.m.n < 1 || s.m.n > PCI_MAX_LAYERS || s.m.dims[0] != 3 + s.D || s.K < 1)
    return false;
  s.tc = tensor;
  if (tensor) {
    s.ld = tc_ld(chain_width(s.m, true));
    s.ldb = tc_ld(chain_width(s.m, false));
    s.Q = tc_queries(B, s.S, s.K);
    s.R = std::min(64, round_up(s.Q * s.K, 16));
    tc_fit(s, budget, ball_conv_smem);
    return true;
  }
  int ld = 0;
  for (int l = 0; l <= s.m.n; ++l) ld = std::max(ld, s.m.dims[l]);
  s.ld = round_up(ld, 4);
  s.ldb = s.ld, s.ring_ntw = 0;
  s.Q = B * s.S >= 512 ? 4 : 1;
  s.R = std::max(8, std::min(64, (96 * 1024 / (2 * s.ld * 4)) / 8 * 8));
  s.R = std::min(s.R, round_up(s.Q * s.K, 8));
  while (ball_conv_smem(s) > budget && s.R > 8) s.R = std::max(8, s.R / 2);
  return true;
}

// Centres q0 .. q0 + Q - 1 of stream b (a tail tile repeats the last
// centre and writes only the real ones).
template <typename Mlp = ScalarMlp>
__device__ __forceinline__ void ball_conv_tile(const BallConvStage& st, int b,
                                               int q0, float* smem) {
  const int Q = st.Q, K = st.K, N = st.N, S = st.S, D = st.D, ld = st.ld;
  const int R = st.R, RR = round_up(R, Mlp::kRows);
  const int cout = st.m.dims[st.m.n];
  const int ldb = Mlp::kTensor ? st.ldb : ld;
  float* bufA = smem;
  float* bufB = bufA + (size_t)RR * ld;
  float* best = bufB + (size_t)RR * ldb;
  int* sidx = reinterpret_cast<int*>(best + round_up(Q * cout, 4));
  float* ring = Mlp::kTensor ? reinterpret_cast<float*>(sidx + round_up(Q * K, 4)) : nullptr;
  const float* X = st.xyz + (size_t)b * N * 3;
  const float* F = st.feats + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers

  // 1. ball query: one warp a centre, keys in index order, early exit
  for (int qi = warp; qi < Q; qi += nwarps) {
    int* id = sidx + qi * K;
    const int q = min(q0 + qi, S - 1);
    const float qx = QX[q * 3], qy = QX[q * 3 + 1], qz = QX[q * 3 + 2];
    int count = 0;
    for (int base = 0; base < N && count < K; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < N) hit = sqdist3(X[j * 3], X[j * 3 + 1], X[j * 3 + 2], qx, qy, qz) <= st.r2;
      count = ball_place(hit, j, count, K, id);
    }
    ball_pad(id, count, K, 0);  // an empty ball reads key 0
  }
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
// interp: pool by 3-NN inverse distance instead, weights from distances
// recomputed off the chosen keys, 1 / max(d, 1e-10) or (recip_eps)
// 1 / (d + 1e-8).
struct KnnConvStage {
  const float* qxyz;   // queries [B][S][3]
  const float* kxyz;   // keys [B][N][3]
  const float* kfeat;  // key features [B][N][D]
  const float* qfeat;  // [B][S][C1], appended to every slot, or null
  const float* skip;   // [B][S][Cs] after the pooled features, or null
  const float* skip2;  // [B][S][Cs2] after skip, or null
  const float* w1;     // the folded MLP1, in the layout of the tile's MLP routine
  const float* w2;     // the folded MLP2
  float* out;          // [B][S][cout]
  MlpSpec m1, m2;
  int N, S, D, C1, Cs, Cs2, k, interp, recip_eps, n_final;
  int Q, R, ld1, ld2;  // queries a tile, MLP1 rows a chunk, buffer rows
  int tc, ld1b, ld2b;  // TensorMlp's plan: the B buffers' own row strides,
  int ring_ntw;        // and the n-tiles a k-step of its weight ring holds
};

// TensorMlp's layout: MLP1's buffers A [RR][ld1] and B [RR][ld1b], whose
// space MLP2's B buffer [QR][ld2b] reuses once the slots are pooled, then
// the pooled rows [QR][ld2], weights, indices, the weight ring.
__host__ __device__ inline size_t knn_conv_tc_front(const KnnConvStage& s) {
  const size_t mlp1 = (size_t)round_up(s.R, 16) * (s.ld1 + s.ld1b);
  const size_t mlp2b = (size_t)round_up(s.Q, 16) * s.ld2b;
  return mlp1 > mlp2b ? mlp1 : mlp2b;
}

static inline size_t knn_conv_smem(const KnnConvStage& s) {
  if (s.tc)
    return sizeof(float) * (knn_conv_tc_front(s) + (size_t)round_up(s.Q, 16) * s.ld2 +
                            2 * round_up(s.Q * s.k, 4) +
                            MMA_RING_FLOATS(s.ring_ntw));
  return sizeof(float) * (2 * (size_t)round_up(s.R, 8) * s.ld1 +
                          2 * (size_t)round_up(s.Q, 8) * s.ld2 +
                          round_up(s.Q * s.k, 4)) +
         sizeof(int) * (size_t)s.Q * s.k;
}

// Host side: checks the widths and plans the tiles: interp, Q <= 32 pooled
// rows in 96 KB of MLP2 buffers and R = 8; else Q = 32 / k queries (1..8)
// and R <= 64 rows in 96 KB of MLP1 buffers, no more than a tile's Q * k
// rows.  Then R (for interp, Q) halved while the tile's shared memory
// exceeds `budget` bytes.  tensor (the TensorMlp plan): Q = tc_queries
// queries (interp 16), R <= 64 rows in 16-row tiles, fitted to the budget
// by tc_fit; B streams.
static inline bool knn_conv_plan(KnnConvStage& s, size_t budget, bool tensor = false,
                                 int B = 1) {
  const int n1 = s.m1.n, n2 = s.m2.n;
  if (n1 < 0 || n1 > PCI_MAX_LAYERS || n2 < 0 || n2 > PCI_MAX_LAYERS ||
      s.k < 1 || s.k > s.N || (s.interp && (n1 || s.C1)) || s.n_final < 0 ||
      s.n_final > n2)
    return false;
  const int C0 = 3 + s.D + s.C1;
  if (n1 && s.m1.dims[0] != C0) return false;
  const int cm = s.interp ? s.D : (n1 ? s.m1.dims[n1] : C0);
  const int cin2 = cm + s.Cs + s.Cs2;
  if (n2 && s.m2.dims[0] != cin2) return false;
  s.tc = tensor;
  if (tensor) {
    s.ld1 = s.interp ? 0 : tc_ld(n1 ? chain_width(s.m1, true) : C0);
    s.ld1b = s.interp || !n1 ? 0 : tc_ld(chain_width(s.m1, false));
    s.ld2 = tc_ld(n2 ? std::max(cin2, chain_width(s.m2, true)) : cin2);
    s.ld2b = n2 ? tc_ld(chain_width(s.m2, false)) : 0;
    s.Q = s.interp ? 16 : tc_queries(B, s.S, s.k);
    s.R = s.interp ? 16 : std::min(64, round_up(s.Q * s.k, 16));
    tc_fit(s, budget, knn_conv_smem);
    return true;
  }
  int ld1 = s.interp ? 0 : C0;
  for (int l = 0; l <= n1 && n1 && !s.interp; ++l) ld1 = std::max(ld1, s.m1.dims[l]);
  s.ld1 = round_up(ld1, 4);
  int ld2 = cin2;
  for (int l = 0; l <= n2 && n2; ++l) ld2 = std::max(ld2, s.m2.dims[l]);
  s.ld2 = round_up(ld2, 4);
  s.ld1b = s.ld1, s.ld2b = s.ld2, s.ring_ntw = 0;
  if (s.interp) {
    s.Q = std::max(8, std::min(32, (96 * 1024 / (2 * s.ld2 * 4)) / 8 * 8));
    s.R = 8;
    while (knn_conv_smem(s) > budget && s.Q > 8) s.Q = std::max(8, s.Q / 2);
  } else {
    s.Q = std::max(1, std::min(8, 32 / s.k));
    s.R = std::max(8, std::min(64, (96 * 1024 / (2 * s.ld1 * 4)) / 8 * 8));
    s.R = std::min(s.R, round_up(s.Q * s.k, 8));
    while (knn_conv_smem(s) > budget && s.R > 8) s.R = std::max(8, s.R / 2);
  }
  return true;
}


// Queries q0 .. q0 + Q - 1 of stream b (a tail tile repeats the last query
// and writes only the real ones).
template <typename Mlp = ScalarMlp>
__device__ __forceinline__ void knn_conv_tile(const KnnConvStage& st, int b,
                                              int q0, float* smem) {
  const int Q = st.Q, R = st.R, k = st.k, N = st.N, S = st.S, D = st.D;
  const int C1 = st.C1, Cs = st.Cs, Cs2 = st.Cs2, ld1 = st.ld1, ld2 = st.ld2;
  const int RR = round_up(R, Mlp::kRows), QR = round_up(Q, Mlp::kRows);
  float *bufA, *bufB, *h2a, *h2b, *wts, *ring = nullptr;
  int ld1b = ld1, ld2b = ld2;
  if constexpr (Mlp::kTensor) {
    ld1b = st.ld1b, ld2b = st.ld2b;
    bufA = smem;                                   // [RR][ld1] MLP1 rows
    bufB = bufA + (size_t)RR * ld1;                // [RR][ld1b]
    h2b = smem;                                    // [QR][ld2b], after MLP1
    h2a = smem + knn_conv_tc_front(st);            // [QR][ld2] pooled | skips
    wts = h2a + (size_t)QR * ld2;                  // [Q][k] interp weights
    ring = wts + 2 * round_up(Q * k, 4);           // after the indices
  } else {
    bufA = smem;                          // [RR][ld1] MLP1 rows
    bufB = bufA + (size_t)RR * ld1;       // [RR][ld1]
    h2a = bufB + (size_t)RR * ld1;        // [QR][ld2] pooled | skips
    h2b = h2a + (size_t)QR * ld2;         // [QR][ld2]
    wts = h2b + (size_t)QR * ld2;         // [Q][k] interp weights
  }
  int* sidx = reinterpret_cast<int*>(wts + round_up(Q * k, 4));  // [Q][k]
  const float* KX = st.kxyz + (size_t)b * N * 3;
  const float* KF = st.kfeat + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers

  // 1. exact kNN: one warp a query, k lexicographic argmin rounds over
  // (squared distance, key index), each after the previous winner.
  // TensorMlp, for k > 16 (FlowEmbedding's 64 of 256, one query a tile):
  // where the tile's distances fit in the MLP1 buffer, every thread ranks
  // one (query, key) pair by (distance, index) among the query's keys
  // instead, and a pair of rank s < k is slot s: the same slots as the
  // rounds, in one pass over the block's threads, not k rounds of a warp
  bool ranked = false;
  if constexpr (Mlp::kTensor) {
    if (!st.interp && k > 16 && (size_t)Q * N <= (size_t)RR * ld1) {
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

  // 2. pooled features into h2a[:, 0:cm]
  int cm;
  if (st.interp) {
    for (int e = threadIdx.x; e < Q * k; e += blockDim.x) {
      const int qi = e / k;
      const int q = min(q0 + qi, S - 1);
      const int j = sidx[e];
      const float d = sqdist3(KX[j * 3], KX[j * 3 + 1], KX[j * 3 + 2],
                              QX[q * 3], QX[q * 3 + 1], QX[q * 3 + 2]);
      wts[e] = st.recip_eps ? 1.f / (d + 1e-8f) : 1.f / fmaxf(d, 1e-10f);
    }
    __syncthreads();
    cm = D;
    for (int e = threadIdx.x; e < Q * D; e += blockDim.x) {
      const int qi = e / D, c = e - qi * D;
      float num = 0.f, den = 0.f;
      for (int s = 0; s < k; ++s) {
        const float w = wts[qi * k + s];
        num += w * KF[(size_t)sidx[qi * k + s] * D + c];
        den += w;
      }
      h2a[(size_t)qi * ld2 + c] = num / den;
    }
  } else {
    const int C0 = 3 + D + C1;
    // TensorMlp: zeros up to MLP1's padded input width
    const int CP = Mlp::kTensor && st.m1.n ? round_up(C0, 8) : C0;
    cm = st.m1.n ? st.m1.dims[st.m1.n] : C0;
    for (int e = threadIdx.x; e < Q * cm; e += blockDim.x)
      h2a[(size_t)(e / cm) * ld2 + (e % cm)] = -CUDART_INF_F;
    const int rows = Q * k;
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int nr = min(R, rows - r0);
      __syncthreads();
      if constexpr (Mlp::kTensor) {  // a warp a row, the feature copies all in flight
        for (int r = warp; r < nr; r += nwarps) {
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
      } else {
        for (int e = threadIdx.x; e < nr * CP; e += blockDim.x) {
          const int r = e / CP, c = e - r * CP;
          const int row = r0 + r;
          const int q = min(q0 + row / k, S - 1);
          const int j = sidx[row];
          float v;
          if (c < 3) v = KX[j * 3 + c] - QX[q * 3 + c];
          else if (c < 3 + D) v = KF[(size_t)j * D + (c - 3)];
          else v = st.qfeat[((size_t)b * S + q) * C1 + (c - 3 - D)];
          bufA[(size_t)r * ld1 + c] = v;
        }
      }
      __syncthreads();
          int ldh;
      const float* h = Mlp::run(st.w1, st.m1, bufA, ld1, bufB, ld1b, nr, 0,
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
  }
  // 3. skip concats (TensorMlp: zeros up to MLP2's padded input width),
  // MLP2 over the tile's Q rows
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
  if constexpr (Mlp::kTensor) {
    const int cin2 = cm + Cs + Cs2, pad = round_up(cin2, 8) - cin2;
    for (int e = threadIdx.x; e < Q * pad && st.m2.n; e += blockDim.x)
      h2a[(size_t)(e / pad) * ld2 + cin2 + (e % pad)] = 0.f;
  }
  __syncthreads();
  int ldh;
  const float* h = Mlp::run(st.w2, st.m2, h2a, ld2, h2b, ld2b, Q, st.n_final,
                            {ring, st.ring_ntw}, ldh);
  const int cout = st.m2.n ? st.m2.dims[st.m2.n] : cm + Cs + Cs2;
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
// for.  The fences make each block's writes before the barrier visible to
// every block after it; stage outputs are read with plain loads, never
// through the read-only cache.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int& passed) {
  __syncthreads();
  passed += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(bar) < passed) __nanosleep(64);
    __threadfence();
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

// Launches `kernel(params)` cooperatively with 256-thread blocks: as many
// blocks as can be resident at once (occupancy x SMs), at most `items`.
// Returns a CUDA error code; a grid that cannot be co-resident is an error,
// never a smaller or per-stage launch.
template <typename Params>
static inline int launch_cooperative(void (*kernel)(Params), const Params& p,
                                     size_t smem, int items, cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::max(1, std::min(per_sm * sms, items));
  Params copy = p;
  void* args[] = {&copy};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(256), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
