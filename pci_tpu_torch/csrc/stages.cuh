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
  const float* w;      // the folded MLP, common.cuh layout
  float* out;          // [B][S][cout]
  MlpSpec m;
  int N, S, D, K;
  int Q, R, ld;  // centres a tile, MLP rows a chunk, floats a buffer row
  float r2;
};

static inline size_t ball_conv_smem(const BallConvStage& s) {
  const int cout = s.m.dims[s.m.n];
  return sizeof(float) * (2 * (size_t)round_up(s.R, 8) * s.ld +
                          round_up(s.Q * cout, 4)) +
         sizeof(int) * (size_t)s.Q * s.K;
}

// Host side: checks the widths and plans the tiles for B streams: Q = 4
// centres a tile once there are 512 centres in all, else 1; R <= 64 rows in
// 96 KB of MLP buffers and no more than a tile's Q * K rows, then halved
// while the tile's shared memory exceeds `budget` bytes.
static inline bool ball_conv_plan(BallConvStage& s, int B, size_t budget) {
  if (s.m.n < 1 || s.m.n > PCI_MAX_LAYERS || s.m.dims[0] != 3 + s.D || s.K < 1)
    return false;
  int ld = 0;
  for (int l = 0; l <= s.m.n; ++l) ld = std::max(ld, s.m.dims[l]);
  s.ld = round_up(ld, 4);
  s.Q = B * s.S >= 512 ? 4 : 1;
  s.R = std::max(8, std::min(64, (96 * 1024 / (2 * s.ld * 4)) / 8 * 8));
  s.R = std::min(s.R, round_up(s.Q * s.K, 8));
  while (ball_conv_smem(s) > budget && s.R > 8) s.R = std::max(8, s.R / 2);
  return true;
}

// Centres q0 .. q0 + Q - 1 of stream b (a tail tile repeats the last
// centre and writes only the real ones).
__device__ __forceinline__ void ball_conv_tile(const BallConvStage& st, int b,
                                               int q0, float* smem) {
  const int Q = st.Q, K = st.K, N = st.N, S = st.S, D = st.D, ld = st.ld;
  const int R = st.R, RR = round_up(R, 8);
  const int cout = st.m.dims[st.m.n];
  float* bufA = smem;
  float* bufB = bufA + (size_t)RR * ld;
  float* best = bufB + (size_t)RR * ld;
  int* sidx = reinterpret_cast<int*>(best + round_up(Q * cout, 4));
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

  // 2. gather [dxyz | feats] rows chunk by chunk, MLP, running max
  const int C = 3 + D;
  const int rows = Q * K;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    for (int e = threadIdx.x; e < nr * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C;
      const int row = r0 + r;
      const int q = min(q0 + row / K, S - 1);
      const int j = sidx[row];
      bufA[(size_t)r * ld + c] =
          c < 3 ? X[j * 3 + c] - QX[q * 3 + c] : F[(size_t)j * D + (c - 3)];
    }
    __syncthreads();
    const float* h = mlp_rows(st.w, st.m, bufA, bufB, ld, nr);
    const int qa = r0 / K, qb = (r0 + nr - 1) / K;
    for (int e = threadIdx.x; e < (qb - qa + 1) * cout; e += blockDim.x) {
      const int qi = qa + e / cout, o = e % cout;
      const int ra = max(qi * K, r0) - r0, rb = min(qi * K + K, r0 + nr) - r0;
      float m = best[qi * cout + o];
      for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ld + o]);
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
  const float* w1;     // the folded MLP1, common.cuh layout
  const float* w2;     // the folded MLP2
  float* out;          // [B][S][cout]
  MlpSpec m1, m2;
  int N, S, D, C1, Cs, Cs2, k, interp, recip_eps, n_final;
  int Q, R, ld1, ld2;  // queries a tile, MLP1 rows a chunk, buffer rows
};

static inline size_t knn_conv_smem(const KnnConvStage& s) {
  return sizeof(float) * (2 * (size_t)round_up(s.R, 8) * s.ld1 +
                          2 * (size_t)round_up(s.Q, 8) * s.ld2 +
                          round_up(s.Q * s.k, 4)) +
         sizeof(int) * (size_t)s.Q * s.k;
}

// Host side: checks the widths and plans the tiles: interp, Q <= 32 pooled
// rows in 96 KB of MLP2 buffers and R = 8; else Q = 32 / k queries (1..8)
// and R <= 64 rows in 96 KB of MLP1 buffers, no more than a tile's Q * k
// rows.  Then R (for interp, Q) halved while the tile's shared memory
// exceeds `budget` bytes.
static inline bool knn_conv_plan(KnnConvStage& s, size_t budget) {
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
  int ld1 = s.interp ? 0 : C0;
  for (int l = 0; l <= n1 && n1 && !s.interp; ++l) ld1 = std::max(ld1, s.m1.dims[l]);
  s.ld1 = round_up(ld1, 4);
  int ld2 = cin2;
  for (int l = 0; l <= n2 && n2; ++l) ld2 = std::max(ld2, s.m2.dims[l]);
  s.ld2 = round_up(ld2, 4);
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
__device__ __forceinline__ void knn_conv_tile(const KnnConvStage& st, int b,
                                              int q0, float* smem) {
  const int Q = st.Q, R = st.R, k = st.k, N = st.N, S = st.S, D = st.D;
  const int C1 = st.C1, Cs = st.Cs, Cs2 = st.Cs2, ld1 = st.ld1, ld2 = st.ld2;
  const int RR = round_up(R, 8), QR = round_up(Q, 8);
  float* bufA = smem;                          // [RR][ld1] MLP1 rows
  float* bufB = bufA + (size_t)RR * ld1;       // [RR][ld1]
  float* h2a = bufB + (size_t)RR * ld1;        // [QR][ld2] pooled | skips
  float* h2b = h2a + (size_t)QR * ld2;         // [QR][ld2]
  float* wts = h2b + (size_t)QR * ld2;         // [Q][k] interp weights
  int* sidx = reinterpret_cast<int*>(wts + round_up(Q * k, 4));  // [Q][k]
  const float* KX = st.kxyz + (size_t)b * N * 3;
  const float* KF = st.kfeat + (size_t)b * N * D;
  const float* QX = st.qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // the block's previous tile is done with the buffers

  // 1. exact kNN: one warp a query, k lexicographic argmin rounds over
  // (squared distance, key index), each after the previous winner
  for (int qi = warp; qi < Q; qi += nwarps) {
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
    cm = st.m1.n ? st.m1.dims[st.m1.n] : C0;
    for (int e = threadIdx.x; e < Q * cm; e += blockDim.x)
      h2a[(size_t)(e / cm) * ld2 + (e % cm)] = -CUDART_INF_F;
    const int rows = Q * k;
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int nr = min(R, rows - r0);
      __syncthreads();
      for (int e = threadIdx.x; e < nr * C0; e += blockDim.x) {
        const int r = e / C0, c = e - r * C0;
        const int row = r0 + r;
        const int q = min(q0 + row / k, S - 1);
        const int j = sidx[row];
        float v;
        if (c < 3) v = KX[j * 3 + c] - QX[q * 3 + c];
        else if (c < 3 + D) v = KF[(size_t)j * D + (c - 3)];
        else v = st.qfeat[((size_t)b * S + q) * C1 + (c - 3 - D)];
        bufA[(size_t)r * ld1 + c] = v;
      }
      __syncthreads();
      const float* h = mlp_rows(st.w1, st.m1, bufA, bufB, ld1, nr);
      const int qa = r0 / k, qb = (r0 + nr - 1) / k;
      for (int e = threadIdx.x; e < (qb - qa + 1) * cm; e += blockDim.x) {
        const int qi = qa + e / cm, o = e % cm;
        const int ra = max(qi * k, r0) - r0, rb = min(qi * k + k, r0 + nr) - r0;
        float m = h2a[(size_t)qi * ld2 + o];
        for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ld1 + o]);
        h2a[(size_t)qi * ld2 + o] = m;
      }
    }
  }
  // 3. skip concats, MLP2 over the tile's Q rows
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
  __syncthreads();
  const float* h = mlp_rows(st.w2, st.m2, h2a, h2b, ld2, Q, st.n_final);
  const int cout = st.m2.n ? st.m2.dims[st.m2.n] : cm + Cs + Cs2;
  for (int e = threadIdx.x; e < Q * cout; e += blockDim.x) {
    const int qi = e / cout, o = e - qi * cout;
    const int q = q0 + qi;
    if (q < S) st.out[((size_t)b * S + q) * cout + o] = h[(size_t)qi * ld2 + o];
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
