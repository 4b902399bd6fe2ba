// Point-transformer vector-attention tail, backward (training):
//   pos = W_d1 relu(W_d0 delta + b_d0) + b_d1
//   a   = W_g1 relu(W_g0 (q - K + pos) + b_g0) + b_g1
//   res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
// given d res, the gradients of q [M, d], g = [K | V] [M, k, 2d], delta
// [M, k, 3] and of the eight weights and biases, at fp32 accuracy.
//
// Replaces pci_tpu/ops/pallas_kernels/attention_tpu.py:_vat_bwd_rule, the
// backward pallas_call of vector_attention_trainable (_attn_bwd_kernel).
// Like it, this kernel keeps no forward intermediate: each tile recomputes
// its forward, then walks the chain rule back.  The trainable forward is
// csrc/attention.cu's eval kernel.
//
// What bounds it on the H100: the tensor cores.  At the transformer's
// shapes (128,000 queries, k = 16, d = 64) the recomputed forward is 2 R
// (3d + 3d^2) flops over R = M k rows and the backward six more [R, d] x
// [d, d] products (three for the inputs' gradients, three for the
// weights'), ~153 GFLOP, 3 x that in 3xTF32: 0.93 ms at 495 TFLOP/s; the
// bytes (q, K|V, delta and d res in, their gradients out, 128,000 x 16
// slots x 128 floats x 4 B each way for K|V alone: ~2.2 GB) take 0.65 ms.
//
// The design: a tile is 64 rows (64 / k queries times their k slots, k <=
// 32) whose activations live in five [64, d] shared buffers (a row stride
// of round_up(d, 16) + 4 floats, zero past d and past the tile's rows),
// its K | V rows beside them, brought by cp.async while the first layers
// run; 16 warps a block, one block an SM.  Every [64, d] x [d, d] product
// runs on the tensor cores in 3xTF32 (csrc/mma_tf32.cuh), a warp taking a
// 16-row tile and two n-tiles: the forward's three d -> d layers and the
// input gradients' (dr2 = da W_g1, dh = dpre2 W_g0, dr1 = dpos W_d1) read
// the same fp32 copy of W_d1^T, W_g0^T and W_g1^T in shared memory (52 KB
// at d = 64), as W^T or, through its transposed strides, as W, and split
// both operands in the kernel.  (Split packs of both directions, 200 KB,
// fit beside the tiles only in device memory; read from there, four warps
// a fragment, the kernel ran 10% slower on the H100.)  The weight gradients dW += X^T D
// contract over the tile's 64 rows on the tensor cores too: each (16 x 8)
// block of dW belongs to one warp, which reads X transposed and D from
// the shared rows and adds its tile's sum (acc + small) to the block's
// partial in shared memory.  dW_d0 and d delta take the same routines
// with delta padded to 16 columns and W_d0 to 8 rows; the forward's first
// layer (delta -> r1) and the softmax stay scalar.  The weight gradients
// cannot be carried across blocks as the TPU's sequential grid carries
// them in constant-index output blocks: each block sums its tiles into
// its partial, every element owned by one thread in tile order, writes it
// to a [blocks, P] buffer, and a second kernel sums the blocks in order,
// so a run gives the same bits as the last on the same card.
//
// The wide instantiation (attention_bwd_wide_kernel, d in 72..128 a
// multiple of 8: ISAPCInet's published width variants, 96 and 128).  The
// tile above takes 400 KB of shared memory at d = 96 and 627 KB at d = 128,
// every large term quadratic in d (the fp32 W^T copies, the dW partial), so
// only the tile's five [64, d] activation buffers stay in shared memory
// (169 KB at d = 128) and the rest moves out:
//   - the d x d products read their B operands from wbuf's W^T in device
//     memory (L2-resident, 197 KB at d = 128) through the same fragment
//     strides (tile_mma_wide, k-steps up to 16), each lane four k-steps
//     ahead of its mma, split in the kernel;
//   - the block's weight-gradient partial is its row of `partial` in device
//     memory, each element owned by one thread every tile as above, so the
//     sums run in tile order and the block-ordered reduce gives the same
//     bits run after run (tile_wgrad_mma_wide loads a block's partial
//     before its products);
//   - q and K | V are read from device memory where they are used (h, the
//     softmax), each once a tile.
#include "mma_tf32.cuh"

#define PCI_ABWD_ROWS 64
#define PCI_ABWD_RT 4
#define PCI_ABWD_THREADS 512
#define PCI_ABWD_KT 8  // k-steps of the widest layer (d = 64), unrolled
#define PCI_ABWD_STAMPS 5  // a block's ns loading its tiles, in the forward's
                           // layers, in the softmax and gradient sums, in the
                           // input gradients' products, in the weight
                           // gradients; then its tiles

// Y[r][o] = act(bias[o] + sum_i X[r][i] W[i][o]) for r < R, scalar: X
// [*][ldx], W [din][dout] (device memory), Y [*][ldy]; rows are read in
// groups of RT (the buffers hold whole groups), rows >= R are not stored.
__device__ void tile_dense(const float* X, int ldx, const float* __restrict__ W,
                           const float* __restrict__ bias, float* Y, int ldy, int R,
                           int din, int dout, bool relu) {
  const int groups = (R + PCI_ABWD_RT - 1) / PCI_ABWD_RT;
  for (int w = threadIdx.x; w < dout * groups; w += blockDim.x) {
    const int o = w % dout, r0 = (w / dout) * PCI_ABWD_RT;
    float acc[PCI_ABWD_RT];
#pragma unroll
    for (int rr = 0; rr < PCI_ABWD_RT; ++rr) acc[rr] = bias[o];
    for (int i = 0; i < din; ++i) {
      const float wv = W[i * dout + o];
#pragma unroll
      for (int rr = 0; rr < PCI_ABWD_RT; ++rr)
        acc[rr] = fmaf(X[(r0 + rr) * ldx + i], wv, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < PCI_ABWD_RT; ++rr)
      if (r0 + rr < R) Y[(r0 + rr) * ldy + o] = relu ? fmaxf(acc[rr], 0.f) : acc[rr];
  }
}

// gb[o] += sum over the tile's 64 rows of D[r][o] (rows past the tile's
// are zero): 8 lanes a channel, each summing 8 rows in order, then a fixed
// tree over the 8 lanes; the first adds to gb (one owner a channel).
__device__ void tile_bgrad(const float* D, int ld, int dout, float* gb) {
  for (int w = threadIdx.x; w < 8 * round_up(dout, 4); w += blockDim.x) {
    const int o = w >> 3, p = w & 7;  // a warp: 4 channels x 8 parts
    float s = 0.f;
    if (o < dout)
#pragma unroll
      for (int r = 0; r < 8; ++r) s += D[(8 * p + r) * ld + o];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (p == 0 && o < dout) gb[o] += s;
  }
}

// Y[r][c] = act((sum_i X[r][i] B[i][c]) + bias[c]) on the tensor cores
// for the tile's 64 rows, B = Wt (a layer's W^T, [in][out]) or, with
// trans, B = Wt^T = W (dx = dy W): X, Y and Wt [*][ld] in shared memory
// (ld % 8 == 4; X's columns and Wt's rows and columns past d zero up to
// KT and NT 8-column steps), bias [bd] in device memory, or null.  Both
// operands are split here (3xTF32).  A warp takes a 16-row tile and two
// n-tiles.  Rows < R are stored; where mask is given (it may be Y), Y is
// kept only where mask > 0 (the ReLU's derivative).
__device__ void tile_mma(const float* X, const float* Wt, bool trans,
                         const float* __restrict__ bias, int bd, float* Y, int ld, int R,
                         int KT, int NT, bool relu, const float* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5, pairs = (NT + 1) / 2;
  // B[k][n] at Wt[k * ks + n * ns]
  const int ks = trans ? 1 : ld, ns = trans ? ld : 1;
  for (int it = warp; it < 4 * pairs; it += nwarps) {
    const int mt = it & 3, n0 = 2 * (it >> 2);
    const bool two = n0 + 1 < NT;
    float acc[2][4], small[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < PCI_ABWD_KT; ++kt) {
      if (kt >= KT) break;
      uint32_t ahi[4], alo[4];
      load_a_split(X, ld, 16 * mt, 8 * kt, ahi, alo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
        const float* bp = Wt + (8 * kt + t) * ks + (8 * (n0 + j) + g) * ns;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(bp[0], bh0, bl0);
        tf32_split(bp[4 * ks], bh1, bl1);
        mma_3xtf32_apart(acc[j], small[j], ahi, alo,
                         make_float4(__uint_as_float(bh0), __uint_as_float(bh1),
                                     __uint_as_float(bl0), __uint_as_float(bl1)));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !two) break;
      const int c = 8 * (n0 + j) + 2 * t;
      const float b0 = bias && c < bd ? __ldg(bias + c) : 0.f;
      const float b1 = bias && c + 1 < bd ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        if (r >= R) continue;
        float v0 = (acc[j][2 * h] + small[j][2 * h]) + b0;
        float v1 = (acc[j][2 * h + 1] + small[j][2 * h + 1]) + b1;
        if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        if (mask) {
          const float2 m = *reinterpret_cast<const float2*>(mask + r * ld + c);
          v0 = m.x > 0.f ? v0 : 0.f;
          v1 = m.y > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<float2*>(Y + r * ld + c) = make_float2(v0, v1);
      }
    }
  }
}

// G[i][o] += sum over the tile's 64 rows of X[r][i] D[r][o] for i < din,
// o < dout (G row-major [din][dout]) on the tensor cores in 3xTF32: A =
// X^T and B = D read from the shared rows ([64][ld], zero past the tile's
// rows and up to 16-column and 8-column multiples) and split here, the 8
// row steps unrolled; each (16 x 8) block of G belongs to one warp, the
// same every tile, which adds its tile's (acc + small), so G's sums run in
// tile order.  (Two blocks a warp sharing their B fragments ran slower on
// the H100.)
__device__ void tile_wgrad_mma(const float* X, const float* D, int ld, int din, int dout,
                               float* G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5, MT = (din + 15) / 16, NT = (dout + 7) / 8;
  for (int f = warp; f < MT * NT; f += nwarps) {
    const int mi = f / NT, nt = f % NT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kr = 0; kr < PCI_ABWD_ROWS / 8; ++kr) {
      const float* x = X + (8 * kr + t) * ld + 16 * mi + g;
      const float* dp = D + (8 * kr + t) * ld + 8 * nt + g;
      uint32_t ahi[4], alo[4], bh0, bl0, bh1, bl1;
      tf32_split(x[0], ahi[0], alo[0]);
      tf32_split(x[8], ahi[1], alo[1]);
      tf32_split(x[4 * ld], ahi[2], alo[2]);
      tf32_split(x[4 * ld + 8], ahi[3], alo[3]);
      tf32_split(dp[0], bh0, bl0);
      tf32_split(dp[4 * ld], bh1, bl1);
      mma_3xtf32_apart(acc, small, ahi, alo,
                       make_float4(__uint_as_float(bh0), __uint_as_float(bh1),
                                   __uint_as_float(bl0), __uint_as_float(bl1)));
    }
    const int o = 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mi + g + 8 * h;
      if (i >= din) continue;
      if (o < dout) G[i * dout + o] += acc[2 * h] + small[2 * h];
      if (o + 1 < dout) G[i * dout + o + 1] += acc[2 * h + 1] + small[2 * h + 1];
    }
  }
}

__global__ void __launch_bounds__(PCI_ABWD_THREADS, 1)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ g,
                     const float* __restrict__ delta, const float* __restrict__ wbuf,
                     const float* __restrict__ gout, float* __restrict__ dq,
                     float* __restrict__ dg, float* __restrict__ ddelta,
                     float* __restrict__ partial, unsigned long long* __restrict__ stamps,
                     int M, int d, int k, int QT) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nw = attn_weight_floats(d), nw4 = round_up(nw, 4);
  const int R = QT * k, Rp = round_up(R, PCI_ABWD_RT);
  const int ld = round_up(d, 16) + 4, tile = PCI_ABWD_ROWS * ld;
  const int d8 = round_up(d, 8), KT = d8 / 8;
  float* G = sm;            // this block's gradient partial, wbuf's layout
  float* A1 = G + nw4;      // r1, then dpre1
  float* A2 = A1 + tile;    // pos, then da, dh, dpos
  float* A3 = A2 + tile;    // h
  float* A4 = A3 + tile;    // r2, then dpre2
  float* A5 = A4 + tile;    // a, then the softmax s
  float* KV = A5 + tile;    // [64][2d] the tile's K | V rows
  float* WS = KV + PCI_ABWD_ROWS * 2 * d;  // W_d1^T, W_g0^T, W_g1^T, [d8][ld] each
  float* WD0 = WS + 3 * d8 * ld;  // W_d0^T [8][ld] (rows 3..7 zero)
  float* DL = WD0 + 8 * ld;       // [Rp][3] delta
  // offsets of each weight and bias in wbuf and G
  const int oWd0 = 0, obd0 = 3 * d, oWd1 = obd0 + d, obd1 = oWd1 + d * d,
            oWg0 = obd1 + d, obg0 = oWg0 + d * d, oWg1 = obg0 + d,
            obg1 = oWg1 + d * d;
  float* Wd1 = WS;
  float* Wg0 = WS + d8 * ld;
  float* Wg1 = WS + 2 * d8 * ld;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) G[e] = 0.f;
  for (int e = threadIdx.x; e < 5 * tile; e += blockDim.x) A1[e] = 0.f;
  for (int e = threadIdx.x; e < 3 * d8 * ld; e += blockDim.x) {
    const int l = e / (d8 * ld), i = (e / ld) % d8, o = e % ld;
    const int off = (l == 0 ? oWd1 : l == 1 ? oWg0 : oWg1) + i * d + o;
    WS[e] = i < d && o < d ? wbuf[off] : 0.f;
  }
  for (int e = threadIdx.x; e < 8 * ld; e += blockDim.x)
    WD0[e] = e / ld < 3 && e % ld < d ? wbuf[oWd0 + (e / ld) * d + e % ld] : 0.f;
  for (int e = threadIdx.x; e < Rp * 3; e += blockDim.x) DL[e] = 0.f;
  const bool timed = stamps != nullptr && threadIdx.x == 0;
  unsigned long long tacc[PCI_ABWD_STAMPS] = {0, 0, 0, 0, 0}, tprev = timed ? global_ns() : 0;
  auto mark = [&](int i) {
    if (timed) {
      const unsigned long long now = global_ns();
      tacc[i] += now - tprev;
      tprev = now;
    }
  };
  const float inv_sqrt_d = 1.f / sqrtf((float)d);
  const int two_d = 2 * d;
  const int tiles = (M + QT - 1) / QT;
  int done = 0;
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x, ++done) {
    const int q0 = tl * QT;
    const size_t row0 = (size_t)q0 * k;  // first (query, slot) row
    __syncthreads();  // the previous tile's readers are done
    mark(4);
    {  // the tile's K | V rows by cp.async, in flight through the first layers
      const int nv = min(R, (M - q0) * k) * two_d;  // the real queries' rows
      const float* src = g + row0 * two_d;
      if ((d & 1) == 0) {
        for (int e = 4 * threadIdx.x; e < nv; e += 4 * blockDim.x) cp_async16(KV + e, src + e);
      } else {
        for (int e = threadIdx.x; e < nv; e += blockDim.x) cp_async4(KV + e, src + e);
      }
      cp_async_commit();
      for (int e = nv + threadIdx.x; e < R * two_d; e += blockDim.x) KV[e] = 0.f;
    }
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x)
      DL[e] = q0 + e / 3 / k < M ? delta[row0 * 3 + e] : 0.f;
    __syncthreads();
    mark(0);
    // forward recompute
    tile_dense(DL, 3, wbuf + oWd0, wbuf + obd0, A1, ld, R, 3, d, true);
    __syncthreads();
    tile_mma(A1, Wd1, false, wbuf + obd1, d, A2, ld, R, KT, KT, false, nullptr);
    cp_async_wait_all();
    __syncthreads();  // pos and every thread's K | V copies are in
    mark(1);
    for (int e = threadIdx.x; e < R * d; e += blockDim.x) {
      const int r = e / d, c = e % d;
      const float qv = q0 + r / k < M ? q[(size_t)(q0 + r / k) * d + c] : 0.f;
      A3[r * ld + c] = (qv - KV[r * two_d + c]) + A2[r * ld + c];
    }
    __syncthreads();
    mark(2);
    tile_mma(A3, Wg0, false, wbuf + obg0, d, A4, ld, R, KT, KT, true, nullptr);
    __syncthreads();
    tile_mma(A4, Wg1, false, wbuf + obg1, d, A5, ld, R, KT, KT, false, nullptr);
    __syncthreads();
    mark(1);
    // softmax over the slots per (query, channel); ds = (V + pos) * gout,
    // da = s (ds - sum_k s ds) / sqrt(d); d V = s * gout.  Two neighbouring
    // lanes a (query, channel), each over half the slots, their max and
    // sums joined by one shuffle (every lane runs every round).
    for (int w0 = 0; w0 < 2 * QT * d; w0 += blockDim.x) {
      const int e = (w0 + threadIdx.x) >> 1, half = threadIdx.x & 1;
      const bool act = e < QT * d;
      const int qi = act ? e / d : 0, c = e - qi * d;
      const bool valid = act && q0 + qi < M;
      const int rb = qi * k, s0 = half ? (k + 1) / 2 : 0, s1 = act ? (half ? k : (k + 1) / 2) : 0;
      float mx = -CUDART_INF_F;
      for (int s = s0; s < s1; ++s) mx = fmaxf(mx, A5[(rb + s) * ld + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float den = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float ex = expf((A5[x] - mx) * inv_sqrt_d);
        A5[x] = ex;
        den += ex;
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      const float go = valid ? gout[(size_t)q0 * d + e] : 0.f, rden = 1.f / den;
      float sds = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float sv = A5[x] * rden;
        const float vf = KV[(rb + s) * two_d + d + c];
        const float ds = (vf + A2[x]) * go;
        A5[x] = sv;
        A2[x] = ds;
        sds += sv * ds;
        if (valid) dg[(row0 + rb + s) * two_d + d + c] = sv * go;
      }
      sds += __shfl_xor_sync(0xffffffffu, sds, 1);
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        A2[x] = A5[x] * (A2[x] - sds) * inv_sqrt_d;
      }
    }
    __syncthreads();
    mark(2);
    // gamma MLP
    tile_wgrad_mma(A4, A2, ld, d, d, G + oWg1);
    tile_bgrad(A2, ld, d, G + obg1);
    __syncthreads();
    mark(4);
    tile_mma(A2, Wg1, true, nullptr, 0, A4, ld, R, KT, KT, false, A4);  // dpre2
    __syncthreads();
    mark(3);
    tile_wgrad_mma(A3, A4, ld, d, d, G + oWg0);
    tile_bgrad(A4, ld, d, G + obg0);
    __syncthreads();
    mark(4);
    tile_mma(A4, Wg0, true, nullptr, 0, A2, ld, R, KT, KT, false, nullptr);  // dh
    __syncthreads();
    mark(3);
    // dq = sum_k dh, dK = -dh, dpos = dh + s * gout (two lanes a (query,
    // channel), as above)
    for (int w0 = 0; w0 < 2 * QT * d; w0 += blockDim.x) {
      const int e = (w0 + threadIdx.x) >> 1, half = threadIdx.x & 1;
      const bool act = e < QT * d;
      const int qi = act ? e / d : 0, c = e - qi * d;
      const bool valid = act && q0 + qi < M;
      const int rb = qi * k, s0 = half ? (k + 1) / 2 : 0, s1 = act ? (half ? k : (k + 1) / 2) : 0;
      const float go = valid ? gout[(size_t)q0 * d + e] : 0.f;
      float acc = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float dh = A2[x];
        acc += dh;
        if (valid) dg[(row0 + rb + s) * two_d + c] = -dh;
        A2[x] = dh + A5[x] * go;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (valid && half == 0) dq[(size_t)q0 * d + e] = acc;
    }
    __syncthreads();
    mark(2);
    // pos MLP
    tile_wgrad_mma(A1, A2, ld, d, d, G + oWd1);
    tile_bgrad(A2, ld, d, G + obd1);
    __syncthreads();
    mark(4);
    tile_mma(A2, Wd1, true, nullptr, 0, A1, ld, R, KT, KT, false, A1);  // dpre1
    __syncthreads();
    mark(3);
    // the 3-wide layer on the tensor cores too: delta into A5 (the softmax
    // s, done with) as 16 zero-padded columns, dW_d0 += delta^T dpre1 and
    // d delta = dpre1 W_d0 (one n-tile, into A3: h, done with)
    for (int e = threadIdx.x; e < PCI_ABWD_ROWS * 16; e += blockDim.x) {
      const int r = e >> 4, c = e & 15;
      A5[r * ld + c] = c < 3 && r < R ? DL[r * 3 + c] : 0.f;
    }
    __syncthreads();
    tile_wgrad_mma(A5, A1, ld, 3, d, G + oWd0);
    tile_bgrad(A1, ld, d, G + obd0);
    tile_mma(A1, WD0, true, nullptr, 0, A3, ld, R, KT, 1, false, nullptr);
    __syncthreads();
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x) {
      const int r = e / 3;
      if (q0 + r / k < M) ddelta[row0 * 3 + e] = A3[r * ld + e % 3];
    }
  }
  __syncthreads();
  mark(4);
  for (int e = threadIdx.x; e < nw; e += blockDim.x)
    partial[(size_t)blockIdx.x * nw + e] = G[e];
  if (timed) {
    unsigned long long* st = stamps + (size_t)blockIdx.x * (PCI_ABWD_STAMPS + 1);
    for (int i = 0; i < PCI_ABWD_STAMPS; ++i) st[i] = tacc[i];
    st[PCI_ABWD_STAMPS] = done;
  }
}

#define ABW_PF 4  // k-steps of B fragments a lane has in flight (tile_mma_wide)

// tile_mma for d up to 128 (KT <= 16), with B = Wt (a layer's W^T,
// [in][out]) or, with trans, B = Wt^T at a row stride lw of its own: wbuf's
// layers in device memory (lw = d) or W_d0^T in shared memory (lw = ld).
// Each lane loads its B fragments ABW_PF k-steps ahead of their mma (from
// L2, a k-step's load waited on at once left the warps idle).
__device__ void tile_mma_wide(const float* X, const float* Wt, int lw, bool trans,
                              const float* __restrict__ bias, int bd, float* Y, int ld, int R,
                              int KT, int NT, bool relu, const float* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5, pairs = (NT + 1) / 2;
  const int ks = trans ? 1 : lw, ns = trans ? lw : 1;  // B[k][n] at Wt[k * ks + n * ns]
  for (int it = warp; it < 4 * pairs; it += nwarps) {
    const int mt = it & 3, n0 = 2 * (it >> 2);
    const bool two = n0 + 1 < NT;
    float acc[2][4], small[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
    float bq[ABW_PF][2][2];  // the fragments of k-steps kt .. kt + ABW_PF - 1
    auto fetch = [&](int kt, float (&b)[2][2]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][0] = b[j][1] = 0.f;
        if (kt < KT && (j == 0 || two)) {
          const float* bp = Wt + (8 * kt + t) * ks + (8 * (n0 + j) + g) * ns;
          b[j][0] = bp[0];
          b[j][1] = bp[4 * ks];
        }
      }
    };
#pragma unroll
    for (int kt = 0; kt < ABW_PF; ++kt) fetch(kt, bq[kt]);
#pragma unroll
    for (int kt = 0; kt < 16; ++kt) {
      if (kt >= KT) break;
      float b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j][0] = bq[kt % ABW_PF][j][0], b[j][1] = bq[kt % ABW_PF][j][1];
      fetch(kt + ABW_PF, bq[kt % ABW_PF]);
      uint32_t ahi[4], alo[4];
      load_a_split(X, ld, 16 * mt, 8 * kt, ahi, alo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(b[j][0], bh0, bl0);
        tf32_split(b[j][1], bh1, bl1);
        mma_3xtf32_apart(acc[j], small[j], ahi, alo,
                         make_float4(__uint_as_float(bh0), __uint_as_float(bh1),
                                     __uint_as_float(bl0), __uint_as_float(bl1)));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !two) break;
      const int c = 8 * (n0 + j) + 2 * t;
      const float b0 = bias && c < bd ? __ldg(bias + c) : 0.f;
      const float b1 = bias && c + 1 < bd ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        if (r >= R) continue;
        float v0 = (acc[j][2 * h] + small[j][2 * h]) + b0;
        float v1 = (acc[j][2 * h + 1] + small[j][2 * h + 1]) + b1;
        if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        if (mask) {
          const float2 m = *reinterpret_cast<const float2*>(mask + r * ld + c);
          v0 = m.x > 0.f ? v0 : 0.f;
          v1 = m.y > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<float2*>(Y + r * ld + c) = make_float2(v0, v1);
      }
    }
  }
}

// tile_wgrad_mma with G in device memory (the wide kernel's partial): each
// (16 x 8) block's partial is loaded before its products, so the load's
// latency runs under them, and stored as G + (acc + small), the same sum
// in the same order, by the same owner every tile.
__device__ void tile_wgrad_mma_wide(const float* X, const float* D, int ld, int din, int dout,
                                    float* __restrict__ G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5, MT = (din + 15) / 16, NT = (dout + 7) / 8;
  for (int f = warp; f < MT * NT; f += nwarps) {
    const int mi = f / NT, nt = f % NT, o = 8 * nt + 2 * t;
    float gp[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mi + g + 8 * h;
      gp[h][0] = i < din && o < dout ? G[i * dout + o] : 0.f;
      gp[h][1] = i < din && o + 1 < dout ? G[i * dout + o + 1] : 0.f;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kr = 0; kr < PCI_ABWD_ROWS / 8; ++kr) {
      const float* x = X + (8 * kr + t) * ld + 16 * mi + g;
      const float* dp = D + (8 * kr + t) * ld + 8 * nt + g;
      uint32_t ahi[4], alo[4], bh0, bl0, bh1, bl1;
      tf32_split(x[0], ahi[0], alo[0]);
      tf32_split(x[8], ahi[1], alo[1]);
      tf32_split(x[4 * ld], ahi[2], alo[2]);
      tf32_split(x[4 * ld + 8], ahi[3], alo[3]);
      tf32_split(dp[0], bh0, bl0);
      tf32_split(dp[4 * ld], bh1, bl1);
      mma_3xtf32_apart(acc, small, ahi, alo,
                       make_float4(__uint_as_float(bh0), __uint_as_float(bh1),
                                   __uint_as_float(bl0), __uint_as_float(bl1)));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mi + g + 8 * h;
      if (i >= din) continue;
      if (o < dout) G[i * dout + o] = gp[h][0] + (acc[2 * h] + small[2 * h]);
      if (o + 1 < dout) G[i * dout + o + 1] = gp[h][1] + (acc[2 * h + 1] + small[2 * h + 1]);
    }
  }
}

// attention_bwd_kernel's walk at d in 72..128 (a multiple of 8), its
// weights read from wbuf in device memory and its partial G kept in
// partial's row of the block (the header).
__global__ void __launch_bounds__(PCI_ABWD_THREADS, 1)
attention_bwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ g,
                          const float* __restrict__ delta, const float* __restrict__ wbuf,
                          const float* __restrict__ gout, float* __restrict__ dq,
                          float* __restrict__ dg, float* __restrict__ ddelta,
                          float* __restrict__ partial, unsigned long long* __restrict__ stamps,
                          int M, int d, int k, int QT) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nw = attn_weight_floats(d);
  const int R = QT * k, Rp = round_up(R, PCI_ABWD_RT);
  const int ld = round_up(d, 16) + 4, tile = PCI_ABWD_ROWS * ld;
  const int KT = d / 8;
  float* G = partial + (size_t)blockIdx.x * nw;  // this block's partial, wbuf's layout
  float* A1 = sm;           // r1, then dpre1
  float* A2 = A1 + tile;    // pos, then da, dh, dpos
  float* A3 = A2 + tile;    // h
  float* A4 = A3 + tile;    // r2, then dpre2
  float* A5 = A4 + tile;    // a, then the softmax s
  float* WD0 = A5 + tile;   // W_d0^T [8][ld] (rows 3..7 zero)
  float* DL = WD0 + 8 * ld;  // [Rp][3] delta
  const int oWd0 = 0, obd0 = 3 * d, oWd1 = obd0 + d, obd1 = oWd1 + d * d,
            oWg0 = obd1 + d, obg0 = oWg0 + d * d, oWg1 = obg0 + d,
            obg1 = oWg1 + d * d;
  const float* Wd1 = wbuf + oWd1;
  const float* Wg0 = wbuf + oWg0;
  const float* Wg1 = wbuf + oWg1;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) G[e] = 0.f;
  for (int e = threadIdx.x; e < 5 * tile; e += blockDim.x) A1[e] = 0.f;
  for (int e = threadIdx.x; e < 8 * ld; e += blockDim.x)
    WD0[e] = e / ld < 3 && e % ld < d ? wbuf[oWd0 + (e / ld) * d + e % ld] : 0.f;
  for (int e = threadIdx.x; e < Rp * 3; e += blockDim.x) DL[e] = 0.f;
  const bool timed = stamps != nullptr && threadIdx.x == 0;
  unsigned long long tacc[PCI_ABWD_STAMPS] = {0, 0, 0, 0, 0}, tprev = timed ? global_ns() : 0;
  auto mark = [&](int i) {
    if (timed) {
      const unsigned long long now = global_ns();
      tacc[i] += now - tprev;
      tprev = now;
    }
  };
  const float inv_sqrt_d = 1.f / sqrtf((float)d);
  const int two_d = 2 * d;
  const int tiles = (M + QT - 1) / QT;
  int done = 0;
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x, ++done) {
    const int q0 = tl * QT;
    const size_t row0 = (size_t)q0 * k;  // first (query, slot) row
    __syncthreads();  // the previous tile's readers are done
    mark(4);
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x)
      DL[e] = q0 + e / 3 / k < M ? delta[row0 * 3 + e] : 0.f;
    __syncthreads();
    mark(0);
    // forward recompute
    tile_dense(DL, 3, wbuf + oWd0, wbuf + obd0, A1, ld, R, 3, d, true);
    __syncthreads();
    tile_mma_wide(A1, Wd1, d, false, wbuf + obd1, d, A2, ld, R, KT, KT, false, nullptr);
    __syncthreads();
    mark(1);
#pragma unroll 4
    for (int e = threadIdx.x; e < R * d; e += blockDim.x) {
      const int r = e / d, c = e % d;
      const bool real = q0 + r / k < M;
      const float qv = real ? q[(size_t)(q0 + r / k) * d + c] : 0.f;
      const float kf = real ? g[(row0 + r) * two_d + c] : 0.f;
      A3[r * ld + c] = (qv - kf) + A2[r * ld + c];
    }
    __syncthreads();
    mark(2);
    tile_mma_wide(A3, Wg0, d, false, wbuf + obg0, d, A4, ld, R, KT, KT, true, nullptr);
    __syncthreads();
    tile_mma_wide(A4, Wg1, d, false, wbuf + obg1, d, A5, ld, R, KT, KT, false, nullptr);
    __syncthreads();
    mark(1);
    // the softmax and da, d V = s * gout: attention_bwd_kernel's two lanes
    // a (query, channel), V read from device memory
    for (int w0 = 0; w0 < 2 * QT * d; w0 += blockDim.x) {
      const int e = (w0 + threadIdx.x) >> 1, half = threadIdx.x & 1;
      const bool act = e < QT * d;
      const int qi = act ? e / d : 0, c = e - qi * d;
      const bool valid = act && q0 + qi < M;
      const int rb = qi * k, s0 = half ? (k + 1) / 2 : 0, s1 = act ? (half ? k : (k + 1) / 2) : 0;
      float mx = -CUDART_INF_F;
      for (int s = s0; s < s1; ++s) mx = fmaxf(mx, A5[(rb + s) * ld + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float den = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float ex = expf((A5[x] - mx) * inv_sqrt_d);
        A5[x] = ex;
        den += ex;
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      const float go = valid ? gout[(size_t)q0 * d + e] : 0.f, rden = 1.f / den;
      float sds = 0.f;
#pragma unroll 4
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float sv = A5[x] * rden;
        const float vf = valid ? g[(row0 + rb + s) * two_d + d + c] : 0.f;
        const float ds = (vf + A2[x]) * go;
        A5[x] = sv;
        A2[x] = ds;
        sds += sv * ds;
        if (valid) dg[(row0 + rb + s) * two_d + d + c] = sv * go;
      }
      sds += __shfl_xor_sync(0xffffffffu, sds, 1);
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        A2[x] = A5[x] * (A2[x] - sds) * inv_sqrt_d;
      }
    }
    __syncthreads();
    mark(2);
    // gamma MLP
    tile_wgrad_mma_wide(A4, A2, ld, d, d, G + oWg1);
    tile_bgrad(A2, ld, d, G + obg1);
    __syncthreads();
    mark(4);
    tile_mma_wide(A2, Wg1, d, true, nullptr, 0, A4, ld, R, KT, KT, false, A4);  // dpre2
    __syncthreads();
    mark(3);
    tile_wgrad_mma_wide(A3, A4, ld, d, d, G + oWg0);
    tile_bgrad(A4, ld, d, G + obg0);
    __syncthreads();
    mark(4);
    tile_mma_wide(A4, Wg0, d, true, nullptr, 0, A2, ld, R, KT, KT, false, nullptr);  // dh
    __syncthreads();
    mark(3);
    // dq = sum_k dh, dK = -dh, dpos = dh + s * gout
    for (int w0 = 0; w0 < 2 * QT * d; w0 += blockDim.x) {
      const int e = (w0 + threadIdx.x) >> 1, half = threadIdx.x & 1;
      const bool act = e < QT * d;
      const int qi = act ? e / d : 0, c = e - qi * d;
      const bool valid = act && q0 + qi < M;
      const int rb = qi * k, s0 = half ? (k + 1) / 2 : 0, s1 = act ? (half ? k : (k + 1) / 2) : 0;
      const float go = valid ? gout[(size_t)q0 * d + e] : 0.f;
      float acc = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int x = (rb + s) * ld + c;
        const float dh = A2[x];
        acc += dh;
        if (valid) dg[(row0 + rb + s) * two_d + c] = -dh;
        A2[x] = dh + A5[x] * go;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (valid && half == 0) dq[(size_t)q0 * d + e] = acc;
    }
    __syncthreads();
    mark(2);
    // pos MLP
    tile_wgrad_mma_wide(A1, A2, ld, d, d, G + oWd1);
    tile_bgrad(A2, ld, d, G + obd1);
    __syncthreads();
    mark(4);
    tile_mma_wide(A2, Wd1, d, true, nullptr, 0, A1, ld, R, KT, KT, false, A1);  // dpre1
    __syncthreads();
    mark(3);
    // the 3-wide layer: delta into A5 as 16 zero-padded columns, dW_d0 +=
    // delta^T dpre1 and d delta = dpre1 W_d0 (one n-tile, into A3)
    for (int e = threadIdx.x; e < PCI_ABWD_ROWS * 16; e += blockDim.x) {
      const int r = e >> 4, c = e & 15;
      A5[r * ld + c] = c < 3 && r < R ? DL[r * 3 + c] : 0.f;
    }
    __syncthreads();
    tile_wgrad_mma_wide(A5, A1, ld, 3, d, G + oWd0);
    tile_bgrad(A1, ld, d, G + obd0);
    tile_mma_wide(A1, WD0, ld, true, nullptr, 0, A3, ld, R, KT, 1, false, nullptr);
    __syncthreads();
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x) {
      const int r = e / 3;
      if (q0 + r / k < M) ddelta[row0 * 3 + e] = A3[r * ld + e % 3];
    }
  }
  __syncthreads();
  mark(4);
  if (timed) {
    unsigned long long* st = stamps + (size_t)blockIdx.x * (PCI_ABWD_STAMPS + 1);
    for (int i = 0; i < PCI_ABWD_STAMPS; ++i) st[i] = tacc[i];
    st[PCI_ABWD_STAMPS] = done;
  }
}

// out[e] = sum over blocks of partial[block][e], blocks in order.
__global__ void attention_bwd_reduce(const float* __restrict__ partial,
                                     int blocks, int P, float* __restrict__ out) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < P;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * P + e];
    out[e] = s;
  }
}

static size_t abwd_smem(int d, int k) {
  const int QT = std::max(1, PCI_ABWD_ROWS / k);
  const int Rp = round_up(QT * k, PCI_ABWD_RT);
  const int ld = round_up(d, 16) + 4;
  return sizeof(float) * ((size_t)round_up(attn_weight_floats(d), 4) +
                          5 * (size_t)PCI_ABWD_ROWS * ld + (size_t)PCI_ABWD_ROWS * 2 * d +
                          (3 * (size_t)round_up(d, 8) + 8) * ld + Rp * 3);
}

static size_t abwd_wide_smem(int d, int k) {
  const int QT = std::max(1, PCI_ABWD_ROWS / k);
  const int Rp = round_up(QT * k, PCI_ABWD_RT);
  const int ld = round_up(d, 16) + 4;
  return sizeof(float) * ((5 * (size_t)PCI_ABWD_ROWS + 8) * ld + Rp * 3);
}

// q [M, d], g [M, k, 2d] (K | V), delta [M, k, 3], wbuf (common.cuh's
// attention layout), gout [M, d] -> dq [M, d], dg [M, k, 2d], ddelta
// [M, k, 3], and dw: the weight
// and bias gradients in wbuf's layout.  partial: scratch of at least
// max_blocks * attn_weight_floats(d) floats; stamps: null, or
// [max_blocks][PCI_ABWD_STAMPS + 1] uint64 (zeroed).  1 <= d <= 64, or d
// in 72..128 a multiple of 8 (the wide instantiation); 1 <= k <= 32.
extern "C" int pci_attention_bwd(const void* q, const void* g, const void* delta,
                                 const void* wbuf, const void* gout, void* dq, void* dg, void* ddelta,
                                 void* partial, void* dw, void* stamps, int M, int d, int k,
                                 int max_blocks, void* stream) {
  const bool wide = d > 64;
  if (d < 1 || d > 128 || (wide && d % 8) || k < 1 || k > 32 || M < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int QT = std::max(1, PCI_ABWD_ROWS / k);
  const int nw = attn_weight_floats(d);
  const size_t smem = wide ? abwd_wide_smem(d, k) : abwd_smem(d, k);
  cudaError_t e = wide ? allow_smem(attention_bwd_wide_kernel, smem)
                       : allow_smem(attention_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M + QT - 1) / QT;
  const int blocks = std::min(max_blocks, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  auto* kernel = wide ? attention_bwd_wide_kernel : attention_bwd_kernel;
  kernel<<<blocks, PCI_ABWD_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<const float*>(delta), static_cast<const float*>(wbuf),
      static_cast<const float*>(gout), static_cast<float*>(dq), static_cast<float*>(dg),
      static_cast<float*>(ddelta), part, static_cast<unsigned long long*>(stamps), M, d, k,
      QT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_bwd_reduce<<<(nw + 255) / 256, 256, 0, st>>>(part, blocks, nw,
                                                         static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

// The kernel's resources at d = 64, k = 16 (_build.kernel_attrs).
extern "C" int pci_attention_bwd_attrs(int* out) {
  return kernel_attrs(attention_bwd_kernel, abwd_smem(64, 16), out, PCI_ABWD_THREADS);
}

// The wide instantiation's resources at d = 128, k = 16 (_build.kernel_attrs).
extern "C" int pci_attention_bwd_wide_attrs(int* out) {
  return kernel_attrs(attention_bwd_wide_kernel, abwd_wide_smem(128, 16), out,
                      PCI_ABWD_THREADS);
}
