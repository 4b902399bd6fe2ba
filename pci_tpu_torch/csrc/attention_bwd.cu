// Point-transformer vector-attention tail, backward (training):
//   pos = W_d1 relu(W_d0 delta + b_d0) + b_d1
//   a   = W_g1 relu(W_g0 (q - K + pos) + b_g0) + b_g1
//   res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
// given d res, the gradients of q [M, d], g = [K | V] [M, k, 2d], delta
// [M, k, 3] and of the eight weights and biases, all in fp32.
//
// Replaces pci_tpu/ops/pallas_kernels/attention_tpu.py:_vat_bwd_rule, the
// backward pallas_call of vector_attention_trainable (_attn_bwd_kernel).
// Like it, this kernel keeps no forward intermediate: each tile recomputes
// its forward in shared memory, then walks the chain rule back.  The
// trainable forward is csrc/attention.cu's fp32 eval kernel.
//
// What bounds it on the H100: operations.  At the transformer's shapes
// (128,000 queries, k = 16, d = 64) the recomputed forward is 2 R (3d +
// 3d^2) flops over R = M k rows and the backward six more [R, d] x [d, d]
// products, ~1.5e11 flops, 2.3 ms at 67 TFLOP/s; the bytes (q, K|V, delta
// in, their gradients out: 0.6 GB) take 0.2 ms.  The design: a tile is
// 64 rows (64 / k queries times their k slots) whose activations live in
// five [64, d] shared buffers; every product runs from shared memory, one
// thread an output channel for 4 rows (transposed products rotate their
// summation start by the thread's channel, so a warp reads 32 banks).
// The weight gradients cannot be carried across blocks as the TPU's
// sequential grid carries them in constant-index output blocks: each block
// sums its tiles into a partial in shared memory (every element owned by
// one thread, in tile order), writes it to a [blocks, P] buffer, and a
// second kernel sums the blocks in order, so a run gives the same bits as
// the last on the same card.  One block an SM (the weights, the partial
// and the buffers take ~186 KB at d = 64) of 1,024 threads, which hide
// the shared-memory latency better than 256 (PERF.md).
#include "common.cuh"

#define PCI_ABWD_ROWS 64
#define PCI_ABWD_RT 4
#define PCI_ABWD_THREADS 1024

// Y[r][o] = act(bias[o] + sum_i X[r][i] W[i][o]) for r < R: X [*][ldx],
// W [din][dout], Y [*][ldy], all in shared memory; rows are read in groups
// of RT (the buffers hold whole groups), rows >= R are not stored.
__device__ void tile_dense(const float* X, int ldx, const float* W,
                           const float* bias, float* Y, int ldy, int R,
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

// Y[r][i] = sum_o X[r][o] W[i][o] (X times W transposed) for r < R and
// i < din <= dout; where mask is given (it may be Y itself), Y[r][i] is
// kept only where mask[r][i] > 0 (the ReLU's derivative).
__device__ void tile_dense_t(const float* X, int ldx, const float* W, int din,
                             int dout, float* Y, int ldy, int R,
                             const float* mask) {
  const int groups = (R + PCI_ABWD_RT - 1) / PCI_ABWD_RT;
  for (int w = threadIdx.x; w < din * groups; w += blockDim.x) {
    const int i = w % din, r0 = (w / din) * PCI_ABWD_RT;
    float acc[PCI_ABWD_RT];
#pragma unroll
    for (int rr = 0; rr < PCI_ABWD_RT; ++rr) acc[rr] = 0.f;
    for (int s = 0; s < dout; ++s) {
      int o = i + s;  // rotated start: neighbouring threads, other banks
      if (o >= dout) o -= dout;
      const float wv = W[i * dout + o];
#pragma unroll
      for (int rr = 0; rr < PCI_ABWD_RT; ++rr)
        acc[rr] = fmaf(X[(r0 + rr) * ldx + o], wv, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < PCI_ABWD_RT; ++rr) {
      const int r = r0 + rr;
      if (r < R) {
        const bool keep = mask == nullptr || mask[r * ldy + i] > 0.f;
        Y[r * ldy + i] = keep ? acc[rr] : 0.f;
      }
    }
  }
}

// G[i][o] += sum_{r < R} X[r][i] D[r][o] and gb[o] += sum_r D[r][o], rows
// summed in order; each element of G and gb has one owner thread.
__device__ void tile_wgrad(const float* X, int ldx, const float* D, int ldd,
                           int R, int din, int dout, float* G, float* gb) {
  const int igroups = (din + 3) / 4;
  for (int w = threadIdx.x; w < dout * igroups; w += blockDim.x) {
    const int o = w % dout, i0 = (w / dout) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < R; ++r) {
      const float dv = D[r * ldd + o];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        acc[ii] = fmaf(X[r * ldx + min(i0 + ii, din - 1)], dv, acc[ii]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      if (i0 + ii < din) G[(i0 + ii) * dout + o] += acc[ii];
  }
  for (int o = threadIdx.x; o < dout; o += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += D[r * ldd + o];
    gb[o] += s;
  }
}

__global__ void __launch_bounds__(PCI_ABWD_THREADS)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ g,
                     const float* __restrict__ delta,
                     const float* __restrict__ wbuf,
                     const float* __restrict__ gout, float* __restrict__ dq,
                     float* __restrict__ dg, float* __restrict__ ddelta,
                     float* __restrict__ partial, int M, int d, int k, int QT) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nw = attn_weight_floats(d), nw4 = round_up(nw, 4);
  const int R = QT * k, Rp = round_up(R, PCI_ABWD_RT);
  float* W = sm;          // the weights, attention.cu's layout
  float* G = W + nw4;     // this block's gradient partial, same layout
  float* A1 = G + nw4;    // r1, then dpre1
  float* A2 = A1 + Rp * d;  // pos, then ds, da, dh, dpos
  float* A3 = A2 + Rp * d;  // h
  float* A4 = A3 + Rp * d;  // r2, then dpre2
  float* A5 = A4 + Rp * d;  // a, then the softmax s
  float* QV = A5 + Rp * d;  // [QT][d] q
  float* GO = QV + QT * d;  // [QT][d] d res
  float* DL = GO + QT * d;  // [Rp][3] delta
  // offsets of each weight and bias in W and G
  const int oWd0 = 0, obd0 = 3 * d, oWd1 = obd0 + d, obd1 = oWd1 + d * d,
            oWg0 = obd1 + d, obg0 = oWg0 + d * d, oWg1 = obg0 + d,
            obg1 = oWg1 + d * d;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) {
    W[e] = wbuf[e];
    G[e] = 0.f;
  }
  const float inv_sqrt_d = 1.f / sqrtf((float)d);
  const int two_d = 2 * d;
  const int tiles = (M + QT - 1) / QT;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int q0 = tile * QT;
    const size_t row0 = (size_t)q0 * k;  // first (query, slot) row
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
      const int m = q0 + e / d;
      QV[e] = m < M ? q[(size_t)q0 * d + e] : 0.f;
      GO[e] = m < M ? gout[(size_t)q0 * d + e] : 0.f;
    }
    for (int e = threadIdx.x; e < Rp * 3; e += blockDim.x) {
      const int r = e / 3;
      DL[e] = r < R && q0 + r / k < M ? delta[row0 * 3 + e] : 0.f;
    }
    __syncthreads();
    // forward recompute
    tile_dense(DL, 3, W + oWd0, W + obd0, A1, d, R, 3, d, true);
    __syncthreads();
    tile_dense(A1, d, W + oWd1, W + obd1, A2, d, R, d, d, false);
    __syncthreads();
    for (int e = threadIdx.x; e < R * d; e += blockDim.x) {
      const int r = e / d, c = e % d;
      const float kf = q0 + r / k < M ? g[(row0 + r) * two_d + c] : 0.f;
      A3[e] = QV[(r / k) * d + c] - kf + A2[e];
    }
    __syncthreads();
    tile_dense(A3, d, W + oWg0, W + obg0, A4, d, R, d, d, true);
    __syncthreads();
    tile_dense(A4, d, W + oWg1, W + obg1, A5, d, R, d, d, false);
    __syncthreads();
    // softmax over the slots per (query, channel); ds = (V + pos) * gout,
    // da = s (ds - sum_k s ds) / sqrt(d); d V = s * gout
    for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
      const int qi = e / d, c = e % d;
      const bool valid = q0 + qi < M;
      const int rb = qi * k;
      float mx = -CUDART_INF_F;
      for (int s = 0; s < k; ++s) mx = fmaxf(mx, A5[(rb + s) * d + c]);
      float den = 0.f;
      for (int s = 0; s < k; ++s) den += expf((A5[(rb + s) * d + c] - mx) * inv_sqrt_d);
      const float go = GO[e];
      float sds = 0.f;
      for (int s = 0; s < k; ++s) {
        const int x = (rb + s) * d + c;
        const float sv = expf((A5[x] - mx) * inv_sqrt_d) / den;
        const float vf = valid ? g[(row0 + rb + s) * two_d + d + c] : 0.f;
        const float ds = (vf + A2[x]) * go;
        A5[x] = sv;
        A2[x] = ds;
        sds += sv * ds;
        if (valid) dg[(row0 + rb + s) * two_d + d + c] = sv * go;
      }
      for (int s = 0; s < k; ++s) {
        const int x = (rb + s) * d + c;
        A2[x] = A5[x] * (A2[x] - sds) * inv_sqrt_d;
      }
    }
    __syncthreads();
    // gamma MLP
    tile_wgrad(A4, d, A2, d, R, d, d, G + oWg1, G + obg1);
    __syncthreads();
    tile_dense_t(A2, d, W + oWg1, d, d, A4, d, R, A4);  // dpre2
    __syncthreads();
    tile_wgrad(A3, d, A4, d, R, d, d, G + oWg0, G + obg0);
    __syncthreads();
    tile_dense_t(A4, d, W + oWg0, d, d, A2, d, R, nullptr);  // dh
    __syncthreads();
    // dq = sum_k dh, dK = -dh, dpos = dh + s * gout
    for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
      const int qi = e / d, c = e % d;
      const bool valid = q0 + qi < M;
      const int rb = qi * k;
      float acc = 0.f;
      for (int s = 0; s < k; ++s) {
        const int x = (rb + s) * d + c;
        const float dh = A2[x];
        acc += dh;
        if (valid) dg[(row0 + rb + s) * two_d + c] = -dh;
        A2[x] = dh + A5[x] * GO[e];
      }
      if (valid) dq[(size_t)q0 * d + e] = acc;
    }
    __syncthreads();
    // pos MLP
    tile_wgrad(A1, d, A2, d, R, d, d, G + oWd1, G + obd1);
    __syncthreads();
    tile_dense_t(A2, d, W + oWd1, d, d, A1, d, R, A1);  // dpre1
    __syncthreads();
    tile_wgrad(DL, 3, A1, d, R, 3, d, G + oWd0, G + obd0);
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x) {
      const int r = e / 3, j = e % 3;
      float s = 0.f;
      for (int o = 0; o < d; ++o) s = fmaf(A1[r * d + o], W[oWd0 + j * d + o], s);
      if (q0 + r / k < M) ddelta[row0 * 3 + e] = s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nw; e += blockDim.x)
    partial[(size_t)blockIdx.x * nw + e] = G[e];
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

// q [M, d], g [M, k, 2d] (K | V), delta [M, k, 3], wbuf (attention.cu's
// layout), gout [M, d] -> dq [M, d], dg [M, k, 2d], ddelta [M, k, 3], and
// dw: the weight and bias gradients in wbuf's layout.  partial: scratch of
// at least max_blocks * attn_weight_floats(d) floats.  1 <= d <= 64,
// 1 <= k <= 32.
extern "C" int pci_attention_bwd(const void* q, const void* g,
                                 const void* delta, const void* wbuf,
                                 const void* gout, void* dq, void* dg,
                                 void* ddelta, void* partial, void* dw, int M,
                                 int d, int k, int max_blocks, void* stream) {
  if (d < 1 || d > 64 || k < 1 || k > 32 || M < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int QT = std::max(1, PCI_ABWD_ROWS / k);
  const int Rp = round_up(QT * k, PCI_ABWD_RT);
  const int nw = attn_weight_floats(d);
  const size_t smem = sizeof(float) * ((size_t)2 * round_up(nw, 4) + 5 * Rp * d +
                                       2 * QT * d + Rp * 3);
  cudaError_t e = allow_smem(attention_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M + QT - 1) / QT;
  const int blocks = std::min(max_blocks, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  attention_bwd_kernel<<<blocks, PCI_ABWD_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<const float*>(delta), static_cast<const float*>(wbuf),
      static_cast<const float*>(gout), static_cast<float*>(dq),
      static_cast<float*>(dg), static_cast<float*>(ddelta), part, M, d, k, QT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_bwd_reduce<<<(nw + 255) / 256, 256, 0, st>>>(part, blocks, nw,
                                                         static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
