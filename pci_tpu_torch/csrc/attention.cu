// Point-transformer vector-attention tail, eval:
//   pos = W_d1 relu(W_d0 delta + b_d0) + b_d1
//   a   = W_g1 relu(W_g0 (q - K + pos) + b_g0) + b_g1
//   res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
// with the softmax per (query, channel) over the k slots, at fp32 accuracy.
//
// Replaces pci_tpu/ops/pallas_kernels/attention_tpu.py:fused_vector_attention
// and the forward of its vector_attention_trainable (_attn_fwd_f32).  The
// TPU eval kernel casts q and the gathered K|V to bf16 (a TPU precision
// choice); this one reads everything in fp32, the function of the XLA
// expression (pci_tpu/nn/transformer.py:165-181).
//
// What bounds it on the H100: bytes, then the tensor cores.  At the
// transformer's shapes (65,536 queries, k = 16, d = 64) the four dense
// layers are 2 N k (3d + 3d^2) = 26.2 GFLOP, 3 x that in 3xTF32 on the
// tensor cores (0.16 ms at 495 TFLOP/s), against 0.58 GB of q, K|V, delta
// and the output (0.17 ms at 3.35 TB/s).  The XLA route writes each
// [N, k, d] intermediate (268 MB) to device memory; here none leaves the SM.
//
// The tensor-core route (attention_tc_kernel: d <= 64 a multiple of 8,
// k <= 16, the transformer's shapes):
//   - one warp a query: its k <= 16 slots are the 16 rows of one m16n8k8
//     tile (rows >= k are masked out of the softmax), so no block barrier;
//   - the four layers on the tensor cores in 3xTF32 (csrc/mma_tf32.cuh):
//     the weights split once on the host (_build.pack_tf32(chain=True), 103
//     KB at d = 64) sit in shared memory for the block's life; every
//     activation stays in registers as accumulator fragments, which are
//     the next layer's A fragments (the chained layout), the 3-wide first
//     layer one k-step of zero-padded delta;
//   - h = (q - K) + pos and V + pos are formed in the accumulator layout
//     from the query's K|V rows in the warp's shared buffer (a row stride
//     of 2d + 8 floats: the float2 reads of 16 lanes hit 32 banks);
//   - the softmax over k is a max and a sum over the fragment's rows: two
//     registers a lane, then __shfl_xor over the 8 lanes of a column group;
//   - each query's K|V (k x 2d floats, one contiguous block), q and delta
//     arrive by cp.async (16 bytes a lane; delta 4) into the warp's buffer;
//     the next query's copies are issued as soon as this one's K, V, q and
//     delta are in registers, so they stream while its gamma MLP runs;
//   - persistent blocks of 12 warps, one an SM (the weights and 12 buffers
//     take 209 KB at d = 64), each warp walking queries w, w + 12 * grid,
//     ...
// Each output's sum runs in mma_tf32.cuh's order (the large products per
// k-step, the small ones apart, then (acc + small) + bias), so a query's
// result does not depend on the batch or the launch.
//
// The wide tensor-core route (attention_wide_kernel: d in 72..128 a
// multiple of 8, k <= 16; ISAPCInet's published width variants, 96 and 128):
// the per-warp design does not fit there (its chained split pack alone is
// 224 KB at d = 96 and 394 KB at d = 128, and a warp's accumulator
// fragments double), so the work is block-wide:
//   - a tile is 64 (query, slot) rows, 64 / k whole queries;
//   - the four layers run over the tile's rows in shared memory (aw_dense:
//     3xTF32 in mma_tf32.cuh's summation order, the per-warp route's), a
//     warp taking two output n-tiles over all four m-tiles, the split
//     weights (_build.pack_tf32, unchained, 198 KB at d = 128) streamed
//     from device memory (L2) through each lane's 8-deep cp.async ring, so
//     no layer sits in shared memory;
//   - K, V and q are read as float4 from device memory where they are used
//     (h, the softmax), each once; the softmax and the weighted sum run
//     one thread a query and four channels;
//   - persistent blocks of 256 threads, one an SM: at d = 128 three
//     [64][d + 4] activation buffers (101 KB), the ring (64 KB) and delta
//     (3 KB) take 168 KB.
//
// The scalar route (attention_kernel, every other shape the wrapper takes:
// k in 17..32): the weights (d = 64: 50 KB) in shared
// memory; one warp a query, each lane owning the channels lane, lane + 32,
// ...; the k slots four at a time, their activations in a per-warp [d][4]
// shared buffer, so one weight load feeds four slots' FMAs; an online
// softmax folds each slot in as it is computed.
#include "mma_tf32.cuh"

#define PCI_ATTN_SLOTS 4

// acc[ci][s] += sum_i h[i][s] * W[i][c] for the lane's channels; h is a
// [d][4] slot-minor buffer, so h[i][0..3] is one float4 broadcast.
template <int CPL>
__device__ __forceinline__ void dense4(const float* W, const float* h, int d,
                                       int lane, float acc[CPL][PCI_ATTN_SLOTS]) {
  for (int i = 0; i < d; ++i) {
    const float4 hv = reinterpret_cast<const float4*>(h)[i];
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const float w = W[i * d + min(lane + 32 * ci, d - 1)];
      acc[ci][0] = fmaf(hv.x, w, acc[ci][0]);
      acc[ci][1] = fmaf(hv.y, w, acc[ci][1]);
      acc[ci][2] = fmaf(hv.z, w, acc[ci][2]);
      acc[ci][3] = fmaf(hv.w, w, acc[ci][3]);
    }
  }
}

template <int CPL>
__global__ void __launch_bounds__(256)
attention_kernel(const float* __restrict__ q, const float* __restrict__ g,
                 const float* __restrict__ delta,
                 const float* __restrict__ wbuf, float* __restrict__ out,
                 int M, int d, int k) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nw = attn_weight_floats(d);
  const float* Wd0 = smem;
  const float* bd0 = Wd0 + 3 * d;
  const float* Wd1 = bd0 + d;
  const float* bd1 = Wd1 + d * d;
  const float* Wg0 = bd1 + d;
  const float* bg0 = Wg0 + d * d;
  const float* Wg1 = bg0 + d;
  const float* bg1 = Wg1 + d * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* bufA = smem + round_up(nw, 4) + (size_t)warp * 8 * d;  // [d][4]
  float* bufB = bufA + 4 * d;                                   // [d][4]
  for (int e = threadIdx.x; e < nw; e += blockDim.x) smem[e] = wbuf[e];
  __syncthreads();

  const float inv_sqrt_d = 1.f / sqrtf((float)d);
  for (int r = blockIdx.x * nwarps + warp; r < M; r += gridDim.x * nwarps) {
    float qv[CPL], mx[CPL], den[CPL], num[CPL];
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int c = lane + 32 * ci;
      qv[ci] = c < d ? q[(size_t)r * d + c] : 0.f;
      mx[ci] = -CUDART_INF_F;
      den[ci] = 0.f;
      num[ci] = 0.f;
    }
    for (int s0 = 0; s0 < k; s0 += PCI_ATTN_SLOTS) {
      __syncwarp();  // the previous group's readers of bufA are done
      float dl[PCI_ATTN_SLOTS][3];
#pragma unroll
      for (int s = 0; s < PCI_ATTN_SLOTS; ++s) {
        const bool ok = s0 + s < k;
        const float* dp = delta + ((size_t)r * k + s0 + s) * 3;
        dl[s][0] = ok ? dp[0] : 0.f;
        dl[s][1] = ok ? dp[1] : 0.f;
        dl[s][2] = ok ? dp[2] : 0.f;
      }
      // pos layer 0 (3 -> d) into bufA
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = lane + 32 * ci;
        if (c < d) {
          float h[PCI_ATTN_SLOTS];
#pragma unroll
          for (int s = 0; s < PCI_ATTN_SLOTS; ++s) {
            h[s] = bd0[c];
            h[s] = fmaf(dl[s][0], Wd0[c], h[s]);
            h[s] = fmaf(dl[s][1], Wd0[d + c], h[s]);
            h[s] = fmaxf(fmaf(dl[s][2], Wd0[2 * d + c], h[s]), 0.f);
          }
          reinterpret_cast<float4*>(bufA)[c] = make_float4(h[0], h[1], h[2], h[3]);
        }
      }
      __syncwarp();
      // pos layer 1 (d -> d), kept in registers
      float pos[CPL][PCI_ATTN_SLOTS];
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const float bb = bd1[min(lane + 32 * ci, d - 1)];
#pragma unroll
        for (int s = 0; s < PCI_ATTN_SLOTS; ++s) pos[ci][s] = bb;
      }
      dense4<CPL>(Wd1, bufA, d, lane, pos);
      // gamma input q - K + pos into bufB
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = lane + 32 * ci;
        if (c < d) {
          float h[PCI_ATTN_SLOTS];
#pragma unroll
          for (int s = 0; s < PCI_ATTN_SLOTS; ++s) {
            const bool ok = s0 + s < k;
            const float kf = ok ? g[((size_t)r * k + s0 + s) * 2 * d + c] : 0.f;
            h[s] = qv[ci] - kf + pos[ci][s];
          }
          reinterpret_cast<float4*>(bufB)[c] = make_float4(h[0], h[1], h[2], h[3]);
        }
      }
      __syncwarp();
      // gamma layer 0 (d -> d) + relu into bufA
      float a[CPL][PCI_ATTN_SLOTS];
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const float bb = bg0[min(lane + 32 * ci, d - 1)];
#pragma unroll
        for (int s = 0; s < PCI_ATTN_SLOTS; ++s) a[ci][s] = bb;
      }
      dense4<CPL>(Wg0, bufB, d, lane, a);
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = lane + 32 * ci;
        if (c < d)
          reinterpret_cast<float4*>(bufA)[c] =
              make_float4(fmaxf(a[ci][0], 0.f), fmaxf(a[ci][1], 0.f),
                          fmaxf(a[ci][2], 0.f), fmaxf(a[ci][3], 0.f));
      }
      __syncwarp();
      // gamma layer 1 (d -> d)
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const float bb = bg1[min(lane + 32 * ci, d - 1)];
#pragma unroll
        for (int s = 0; s < PCI_ATTN_SLOTS; ++s) a[ci][s] = bb;
      }
      dense4<CPL>(Wg1, bufA, d, lane, a);
      // online softmax over the slots, weighted sum of V + pos
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int c = lane + 32 * ci;
#pragma unroll
        for (int s = 0; s < PCI_ATTN_SLOTS; ++s) {
          if (s0 + s < k && c < d) {
            const float x = a[ci][s] * inv_sqrt_d;
            const float v = g[((size_t)r * k + s0 + s) * 2 * d + d + c] + pos[ci][s];
            const float m = fmaxf(mx[ci], x);
            const float scale = expf(mx[ci] - m);
            const float e = expf(x - m);
            den[ci] = den[ci] * scale + e;
            num[ci] = num[ci] * scale + e * v;
            mx[ci] = m;
          }
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int c = lane + 32 * ci;
      if (c < d) out[(size_t)r * d + c] = num[ci] / den[ci];
    }
  }
}

template <int CPL>
static cudaError_t launch_attention(const float* q, const float* g,
                                    const float* delta, const float* wbuf,
                                    float* out, int M, int d, int k,
                                    cudaStream_t stream) {
  // weights once, then two [d][4] buffers a warp; fewer warps at d = 128
  const size_t wbytes = sizeof(float) * round_up(attn_weight_floats(d), 4);
  const size_t per_warp = sizeof(float) * 8 * (size_t)d;
  int warps = 8;
  while (warps > 1 && wbytes + warps * per_warp > 200 * 1024) warps /= 2;
  const size_t smem = wbytes + warps * per_warp;
  cudaError_t e = allow_smem(attention_kernel<CPL>, smem);
  if (e != cudaSuccess) return e;
  int blocks = (M + warps - 1) / warps;
  blocks = std::min(blocks, 132 * 8);
  attention_kernel<CPL><<<blocks, warps * 32, smem, stream>>>(q, g, delta, wbuf,
                                                              out, M, d, k);
  return cudaGetLastError();
}

// ---- the tensor-core route ------------------------------------------------

// warps a block: 12 (at d = 64 they spill ~100 bytes a thread at the
// 168-register cap, and still beat 8 warps at 255 registers, which spill
// too, by 10%, on the H100)
#define ATC_WARPS 12
#define ATC_STAMPS 5  // a warp's ns waiting for its copies, in the pos MLP, forming
                      // h and V + pos, in the gamma MLP, in the softmax; then queries

// Float offsets in the chained split pack of the tail at width D = 8 NT
// (_build.pack_tf32(chain=True)): layer 0 (3 -> D, one k-step), then three
// D -> D layers, each its fragments then its bias.
template <int NT>
struct AtcPack {
  static constexpr int D = 8 * NT;
  static constexpr int W0 = 0, B0 = W0 + 16 * D, W1 = B0 + D, B1 = W1 + 2 * D * D,
                       W2 = B1 + D, B2 = W2 + 2 * D * D, W3 = B2 + D, B3 = W3 + 2 * D * D,
                       NW = B3 + D;
  // a warp's buffer: k <= 16 K|V rows (stride 2D + 8), q, delta rows (x, y, z, 0)
  static constexpr int LD = 2 * D + 8, Q = 16 * LD, DL = Q + D, BUF = DL + 64;
};

// out = act((in x W) + bias) for one warp's 16-row tile: `in`, the previous
// layer's accumulator fragments (the chained A operand), NT n-tiles of
// weights from a chained layer of the pack (float4 a lane, k-step major),
// every output n-tile at once.
template <int NT>
__device__ __forceinline__ void atc_dense(const float (&in)[NT][4], const float4* w4,
                                          const float* bias, float (&out)[NT][4], bool relu) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float small[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = small[n][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    uint32_t ahi[4], alo[4];
    split_chained(in[kt], ahi, alo);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_3xtf32_apart(out[n], small[n], ahi, alo, w4[(kt * NT + n) * 32 + lane]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = (out[n][e] + small[n][e]) + ((e & 1) ? b.y : b.x);
      out[n][e] = relu ? fmaxf(v, 0.f) : v;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(ATC_WARPS * 32, 1)
attention_tc_kernel(const float* __restrict__ q, const float* __restrict__ g,
                    const float* __restrict__ delta, const float* __restrict__ wtc,
                    float* __restrict__ out, unsigned long long* __restrict__ stamps, int M,
                    int k) {
  using L = AtcPack<NT>;
  constexpr int D = L::D, W = ATC_WARPS;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const float4* w4 = smem4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  float* buf = sw + L::NW + warp * L::BUF;
  for (int e = threadIdx.x; e < L::NW / 4; e += blockDim.x)
    smem4[e] = reinterpret_cast<const float4*>(wtc)[e];
  for (int e = lane; e < L::BUF; e += 32) buf[e] = 0.f;  // rows >= k stay 0
  __syncthreads();

  const int step = gridDim.x * W;
  // this query's K|V rows, q and delta into the warp's buffer (one group)
  auto issue = [&](int r) {
    if (r < M) {
      const float* src = g + (size_t)r * k * 2 * D;
      for (int e = lane; e < k * (D / 2); e += 32)
        cp_async16(buf + (e / (D / 2)) * L::LD + 4 * (e % (D / 2)), src + 4 * e);
      for (int e = lane; e < D / 4; e += 32) cp_async16(buf + L::Q + 4 * e, q + (size_t)r * D + 4 * e);
      for (int e = lane; e < 3 * k; e += 32)
        cp_async4(buf + L::DL + (e / 3) * 4 + e % 3, delta + (size_t)r * k * 3 + e);
    }
    cp_async_commit();
  };
  const bool timed = stamps != nullptr;
  unsigned long long tacc[ATC_STAMPS] = {0, 0, 0, 0, 0}, tprev = timed ? global_ns() : 0;
  auto mark = [&](int i) {
    if (timed) {
      const unsigned long long now = global_ns();
      tacc[i] += now - tprev;
      tprev = now;
    }
  };
  const float scale = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(d)
  int r = blockIdx.x * W + warp;
  issue(r);
  int done = 0;
  for (; r < M; r += step, ++done) {
    cp_async_wait_all();
    __syncwarp();  // every lane's copies are in
    mark(0);
    // pos MLP: layer 0 (3 -> D) as one k-step of delta's rows (columns 3..7
    // zero), then D -> D
    float h0[NT][4], pos[NT][4];
    {
      uint32_t ahi[4], alo[4];
      tf32_split(buf[L::DL + gq * 4 + t], ahi[0], alo[0]);  // column 3 is 0
      tf32_split(buf[L::DL + (gq + 8) * 4 + t], ahi[1], alo[1]);
      ahi[2] = ahi[3] = alo[2] = alo[3] = 0u;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float small[4] = {0.f, 0.f, 0.f, 0.f};
        h0[n][0] = h0[n][1] = h0[n][2] = h0[n][3] = 0.f;
        mma_3xtf32_apart(h0[n], small, ahi, alo, w4[L::W0 / 4 + n * 32 + lane]);
        const float2 b = *reinterpret_cast<const float2*>(sw + L::B0 + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h0[n][e] = fmaxf((h0[n][e] + small[e]) + ((e & 1) ? b.y : b.x), 0.f);
      }
    }
    atc_dense<NT>(h0, w4 + L::W1 / 4, sw + L::B1, pos, false);
    mark(1);
    // h = (q - K) + pos and vp = V + pos, rows gq and gq + 8
    float hh[NT][4], vp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 qv = *reinterpret_cast<const float2*>(buf + L::Q + c);
      const float2 k0 = *reinterpret_cast<const float2*>(buf + gq * L::LD + c);
      const float2 k1 = *reinterpret_cast<const float2*>(buf + (gq + 8) * L::LD + c);
      const float2 v0 = *reinterpret_cast<const float2*>(buf + gq * L::LD + D + c);
      const float2 v1 = *reinterpret_cast<const float2*>(buf + (gq + 8) * L::LD + D + c);
      hh[n][0] = (qv.x - k0.x) + pos[n][0];
      hh[n][1] = (qv.y - k0.y) + pos[n][1];
      hh[n][2] = (qv.x - k1.x) + pos[n][2];
      hh[n][3] = (qv.y - k1.y) + pos[n][3];
      vp[n][0] = v0.x + pos[n][0];
      vp[n][1] = v0.y + pos[n][1];
      vp[n][2] = v1.x + pos[n][2];
      vp[n][3] = v1.y + pos[n][3];
    }
    __syncwarp();  // every lane is done with the buffer
    issue(r + step);
    mark(2);
    // gamma MLP
    float r2[NT][4], a[NT][4];
    atc_dense<NT>(hh, w4 + L::W2 / 4, sw + L::B2, r2, true);
    atc_dense<NT>(r2, w4 + L::W3 / 4, sw + L::B3, a, false);
    mark(3);
    // softmax over the rows (slots) of each column, weighted sum of V + pos
    const bool ok0 = gq < k, ok1 = gq + 8 < k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float res[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // exp(a / sqrt(d) - max) as exp2 of a scaled by log2(e) / sqrt(d)
        const float x0 = ok0 ? a[n][e] * scale : -CUDART_INF_F;
        const float x1 = ok1 ? a[n][e + 2] * scale : -CUDART_INF_F;
        float m = fmaxf(x0, x1);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        const float e0 = ok0 ? exp2f(x0 - m) : 0.f, e1 = ok1 ? exp2f(x1 - m) : 0.f;
        float den = e0 + e1;
        float num = (ok0 ? e0 * vp[n][e] : 0.f) + (ok1 ? e1 * vp[n][e + 2] : 0.f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          den += __shfl_xor_sync(0xffffffffu, den, off);
          num += __shfl_xor_sync(0xffffffffu, num, off);
        }
        res[e] = num / den;
      }
      if (gq == 0)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * n + 2 * t) = make_float2(res[0], res[1]);
    }
    mark(4);
  }
  cp_async_wait_all();  // the last (empty) group
  if (timed && lane == 0) {
    unsigned long long* st = stamps + ((size_t)blockIdx.x * W + warp) * (ATC_STAMPS + 1);
    for (int i = 0; i < ATC_STAMPS; ++i) st[i] = tacc[i];
    st[ATC_STAMPS] = done;
  }
}

template <int NT>
static size_t atc_smem() {
  using L = AtcPack<NT>;
  return sizeof(float) * ((size_t)L::NW + (size_t)ATC_WARPS * L::BUF);
}

static int atc_blocks(int M, int W) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, std::min(sms, (M + W - 1) / W));
}

template <int NT>
static cudaError_t launch_attention_tc(const float* q, const float* g, const float* delta,
                                       const float* wtc, float* out,
                                       unsigned long long* stamps, int M, int k,
                                       cudaStream_t stream) {
  const size_t smem = atc_smem<NT>();
  cudaError_t e = allow_smem(attention_tc_kernel<NT>, smem);
  if (e != cudaSuccess) return e;
  attention_tc_kernel<NT><<<atc_blocks(M, ATC_WARPS), ATC_WARPS * 32, smem, stream>>>(
      q, g, delta, wtc, out, stamps, M, k);
  return cudaGetLastError();
}

// ---- the wide tensor-core route ---------------------------------------------

#define AW_ROWS 64     // (query, slot) rows a tile: four 16-row m-tiles
#define AW_THREADS 256
#define AW_NTW 2       // output n-tiles a warp's item
#define AW_DEPTH 8     // weight k-steps a lane keeps in flight through its ring
#define AW_DL 12       // delta's row stride: x, y, z, zeros (ld % 8 == 4)

// Float offsets in the wide kernel's shared memory at width d: the
// activation buffers X, P (pos) and Y ([AW_ROWS][d + 4] each), delta
// ([AW_ROWS][AW_DL]), the weight ring (AW_DEPTH x AW_NTW float4 a thread).
struct AwLayout {
  int ld, P, Y, DL, RING, total;
  __host__ __device__ explicit AwLayout(int d)
      : ld(d + 4), P(AW_ROWS * ld), Y(2 * AW_ROWS * ld), DL(3 * AW_ROWS * ld),
        RING(DL + AW_ROWS * AW_DL), total(RING + AW_DEPTH * AW_NTW * 4 * AW_THREADS) {}
};

// Float offsets of layer l's fragments and bias in the unchained split pack
// of the tail at width d (_build.pack_tf32: 3 -> d, one k-step, then three
// d -> d layers; make_tf32_spec's layout).
__device__ __forceinline__ int aw_woff(int l, int d) {
  return l == 0 ? 0 : 17 * d + (l - 1) * (2 * d * d + d);
}
__device__ __forceinline__ int aw_boff(int l, int d) {
  return aw_woff(l, d) + (l == 0 ? 16 * d : 2 * d * d);
}

// hout = act((hin x W) + bias) over the tile's four m-tiles, by every
// thread of the block: mma_tf32.cuh's mma_dense_tiles with its summation
// order, each warp's item AW_NTW n-tiles over all four m-tiles, each lane
// streaming the B fragments it reads AW_DEPTH - 1 k-steps ahead of its mma
// through its own ring slots (cp.async from the pack in device memory, L2:
// at 8 warps an SM the shallower shared ring left every k-step waiting on
// L2).  hin's columns [cin, 8 KT) are zero; ldi and ldo are % 8 == 4.
__device__ __forceinline__ void aw_dense(const float* __restrict__ wf,
                                         const float* __restrict__ bias, const float* hin,
                                         int ldi, float* hout, int ldo, int cin, int cout,
                                         bool relu, float4* ring) {
  const int KT = round_up(cin, 8) / 8, NT = round_up(cout, 8) / 8;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float4* wf4 = reinterpret_cast<const float4*>(wf);
  float4* mine = ring + threadIdx.x;  // slot s: mine[s * blockDim.x]
  for (int it = warp; it * AW_NTW < NT; it += nwarps) {
    const int n0 = it * AW_NTW, nn = min(AW_NTW, NT - n0);
    auto issue = [&](int kt) {  // this lane's fragments of k-step kt
      if (kt < KT) {
        const float4* src = wf4 + ((size_t)kt * NT + n0) * 32 + lane;
        float4* dst = mine + (kt % AW_DEPTH) * AW_NTW * blockDim.x;
#pragma unroll
        for (int j = 0; j < AW_NTW; ++j)
          if (j < nn) cp_async16(dst + j * blockDim.x, src + j * 32);
      }
      cp_async_commit();
    };
    float acc[4][AW_NTW][4], small[4][AW_NTW][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < AW_NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = small[m][j][e] = 0.f;
#pragma unroll
    for (int d = 0; d < AW_DEPTH - 1; ++d) issue(d);
    for (int kt = 0; kt < KT; ++kt) {
      issue(kt + AW_DEPTH - 1);     // into the slot k-step kt - 1 read
      cp_async_wait<AW_DEPTH - 1>();  // k-step kt's fragments are in
      const float4* sl = mine + (kt % AW_DEPTH) * AW_NTW * blockDim.x;
      float4 w[AW_NTW];
#pragma unroll
      for (int j = 0; j < AW_NTW; ++j)
        if (j < nn) w[j] = sl[j * blockDim.x];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t ahi[4], alo[4];
        load_a_split(hin, ldi, m * 16, kt * 8, ahi, alo);
#pragma unroll
        for (int j = 0; j < AW_NTW; ++j)
          if (j < nn) mma_3xtf32_apart(acc[m][j], small[m][j], ahi, alo, w[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < AW_NTW; ++j) {
      if (j < nn) {
        const int c = (n0 + j) * 8 + 2 * t;
        const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float v0 = (acc[m][j][0] + small[m][j][0]) + b0;
          float v1 = (acc[m][j][1] + small[m][j][1]) + b1;
          float v2 = (acc[m][j][2] + small[m][j][2]) + b0;
          float v3 = (acc[m][j][3] + small[m][j][3]) + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f), v2 = fmaxf(v2, 0.f), v3 = fmaxf(v3, 0.f);
          }
          const int r = m * 16 + g;
          *reinterpret_cast<float2*>(hout + (size_t)r * ldo + c) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(hout + (size_t)(r + 8) * ldo + c) = make_float2(v2, v3);
        }
      }
    }
  }
  cp_async_wait_all();  // the trailing (empty) groups
  __syncthreads();      // hout is whole for the next step
}

// stamps: null, or rows blockIdx.x * ATC_WARPS of [grid * ATC_WARPS]
// [ATC_STAMPS + 1] (the per-warp kernel's layout; thread 0's ns loading
// delta, in the pos MLP, forming h, in the gamma MLP, in the softmax; then
// its tiles).
__global__ void __launch_bounds__(AW_THREADS, 1)
attention_wide_kernel(const float* __restrict__ q, const float* __restrict__ g,
                      const float* __restrict__ delta, const float* __restrict__ wtc,
                      float* __restrict__ out, unsigned long long* __restrict__ stamps, int M,
                      int d, int k) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const AwLayout L(d);
  float* X = sm;
  float* P = sm + L.P;
  float* Y = sm + L.Y;
  float* DL = sm + L.DL;
  float4* ring = reinterpret_cast<float4*>(sm + L.RING);
  // delta's columns 3..7 stay zero (the first layer's k-step pads)
  for (int e = threadIdx.x; e < AW_ROWS * AW_DL; e += blockDim.x) DL[e] = 0.f;
  const int QT = AW_ROWS / k, two_d = 2 * d, d4 = d / 4;
  const int tiles = (M + QT - 1) / QT;
  const float scale = 1.4426950408889634f / sqrtf((float)d);  // log2(e) / sqrt(d)
  const bool timed = stamps != nullptr && threadIdx.x == 0;
  unsigned long long tacc[ATC_STAMPS] = {0, 0, 0, 0, 0}, tprev = timed ? global_ns() : 0;
  auto mark = [&](int i) {
    if (timed) {
      const unsigned long long now = global_ns();
      tacc[i] += now - tprev;
      tprev = now;
    }
  };
  int done = 0;
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x, ++done) {
    const int q0 = tl * QT, nq = min(QT, M - q0), R = nq * k;
    const size_t row0 = (size_t)q0 * k;  // the tile's first (query, slot) row
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < R * 3; e += blockDim.x)
      DL[(e / 3) * AW_DL + e % 3] = __ldg(delta + row0 * 3 + e);
    __syncthreads();
    mark(0);
    // pos MLP: 3 -> d as one k-step of delta's padded rows, then d -> d
    aw_dense(wtc + aw_woff(0, d), wtc + aw_boff(0, d), DL, AW_DL, X, L.ld, 3, d, true, ring);
    aw_dense(wtc + aw_woff(1, d), wtc + aw_boff(1, d), X, L.ld, P, L.ld, d, d, false, ring);
    mark(1);
    // h = (q - K) + pos, four channels a thread: K and q as float4 from
    // device memory, read once where they are used
#pragma unroll 4
    for (int e = threadIdx.x; e < R * d4; e += blockDim.x) {
      const int r = e / d4, c = 4 * (e - r * d4);
      const float4 kv = __ldg(reinterpret_cast<const float4*>(g + (row0 + r) * two_d + c));
      const float4 qv = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r / k) * d + c));
      float* x = X + r * L.ld + c;
      const float* pp = P + r * L.ld + c;
      x[0] = (qv.x - kv.x) + pp[0];
      x[1] = (qv.y - kv.y) + pp[1];
      x[2] = (qv.z - kv.z) + pp[2];
      x[3] = (qv.w - kv.w) + pp[3];
    }
    __syncthreads();
    mark(2);
    // gamma MLP
    aw_dense(wtc + aw_woff(2, d), wtc + aw_boff(2, d), X, L.ld, Y, L.ld, d, d, true, ring);
    aw_dense(wtc + aw_woff(3, d), wtc + aw_boff(3, d), Y, L.ld, X, L.ld, d, d, false, ring);
    mark(3);
    // softmax over each query's slots per channel (as exp2 of a scaled by
    // log2(e) / sqrt(d)), weighted sum of V + pos: four channels a thread,
    // V as float4 from device memory
    for (int e = threadIdx.x; e < nq * d4; e += blockDim.x) {
      const int qi = e / d4, c = 4 * (e - qi * d4), rb = qi * k;
      float m[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
      for (int s = 0; s < k; ++s) {
        const float* a = X + (rb + s) * L.ld + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], a[i] * scale);
      }
      float den[4] = {0.f, 0.f, 0.f, 0.f}, num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int s = 0; s < k; ++s) {
        const int r = rb + s;
        const float4 v = __ldg(reinterpret_cast<const float4*>(g + (row0 + r) * two_d + d + c));
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float* a = X + r * L.ld + c;
        const float* pp = P + r * L.ld + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ex = exp2f(a[i] * scale - m[i]);
          den[i] += ex;
          num[i] += ex * (vv[i] + pp[i]);
        }
      }
      *reinterpret_cast<float4*>(out + (size_t)(q0 + qi) * d + c) =
          make_float4(num[0] / den[0], num[1] / den[1], num[2] / den[2], num[3] / den[3]);
    }
    __syncthreads();
    mark(4);
  }
  if (timed) {
    unsigned long long* st = stamps + (size_t)blockIdx.x * ATC_WARPS * (ATC_STAMPS + 1);
    for (int i = 0; i < ATC_STAMPS; ++i) st[i] = tacc[i];
    st[ATC_STAMPS] = done;
  }
}

static size_t aw_smem(int d) { return sizeof(float) * (size_t)AwLayout(d).total; }

static cudaError_t launch_attention_wide(const float* q, const float* g, const float* delta,
                                         const float* wtc, float* out,
                                         unsigned long long* stamps, int M, int d, int k,
                                         cudaStream_t stream) {
  const size_t smem = aw_smem(d);
  cudaError_t e = allow_smem(attention_wide_kernel, smem);
  if (e != cudaSuccess) return e;
  attention_wide_kernel<<<atc_blocks(M, AW_ROWS / k), AW_THREADS, smem, stream>>>(
      q, g, delta, wtc, out, stamps, M, d, k);
  return cudaGetLastError();
}

// q [M, d], g [M, k, 2d] (K | V), delta [M, k, 3], out [M, d], M = B * N;
// d <= 128 and a multiple of 8, 1 <= k <= 32.  wtc non-null: the
// tensor-core routes (k <= 16): d <= 64 per warp (wtc the chained split
// pack of the four layers), d in 72..128 block-wide (wtc the unchained
// pack), with optional stamps [grid * ATC_WARPS][ATC_STAMPS + 1] (the
// block-wide kernel's in each block's first row); else the scalar route on
// wbuf (common.cuh's attention layout).
extern "C" int pci_attention(const void* q, const void* g, const void* delta,
                             const void* wbuf, const void* wtc, void* out, void* stamps,
                             int M, int d, int k, void* stream) {
  if (d < 8 || d > 128 || d % 8 || k < 1 || k > 32 || M < 1)
    return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* gg = static_cast<const float*>(g);
  const float* dd = static_cast<const float*>(delta);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wtc != nullptr) {
    if (k > 16) return (int)cudaErrorInvalidValue;
    const float* w = static_cast<const float*>(wtc);
    auto* sp = static_cast<unsigned long long*>(stamps);
    if (d > 64) return (int)launch_attention_wide(qq, gg, dd, w, o, sp, M, d, k, st);
    switch (d / 8) {
      case 1: return (int)launch_attention_tc<1>(qq, gg, dd, w, o, sp, M, k, st);
      case 2: return (int)launch_attention_tc<2>(qq, gg, dd, w, o, sp, M, k, st);
      case 3: return (int)launch_attention_tc<3>(qq, gg, dd, w, o, sp, M, k, st);
      case 4: return (int)launch_attention_tc<4>(qq, gg, dd, w, o, sp, M, k, st);
      case 5: return (int)launch_attention_tc<5>(qq, gg, dd, w, o, sp, M, k, st);
      case 6: return (int)launch_attention_tc<6>(qq, gg, dd, w, o, sp, M, k, st);
      case 7: return (int)launch_attention_tc<7>(qq, gg, dd, w, o, sp, M, k, st);
      default: return (int)launch_attention_tc<8>(qq, gg, dd, w, o, sp, M, k, st);
    }
  }
  const float* w = static_cast<const float*>(wbuf);
  if (d <= 32) return (int)launch_attention<1>(qq, gg, dd, w, o, M, d, k, st);
  if (d <= 64) return (int)launch_attention<2>(qq, gg, dd, w, o, M, d, k, st);
  return (int)launch_attention<4>(qq, gg, dd, w, o, M, d, k, st);
}

// The tensor-core kernel's resources at d = 64 (_build.kernel_attrs).
extern "C" int pci_attention_attrs(int* out) {
  return kernel_attrs(attention_tc_kernel<8>, atc_smem<8>(), out, ATC_WARPS * 32);
}

// The wide kernel's resources at d = 128 (_build.kernel_attrs).
extern "C" int pci_attention_wide_attrs(int* out) {
  return kernel_attrs(attention_wide_kernel, aw_smem(128), out, AW_THREADS);
}
