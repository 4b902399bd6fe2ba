// Point-transformer vector-attention tail, eval:
//   pos = W_d1 relu(W_d0 delta + b_d0) + b_d1
//   a   = W_g1 relu(W_g0 (q - K + pos) + b_g0) + b_g1
//   res = sum_k softmax_k(a / sqrt(d)) * (V + pos)
// with the softmax per (query, channel) over the k slots, all in fp32.
//
// Replaces pci_tpu/ops/pallas_kernels/attention_tpu.py:fused_vector_attention.
// The TPU kernel casts q and the gathered K|V to bf16 (a TPU precision
// choice); this one reads and computes everything in fp32, the function
// of the XLA expression (pci_tpu/nn/transformer.py:165-181).
//
// What bounds it on the H100: operations.  At the transformer's shapes
// (65,536 queries, k = 16, d = 64) the four dense layers are 2 N k
// (3d + 3d^2) = 26 GFLOP against 2.4 MB of q and 286 MB of K|V, V and
// delta read once, so 0.4 ms by fp32 operations and 0.09 ms by bytes.
// The XLA route writes each [N, k, d] intermediate (268 MB) to device
// memory; here none leaves the SM.  The design: the weights (d = 64:
// 50 KB) sit in shared memory for the block's whole life; one warp a
// query, each lane owning the channels lane, lane + 32, ...; the k slots
// run four at a time, their activations in a per-warp [d][4] shared
// buffer, so one weight load feeds four slots' FMAs and one float4
// broadcast brings the four slots' inputs; an online softmax (running
// max, sum and weighted sum per channel) folds each slot in as it is
// computed.
#include "common.cuh"

#define PCI_ATTN_SLOTS 4

// Weight buffer layout (fp32, row-major [in][out]): Wd0 [3][d], bd0 [d],
// Wd1 [d][d], bd1 [d], Wg0 [d][d], bg0 [d], Wg1 [d][d], bg1 [d].
__host__ __device__ inline int attn_weight_floats(int d) {
  return 3 * d + d + 3 * (d * d + d);
}

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

// q [M, d], g [M, k, 2d] (K | V), delta [M, k, 3], out [M, d], M = B * N;
// d <= 128 and a multiple of 8, 1 <= k <= 32.
extern "C" int pci_attention(const void* q, const void* g, const void* delta,
                             const void* wbuf, void* out, int M, int d, int k,
                             void* stream) {
  if (d < 8 || d > 128 || d % 8 || k < 1 || k > 32 || M < 1)
    return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* gg = static_cast<const float*>(g);
  const float* dd = static_cast<const float*>(delta);
  const float* w = static_cast<const float*>(wbuf);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return (int)launch_attention<1>(qq, gg, dd, w, o, M, d, k, st);
  if (d <= 64) return (int)launch_attention<2>(qq, gg, dd, w, o, M, d, k, st);
  return (int)launch_attention<4>(qq, gg, dd, w, o, M, d, k, st);
}
