// The fusion's attention head over given residuals: score MLP over
// [resi | safe_norm(resi)] (4 -> 64 -> 64 -> 128, BatchNorm folded, ReLU
// each), max over channels, fp32 softmax over the k slots, then combined +
// sum_k w * resi and, for a payload, sum_k w * extra.
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_tail_tpu.py:
// fusion_attention_tail, the eval route of PointsFusion with the one-shot
// kernel off (after the residual kNN, csrc/fusion_knn.cu
// fusion_resi_kernel).  The head is the one-shot kernel's
// (csrc/fusion_head.cuh).
//
// What bounds it on the H100: at B = 8, N = 16,384, k = 32 the residuals
// are 50 MB (15 us at 3.35 TB/s) and the MLP 52 GFLOP (0.78 ms at 67
// TFLOP/s fp32): operations.  The design: one warp a query, lane L owns slot
// L, the weights (51 KB) in shared memory and the activations in registers,
// so the [B, N, k, 128] activation block never exists; the softmax is a
// warp max and warp sums.
#include "fusion_head.cuh"

template <int H1, int H2, int H3>
__global__ void __launch_bounds__(256)
fusion_tail_kernel(const float* __restrict__ comb, const float* __restrict__ resi,
                   const float* __restrict__ extra, const float* __restrict__ wbuf,
                   float* __restrict__ out, int N, int k, int Ce) {
  constexpr int NW = ScoreMlp<H1, H2, H3>::NW;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  for (int e = threadIdx.x; e < NW; e += blockDim.x) sw[e] = wbuf[e];
  __syncthreads();

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= N) return;  // the whole warp
  const size_t row = (size_t)b * N + q;
  const bool active = lane < k;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  if (active) {
    const float* r = resi + (row * k + lane) * 3;
    rx = r[0];
    ry = r[1];
    rz = r[2];
  }
  const float w = slot_weight(slot_score<H1, H2, H3>(rx, ry, rz, sw), active);
  const float sw_ = warp_sum(w), ax = warp_sum(w * rx), ay = warp_sum(w * ry),
              az = warp_sum(w * rz);
  float* o = out + row * (3 + Ce);
  if (lane == 0) {
    o[0] = comb[row * 3] + ax / sw_;
    o[1] = comb[row * 3 + 1] + ay / sw_;
    o[2] = comb[row * 3 + 2] + az / sw_;
  }
  for (int c = 0; c < Ce; ++c) {
    const float v = warp_sum(active ? w * extra[(row * k + lane) * Ce + c] : 0.f);
    if (lane == 0) o[3 + c] = v / sw_;
  }
}

// comb [B, N, 3], resi [B, N, k, 3], extra [B, N, k, Ce] (null for Ce == 0)
// fp32; wbuf the packed score MLP (4 -> h1 -> h2 -> h3); out [B, N, 3 + Ce].
extern "C" int pci_fusion_tail(const void* comb, const void* resi,
                               const void* extra, const void* wbuf, int h1,
                               int h2, int h3, void* out, int B, int N, int k,
                               int Ce, void* stream) {
  if (h1 != 64 || h2 != 64 || h3 != 128 || k < 1 || k > 32 || Ce < 0 ||
      (Ce > 0 && extra == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ScoreMlp<64, 64, 128>::NW;
  cudaError_t e = allow_smem(fusion_tail_kernel<64, 64, 128>, smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = 8;
  dim3 grid((N + warps - 1) / warps, B);
  fusion_tail_kernel<64, 64, 128><<<grid, warps * 32, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(comb), static_cast<const float*>(resi),
      static_cast<const float*>(extra), static_cast<const float*>(wbuf),
      static_cast<float*>(out), N, k, Ce);
  return (int)cudaGetLastError();
}
