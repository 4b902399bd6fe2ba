// The fusion's attention head for one query, one warp a query and lane L
// holding slot L (k <= 32), shared by the one-shot fusion
// (csrc/fusion_knn.cu) and the attention tail over given residuals
// (csrc/fusion_tail.cu): the folded score MLP over [resi | safe_norm(resi)]
// with the activations in registers and the weights in shared memory, the
// max over channels, and the softmax over the slots.
#pragma once

#include "common.cuh"

#define FULL 0xffffffffu

// Float offsets of the packed score MLP 4 -> H1 -> H2 -> H3 (common.cuh
// layout: W row-major [in][out], then b, a layer).
template <int H1, int H2, int H3>
struct ScoreMlp {
  static constexpr int W1 = 0, B1 = W1 + 4 * H1, W2 = B1 + H1, B2 = W2 + H1 * H2,
                       W3 = B2 + H2, B3 = W3 + H2 * H3, NW = B3 + H3;
};

// max_c ReLU(MLP([rx, ry, rz, sqrt(r.r + 1e-12)])) for this lane's slot.
template <int H1, int H2, int H3>
__device__ __forceinline__ float slot_score(float rx, float ry, float rz,
                                            const float* sw) {
  using L = ScoreMlp<H1, H2, H3>;
  const float f3 = sqrtf(rx * rx + ry * ry + rz * rz + 1e-12f);
  float h1[H1];
#pragma unroll
  for (int o = 0; o < H1; ++o) {
    float v = sw[L::B1 + o];
    v = fmaf(rx, sw[L::W1 + 0 * H1 + o], v);
    v = fmaf(ry, sw[L::W1 + 1 * H1 + o], v);
    v = fmaf(rz, sw[L::W1 + 2 * H1 + o], v);
    v = fmaf(f3, sw[L::W1 + 3 * H1 + o], v);
    h1[o] = fmaxf(v, 0.f);
  }
  float h2[H2];
#pragma unroll
  for (int o = 0; o < H2; ++o) h2[o] = sw[L::B2 + o];
#pragma unroll
  for (int i = 0; i < H1; ++i) {
#pragma unroll
    for (int o = 0; o < H2; o += 4) {
      const float4 w = *reinterpret_cast<const float4*>(sw + L::W2 + i * H2 + o);
      h2[o] = fmaf(h1[i], w.x, h2[o]);
      h2[o + 1] = fmaf(h1[i], w.y, h2[o + 1]);
      h2[o + 2] = fmaf(h1[i], w.z, h2[o + 2]);
      h2[o + 3] = fmaf(h1[i], w.w, h2[o + 3]);
    }
  }
#pragma unroll
  for (int o = 0; o < H2; ++o) h2[o] = fmaxf(h2[o], 0.f);
  float score = -CUDART_INF_F;
#pragma unroll 1
  for (int o = 0; o < H3; o += 4) {
    float a0 = sw[L::B3 + o], a1 = sw[L::B3 + o + 1], a2 = sw[L::B3 + o + 2],
          a3 = sw[L::B3 + o + 3];
#pragma unroll
    for (int i = 0; i < H2; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(sw + L::W3 + i * H3 + o);
      a0 = fmaf(h2[i], w.x, a0);
      a1 = fmaf(h2[i], w.y, a1);
      a2 = fmaf(h2[i], w.z, a2);
      a3 = fmaf(h2[i], w.w, a3);
    }
    score = fmaxf(score, fmaxf(fmaxf(fmaxf(a0, 0.f), fmaxf(a1, 0.f)),
                               fmaxf(fmaxf(a2, 0.f), fmaxf(a3, 0.f))));
  }
  return score;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// This slot's softmax weight before normalisation, exp(score - max over the
// active slots), 0 for an inactive one; the caller divides by warp_sum.
__device__ __forceinline__ float slot_weight(float score, bool active) {
  const float s = active ? score : -CUDART_INF_F;
  float m = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  return active ? expf(s - m) : 0.f;
}
