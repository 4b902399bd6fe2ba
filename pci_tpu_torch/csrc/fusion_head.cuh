// The fusion's attention head for one query, one warp a query and lane L
// holding slot L (k <= 32), slots L and 32 + L (k <= 64: head_weight2,
// fused_row2, payload_sums2) or slots 32 h + L, h < 4 (k <= 128:
// head_weight4, fused_row4, payload_sums4); the tail past k = 64 takes the
// scores 32 slots at a time (head_score): the folded score MLP over [resi |
// safe_norm(resi)], the max over channels, and the softmax over the slots,
// on the tensor cores in 3xTF32 (csrc/mma_tf32.cuh), the split weights in
// shared memory (score_tile, head_weight, fused_row), then the weighted
// payload sums (payload_sums).  Every kernel that runs the head takes it
// from here: the two one-shot kernels, flat
// (csrc/fusion_knn.cu) and cell-pruned (csrc/fusion_cells.cu), and the tail
// over given residuals (csrc/fusion_tail.cu), so that all give the same
// rows for the same neighbours.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

#define FULL 0xffffffffu

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

// ---- the head on the tensor cores ----------------------------------------

// the split score MLP 4 -> 64 -> 64 -> 128 in smem (mma_tf32.cuh layout,
// the last two layers chained), float offsets
#define ONE_H1 64
#define ONE_H2 64
#define ONE_H3 128
#define ONE_W1 0
#define ONE_B1 (ONE_W1 + 8 * ONE_H1 * 2)
#define ONE_W2 (ONE_B1 + ONE_H1)
#define ONE_B2 (ONE_W2 + ONE_H1 * ONE_H2 * 2)
#define ONE_W3 (ONE_B2 + ONE_H2)
#define ONE_B3 (ONE_W3 + ONE_H2 * ONE_H3 * 2)
#define ONE_NW (ONE_B3 + ONE_H3)

// One 16-slot row tile of the score head on the tensor cores: rows are
// slots 16 mt .. 16 mt + 15 of this warp's query, the input [r | safe_norm]
// of slot s held by lane s.  4 -> 64 -> 64 -> 128, ReLU after each, in
// 3xTF32 (mma_tf32.cuh), the activations in registers from layer to layer
// as accumulator fragments, which are the next layer's A fragments for the
// chained weight layout (split a k-step at a time); the last layer in four
// chunks of 32 outputs with a running max.  Returns, on lane 4 g (g < 8),
// max_c of rows g (lo) and g + 8 (hi).
__device__ __forceinline__ void score_tile(const float* sw, float rx, float ry, float rz,
                                           float nr, int mt, float& mlo, float& mhi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4* w4 = reinterpret_cast<const float4*>(sw);
  float h[8][4];  // a layer's output, [n-tile][accumulator fragment]
  {
    uint32_t ahi[4], alo[4];
    const int s0 = 16 * mt + g, s1 = s0 + 8;
    const float x0 = __shfl_sync(FULL, rx, s0), y0 = __shfl_sync(FULL, ry, s0);
    const float z0 = __shfl_sync(FULL, rz, s0), n0 = __shfl_sync(FULL, nr, s0);
    const float x1 = __shfl_sync(FULL, rx, s1), y1 = __shfl_sync(FULL, ry, s1);
    const float z1 = __shfl_sync(FULL, rz, s1), n1 = __shfl_sync(FULL, nr, s1);
    tf32_split(t == 0 ? x0 : (t == 1 ? y0 : (t == 2 ? z0 : n0)), ahi[0], alo[0]);
    tf32_split(t == 0 ? x1 : (t == 1 ? y1 : (t == 2 ? z1 : n1)), ahi[1], alo[1]);
    ahi[2] = ahi[3] = alo[2] = alo[3] = 0u;  // columns 4..7: padding
    // layer 1: one k-step, 8 n-tiles
#pragma unroll
    for (int nt = 0; nt < ONE_H1 / 8; ++nt) {
      float small[4] = {0.f, 0.f, 0.f, 0.f};
      h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
      mma_3xtf32_apart(h[nt], small, ahi, alo, w4[(ONE_W1 / 4) + nt * 32 + lane]);
      const float2 b = *reinterpret_cast<const float2*>(sw + ONE_B1 + 8 * nt + 2 * t);
      h[nt][0] = fmaxf((h[nt][0] + small[0]) + b.x, 0.f);
      h[nt][1] = fmaxf((h[nt][1] + small[1]) + b.y, 0.f);
      h[nt][2] = fmaxf((h[nt][2] + small[2]) + b.x, 0.f);
      h[nt][3] = fmaxf((h[nt][3] + small[3]) + b.y, 0.f);
    }
  }
  // layer 2: 8 k-steps x 8 n-tiles, in two halves of 4 (the small products
  // in their own sums, mma_3xtf32_apart); the first half's outputs wait in
  // h2 while the second reads h
  float h2[4][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[4][4], small[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < ONE_H1 / 8; ++kt) {
      uint32_t ahi[4], alo[4];
      split_chained(h[kt], ahi, alo);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma_3xtf32_apart(acc[n], small[n], ahi, alo,
                         w4[(ONE_W2 / 4) + (kt * (ONE_H2 / 8) + 4 * half + n) * 32 + lane]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(sw + ONE_B2 + 8 * (4 * half + n) + 2 * t);
      float* o = half ? h[4 + n] : h2[n];
      o[0] = fmaxf((acc[n][0] + small[n][0]) + b.x, 0.f);
      o[1] = fmaxf((acc[n][1] + small[n][1]) + b.y, 0.f);
      o[2] = fmaxf((acc[n][2] + small[n][2]) + b.x, 0.f);
      o[3] = fmaxf((acc[n][3] + small[n][3]) + b.y, 0.f);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[n][e] = h2[n][e];
  // layer 3: 8 k-steps x 16 n-tiles in four chunks of 4, max over outputs
  mlo = -CUDART_INF_F;
  mhi = -CUDART_INF_F;
#pragma unroll 1
  for (int c = 0; c < ONE_H3 / 8; c += 4) {
    float acc[4][4], small[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < ONE_H2 / 8; ++kt) {
      uint32_t ahi[4], alo[4];
      split_chained(h[kt], ahi, alo);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma_3xtf32_apart(acc[n], small[n], ahi, alo,
                         w4[(ONE_W3 / 4) + (kt * (ONE_H3 / 8) + c + n) * 32 + lane]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(sw + ONE_B3 + 8 * (c + n) + 2 * t);
      mlo = fmaxf(mlo, fmaxf(fmaxf((acc[n][0] + small[n][0]) + b.x, 0.f),
                             fmaxf((acc[n][1] + small[n][1]) + b.y, 0.f)));
      mhi = fmaxf(mhi, fmaxf(fmaxf((acc[n][2] + small[n][2]) + b.x, 0.f),
                             fmaxf((acc[n][3] + small[n][3]) + b.y, 0.f)));
    }
  }
  mlo = fmaxf(mlo, __shfl_xor_sync(FULL, mlo, 1));
  mlo = fmaxf(mlo, __shfl_xor_sync(FULL, mlo, 2));
  mhi = fmaxf(mhi, __shfl_xor_sync(FULL, mhi, 1));
  mhi = fmaxf(mhi, __shfl_xor_sync(FULL, mhi, 2));
}

// Slot `lane`'s score, max_c MLP([r | safe_norm(r)]), on the tensor-core
// head: the score MLP over `tiles` 16-slot tiles (2, or 1 where no slot
// past 15 is read), slot `lane` holding the residual (rx, ry, rz).
__device__ __forceinline__ float head_score(const float* sw, float rx, float ry, float rz,
                                            int tiles) {
  const int lane = threadIdx.x & 31;
  const float nr = sqrtf(rx * rx + ry * ry + rz * rz + 1e-12f);
  float lo0, hi0, lo1 = 0.f, hi1 = 0.f;
  score_tile(sw, rx, ry, rz, nr, 0, lo0, hi0);
  if (tiles > 1) score_tile(sw, rx, ry, rz, nr, 1, lo1, hi1);
  // slot s = 16 mt + r sits on lane 4 (r % 8), lo for r < 8, hi above
  const int src = (lane & 7) * 4;
  const float s00 = __shfl_sync(FULL, lo0, src), s01 = __shfl_sync(FULL, hi0, src);
  const float s10 = __shfl_sync(FULL, lo1, src), s11 = __shfl_sync(FULL, hi1, src);
  return lane < 16 ? (lane < 8 ? s00 : s01) : (lane < 24 ? s10 : s11);
}

// Slot `lane`'s softmax weight before normalisation on the tensor-core
// head (the caller divides by warp_sum): slot `lane` holds the residual
// (rx, ry, rz) (zero for a slot that is inactive or unfilled), the score
// MLP over [r | safe_norm(r)] in `tiles` 16-slot tiles (2, or 1 where
// every slot past 15 is inactive: the warp-uniform skip of a tile whose
// scores no active slot reads), exp(score - max over the active slots), 0
// for an inactive slot.  sw: the split score MLP (ONE_NW floats) in shared
// memory.
__device__ __forceinline__ float head_weight(const float* sw, float rx, float ry, float rz,
                                             bool active, int tiles = 2) {
  return slot_weight(head_score(sw, rx, ry, rz, tiles), active);
}

// The fused row of one query from its slots on the tensor-core head
// (head_weight over both tiles): q + sum w r / sum w on every lane.  w and
// wsum return slot `lane`'s weight and the weights' sum, for
// payload_sums.
__device__ __forceinline__ float3 fused_row(const float* sw, float x, float y, float z,
                                            float rx, float ry, float rz, bool active,
                                            float& w, float& wsum) {
  w = head_weight(sw, rx, ry, rz, active);
  wsum = warp_sum(w);
  const float ax = warp_sum(w * rx), ay = warp_sum(w * ry), az = warp_sum(w * rz);
  return make_float3(x + ax / wsum, y + ay / wsum, z + az / wsum);
}

// ---- up to 64 slots, two a lane -------------------------------------------

// Slots `lane` (half 0, residual x0 y0 z0) and 32 + lane (half 1, x1 y1 z1)
// of one query, k <= 64: the same score_tile over `tiles` 16-slot tiles (1 to
// 4, one loop: a tile past the last active slot is not run; tile mt reads
// half mt / 2), then the softmax over both halves at once.  This is the
// merge of the TPU kernel's online softmax over two blocks of slots
// (fusion_knn_tpu.py:online_softmax_step) with both halves' scores still in
// registers: the max of the two halves' maxima comes first, so no partial
// sum is rescaled.  w0 / w1: the two slots' weights before normalisation
// (exp(score - max over the active slots)), 0 for an inactive slot.
__device__ __forceinline__ void head_weight2(const float* sw, float x0, float y0, float z0,
                                             float x1, float y1, float z1, bool act0, bool act1,
                                             int tiles, float& w0, float& w1) {
  const int lane = threadIdx.x & 31, src = (lane & 7) * 4;
  const float n0 = sqrtf(x0 * x0 + y0 * y0 + z0 * z0 + 1e-12f);
  const float n1 = sqrtf(x1 * x1 + y1 * y1 + z1 * z1 + 1e-12f);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
  for (int mt = 0; mt < tiles; ++mt) {
    const bool hi = mt >= 2;
    float lo, up;
    score_tile(sw, hi ? x1 : x0, hi ? y1 : y0, hi ? z1 : z0, hi ? n1 : n0, mt & 1, lo, up);
    // slot 16 (mt & 1) + r of the half sits on lane 4 (r % 8), lo for r < 8
    const float a = __shfl_sync(FULL, lo, src), b = __shfl_sync(FULL, up, src);
    if ((lane >> 4) == (mt & 1)) {
      const float v = (lane & 8) ? b : a;
      if (hi) s1 = v;
      else s0 = v;
    }
  }
  float m = fmaxf(act0 ? s0 : -CUDART_INF_F, act1 ? s1 : -CUDART_INF_F);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  w0 = act0 ? expf(s0 - m) : 0.f;
  w1 = act1 ? expf(s1 - m) : 0.f;
}

// The fused row of one query over up to 64 slots (head_weight2): q + sum w
// r / sum w on every lane; w0, w1 and wsum return the lane's two slot
// weights and the weights' sum, for payload_sums2.
__device__ __forceinline__ float3 fused_row2(const float* sw, float x, float y, float z,
                                             float rx0, float ry0, float rz0, float rx1,
                                             float ry1, float rz1, bool act0, bool act1,
                                             int tiles, float& w0, float& w1, float& wsum) {
  head_weight2(sw, rx0, ry0, rz0, rx1, ry1, rz1, act0, act1, tiles, w0, w1);
  wsum = warp_sum(w0 + w1);
  const float ax = warp_sum(w0 * rx0 + w1 * rx1), ay = warp_sum(w0 * ry0 + w1 * ry1),
              az = warp_sum(w0 * rz0 + w1 * rz1);
  return make_float3(x + ax / wsum, y + ay / wsum, z + az / wsum);
}

// The most payload channels the one-shot kernels carry (rows 4 and 12; the
// wrappers route a wider payload to the plain versions).
#define PAYLOAD_MAX 8

// A query's weighted payload sums after its head, the one definition that
// the tail and both one-shot kernels share: for c < Cp, lane 0 writes
// sum_slots w x_c / wsum to dst[c] (w, wsum: head_weight's slot weight and
// their warp sum; dst null: no store, for a pad query).  value(c) reads
// slot `lane`'s channel c from device memory; it is called for an active
// slot only (an inactive one weighs 0).  Where a query's guard is a
// branch the compiler cannot see is warp-uniform, call it outside the
// branch with dst null: the flat one-shot kernel ran 13% slower with these
// shuffles under its `q < N` test, 1-2% slower without (on an H100).
template <class Value>
__device__ __forceinline__ void payload_sums(float w, float wsum, bool active, int Cp,
                                             const Value& value, float* dst) {
  for (int c = 0; c < Cp; ++c) {
    const float v = warp_sum(w * (active ? value(c) : 0.f));
    if ((threadIdx.x & 31) == 0 && dst) dst[c] = v / wsum;
  }
}

// payload_sums over two slots a lane (head_weight2): value(c, h) reads
// channel c of slot 32 h + lane, for an active slot only.
template <class Value>
__device__ __forceinline__ void payload_sums2(float w0, float w1, float wsum, bool act0,
                                              bool act1, int Cp, const Value& value,
                                              float* dst) {
  for (int c = 0; c < Cp; ++c) {
    const float v = warp_sum(w0 * (act0 ? value(c, 0) : 0.f) + w1 * (act1 ? value(c, 1) : 0.f));
    if ((threadIdx.x & 31) == 0 && dst) dst[c] = v / wsum;
  }
}

// ---- up to 128 slots, four a lane -----------------------------------------

// Slots 32 h + lane (h < 4, residual x[h] y[h] z[h]) of one query, k <=
// 128: the same score_tile over `tiles` 16-slot tiles (1 to 8, one loop;
// tile mt reads quarter mt / 2, selected by warp-uniform compares so that
// the slots stay in registers), then the softmax over all four at once (the
// max of every active slot first, so no partial sum is rescaled).  w[h]:
// slot 32 h + lane's weight before normalisation, 0 for an inactive slot.
__device__ __forceinline__ void head_weight4(const float* sw, const float (&x)[4],
                                             const float (&y)[4], const float (&z)[4],
                                             const bool (&act)[4], int tiles, float (&w)[4]) {
  const int lane = threadIdx.x & 31, src = (lane & 7) * 4;
  float nr[4], s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 4; ++h) nr[h] = sqrtf(x[h] * x[h] + y[h] * y[h] + z[h] * z[h] + 1e-12f);
#pragma unroll 1
  for (int mt = 0; mt < tiles; ++mt) {
    const int h = mt >> 1;
    const float rx = h == 0 ? x[0] : h == 1 ? x[1] : h == 2 ? x[2] : x[3];
    const float ry = h == 0 ? y[0] : h == 1 ? y[1] : h == 2 ? y[2] : y[3];
    const float rz = h == 0 ? z[0] : h == 1 ? z[1] : h == 2 ? z[2] : z[3];
    const float rn = h == 0 ? nr[0] : h == 1 ? nr[1] : h == 2 ? nr[2] : nr[3];
    float lo, up;
    score_tile(sw, rx, ry, rz, rn, mt & 1, lo, up);
    // slot 16 (mt & 1) + r of the quarter sits on lane 4 (r % 8), lo for r < 8
    const float a = __shfl_sync(FULL, lo, src), b = __shfl_sync(FULL, up, src);
    if ((lane >> 4) == (mt & 1)) {
      const float v = (lane & 8) ? b : a;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q == h) s[q] = v;
    }
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int h = 0; h < 4; ++h) m = fmaxf(m, act[h] ? s[h] : -CUDART_INF_F);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
#pragma unroll
  for (int h = 0; h < 4; ++h) w[h] = act[h] ? expf(s[h] - m) : 0.f;
}

// The fused row of one query over up to 128 slots (head_weight4): q + sum
// w r / sum w on every lane; w and wsum return the lane's four slot weights
// and the weights' sum, for payload_sums4.
__device__ __forceinline__ float3 fused_row4(const float* sw, float qx, float qy, float qz,
                                             const float (&x)[4], const float (&y)[4],
                                             const float (&z)[4], const bool (&act)[4],
                                             int tiles, float (&w)[4], float& wsum) {
  head_weight4(sw, x, y, z, act, tiles, w);
  float sw_ = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    sw_ += w[h];
    ax += w[h] * x[h];
    ay += w[h] * y[h];
    az += w[h] * z[h];
  }
  wsum = warp_sum(sw_);
  ax = warp_sum(ax), ay = warp_sum(ay), az = warp_sum(az);
  return make_float3(qx + ax / wsum, qy + ay / wsum, qz + az / wsum);
}

// payload_sums over four slots a lane (head_weight4): value(c, h) reads
// channel c of slot 32 h + lane, for an active slot only.
template <class Value>
__device__ __forceinline__ void payload_sums4(const float (&w)[4], float wsum,
                                              const bool (&act)[4], int Cp, const Value& value,
                                              float* dst) {
  for (int c = 0; c < Cp; ++c) {
    float v = 0.f;
#pragma unroll
    for (int h = 0; h < 4; ++h) v += w[h] * (act[h] ? value(c, h) : 0.f);
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && dst) dst[c] = v / wsum;
  }
}
