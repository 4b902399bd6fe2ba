// The scan rules shared by the cell-pruned kernels (csrc/fusion_cells.cu,
// csrc/knn_cells.cu): a query's neighbour list ordered by (distance,
// index) in one thread's registers, and the round-down bound of a query's
// distance to a box.
#pragma once

#include "common.cuh"

#ifndef FULL
#define FULL 0xffffffffu
#endif
#define CELL_EMPTY 0x7fffffff

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Insert (d, id) into the list (bd, bi), sorted by (distance, index): every
// entry compares at once (the comparisons are monotone in the entry), then
// each entry at or past the new one's place takes its left neighbour.
template <int KM>
__device__ __forceinline__ void list_insert(float (&bd)[KM], int (&bi)[KM], float d, int id) {
  bool lt[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) lt[i] = lex_less(d, id, bd[i], bi[i]);
#pragma unroll
  for (int i = KM - 1; i > 0; --i) {
    if (lt[i]) {
      bd[i] = lt[i - 1] ? bd[i - 1] : d;
      bi[i] = lt[i - 1] ? bi[i - 1] : id;
    }
  }
  if (lt[0]) {
    bd[0] = d;
    bi[0] = id;
  }
}

// Squared distance from (qx, qy, qz) to the box [lo, hi], every operation
// rounded down: by monotonicity of rounding it never exceeds sqdist3 of the
// query and any point in the box.
__device__ __forceinline__ float box_bound_rd(float4 lo, float4 hi, float qx,
                                              float qy, float qz) {
  const float gx = fmaxf(0.f, fmaxf(__fsub_rd(lo.x, qx), __fsub_rd(qx, hi.x)));
  const float gy = fmaxf(0.f, fmaxf(__fsub_rd(lo.y, qy), __fsub_rd(qy, hi.y)));
  const float gz = fmaxf(0.f, fmaxf(__fsub_rd(lo.z, qz), __fsub_rd(qz, hi.z)));
  return __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)),
                   __fmul_rd(gz, gz));
}
