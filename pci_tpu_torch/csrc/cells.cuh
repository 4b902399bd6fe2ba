// The scan rules shared by the cell-pruned kernels (csrc/fusion_cells.cu,
// csrc/knn_cells.cu): a neighbour list ordered by (distance, index), one
// entry a lane, and the round-down bound of a query's distance to a box.
#pragma once

#include "common.cuh"

#ifndef FULL
#define FULL 0xffffffffu
#endif
#define CELL_EMPTY 0x7fffffff

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// dL/iL: entry `lane` of a list sorted by (distance, index), entries past
// `cap` empty; (thd, thi) is entry cap - 1, the bar a key must pass.
__device__ __forceinline__ void lex_insert(float& dL, int& iL, float& thd,
                                           int& thi, int cap, float dn, int jn,
                                           int lane) {
  if (!lex_less(dn, jn, thd, thi)) return;  // warp-uniform
  const int p = __popc(__ballot_sync(FULL, lex_less(dL, iL, dn, jn)));
  const float du = __shfl_up_sync(FULL, dL, 1);
  const int iu = __shfl_up_sync(FULL, iL, 1);
  if (lane > p) {
    dL = du;
    iL = iu;
  } else if (lane == p) {
    dL = dn;
    iL = jn;
  }
  if (lane >= cap) {
    dL = CUDART_INF_F;
    iL = CELL_EMPTY;
  }
  thd = __shfl_sync(FULL, dL, cap - 1);
  thi = __shfl_sync(FULL, iL, cap - 1);
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
