// The fusion's budgeted two-segment self-kNN over a Morton-sorted, chunked
// cloud, scanning only the chunks that can hold a neighbour; one-shot mode
// adds the attention head (the fused rows), residual mode writes idx and
// resi.
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_cells_tpu.py:knn_fusion_cells
// (and knn_fusion_cells_grad's forward), the JAX package's fusion route at
// N >= 32,768 points.  The function is the one of csrc/fusion_knn.cu: each
// query takes its exact k1 nearest keys in segment A = rows [0, N1) and its
// exact k2 nearest in B = rows [N1, N), ties to the lower combined-cloud
// index, slots [0, k1) from A and [k1, k1 + k2) from B; a slot its segment
// cannot fill is a zero residual (the row itself).  The TPU kernel is an
// approximation (it scans the M best chunks by box bound and keeps
// `winners` packed-key minima a bucket); this one prunes only chunks that
// provably hold no neighbour, so it gives the flat kernel's neighbours.
//
// What bounds it on the H100: at 65,536 points the flat scan is 4.3e9
// pairs; here each query reads about ten chunk boxes and scans the few
// chunks whose box bound does not exceed its current k_s-th distance (a
// few thousand pairs), so the one-shot mode's score MLP (65,536 x 32 slots
// x 12.3k FMA, ~52 GFLOP) dominates: operations.  Design: outside the
// kernel (torch) the cloud is Morton-sorted and cut into chunks of C keys
// with a box a segment, and for each tile of TQ consecutive sorted queries
// the chunks are ordered by the tile's box bound min(lbA, lbB).  Here one
// warp takes one sorted query (lane L owns list entry L, k <= 32) and walks
// its tile's chunk order with no block-wide synchronisation: it stops when
// the tile bound exceeds every current k_s-th distance (with a margin for
// the torch bound's rounding), skips a chunk whose per-segment box bound,
// computed with round-down arithmetic and so never above the rounded
// distance of any key in the box, exceeds that segment's k_s-th (distance,
// index), and otherwise scans its keys 32 at a time.  Keys arrive out of
// index order, so the insert orders by (distance, index) itself.  Each
// query writes its own original row: no un-permute pass.
#include "fusion_head.cuh"
#include "cells.cuh"

struct CellsParams {
  const float* pts;     // combined [B][N][3], original order
  const float* sk;      // sorted keys [B][3][Np] (x row, y row, z row)
  const int* sid;       // sorted keys' original ids [B][Np] (pads: N)
  const float4* boxes;  // [B][nc][4]: lo A, hi A, lo B, hi B (xyz, pad)
  const int* order;     // [B][nt][nc] chunk ids by ascending tile bound
  const float* lbs;     // [B][nt][nc] those bounds
  const int* seg;       // [B][4] = (N1, N, k1, k2)
  const float* wbuf;    // the packed score MLP (one-shot mode), or null
  float* out;           // one-shot: fused [B][N][3]
  long long* out_i;     // residual: idx [B][N][k]
  float* out_r;         // residual: resi [B][N][k][3]
  unsigned long long* scanned;  // pairs scanned, or null
  int N, Np, C, TQ, nc, nt, k;
};

// The budgeted kNN of sorted query s of batch row b (one warp): returns the
// original index for slot `lane`, -1 for a slot its segment cannot fill or
// past the budgets.
__device__ __forceinline__ int cells_slot(const CellsParams& p, int b, int s,
                                          float qx, float qy, float qz,
                                          int N1, int k1, int k2, int lane) {
  float dA = CUDART_INF_F, dB = CUDART_INF_F;
  int iA = CELL_EMPTY, iB = CELL_EMPTY;
  float thdA = k1 > 0 ? CUDART_INF_F : -CUDART_INF_F;
  float thdB = k2 > 0 ? CUDART_INF_F : -CUDART_INF_F;
  int thiA = CELL_EMPTY, thiB = CELL_EMPTY;
  const size_t tile = (size_t)b * p.nt + s / p.TQ;
  const int* ord = p.order + tile * p.nc;
  const float* lbt = p.lbs + tile * p.nc;
  const float* X = p.sk + (size_t)b * 3 * p.Np;
  const float* Y = X + p.Np;
  const float* Z = Y + p.Np;
  const int* ID = p.sid + (size_t)b * p.Np;
  const float4* BX = p.boxes + (size_t)b * p.nc * 4;
  const int N = p.N;
  unsigned long long nscan = 0;
  for (int m = 0; m < p.nc; ++m) {
    // every later chunk's tile bound is at least this one's; the margin
    // covers the torch bound's round-to-nearest against round-down here
    const float T = fmaxf(thdA, thdB);
    if (lbt[m] > T * 1.00001f + 1e-30f) break;
    const int c = ord[m];
    const float4 loA = BX[c * 4], hiA = BX[c * 4 + 1];
    const float4 loB = BX[c * 4 + 2], hiB = BX[c * 4 + 3];
    const bool needA = k1 > 0 && loA.x <= hiA.x &&
                       box_bound_rd(loA, hiA, qx, qy, qz) <= thdA;
    const bool needB = k2 > 0 && loB.x <= hiB.x &&
                       box_bound_rd(loB, hiB, qx, qy, qz) <= thdB;
    if (!needA && !needB) continue;
    nscan += p.C;
    for (int base = c * p.C; base < (c + 1) * p.C; base += 32) {
      const int j = base + lane;
      const float d = sqdist3(X[j], Y[j], Z[j], qx, qy, qz);
      const int id = ID[j];
      const bool pass = id < N1 ? needA && lex_less(d, id, thdA, thiA)
                                : id < N && needB && lex_less(d, id, thdB, thiB);
      unsigned mask = __ballot_sync(FULL, pass);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float dn = __shfl_sync(FULL, d, src);
        const int jn = __shfl_sync(FULL, id, src);
        if (jn < N1) lex_insert(dA, iA, thdA, thiA, k1, dn, jn, lane);
        else lex_insert(dB, iB, thdB, thiB, k2, dn, jn, lane);
      }
    }
  }
  if (p.scanned && lane == 0) atomicAdd(p.scanned, nscan);
  const int vB = __shfl_sync(FULL, iB, max(lane - k1, 0));
  int idx = -1;
  if (lane < k1) idx = iA;
  else if (lane < k1 + k2) idx = vB;
  return idx == CELL_EMPTY ? -1 : idx;
}

template <bool ONESHOT>
__global__ void __launch_bounds__(256) fusion_cells_kernel(const __grid_constant__ CellsParams p) {
  constexpr int NW = ScoreMlp<64, 64, 128>::NW;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  if (ONESHOT) {
    for (int e = threadIdx.x; e < NW; e += blockDim.x) sw[e] = p.wbuf[e];
    __syncthreads();
  }
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= p.Np) return;  // warp-uniform; no block barrier follows
  const int q = p.sid[(size_t)b * p.Np + s];
  if (q >= p.N) return;  // a pad row
  const float* P = p.pts + (size_t)b * p.N * 3;
  const int N1 = p.seg[b * 4];
  const int k1 = min(p.seg[b * 4 + 2], 32);
  const int k2 = min(p.seg[b * 4 + 3], 32 - k1);
  const float qx = P[q * 3], qy = P[q * 3 + 1], qz = P[q * 3 + 2];
  const int idx = cells_slot(p, b, s, qx, qy, qz, N1, k1, k2, lane);
  if (ONESHOT) {
    // the head of csrc/fusion_knn.cu's one-shot kernel, slot for slot
    const bool active = lane < k1 + k2;
    float rx = 0.f, ry = 0.f, rz = 0.f;
    if (active && idx >= 0) {
      rx = P[(size_t)idx * 3] - qx;
      ry = P[(size_t)idx * 3 + 1] - qy;
      rz = P[(size_t)idx * 3 + 2] - qz;
    }
    const float w = slot_weight(slot_score<64, 64, 128>(rx, ry, rz, sw), active);
    const float sw_ = warp_sum(w), ax = warp_sum(w * rx), ay = warp_sum(w * ry),
                az = warp_sum(w * rz);
    if (lane == 0) {
      float* o = p.out + ((size_t)b * p.N + q) * 3;
      o[0] = qx + ax / sw_;
      o[1] = qy + ay / sw_;
      o[2] = qz + az / sw_;
    }
  } else if (lane < p.k) {
    const int j = idx >= 0 ? idx : q;  // unfilled slot: the row itself
    const size_t o = ((size_t)b * p.N + q) * p.k + lane;
    p.out_i[o] = j;
    p.out_r[o * 3] = __fsub_rn(P[(size_t)j * 3], qx);
    p.out_r[o * 3 + 1] = __fsub_rn(P[(size_t)j * 3 + 1], qy);
    p.out_r[o * 3 + 2] = __fsub_rn(P[(size_t)j * 3 + 2], qz);
  }
}

// pts [B, N, 3]; sk [B, 3, Np], sid [B, Np], boxes [B, nc, 4, 4], order and
// lbs [B, Np / TQ, nc] (nc = Np / C), seg [B, 4] = (N1, N, k1, k2), all on
// the device.  One-shot mode when wbuf is not null (the packed score MLP
// 4 -> h1 -> h2 -> h3): out [B, N, 3]; else out_i [B, N, k] int64 and out_r
// [B, N, k, 3].  scanned: an unsigned 64-bit counter of the key pairs
// scanned, or null.
extern "C" int pci_fusion_cells(const void* pts, const void* sk, const void* sid,
                                const void* boxes, const void* order,
                                const void* lbs, const void* seg,
                                const void* wbuf, int h1, int h2, int h3,
                                void* out, void* out_i, void* out_r,
                                void* scanned, int B, int N, int Np, int C,
                                int TQ, int k, void* stream) {
  if (N < 1 || Np < N || C < 32 || C % 32 || Np % C || TQ < 1 || Np % TQ ||
      k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  if (wbuf && (h1 != 64 || h2 != 64 || h3 != 128)) return (int)cudaErrorInvalidValue;
  CellsParams p;
  p.pts = static_cast<const float*>(pts);
  p.sk = static_cast<const float*>(sk);
  p.sid = static_cast<const int*>(sid);
  p.boxes = static_cast<const float4*>(boxes);
  p.order = static_cast<const int*>(order);
  p.lbs = static_cast<const float*>(lbs);
  p.seg = static_cast<const int*>(seg);
  p.wbuf = static_cast<const float*>(wbuf);
  p.out = static_cast<float*>(out);
  p.out_i = static_cast<long long*>(out_i);
  p.out_r = static_cast<float*>(out_r);
  p.scanned = static_cast<unsigned long long*>(scanned);
  p.N = N, p.Np = Np, p.C = C, p.TQ = TQ, p.nc = Np / C, p.nt = Np / TQ, p.k = k;
  const int warps = 8;
  dim3 grid((Np + warps - 1) / warps, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wbuf) {
    const size_t smem = sizeof(float) * ScoreMlp<64, 64, 128>::NW;
    cudaError_t e = allow_smem(fusion_cells_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    fusion_cells_kernel<true><<<grid, warps * 32, smem, st>>>(p);
  } else {
    fusion_cells_kernel<false><<<grid, warps * 32, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
