// One-shot attentive fusion: budgeted two-segment self-kNN of the combined
// cloud + score MLP over [resi | safe-norm] + max over channels + softmax
// over the k slots + combined + sum(w * resi).
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:knn_fusion_attention
// (its one-shot route, _fusion_impl with n_tail > 0 and no payload).  The
// function it ports is the exact XLA route of pci_tpu/nn/fusion.py:426-440
// (knn_prefix per segment + _prefix_merge + the attention tail), not the
// TPU kernel's bucketed approximation: each query takes its exact k1
// nearest keys in [0, N1) and its exact k2 nearest in [N1, N), ties to the
// lower index.  A segment with fewer keys than its budget leaves slots
// empty; they become zero residuals (a self-neighbour), as on the TPU.
//
// What bounds it on the H100: 16,384 x 16,384 distances (2.7e8, ~2.1 GFLOP)
// and the score MLP (16,384 x 32 slots x 12.3k FMA, ~13 GFLOP), against
// 0.2 MB of input: operations, not bytes.  The design: one warp a query,
// k <= 32 so lane L owns slot L.  Each lane keeps entry L of two sorted
// top-k lists (one per segment) in registers; the block streams the keys
// through shared memory in tiles, every lane tests one key against the
// list's current k-th distance, and the few keys that pass (about
// k * ln(N / k) per query) are inserted by one ballot + shuffle-up each.
// Then lane L runs the score MLP for its own slot with the folded weights
// (51 KB) in shared memory and the activations in registers, and the
// softmax over k is a warp max and a warp sum: the [N, k, 3] residual block
// never exists.
//
// The same file holds the training route's kernel, fusion_resi_kernel: it
// replaces fusion_knn_tpu.py:knn_fusion_adaptive / knn_fusion_multi
// (_fusion_core, the residual-emitting call with the fixed-neighbour VJP)
// by the same budgeted extraction (budgeted_slot) over F <= 4 segments,
// writing idx [B, N, k] and resi = neighbour - row [B, N, k, 3]; a slot its
// segment cannot fill holds the row itself (zero residual).  Its backward
// is a scatter-add of the residual gradient, outside any kernel, as in the
// JAX package.  Bound: the 16,000^2 distances a cloud (8 flops each), so
// operations; the extraction costs the same as in the one-shot kernel.
#include "common.cuh"

#define FUS_TILE 2048
#define FULL 0xffffffffu

__device__ __forceinline__ void list_insert(float& dL, int& iL, float& thr,
                                            int cap, float dn, int jn,
                                            int lane) {
  // dL/iL: entry `lane` of a list sorted by (distance, index); entries
  // past `cap` stay empty (inf).  Keys arrive in index order, so an equal
  // distance already listed keeps its place in front.
  if (!(dn < thr)) return;  // warp-uniform
  const int p = __popc(__ballot_sync(FULL, dL <= dn));
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
    iL = -1;
  }
  thr = __shfl_sync(FULL, dL, cap - 1);
}

// The budgeted F-segment self-kNN of one query, one warp a query: slots
// [cum_f, cum_f + cap_f) hold segment f's cap_f nearest keys in ascending
// (distance, index) order, segment f being rows [ends[f-1], ends[f]) and
// cap_f its budget (clipped so the slots fit in the warp).  Each lane keeps
// entry `lane` of one sorted list a segment in registers; the block streams
// the keys through the shared tiles tx/ty/tz (every warp of the block takes
// part, so all of them call this), every lane tests one key against its
// segment's current cap-th distance, and the few keys that pass are
// inserted by list_insert.  Returns the key index of slot `lane`, -1 for a
// slot its segment could not fill (fewer keys than budget) or past the
// budgets.
template <int FM>
__device__ __forceinline__ int budgeted_slot(const float* __restrict__ P,
                                             int N, const int (&ends)[FM],
                                             const int (&buds)[FM], int F,
                                             float qx, float qy, float qz,
                                             float* tx, float* ty, float* tz,
                                             int lane) {
  float dL[FM], thr[FM];
  int iL[FM], cap[FM], cum[FM], lo[FM];
  int used = 0, start = 0;
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    cap[f] = f < F ? max(0, min(buds[f], 32 - used)) : 0;
    cum[f] = used;
    used += cap[f];
    lo[f] = start;
    start = f < F ? max(start, ends[f]) : start;
    dL[f] = CUDART_INF_F;
    iL[f] = -1;
    thr[f] = cap[f] > 0 ? CUDART_INF_F : -CUDART_INF_F;
  }
  for (int t0 = 0; t0 < N; t0 += FUS_TILE) {
    const int tn = min(FUS_TILE, N - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < tn; e += blockDim.x) {
      tx[e] = P[(size_t)(t0 + e) * 3];
      ty[e] = P[(size_t)(t0 + e) * 3 + 1];
      tz[e] = P[(size_t)(t0 + e) * 3 + 2];
    }
    __syncthreads();
    for (int base = 0; base < tn; base += 32) {
      const int jl = base + lane;
      const int j = t0 + jl;
      float d = CUDART_INF_F, th = -CUDART_INF_F;
      if (jl < tn) d = sqdist3(tx[jl], ty[jl], tz[jl], qx, qy, qz);
#pragma unroll
      for (int f = 0; f < FM; ++f)
        if (f < F && j >= lo[f] && j < ends[f]) th = thr[f];
      unsigned mask = __ballot_sync(FULL, d < th);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float dn = __shfl_sync(FULL, d, src);
        const int jn = t0 + base + src;
#pragma unroll
        for (int f = 0; f < FM; ++f)  // one segment holds jn (warp-uniform)
          if (f < F && jn >= lo[f] && jn < ends[f])
            list_insert(dL[f], iL[f], thr[f], cap[f], dn, jn, lane);
      }
    }
  }
  int idx = -1;
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    const int v = __shfl_sync(FULL, iL[f], min(max(lane - cum[f], 0), 31));
    if (lane >= cum[f] && lane < cum[f] + cap[f]) idx = v;
  }
  return idx;
}

template <int H1, int H2, int H3>
__global__ void __launch_bounds__(256)
fusion_kernel(const float* __restrict__ pts, const int* __restrict__ seg,
              const float* __restrict__ wbuf, float* __restrict__ out, int N) {
  constexpr int NW = 4 * H1 + H1 + H1 * H2 + H2 + H2 * H3 + H3;
  constexpr int W1 = 0, B1 = W1 + 4 * H1, W2 = B1 + H1, B2 = W2 + H1 * H2,
                W3 = B2 + H2, B3 = W3 + H2 * H3;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* tx = sw + ((NW + 3) / 4) * 4;
  float* ty = tx + FUS_TILE;
  float* tz = ty + FUS_TILE;
  for (int e = threadIdx.x; e < NW; e += blockDim.x) sw[e] = wbuf[e];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  const int qq = min(q, N - 1);
  const float* P = pts + (size_t)b * N * 3;
  const int ends[2] = {seg[b * 4 + 0], seg[b * 4 + 1]};
  const int buds[2] = {seg[b * 4 + 2], seg[b * 4 + 3]};
  const int k1 = min(buds[0], 32);
  const int k2 = min(buds[1], 32 - k1);
  const float qx = P[qq * 3], qy = P[qq * 3 + 1], qz = P[qq * 3 + 2];
  const int idx = budgeted_slot<2>(P, N, ends, buds, 2, qx, qy, qz, tx, ty,
                                   tz, lane);

  // slot `lane`: [0, k1) from segment A, [k1, k1 + k2) from segment B
  const bool active = lane < k1 + k2;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  if (active && idx >= 0) {
    rx = P[(size_t)idx * 3] - qx;
    ry = P[(size_t)idx * 3 + 1] - qy;
    rz = P[(size_t)idx * 3 + 2] - qz;
  }
  __syncthreads();  // weights loaded (the tile loop may have run zero times)

  // score MLP for this lane's slot, activations in registers
  const float f3 = sqrtf(rx * rx + ry * ry + rz * rz + 1e-12f);
  float h1[H1];
#pragma unroll
  for (int o = 0; o < H1; ++o) {
    float v = sw[B1 + o];
    v = fmaf(rx, sw[W1 + 0 * H1 + o], v);
    v = fmaf(ry, sw[W1 + 1 * H1 + o], v);
    v = fmaf(rz, sw[W1 + 2 * H1 + o], v);
    v = fmaf(f3, sw[W1 + 3 * H1 + o], v);
    h1[o] = fmaxf(v, 0.f);
  }
  float h2[H2];
#pragma unroll
  for (int o = 0; o < H2; ++o) h2[o] = sw[B2 + o];
#pragma unroll
  for (int i = 0; i < H1; ++i) {
#pragma unroll
    for (int o = 0; o < H2; o += 4) {
      const float4 w = *reinterpret_cast<const float4*>(sw + W2 + i * H2 + o);
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
    float a0 = sw[B3 + o], a1 = sw[B3 + o + 1], a2 = sw[B3 + o + 2],
          a3 = sw[B3 + o + 3];
#pragma unroll
    for (int i = 0; i < H2; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(sw + W3 + i * H3 + o);
      a0 = fmaf(h2[i], w.x, a0);
      a1 = fmaf(h2[i], w.y, a1);
      a2 = fmaf(h2[i], w.z, a2);
      a3 = fmaf(h2[i], w.w, a3);
    }
    score = fmaxf(score, fmaxf(fmaxf(fmaxf(a0, 0.f), fmaxf(a1, 0.f)),
                               fmaxf(fmaxf(a2, 0.f), fmaxf(a3, 0.f))));
  }

  // softmax over the k slots, weighted residual sum
  float s = active ? score : -CUDART_INF_F;
  float m = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float w = active ? expf(s - m) : 0.f;
  float sw_ = w, ax = w * rx, ay = w * ry, az = w * rz;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sw_ += __shfl_xor_sync(FULL, sw_, off);
    ax += __shfl_xor_sync(FULL, ax, off);
    ay += __shfl_xor_sync(FULL, ay, off);
    az += __shfl_xor_sync(FULL, az, off);
  }
  if (lane == 0 && q < N) {
    float* o = out + ((size_t)b * N + q) * 3;
    o[0] = qx + ax / sw_;
    o[1] = qy + ay / sw_;
    o[2] = qz + az / sw_;
  }
}

// seg: device int32 [B, 4] = (N1, N, k1, k2) per batch.  wbuf: the packed
// score MLP (4 -> h1 -> h2 -> h3, common.cuh layout).  k1 + k2 <= 32.
extern "C" int pci_fusion(const void* pts, const void* seg, const void* wbuf,
                          int h1, int h2, int h3, void* out, int B, int N,
                          void* stream) {
  if (h1 != 64 || h2 != 64 || h3 != 128) return (int)cudaErrorInvalidValue;
  constexpr int NW = 4 * 64 + 64 + 64 * 64 + 64 + 64 * 128 + 128;
  const size_t smem = sizeof(float) * (((NW + 3) / 4) * 4 + 3 * FUS_TILE);
  cudaError_t e = allow_smem(fusion_kernel<64, 64, 128>, smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = 8;
  dim3 grid((N + warps - 1) / warps, B);
  fusion_kernel<64, 64, 128><<<grid, warps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(seg),
      static_cast<const float*>(wbuf), static_cast<float*>(out), N);
  return (int)cudaGetLastError();
}

template <int FM>
__global__ void __launch_bounds__(256)
fusion_resi_kernel(const float* __restrict__ pts, const int* __restrict__ ends_g,
                   const int* __restrict__ buds_g, int F,
                   long long* __restrict__ out_i, float* __restrict__ out_r,
                   int N, int k) {
  __shared__ float tx[FUS_TILE], ty[FUS_TILE], tz[FUS_TILE];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  const int qq = min(q, N - 1);
  const float* P = pts + (size_t)b * N * 3;
  int ends[FM], buds[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    ends[f] = f < F ? ends_g[b * F + f] : N;
    buds[f] = f < F ? buds_g[b * F + f] : 0;
  }
  const float qx = P[qq * 3], qy = P[qq * 3 + 1], qz = P[qq * 3 + 2];
  const int idx = budgeted_slot<FM>(P, N, ends, buds, F, qx, qy, qz, tx, ty,
                                    tz, lane);
  if (q < N && lane < k) {
    const int j = idx >= 0 ? idx : q;  // unfilled slot: the row itself
    const size_t o = ((size_t)b * N + q) * k + lane;
    out_i[o] = j;
    out_r[o * 3] = __fsub_rn(P[(size_t)j * 3], qx);
    out_r[o * 3 + 1] = __fsub_rn(P[(size_t)j * 3 + 1], qy);
    out_r[o * 3 + 2] = __fsub_rn(P[(size_t)j * 3 + 2], qz);
  }
}

// pts [B, N, 3] fp32; ends, buds: device int32 [B, F] (cumulative segment
// ends, the last == N; budgets summing to k) -> out_i [B, N, k] int64,
// out_r [B, N, k, 3] fp32.  1 <= F <= 4, 1 <= k <= 32.
extern "C" int pci_fusion_resi(const void* pts, const void* ends,
                               const void* buds, int F, void* out_i,
                               void* out_r, int B, int N, int k,
                               void* stream) {
  if (F < 1 || F > 4 || k < 1 || k > 32 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = 8;
  dim3 grid((N + warps - 1) / warps, B);
  const float* p = static_cast<const float*>(pts);
  const int* e = static_cast<const int*>(ends);
  const int* bu = static_cast<const int*>(buds);
  long long* oi = static_cast<long long*>(out_i);
  float* orr = static_cast<float*>(out_r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F <= 2)
    fusion_resi_kernel<2><<<grid, warps * 32, 0, st>>>(p, e, bu, F, oi, orr, N, k);
  else
    fusion_resi_kernel<4><<<grid, warps * 32, 0, st>>>(p, e, bu, F, oi, orr, N, k);
  return (int)cudaGetLastError();
}
