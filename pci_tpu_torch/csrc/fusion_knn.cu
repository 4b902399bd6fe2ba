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
// What bounds it on the H100: 16,384 x 16,384 distances (2.7e8 pairs,
// ~2.1 GFLOP of scalar work) and the score MLP (16,384 x 32 slots x 12.3k
// multiply-adds, ~13 GFLOP, ~39 GFLOP of TF32 products split three ways),
// against 0.2 MB of input: operations.  The key scan is latency-bound
// (shared loads, a compare and a ballot per 32 keys); the head is dense.
// The design:
//   - persistent blocks, one an SM (16 warps, two queries each, so a group
//     of 32 queries a turn): each block copies the split score MLP (101 KB,
//     _build.pack_tf32(chain=True)) into shared memory once and keeps it
//     for every group it walks, instead of each of 2,048 blocks reading
//     51 KB again;
//   - the scan (oneshot_slots) is budgeted_slot's: lane L keeps entry L of
//     two sorted top-k lists a query in registers, every lane tests one key
//     against its segment's k-th distance, the few keys that pass (about
//     k ln(N / k) a query) are inserted by a ballot and a shuffle, so the
//     same slots, rounding and ties; it is latency-bound, so a warp scans
//     two queries and four 32-key chunks at once (independent loads, math
//     and ballots in flight), and holds few registers (16 warps an SM; the
//     old kernel's 180 registers a thread allowed 8); the key tiles (2,048
//     keys) are double-buffered by cp.async, the next tile loading while
//     the warps scan this one;
//   - the head (fusion_head.cuh:score_tile, shared with the cell-pruned
//     kernel csrc/fusion_cells.cu) runs on the tensor cores in 3xTF32
//     (csrc/mma_tf32.cuh): each warp's 32 slots are two 16-row tiles, the
//     residual rows built in registers by shuffles, every layer's output
//     kept as accumulator fragments that are the next layer's A operand
//     (the weights laid out for that), the last layer in four 32-output
//     chunks with a running max over channels, so no [32, 128] block and
//     no shared memory for activations; the softmax over the k slots is a
//     warp max and a warp sum as before.  The [N, k, 3] residual block
//     never exists.
// The scan and the head of one block alternate (a two-phase block); the
// other SMs' blocks and the 16 warps of each keep both units busy.
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
#include "fusion_head.cuh"

#define FUS_TILE 2048

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

// ---- the one-shot kernel --------------------------------------------------

#define ONE_WARPS 16    // warps a block
#define ONE_QW 2        // queries a warp scans together
#define ONE_TILE 2048   // keys a tile; two tiles in flight

// Copies keys [t0, t0 + tn) of P (xyz interleaved) into the tile buffer
// `dst` as one cp.async group, 16 bytes a copy where the rows allow it.
__device__ __forceinline__ void stage_keys(const float* __restrict__ P, int t0, int tn,
                                           float* dst) {
  const float* src = P + (size_t)t0 * 3;
  const int n = tn * 3;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = 4 * n4 + threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// budgeted_slot's two-segment scan (segment A = [0, n1), B = [n1, N),
// budgets cap0 and cap1 <= 32 - cap0) for QW queries a warp, over the key
// tiles of the one-shot kernel: the block streams the keys through two
// tile buffers (`keys`, 2 x ONE_TILE xyz rows) by cp.async, the next tile
// loading while every warp scans the current one.  For each query, the same
// tests, the same insertions in the same order as budgeted_slot: the same
// slots.  idx[i] is the key index of query i's slot `lane`, -1 for an
// unfilled slot.
template <int QW>
__device__ __forceinline__ void oneshot_slots(const float* __restrict__ P, int N, int n1,
                                              int cap0, int cap1, const float (&qx)[QW],
                                              const float (&qy)[QW], const float (&qz)[QW],
                                              float* keys, int lane, int (&idx)[QW]) {
  float dA[QW], dB[QW], thrA[QW], thrB[QW];
  int iA[QW], iB[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    dA[i] = dB[i] = CUDART_INF_F;
    iA[i] = iB[i] = -1;
    thrA[i] = cap0 > 0 ? CUDART_INF_F : -CUDART_INF_F;
    thrB[i] = cap1 > 0 ? CUDART_INF_F : -CUDART_INF_F;
  }
  const int tiles = (N + ONE_TILE - 1) / ONE_TILE;
  stage_keys(P, 0, min(ONE_TILE, N), keys);
  for (int ti = 0; ti < tiles; ++ti) {
    const int t0 = ti * ONE_TILE, tn = min(ONE_TILE, N - t0);
    if (ti + 1 < tiles)
      stage_keys(P, t0 + ONE_TILE, min(ONE_TILE, N - t0 - ONE_TILE),
                 keys + ((ti + 1) & 1) * 3 * ONE_TILE);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile ti is in for every thread
    const float* kt = keys + (ti & 1) * 3 * ONE_TILE;
    // four 32-key chunks' distances for every query at once (independent
    // loads and math), then each chunk's test and inserts, query by query,
    // against the thresholds as the chunks before it left them
    for (int base = 0; base < tn; base += 128) {
      float d[QW][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jl = base + 32 * u + lane;
        const bool in = jl < tn;
        const float kx = in ? kt[3 * jl] : 0.f, ky = in ? kt[3 * jl + 1] : 0.f,
                    kz = in ? kt[3 * jl + 2] : 0.f;
#pragma unroll
        for (int i = 0; i < QW; ++i)
          d[i][u] = in ? sqdist3(kx, ky, kz, qx[i], qy[i], qz[i]) : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = t0 + base + 32 * u + lane;
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          const float th = j < n1 ? thrA[i] : (j < N ? thrB[i] : -CUDART_INF_F);
          unsigned mask = __ballot_sync(FULL, d[i][u] < th);
          while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const float dn = __shfl_sync(FULL, d[i][u], src);
            const int jn = t0 + base + 32 * u + src;
            if (jn < n1) list_insert(dA[i], iA[i], thrA[i], cap0, dn, jn, lane);  // warp-uniform
            else list_insert(dB[i], iB[i], thrB[i], cap1, dn, jn, lane);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the buffer the next copy reuses
  }
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int vB = __shfl_sync(FULL, iB[i], min(max(lane - cap0, 0), 31));
    idx[i] = lane < cap0 ? iA[i] : (lane < cap0 + cap1 ? vB : -1);
  }
}

// Persistent: each block loads the split score MLP into shared memory
// once, then walks groups of ONE_WARPS x ONE_QW queries (group =
// blockIdx.x, + gridDim.x, ...; a group's queries all in one batch row):
// the block's warps scan the keys together, ONE_QW queries a warp (their
// scans interleaved, for independent work while a load or a ballot is in
// flight), then each warp runs its queries' heads on the tensor cores.
__global__ void __launch_bounds__(ONE_WARPS * 32, 1)
fusion_kernel(const float* __restrict__ pts, const int* __restrict__ seg,
              const float* __restrict__ wtc, float* __restrict__ out, int B, int N) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* keys = sw + ONE_NW;  // 2 x ONE_TILE x 3
  for (int e = threadIdx.x; e < ONE_NW / 4; e += blockDim.x)
    smem4[e] = reinterpret_cast<const float4*>(wtc)[e];
  // (the first tile's __syncthreads orders these stores before any read)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int G = ONE_WARPS * ONE_QW;  // queries a group
  const int per_row = (N + G - 1) / G;
  for (int grp = blockIdx.x; grp < B * per_row; grp += gridDim.x) {
    const int b = grp / per_row;
    const int q0 = (grp - b * per_row) * G + warp;  // queries q0 + i ONE_WARPS
    const float* P = pts + (size_t)b * N * 3;
    const int n1 = seg[b * 4 + 0];
    const int cap0 = max(0, min(seg[b * 4 + 2], 32));
    const int cap1 = max(0, min(seg[b * 4 + 3], 32 - cap0));
    float qx[ONE_QW], qy[ONE_QW], qz[ONE_QW];
    int idx[ONE_QW];
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      const int qq = min(q0 + i * ONE_WARPS, N - 1);
      qx[i] = P[qq * 3], qy[i] = P[qq * 3 + 1], qz[i] = P[qq * 3 + 2];
    }
    oneshot_slots<ONE_QW>(P, N, max(n1, 0), cap0, cap1, qx, qy, qz, keys, lane, idx);

#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      // slot `lane`: [0, cap0) from segment A, [cap0, cap0 + cap1) from B
      const bool active = lane < cap0 + cap1;
      const int j = idx[i];
      float rx = 0.f, ry = 0.f, rz = 0.f;
      if (active && j >= 0) {
        rx = P[(size_t)j * 3] - qx[i];
        ry = P[(size_t)j * 3 + 1] - qy[i];
        rz = P[(size_t)j * 3 + 2] - qz[i];
      }
      const float3 o = fused_row(sw, qx[i], qy[i], qz[i], rx, ry, rz, active);
      const int q = q0 + i * ONE_WARPS;
      if (lane == 0 && q < N) {
        float* dst = out + ((size_t)b * N + q) * 3;
        dst[0] = o.x;
        dst[1] = o.y;
        dst[2] = o.z;
      }
    }
  }
}

static size_t oneshot_smem() { return sizeof(float) * (ONE_NW + 2 * 3 * ONE_TILE); }

// seg: device int32 [B, 4] = (N1, N, k1, k2) per batch.  wtc: the score MLP
// (4 -> h1 -> h2 -> h3) split by _build.pack_tf32(..., chain=True).
// k1 + k2 <= 32.  A grid of one block an SM (at most one a group).
extern "C" int pci_fusion(const void* pts, const void* seg, const void* wtc,
                          int h1, int h2, int h3, void* out, int B, int N,
                          void* stream) {
  if (h1 != ONE_H1 || h2 != ONE_H2 || h3 != ONE_H3 || N < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = oneshot_smem();
  cudaError_t e = allow_smem(fusion_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fusion_kernel, ONE_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (long long)B * ((N + ONE_WARPS * ONE_QW - 1) / (ONE_WARPS * ONE_QW));
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, groups));
  fusion_kernel<<<grid, ONE_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(seg),
      static_cast<const float*>(wtc), static_cast<float*>(out), B, N);
  return (int)cudaGetLastError();
}

// The one-shot kernel's resources (common.cuh's kernel_attrs).
extern "C" int pci_fusion_attrs(int* out) {
  return kernel_attrs(fusion_kernel, oneshot_smem(), out, ONE_WARPS * 32);
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
