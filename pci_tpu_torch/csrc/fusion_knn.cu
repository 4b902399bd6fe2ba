// One-shot attentive fusion: budgeted two-segment self-kNN of the combined
// cloud + score MLP over [resi | safe-norm] + max over channels + softmax
// over the k slots + combined + sum(w * resi), and for a payload (the
// intensity of PointsFusionWithFeatures) sum(w * payload of the slot).
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_knn_tpu.py:knn_fusion_attention
// (its one-shot route, _fusion_impl with n_tail > 0, with or without a
// payload).  The function it ports is the exact XLA route of
// pci_tpu/nn/fusion.py:426-440 and :519-535 (knn_prefix per segment +
// _prefix_merge + the attention tail), not the TPU kernel's bucketed
// approximation: each query takes its exact k1 nearest keys in [0, N1) and
// its exact k2 nearest in [N1, N), ties to the lower index.  A segment with
// fewer keys than its budget leaves slots empty; they become zero
// residuals and carry the query's own payload (a self-neighbour), as on
// the TPU.  The payload (PAYLOAD_MAX channels at most) is read after the
// head from device memory, one 4-byte load and one warp sum a slot and
// channel, beside the head's three MLP layers a slot.
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
//   - the scan (oneshot_slots): lane L keeps entry L of
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
// k <= 64 (PointINet2's ring fusions, pci_fusion64) is an instantiation of
// its own (S = 2), so that k <= 32 keeps its registers and time: each lane
// holds list entries L and 32 + L (list_insert2: two ballots, the shifts
// of both halves), and the head runs the same 16-slot tiles up to four
// times (fusion_head.cuh head_weight2), the softmax taken over both halves
// at once.  k <= 128 (pci_fusion128, the models' fusion_k past 64) is a
// kernel of its own, fusion_wide_kernel: four list entries a lane, the
// segments scanned one after another, the head over up to eight tiles
// (head_weight4); see "k <= 128" below.
//
// The same file holds the training route's kernel, fusion_resi_kernel: it
// replaces fusion_knn_tpu.py:knn_fusion_adaptive / knn_fusion_multi
// (_fusion_core, the residual-emitting call with the fixed-neighbour VJP)
// by the exact budgeted extraction over F <= 4 segments, writing idx [B,
// N, k] and resi = neighbour - row [B, N, k, 3]; a slot its segment cannot
// fill holds the row itself (zero residual).  Its backward is a
// scatter-add of the residual gradient, outside any kernel, as in the JAX
// package.  Bound: the N^2 distances a cloud (8 flops each), so
// operations; its design is set out above the kernel.  k <= 64 runs the
// KMAX = 64 instantiation (a 64-entry list for a segment's budget past 32,
// and shared-memory lists and slot rows sized for it); k <= 128 the
// warp-a-query fusion_resi_wide_kernel (why: "k <= 128" below).
#include "fusion_head.cuh"
#include "cells.cuh"

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

// list_insert for a list of up to 64 entries, two a lane: entry `lane` in
// (d0, i0) and entry 32 + lane in (d1, i1); `cap` <= 64.
__device__ __forceinline__ void list_insert2(float& d0, int& i0, float& d1, int& i1, float& thr,
                                             int cap, float dn, int jn, int lane) {
  if (!(dn < thr)) return;  // warp-uniform
  const int p = __popc(__ballot_sync(FULL, d0 <= dn)) + __popc(__ballot_sync(FULL, d1 <= dn));
  const float u0 = __shfl_up_sync(FULL, d0, 1), u1 = __shfl_up_sync(FULL, d1, 1);
  const int v0 = __shfl_up_sync(FULL, i0, 1), v1 = __shfl_up_sync(FULL, i1, 1);
  const float e31 = __shfl_sync(FULL, d0, 31);  // entry 31 moves to entry 32
  const int j31 = __shfl_sync(FULL, i0, 31);
  if (32 + lane > p) {
    d1 = lane ? u1 : e31;
    i1 = lane ? v1 : j31;
  } else if (32 + lane == p) {
    d1 = dn;
    i1 = jn;
  }
  if (lane > p) {
    d0 = u0;
    i0 = v0;
  } else if (lane == p) {
    d0 = dn;
    i0 = jn;
  }
  if (32 + lane >= cap) {
    d1 = CUDART_INF_F;
    i1 = -1;
  }
  if (lane >= cap) {
    d0 = CUDART_INF_F;
    i0 = -1;
  }
  thr = cap <= 32 ? __shfl_sync(FULL, d0, cap - 1) : __shfl_sync(FULL, d1, cap - 33);
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

// The budgeted two-segment scan (segment A = [0, n1), B = [n1, N),
// budgets cap0 and cap1 <= 32 S - cap0) for QW queries a warp, S list
// entries a lane: each lane keeps entries `lane` (and, for S = 2, 32 +
// lane) of a query's sorted A and B lists in registers, every lane tests
// one key against its segment's current cap-th distance, and the few keys
// that pass go in by list_insert (list_insert2).  The block streams the
// keys through two tile buffers (`keys`, 2 x ONE_TILE xyz rows) by
// cp.async, the next tile loading while every warp scans the current one.
// idx[i][h] is the key index of query i's slot 32 h + lane, -1 for an
// unfilled slot.
template <int QW, int S>
__device__ __forceinline__ void oneshot_slots(const float* __restrict__ P, int N, int n1,
                                              int cap0, int cap1, const float (&qx)[QW],
                                              const float (&qy)[QW], const float (&qz)[QW],
                                              float* keys, int lane, int (&idx)[QW][S]) {
  float dA[QW][S], dB[QW][S], thrA[QW], thrB[QW];
  int iA[QW][S], iB[QW][S];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
#pragma unroll
    for (int h = 0; h < S; ++h) {
      dA[i][h] = dB[i][h] = CUDART_INF_F;
      iA[i][h] = iB[i][h] = -1;
    }
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
            if constexpr (S == 1) {
              if (jn < n1) list_insert(dA[i][0], iA[i][0], thrA[i], cap0, dn, jn, lane);  // warp-uniform
              else list_insert(dB[i][0], iB[i][0], thrB[i], cap1, dn, jn, lane);
            } else {
              if (jn < n1)
                list_insert2(dA[i][0], iA[i][0], dA[i][1], iA[i][1], thrA[i], cap0, dn, jn, lane);
              else
                list_insert2(dB[i][0], iB[i][0], dB[i][1], iB[i][1], thrB[i], cap1, dn, jn, lane);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the buffer the next copy reuses
  }
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    if constexpr (S == 1) {
      const int vB = __shfl_sync(FULL, iB[i][0], min(max(lane - cap0, 0), 31));
      idx[i][0] = lane < cap0 ? iA[i][0] : (lane < cap0 + cap1 ? vB : -1);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // slot s = 32 h + lane: A's entry s, or B's entry s - cap0
        const int s = 32 * h + lane, e = s - cap0;
        const int b0 = __shfl_sync(FULL, iB[i][0], e & 31), b1 = __shfl_sync(FULL, iB[i][1], e & 31);
        idx[i][h] = s < cap0 ? iA[i][h] : (s < cap0 + cap1 ? (e >= 32 ? b1 : b0) : -1);
      }
    }
  }
}

// Persistent: each block loads the split score MLP into shared memory
// once, then walks groups of ONE_WARPS x ONE_QW queries (group =
// blockIdx.x, + gridDim.x, ...; a group's queries all in one batch row):
// the block's warps scan the keys together, ONE_QW queries a warp (their
// scans interleaved, for independent work while a load or a ballot is in
// flight), then each warp runs its queries' heads on the tensor cores and,
// in the PAY instantiation, after each head a payload's Cp weighted sums
// (payload_sums): slot `lane` reads its neighbour's channels, an unfilled
// active slot the query's own (the self-neighbour), from device memory.
// The xyz instantiation is the kernel without the payload code.  S = 1
// serves k <= 32 (lane L slot L); S = 2 serves k <= 64, lane L holding slots
// L and 32 + L, its head over up to four 16-slot tiles (head_weight2).
template <bool PAY, int S>
__global__ void __launch_bounds__(ONE_WARPS * 32, 1)
fusion_kernel(const float* __restrict__ pts, const int* __restrict__ seg,
              const float* __restrict__ wtc, const float* __restrict__ payload, int Cp,
              float* __restrict__ out, int B, int N) {
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
    const int cap0 = max(0, min(seg[b * 4 + 2], 32 * S));
    const int cap1 = max(0, min(seg[b * 4 + 3], 32 * S - cap0));
    float qx[ONE_QW], qy[ONE_QW], qz[ONE_QW];
    int idx[ONE_QW][S];
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      const int qq = min(q0 + i * ONE_WARPS, N - 1);
      qx[i] = P[qq * 3], qy[i] = P[qq * 3 + 1], qz[i] = P[qq * 3 + 2];
    }
    oneshot_slots<ONE_QW, S>(P, N, max(n1, 0), cap0, cap1, qx, qy, qz, keys, lane, idx);

#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      if constexpr (S == 1) {
        // slot `lane`: [0, cap0) from segment A, [cap0, cap0 + cap1) from B
        const bool active = lane < cap0 + cap1;
        const int j = idx[i][0];
        float rx = 0.f, ry = 0.f, rz = 0.f;
        if (active && j >= 0) {
          rx = P[(size_t)j * 3] - qx[i];
          ry = P[(size_t)j * 3 + 1] - qy[i];
          rz = P[(size_t)j * 3 + 2] - qz[i];
        }
        float w, wsum;
        const float3 o = fused_row(sw, qx[i], qy[i], qz[i], rx, ry, rz, active, w, wsum);
        const int q = q0 + i * ONE_WARPS;
        float* dst = out + ((size_t)b * N + q) * (PAY ? 3 + Cp : 3);
        if (lane == 0 && q < N) {
          dst[0] = o.x;
          dst[1] = o.y;
          dst[2] = o.z;
        }
        if constexpr (PAY) {  // a pad query (q >= N) reads row N - 1 and stores nothing
          const float* x = payload + ((size_t)b * N + (j >= 0 ? j : min(q, N - 1))) * Cp;
          payload_sums(w, wsum, active, Cp, [&](int c) { return __ldg(x + c); },
                       q < N ? dst + 3 : nullptr);
        }
      } else {
        // slots `lane` and 32 + lane, as above
        const int kk = cap0 + cap1;
        const bool act0 = lane < kk, act1 = 32 + lane < kk;
        const int j0 = idx[i][0], j1 = idx[i][1];
        float rx0 = 0.f, ry0 = 0.f, rz0 = 0.f, rx1 = 0.f, ry1 = 0.f, rz1 = 0.f;
        if (act0 && j0 >= 0) {
          rx0 = P[(size_t)j0 * 3] - qx[i];
          ry0 = P[(size_t)j0 * 3 + 1] - qy[i];
          rz0 = P[(size_t)j0 * 3 + 2] - qz[i];
        }
        if (act1 && j1 >= 0) {
          rx1 = P[(size_t)j1 * 3] - qx[i];
          ry1 = P[(size_t)j1 * 3 + 1] - qy[i];
          rz1 = P[(size_t)j1 * 3 + 2] - qz[i];
        }
        float w0, w1, wsum;
        const float3 o = fused_row2(sw, qx[i], qy[i], qz[i], rx0, ry0, rz0, rx1, ry1, rz1, act0,
                                    act1, max((kk + 15) / 16, 1), w0, w1, wsum);
        const int q = q0 + i * ONE_WARPS;
        float* dst = out + ((size_t)b * N + q) * (PAY ? 3 + Cp : 3);
        if (lane == 0 && q < N) {
          dst[0] = o.x;
          dst[1] = o.y;
          dst[2] = o.z;
        }
        if constexpr (PAY) {
          const size_t self = (size_t)b * N + min(q, N - 1);
          const float* x0 = payload + (j0 >= 0 ? (size_t)b * N + j0 : self) * Cp;
          const float* x1 = payload + (j1 >= 0 ? (size_t)b * N + j1 : self) * Cp;
          payload_sums2(w0, w1, wsum, act0, act1, Cp,
                        [&](int c, int h) { return __ldg((h ? x1 : x0) + c); },
                        q < N ? dst + 3 : nullptr);
        }
      }
    }
  }
}

static size_t oneshot_smem() { return sizeof(float) * (ONE_NW + 2 * 3 * ONE_TILE); }

template <int S>
static int fusion_launch(const void* pts, const void* seg, const void* wtc, int h1, int h2,
                         int h3, const void* payload, int Cp, void* out, int B, int N,
                         void* stream) {
  if (h1 != ONE_H1 || h2 != ONE_H2 || h3 != ONE_H3 || N < 1 || B < 1 || Cp < 0 ||
      Cp > PAYLOAD_MAX || (Cp > 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto kernel = Cp > 0 ? fusion_kernel<true, S> : fusion_kernel<false, S>;
  const size_t smem = oneshot_smem();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ONE_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (long long)B * ((N + ONE_WARPS * ONE_QW - 1) / (ONE_WARPS * ONE_QW));
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, groups));
  kernel<<<grid, ONE_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(seg),
      static_cast<const float*>(wtc), static_cast<const float*>(payload), Cp,
      static_cast<float*>(out), B, N);
  return (int)cudaGetLastError();
}

// seg: device int32 [B, 4] = (N1, N, k1, k2) per batch.  wtc: the score MLP
// (4 -> h1 -> h2 -> h3) split by _build.pack_tf32(..., chain=True).
// payload: [B, N, Cp] fp32, 0 <= Cp <= PAYLOAD_MAX (null for Cp == 0).  out
// [B, N, 3 + Cp].  k1 + k2 <= 32 (pci_fusion) or <= 64 (pci_fusion64, two
// slots a lane).  A grid of one block an SM (at most one a group).
extern "C" int pci_fusion(const void* pts, const void* seg, const void* wtc,
                          int h1, int h2, int h3, const void* payload, int Cp, void* out,
                          int B, int N, void* stream) {
  return fusion_launch<1>(pts, seg, wtc, h1, h2, h3, payload, Cp, out, B, N, stream);
}
extern "C" int pci_fusion64(const void* pts, const void* seg, const void* wtc,
                            int h1, int h2, int h3, const void* payload, int Cp, void* out,
                            int B, int N, void* stream) {
  return fusion_launch<2>(pts, seg, wtc, h1, h2, h3, payload, Cp, out, B, N, stream);
}

// The one-shot kernel's resources (common.cuh's kernel_attrs), without and
// with the payload, at k <= 32 and k <= 64.
extern "C" int pci_fusion_attrs(int* out) {
  return kernel_attrs(fusion_kernel<false, 1>, oneshot_smem(), out, ONE_WARPS * 32);
}
extern "C" int pci_fusion_payload_attrs(int* out) {
  return kernel_attrs(fusion_kernel<true, 1>, oneshot_smem(), out, ONE_WARPS * 32);
}
extern "C" int pci_fusion64_attrs(int* out) {
  return kernel_attrs(fusion_kernel<false, 2>, oneshot_smem(), out, ONE_WARPS * 32);
}
extern "C" int pci_fusion64_payload_attrs(int* out) {
  return kernel_attrs(fusion_kernel<true, 2>, oneshot_smem(), out, ONE_WARPS * 32);
}


// ---- k <= 128: four list entries a lane ------------------------------------
//
// Budgets past 64 (rows 4 and 4b at k in 65-128) take kernels of their own,
// so that the k <= 32 and k <= 64 instantiations above and below keep their
// code and registers.  Both are one warp a query, lane L holding entries
// L, 32 + L, 64 + L and 96 + L of one sorted list: a 128-entry list of
// (distance, index) a thread (the residual kernel's layout) is 256
// registers, past the 255 cap, and a list a query in shared memory does
// not fit beside the residual kernel's rings (231,728 of 232,448 bytes at
// four parts), so the residual kNN past 64 uses the one-shot kernel's
// warp-a-query scan.  The segments are scanned one after another (a
// query's list of the current segment only is live, 8 registers a query
// at QW = 2), the block streaming each segment's keys through two
// cp.async tiles, every lane testing one key of a 32-key chunk against the
// list's cap-th distance and the few that pass going in by list_insert4,
// as list_insert / list_insert2 do: the same slots, rounding and ties.
// Each segment's list is then placed into the query's slots [cum, cum +
// cap) by shuffles (place_slots).

// list_insert for a list of up to 128 entries, four a lane: entry 32 h +
// lane in (d[h], id[h]); `cap` <= 128.
__device__ __forceinline__ void list_insert4(float (&d)[4], int (&id)[4], float& thr, int cap,
                                             float dn, int jn, int lane) {
  if (!(dn < thr)) return;  // warp-uniform
  int p = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) p += __popc(__ballot_sync(FULL, d[h] <= dn));
  float ud[4];
  int ui[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    ud[h] = __shfl_up_sync(FULL, d[h], 1);
    ui[h] = __shfl_up_sync(FULL, id[h], 1);
  }
#pragma unroll
  for (int h = 1; h < 4; ++h) {  // entry 32 h - 1 moves to entry 32 h
    const float e = __shfl_sync(FULL, d[h - 1], 31);
    const int j = __shfl_sync(FULL, id[h - 1], 31);
    if (lane == 0) {
      ud[h] = e;
      ui[h] = j;
    }
  }
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int s = 32 * h + lane;
    if (s > p) {
      d[h] = ud[h];
      id[h] = ui[h];
    } else if (s == p) {
      d[h] = dn;
      id[h] = jn;
    }
    if (s >= cap) {
      d[h] = CUDART_INF_F;
      id[h] = -1;
    }
  }
  const int hc = (cap - 1) >> 5;
  float v = d[0];
#pragma unroll
  for (int h = 1; h < 4; ++h)
    if (h == hc) v = d[h];
  thr = __shfl_sync(FULL, v, (cap - 1) & 31);
}

// The block's scan of keys [lo, hi) of P (block-uniform bounds) for QW
// queries a warp into lists of `cap` <= 128 entries (d, id; -1 for an
// entry the range cannot fill): the keys through two tile buffers of
// ONE_TILE rows (`keys`), the next tile loading while every warp scans
// this one; four 32-key chunks' distances at once, then each chunk's
// test and inserts, query by query.
template <int QW>
__device__ __forceinline__ void range_scan4(const float* __restrict__ P, int lo, int hi,
                                            int cap, const float (&qx)[QW],
                                            const float (&qy)[QW], const float (&qz)[QW],
                                            float* keys, int lane, float (&d)[QW][4],
                                            int (&id)[QW][4]) {
  float thr[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      d[i][h] = CUDART_INF_F;
      id[i][h] = -1;
    }
    thr[i] = cap > 0 ? CUDART_INF_F : -CUDART_INF_F;
  }
  const int n = hi - lo;
  if (n <= 0 || cap <= 0) return;  // block-uniform
  const int tiles = (n + ONE_TILE - 1) / ONE_TILE;
  stage_keys(P, lo, min(ONE_TILE, n), keys);
  for (int ti = 0; ti < tiles; ++ti) {
    const int t0 = ti * ONE_TILE, tn = min(ONE_TILE, n - t0);
    if (ti + 1 < tiles)
      stage_keys(P, lo + t0 + ONE_TILE, min(ONE_TILE, n - t0 - ONE_TILE),
                 keys + ((ti + 1) & 1) * 3 * ONE_TILE);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile ti is in for every thread
    const float* kt = keys + (ti & 1) * 3 * ONE_TILE;
    for (int base = 0; base < tn; base += 128) {
      float dd[QW][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jl = base + 32 * u + lane;
        const bool in = jl < tn;
        const float kx = in ? kt[3 * jl] : 0.f, ky = in ? kt[3 * jl + 1] : 0.f,
                    kz = in ? kt[3 * jl + 2] : 0.f;
#pragma unroll
        for (int i = 0; i < QW; ++i)
          dd[i][u] = in ? sqdist3(kx, ky, kz, qx[i], qy[i], qz[i]) : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          unsigned mask = __ballot_sync(FULL, dd[i][u] < thr[i]);
          while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const float dn = __shfl_sync(FULL, dd[i][u], src);
            list_insert4(d[i], id[i], thr[i], cap, dn, lo + t0 + base + 32 * u + src, lane);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the buffer the next copy reuses
  }
}

// A segment's list (entry e of query i in li[i][e / 32] on lane e % 32) into
// the query's slots [cum, cum + cap): slot s = 32 h + lane of idx[i][h].
template <int QW>
__device__ __forceinline__ void place_slots(const int (&li)[QW][4], int cum, int cap, int lane,
                                            int (&idx)[QW][4]) {
#pragma unroll
  for (int i = 0; i < QW; ++i) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = 32 * h + lane - cum;
      int v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = __shfl_sync(FULL, li[i][g], e & 31);
      if (e >= 0 && e < cap) {
        const int g = e >> 5;
        idx[i][h] = g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : v[3];
      }
    }
  }
}

// the k <= 128 one-shot kernel's warps a block: at 65,536 points, k = 128,
// 16 warps (128 registers, 540 bytes spilled) ran 14.72 ms against 18.80 at
// 8 (255 registers, 340 bytes) on an H100 80GB HBM3 at 700 W (PERF.md)
#define WIDE_WARPS 16

// The one-shot kernel at k <= 128 (pci_fusion128): persistent blocks of NW
// = WIDE_WARPS warps, one an SM, the split score MLP in shared memory as in
// fusion_kernel; a group of NW x ONE_QW queries of one batch row scans
// segment A = [0, n1) then B = [n1, N) (range_scan4), then each warp runs
// its queries' heads over up to eight 16-slot tiles (fused_row4) and, in the
// PAY instantiation, the payload sums.  Slot s = 32 h + lane: A's entry s
// for s < cap0, B's entry s - cap0 below cap0 + cap1; an unfilled slot
// below cap0 + cap1 is the query itself (zero residual, its own payload).
template <bool PAY>
__global__ void __launch_bounds__(WIDE_WARPS * 32, 1)
fusion_wide_kernel(const float* __restrict__ pts, const int* __restrict__ seg,
                   const float* __restrict__ wtc, const float* __restrict__ payload, int Cp,
                   float* __restrict__ out, int B, int N) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* keys = sw + ONE_NW;  // 2 x ONE_TILE x 3
  for (int e = threadIdx.x; e < ONE_NW / 4; e += blockDim.x)
    smem4[e] = reinterpret_cast<const float4*>(wtc)[e];
  __syncthreads();  // (a group whose segments are empty syncs nowhere else)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NW = WIDE_WARPS;
  constexpr int G = NW * ONE_QW;  // queries a group
  const int per_row = (N + G - 1) / G;
  for (int grp = blockIdx.x; grp < B * per_row; grp += gridDim.x) {
    const int b = grp / per_row;
    const int q0 = (grp - b * per_row) * G + warp;  // queries q0 + i NW
    const float* P = pts + (size_t)b * N * 3;
    const int n1 = min(max(seg[b * 4 + 0], 0), N);
    const int cap0 = max(0, min(seg[b * 4 + 2], 128));
    const int cap1 = max(0, min(seg[b * 4 + 3], 128 - cap0));
    float qx[ONE_QW], qy[ONE_QW], qz[ONE_QW];
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      const int qq = min(q0 + i * NW, N - 1);
      qx[i] = P[qq * 3], qy[i] = P[qq * 3 + 1], qz[i] = P[qq * 3 + 2];
    }
    int idx[ONE_QW][4];
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) idx[i][h] = -1;
    {
      float d[ONE_QW][4];
      int li[ONE_QW][4];
      range_scan4<ONE_QW>(P, 0, n1, cap0, qx, qy, qz, keys, lane, d, li);
      place_slots<ONE_QW>(li, 0, cap0, lane, idx);
      range_scan4<ONE_QW>(P, n1, N, cap1, qx, qy, qz, keys, lane, d, li);
      place_slots<ONE_QW>(li, cap0, cap1, lane, idx);
    }
    const int kk = cap0 + cap1;
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      float x[4], y[4], z[4], w[4], wsum;
      bool act[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = idx[i][h];
        act[h] = 32 * h + lane < kk;
        x[h] = y[h] = z[h] = 0.f;
        if (act[h] && j >= 0) {
          x[h] = P[(size_t)j * 3] - qx[i];
          y[h] = P[(size_t)j * 3 + 1] - qy[i];
          z[h] = P[(size_t)j * 3 + 2] - qz[i];
        }
      }
      const float3 o = fused_row4(sw, qx[i], qy[i], qz[i], x, y, z, act,
                                  max((kk + 15) / 16, 1), w, wsum);
      const int q = q0 + i * NW;
      float* dst = out + ((size_t)b * N + q) * (PAY ? 3 + Cp : 3);
      if (lane == 0 && q < N) {
        dst[0] = o.x;
        dst[1] = o.y;
        dst[2] = o.z;
      }
      if constexpr (PAY) {  // a pad query (q >= N) reads row N - 1 and stores nothing
        const size_t self = (size_t)b * N + min(q, N - 1);
        const float* xs[4];  // slot 32 h + lane's payload row
#pragma unroll
        for (int h = 0; h < 4; ++h)
          xs[h] = payload + (idx[i][h] >= 0 ? (size_t)b * N + idx[i][h] : self) * Cp;
        payload_sums4(w, wsum, act, Cp, [&](int c, int h) { return __ldg(xs[h] + c); },
                      q < N ? dst + 3 : nullptr);
      }
    }
  }
}

// pci_fusion's arguments at k1 + k2 <= 128.
extern "C" int pci_fusion128(const void* pts, const void* seg, const void* wtc,
                             int h1, int h2, int h3, const void* payload, int Cp, void* out,
                             int B, int N, void* stream) {
  if (h1 != ONE_H1 || h2 != ONE_H2 || h3 != ONE_H3 || N < 1 || B < 1 || Cp < 0 ||
      Cp > PAYLOAD_MAX || (Cp > 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int NW = WIDE_WARPS;
  const auto kernel = Cp > 0 ? fusion_wide_kernel<true> : fusion_wide_kernel<false>;
  const size_t smem = oneshot_smem();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NW * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (long long)B * ((N + NW * ONE_QW - 1) / (NW * ONE_QW));
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, groups));
  kernel<<<grid, NW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(seg),
      static_cast<const float*>(wtc), static_cast<const float*>(payload), Cp,
      static_cast<float*>(out), B, N);
  return (int)cudaGetLastError();
}
extern "C" int pci_fusion128_attrs(int* out) {
  return kernel_attrs(fusion_wide_kernel<false>, oneshot_smem(), out,
                      WIDE_WARPS * 32);
}
extern "C" int pci_fusion128_payload_attrs(int* out) {
  return kernel_attrs(fusion_wide_kernel<true>, oneshot_smem(), out,
                      WIDE_WARPS * 32);
}

// ---- the residual kernel --------------------------------------------------
//
// The budgeted F-segment self-kNN's slots and residuals (the function of
// fusion_knn_cuda.fusion_resi_plain).  The N^2 pairs are the work (5.1e8
// at a training step's 2 x 16,000 points), so the design cuts the
// instructions a pair and fills the card:
//   - one thread a query, the keys broadcast from shared memory: a part's
//     warps read the same key at once (no per-pair shuffle, ballot or slot
//     select, and no lane-a-slot list: that walk was twice as slow for the
//     cell-pruned kernel, PERF.md);
//   - a pair costs one LDS.128 and three FMAs: each staged tile is packed
//     as (x, y, z, |k|^2), and a key is marked when |k|^2 - 2 q.k is below
//     the bound less |q|^2 plus a margin that covers both formulas'
//     rounding (common.cuh mark_limit), a superset of the keys whose exact
//     distance (sqdist3, the plain version's) passes; only marked keys are
//     measured exactly, so the lists, ties and slots are the exact scan's;
//   - the segments one after another: a query scans segment f's keys in
//     index order, then f + 1's, so one list of 16 or 32 entries (by the
//     segment's budget) is live at a time in registers and its threshold
//     is loop-invariant between inserts; keys in index order and a strict
//     `<` keep ties on the lower index.  A list shorter than 16 or 32
//     starts with -inf entries, so its last entry is the budget's k-th;
//   - a segment's keys split over P parts (P x 2 warps a block for 64
//     queries, P in 1, 2, 4 by how few items there are to fill the card
//     with): each part keeps its own list over its contiguous key
//     range, publishes its current k-th distance in shared memory, and
//     marks a key only when it is below its own k-th and at most every
//     other part's (a part's k-th bounds the final list, so the filter
//     keeps a superset of it); part 0 then inserts the other parts' lists
//     in order by (distance, index), which makes the final list the first
//     k of the union, the flat scan's;
//   - 32 keys at a time a lane marks, branch-free, the keys that pass the
//     threshold as it stood, then inserts the marked ones, each checked
//     again (a warp pays for the most inserts of one lane, not for every
//     key some lane inserts);
//   - each part streams its keys through its own RES_STAGES-deep cp.async
//     ring (stage_keys' copies), synchronised by a named barrier of its
//     warps; blocks are persistent over the (batch row, 64 queries) items;
//   - the epilogue gathers each slot's neighbour, computes resi by
//     __fsub_rn, and stages the item's idx and resi rows in shared memory
//     so that both leave in coalesced 16-byte stores.
#define RES_QW 2                // warps of queries a part
#define RES_Q (RES_QW * 32)     // queries an item (a block's turn)
#define RES_MAXP 4              // parts a segment at most
#define RES_TK 256              // keys a ring stage
#define RES_STAGES 3            // ring stages a part
#define RES_PART_FLOATS (RES_STAGES * 3 * RES_TK + 4 * RES_TK)  // a part's ring, packed tile
#define RES_STAMPS 6            // an item's: start, end, scan ns, merge ns, write ns, inserts

struct ResiParams {
  const float* pts;       // [B][N][3]
  const int* ends;        // [B][F] cumulative segment ends
  const int* buds;        // [B][F] budgets
  long long* out_i;       // [B][N][k]
  float* out_r;           // [B][N][k][3]
  unsigned long long* stamps;  // [B * items a row][RES_STAMPS], or null
  int F, B, N, k, P;
};

// Insert (d, id) into the list (bd, bi) sorted by distance, where every
// listed key has a lower index (keys arrive in index order): a strict `<`.
template <int KM>
__device__ __forceinline__ void resi_insert(float (&bd)[KM], int (&bi)[KM], float d, int id) {
  bool lt[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) lt[i] = d < bd[i];
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

__device__ __forceinline__ void part_sync(int part, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + part), "r"(threads) : "memory");
}

// Keys [k0, k0 + kn) of P (xyz interleaved) into a ring stage by the
// part's `nt` threads (thread `pt`), as one cp.async group.
__device__ __forceinline__ void resi_stage(const float* __restrict__ P, int k0, int kn,
                                           float* dst, int pt, int nt) {
  const float* src = P + (size_t)k0 * 3;
  const int n = kn * 3;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = pt; e < n4; e += nt) cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = 4 * n4 + pt; e < n; e += nt) cp_async4(dst + e, src + e);
  } else {
    for (int e = pt; e < n; e += nt) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The lowest of the other parts' published k-th distances, as the bound a
// key must not exceed: returned one ulp up, so that `d < bound` is `d <=
// their k-th` (inf stays inf).
__device__ __forceinline__ float others_bound(const volatile float* pub, int P, int part,
                                              int qi) {
  float m = CUDART_INF_F;
  for (int o = 0; o < P; ++o)
    if (o != part) m = fminf(m, pub[o * RES_Q + qi]);
  return m < CUDART_INF_F ? __int_as_float(__float_as_int(m) + 1) : m;
}

// 32 packed keys (x, y, z, |k|^2) of a tile from key `base`, the first
// `lim_n` of them real: the mask of those whose mark_dot is below `lim`,
// the bound's mark_limit (common.cuh: a superset of sqdist3 < bound).
template <bool EDGE>
__device__ __forceinline__ unsigned mark32(const float4* kp, int base, int lim_n, float qx2,
                                           float qy2, float qz2, float lim) {
  unsigned mask = 0;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    bool pass = mark_dot(kp[base + u], qx2, qy2, qz2) < lim;
    if (EDGE) pass = pass && u < lim_n;
    mask |= (unsigned)pass << u;
  }
  return mask;
}

// One part's scan of keys [a, e) for its query (qi, coordinates q) into a
// KM-entry list holding the segment's `cap` nearest, with the other
// parts' shared filter; returns the inserts it made.
template <int KM>
__device__ __forceinline__ int resi_scan(const float* __restrict__ P, int a, int e, float qx,
                                         float qy, float qz, int cap, float (&bd)[KM],
                                         int (&bi)[KM], float* ring, volatile float* pub,
                                         float* kmx, int part, int nparts, int qi, int pt) {
  const int nt = RES_QW * 32;
  float4* kp = reinterpret_cast<float4*>(ring + RES_STAGES * 3 * RES_TK);  // the packed tile
  const float qq = (qx * qx + qy * qy) + qz * qz, qn = sqrtf(qq);
  const float qx2 = -2.f * qx, qy2 = -2.f * qy, qz2 = -2.f * qz;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    bd[i] = i < KM - cap ? -CUDART_INF_F : CUDART_INF_F;
    bi[i] = -1;
  }
  int inserts = 0;
  const int tiles = e > a ? (e - a + RES_TK - 1) / RES_TK : 0;
  for (int m = 0; m < RES_STAGES - 1; ++m) {
    if (m < tiles)
      resi_stage(P, a + m * RES_TK, min(RES_TK, e - a - m * RES_TK),
                 ring + m * 3 * RES_TK, pt, nt);
    else
      cp_async_commit();
  }
  for (int m = 0; m < tiles; ++m) {
    cp_async_wait<RES_STAGES - 2>();
    part_sync(part, nt);  // tile m is in; every thread is done with tile m - 1
    const int mn = m + RES_STAGES - 1;
    if (mn < tiles)
      resi_stage(P, a + mn * RES_TK, min(RES_TK, e - a - mn * RES_TK),
                 ring + (mn % RES_STAGES) * 3 * RES_TK, pt, nt);
    else
      cp_async_commit();
    const float* kt = ring + (m % RES_STAGES) * 3 * RES_TK;
    const int tn = min(RES_TK, e - a - m * RES_TK);
    const int j0 = a + m * RES_TK;
    // the tile packed as (x, y, z, |k|^2), and its largest |k|^2
    float mx = 0.f;
    for (int t = pt; t < tn; t += nt) {
      const float x = kt[3 * t], y = kt[3 * t + 1], z = kt[3 * t + 2];
      const float kk = (x * x + y * y) + z * z;
      kp[t] = make_float4(x, y, z, kk);
      mx = fmaxf(mx, kk);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if ((pt & 31) == 0) kmx[part * RES_QW + (pt >> 5)] = mx;
    part_sync(part, nt);  // packed
    float km = kmx[part * RES_QW];
#pragma unroll
    for (int w = 1; w < RES_QW; ++w) km = fmaxf(km, kmx[part * RES_QW + w]);
    const float rk = sqrtf(km) + qn, r2 = rk * rk;
    for (int base = 0; base < tn; base += 32) {
      const float bound = nparts > 1
          ? fminf(bd[KM - 1], others_bound(pub, nparts, part, qi)) : bd[KM - 1];
      const float lim = mark_limit(bound, qq, r2);
      unsigned mask = base + 32 <= tn ? mark32<false>(kp, base, 32, qx2, qy2, qz2, lim)
                                      : mark32<true>(kp, base, tn - base, qx2, qy2, qz2, lim);
      if (mask) {
        for (; mask; mask &= mask - 1) {
          const int u = base + __ffs(mask) - 1;
          const float4 k = kp[u];
          const float d = sqdist3(k.x, k.y, k.z, qx, qy, qz);
          if (d < bd[KM - 1]) {
            resi_insert<KM>(bd, bi, d, j0 + u);
            ++inserts;
          }
        }
        if (nparts > 1) pub[part * RES_Q + qi] = bd[KM - 1];
      }
    }
  }
  cp_async_wait<0>();
  return inserts;
}

// A segment: every part scans its key range, then part 0 inserts the
// other parts' lists into its own (by (distance, index), each list in
// order, stopping at its first entry that does not enter) and writes the
// segment's slots [cum, cum + cap) of its query (a slot row of SS ints).
template <int KM, int SS>
__device__ void resi_segment(const float* __restrict__ P, int lo, int hi, int cap, int cum,
                             float qx, float qy, float qz, float* region, volatile float* pub,
                             float* kmx, int* slots, int part, int nparts, int qi, int pt,
                             int& inserts, unsigned long long& t_merge) {
  float bd[KM];
  int bi[KM];
  const int len = max(0, hi - lo);
  const int chunk = round_up((len + nparts - 1) / nparts, 4);
  const int a = lo + min(part * chunk, len), e = lo + min((part + 1) * chunk, len);
  inserts += resi_scan<KM>(P, a, e, qx, qy, qz, cap, bd, bi, region + part * RES_PART_FLOATS,
                           pub, kmx, part, nparts, qi, pt);
  __syncthreads();  // every part done: the rings' space takes the lists
  const unsigned long long t0 = global_ns();
  float* ld = region;                                 // [nparts - 1][KM][RES_Q]
  int* li = reinterpret_cast<int*>(region) + (nparts - 1) * KM * RES_Q;
  if (part > 0) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      ld[((part - 1) * KM + i) * RES_Q + qi] = bd[i];
      li[((part - 1) * KM + i) * RES_Q + qi] = bi[i];
    }
  }
  pub[part * RES_Q + qi] = CUDART_INF_F;  // the next segment's filter starts open
  __syncthreads();
  if (part == 0) {
    for (int o = 1; o < nparts; ++o) {
      for (int i = KM - cap; i < KM; ++i) {
        const float d = ld[((o - 1) * KM + i) * RES_Q + qi];
        const int id = li[((o - 1) * KM + i) * RES_Q + qi];
        if (id < 0 || !lex_less(d, id, bd[KM - 1], bi[KM - 1])) break;
        list_insert<KM>(bd, bi, d, id);
        ++inserts;
      }
    }
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i >= KM - cap) slots[qi * SS + cum + i - (KM - cap)] = bi[i];
  }
  __syncthreads();  // the lists read: the next segment's rings may start
  t_merge += global_ns() - t0;
}

__device__ __forceinline__ void copy_out(char* dst, const char* src, int bytes, int tid,
                                         int nt) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n16 = bytes >> 4;
    for (int e = tid; e < n16; e += nt)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
    for (int e = 4 * n16 + tid; e < (bytes >> 2); e += nt)
      reinterpret_cast<float*>(dst)[e] = reinterpret_cast<const float*>(src)[e];
  } else {
    for (int e = tid; e < (bytes >> 2); e += nt)
      reinterpret_cast<float*>(dst)[e] = reinterpret_cast<const float*>(src)[e];
  }
}

// Shared memory: the region (the parts' rings, then the lists of parts 1..,
// then the item's staged output), the published bounds, the slots (rows of
// KMAX + 1 ints) and the item's query rows.
__host__ __device__ inline size_t resi_region_bytes(int P, int k, int KMAX) {
  const size_t ring = (size_t)P * RES_PART_FLOATS * sizeof(float);
  const size_t lists = (size_t)(P - 1) * KMAX * RES_Q * 8;
  const size_t outb = (size_t)RES_Q * k * (8 + 12);
  const size_t m = ring > lists ? ring : lists;
  return m > outb ? m : outb;
}
static size_t resi_smem(int P, int k, int KMAX) {
  return resi_region_bytes(P, k, KMAX) +
         (RES_MAXP * RES_Q + RES_Q * (KMAX + 1) + 4 * RES_Q + 4 + RES_MAXP * RES_QW) * 4;
}

// KMAX = 32 serves k <= 32 (lists of 16 or 32 entries); KMAX = 64 serves k
// <= 64 and adds the 64-entry list for a segment's budget past 32: an
// instantiation of its own, so that k <= 32 keeps its registers and shared
// memory.
template <int KMAX>
__global__ void __launch_bounds__(RES_MAXP * RES_Q)
fusion_resi_kernel(ResiParams p) {
  constexpr int SS = KMAX + 1;  // a query's slot row (odd: no bank conflicts)
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const size_t rb = resi_region_bytes(p.P, p.k, KMAX);
  float* region = reinterpret_cast<float*>(base);
  volatile float* pub = reinterpret_cast<float*>(base + rb);
  int* slots = reinterpret_cast<int*>(base + rb) + RES_MAXP * RES_Q;
  float4* qrow = reinterpret_cast<float4*>(slots + RES_Q * SS);
  int* ins_sum = reinterpret_cast<int*>(qrow + RES_Q);
  float* kmx = reinterpret_cast<float*>(ins_sum + 4);  // [RES_MAXP][RES_QW] tile maxima
  const int tid = threadIdx.x, nt = blockDim.x;
  const int part = tid / RES_Q, pt = tid - part * RES_Q, qi = pt;
  const int per_row = (p.N + RES_Q - 1) / RES_Q;
  const int k = p.k;
  for (int item = blockIdx.x; item < p.B * per_row; item += gridDim.x) {
    const unsigned long long t_start = p.stamps ? global_ns() : 0ull;
    const int b = item / per_row, q0 = (item - b * per_row) * RES_Q;
    const int nq = min(RES_Q, p.N - q0);
    const float* P = p.pts + (size_t)b * p.N * 3;
    const int qq = q0 + min(qi, nq - 1);
    const float qx = P[(size_t)qq * 3], qy = P[(size_t)qq * 3 + 1], qz = P[(size_t)qq * 3 + 2];
    if (part == 0) {
      for (int c = 0; c < KMAX; ++c) slots[qi * SS + c] = -1;  // unfilled: the row itself
      qrow[qi] = make_float4(qx, qy, qz, 0.f);
    }
    pub[part * RES_Q + qi] = CUDART_INF_F;
    if (tid == 0) *ins_sum = 0;
    __syncthreads();
    int inserts = 0, used = 0, start = 0;
    unsigned long long t_merge = 0;
    for (int f = 0; f < p.F; ++f) {
      const int end = p.ends[b * p.F + f];
      const int cap = max(0, min(p.buds[b * p.F + f], k - used));
      if (KMAX > 32 && cap > 32)
        resi_segment<KMAX, SS>(P, start, end, cap, used, qx, qy, qz, region, pub, kmx, slots,
                               part, p.P, qi, pt, inserts, t_merge);
      else if (cap > 16)
        resi_segment<32, SS>(P, start, end, cap, used, qx, qy, qz, region, pub, kmx, slots,
                             part, p.P, qi, pt, inserts, t_merge);
      else if (cap > 0)
        resi_segment<16, SS>(P, start, end, cap, used, qx, qy, qz, region, pub, kmx, slots,
                             part, p.P, qi, pt, inserts, t_merge);
      used += cap;
      start = max(start, end);
    }
    // the epilogue: each (query, slot)'s index and residual staged as the
    // item's output rows, then stored
    const unsigned long long t_write = p.stamps ? global_ns() : 0ull;
    long long* si = reinterpret_cast<long long*>(region);
    float* sr = reinterpret_cast<float*>(si + RES_Q * k);
    for (int e = tid; e < nq * k; e += nt) {
      const int qe = e / k, c = e - qe * k;
      const int j = slots[qe * SS + c] >= 0 ? slots[qe * SS + c] : q0 + qe;
      const float4 r = qrow[qe];
      si[e] = j;
      sr[3 * e] = __fsub_rn(P[(size_t)j * 3], r.x);
      sr[3 * e + 1] = __fsub_rn(P[(size_t)j * 3 + 1], r.y);
      sr[3 * e + 2] = __fsub_rn(P[(size_t)j * 3 + 2], r.z);
    }
    __syncthreads();
    const size_t row0 = (size_t)b * p.N + q0;
    copy_out(reinterpret_cast<char*>(p.out_i + row0 * k), reinterpret_cast<const char*>(si),
             nq * k * 8, tid, nt);
    copy_out(reinterpret_cast<char*>(p.out_r + row0 * k * 3), reinterpret_cast<const char*>(sr),
             nq * k * 12, tid, nt);
    if (p.stamps) {
      atomicAdd(ins_sum, qi < nq ? inserts : 0);
      __syncthreads();
      if (tid == 0) {
        unsigned long long* st = p.stamps + (size_t)item * RES_STAMPS;
        const unsigned long long t_end = global_ns();
        st[0] = t_start;
        st[1] = t_end;
        st[2] = t_write - t_start - t_merge;
        st[3] = t_merge;
        st[4] = t_end - t_write;
        st[5] = *ins_sum;
      }
    }
    __syncthreads();  // the staged rows are out before the next item's scan
  }
}

// The residual kNN at k in 65-128 (a segment's budget may pass 64): one
// warp a query, persistent blocks of RESW_WARPS warps over groups of
// RESW_WARPS x ONE_QW queries of one batch row (see "k <= 128" above); 64
// registers and 48 KB of key tiles a block, so several blocks an SM.
#define RESW_WARPS 8
// The segments one after another, each through range_scan4 and
// place_slots; then lane L writes slots L, 32 + L, 64 + L, 96 + L of its
// query: the index (the query itself for an unfilled slot) and the residual
// by __fsub_rn, as the KMAX kernels' epilogue computes it.
__global__ void __launch_bounds__(RESW_WARPS * 32)
fusion_resi_wide_kernel(ResiParams p) {
  extern __shared__ float4 smem4[];
  float* keys = reinterpret_cast<float*>(smem4);  // 2 x ONE_TILE x 3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int G = RESW_WARPS * ONE_QW;
  const int N = p.N, k = p.k, per_row = (N + G - 1) / G;
  for (int grp = blockIdx.x; grp < p.B * per_row; grp += gridDim.x) {
    const int b = grp / per_row;
    const int q0 = (grp - b * per_row) * G + warp;  // queries q0 + i RESW_WARPS
    const float* P = p.pts + (size_t)b * N * 3;
    float qx[ONE_QW], qy[ONE_QW], qz[ONE_QW];
    int idx[ONE_QW][4];
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      const int qq = min(q0 + i * RESW_WARPS, N - 1);
      qx[i] = P[qq * 3], qy[i] = P[qq * 3 + 1], qz[i] = P[qq * 3 + 2];
#pragma unroll
      for (int h = 0; h < 4; ++h) idx[i][h] = -1;
    }
    int used = 0, start = 0;
    for (int f = 0; f < p.F; ++f) {
      const int end = min(p.ends[b * p.F + f], N);
      const int cap = max(0, min(p.buds[b * p.F + f], k - used));
      float d[ONE_QW][4];
      int li[ONE_QW][4];
      range_scan4<ONE_QW>(P, start, end, cap, qx, qy, qz, keys, lane, d, li);
      place_slots<ONE_QW>(li, used, cap, lane, idx);
      used += cap;
      start = max(start, end);
    }
#pragma unroll
    for (int i = 0; i < ONE_QW; ++i) {
      const int q = q0 + i * RESW_WARPS;
      if (q >= N) continue;
      const size_t row = (size_t)b * N + q;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int s = 32 * h + lane;
        if (s >= k) break;
        const int j = idx[i][h] >= 0 ? idx[i][h] : q;
        p.out_i[row * k + s] = j;
        float* r = p.out_r + (row * k + s) * 3;
        r[0] = __fsub_rn(P[(size_t)j * 3], qx[i]);
        r[1] = __fsub_rn(P[(size_t)j * 3 + 1], qy[i]);
        r[2] = __fsub_rn(P[(size_t)j * 3 + 2], qz[i]);
      }
    }
  }
}

static size_t resi_wide_smem() { return sizeof(float) * 2 * 3 * ONE_TILE; }

static int resi_wide_launch(const ResiParams& p, int sms, cudaStream_t stream) {
  const size_t smem = resi_wide_smem();
  cudaError_t e = allow_smem(fusion_resi_wide_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fusion_resi_wide_kernel,
                                                    RESW_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long groups =
      (long long)p.B * ((p.N + RESW_WARPS * ONE_QW - 1) / (RESW_WARPS * ONE_QW));
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, groups));
  fusion_resi_wide_kernel<<<grid, RESW_WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// pts [B, N, 3] fp32; ends, buds: device int32 [B, F] (cumulative segment
// ends, the last == N; budgets) -> out_i [B, N, k] int64, out_r [B, N, k,
// 3] fp32.  1 <= F <= 4, 1 <= k <= 128.  parts: 1, 2 or 4 key ranges a
// segment, or 0 to choose by the query count; stamps: null, or zeroed
// int64 [B * ceil(N / 64)][RES_STAMPS].  k > 64 runs
// fusion_resi_wide_kernel, which takes neither (parts 0 and null stamps).
extern "C" int pci_fusion_resi(const void* pts, const void* ends, const void* buds, int F,
                               void* out_i, void* out_r, int B, int N, int k, int parts,
                               void* stamps, void* stream) {
  if (F < 1 || F > 4 || k < 1 || k > 128 || N < 1 || B < 1 ||
      !(parts == 0 || parts == 1 || parts == 2 || parts == 4) ||
      (k > 64 && (parts != 0 || stamps != nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  ResiParams p;
  p.pts = static_cast<const float*>(pts);
  p.ends = static_cast<const int*>(ends);
  p.buds = static_cast<const int*>(buds);
  p.out_i = static_cast<long long*>(out_i);
  p.out_r = static_cast<float*>(out_r);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.F = F, p.B = B, p.N = N, p.k = k, p.P = 1;
  if (k > 64) return resi_wide_launch(p, sms, static_cast<cudaStream_t>(stream));
  const long long items = (long long)B * ((N + RES_Q - 1) / RES_Q);
  // the kernel's choice: split only where the items leave the card short
  // of warps (on the H100, 4 parts took 16,384 points at B = 1 in 0.24 ms
  // against 0.29 at one; at B = 2 x 16,000 one part was the fastest)
  if (parts == 0) parts = items <= 2LL * sms ? 4 : items <= 3LL * sms ? 2 : 1;
  const int kmax = k > 32 ? 64 : 32;  // the instantiation, by k
  const auto kernel = kmax > 32 ? fusion_resi_kernel<64> : fusion_resi_kernel<32>;
  const size_t smem = resi_smem(parts, k, kmax);
  if ((e = allow_smem(kernel, resi_smem(RES_MAXP, kmax, kmax))) != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, parts * RES_Q, smem);
  if (e != cudaSuccess) return (int)e;
  p.P = parts;
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, items));
  kernel<<<grid, parts * RES_Q, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The residual kernel's resources at 4 parts, k = 32 and k = 64.
extern "C" int pci_fusion_resi_attrs(int* out) {
  return kernel_attrs(fusion_resi_kernel<32>, resi_smem(RES_MAXP, 32, 32), out,
                      RES_MAXP * RES_Q);
}
extern "C" int pci_fusion_resi64_attrs(int* out) {
  return kernel_attrs(fusion_resi_kernel<64>, resi_smem(RES_MAXP, 64, 64), out,
                      RES_MAXP * RES_Q);
}
extern "C" int pci_fusion_resi128_attrs(int* out) {
  return kernel_attrs(fusion_resi_wide_kernel, resi_wide_smem(), out, RESW_WARPS * 32);
}
