// Exact k-nearest neighbours: for each query, the k keys with the least
// squared distance, ascending, ties to the lower key index.
//
// Replaces pci_tpu/ops/pallas_kernels/knn_cells_tpu.py:knn_cells on the
// transformer's self-kNN (65,536 x 65,536, k = 16).  The TPU kernel is
// approximate (Morton-sorted chunks, a few ranked chunks a query tile,
// bucket winners; recall about 0.97); this kernel computes the exact
// function that pci_tpu.ops.knn(..., exact=True) and the port's plain knn
// define, with distances (dx*dx + dy*dy) + dz*dz rounded op by op
// (common.cuh sqdist3), so indices and distances equal the plain version's
// bit for bit.  It takes queries and keys separately, so it also serves a
// cross-cloud kNN.
//
// It also replaces pci_tpu/ops/pallas_kernels/knn_tpu.py:knn_pallas, the
// flat kNN with an optional key prefix valid_n [B] (the chamfer loss's
// nearest neighbour, k = 1, and ops.knn with valid_n): keys at or after valid_n
// are never scanned, and when valid_n < k the surplus slots hold the
// sentinel distance 1e30 with the indices valid_n, valid_n + 1, ..., as a
// stable sort of the plain version's masked distances orders them.  At
// k = 1 the top list is one running minimum a thread.
//
// What bounds it on the H100: operations.  An exhaustive scan is 8 flops
// per (query, key) pair, 3.4e10 at 65,536 x 65,536, about 0.5 ms at the
// card's 67 TFLOP/s fp32; the bytes (786 KB of keys) are nothing.  The
// design: one thread a query, the keys streamed through shared memory in
// index order as float4 tiles (one broadcast load a key for the whole
// block), and the query's sorted top list in registers (fully unrolled, so
// no local memory).  A key enters only when strictly nearer than the
// current k-th, so among equal distances the earlier (lower) index stays
// ahead, as a stable sort keeps it.  Above k = 64 (up to knn_pallas's
// 128) the list no longer fits in registers: it lives in local memory
// (L1-cached) and the insertion is a loop with the same compares in the
// same order.  csrc/knn_cells.cu serves the large self kNNs.
#include "common.cuh"

#define PCI_KNN_TILE 1024

template <int KM>
__global__ void __launch_bounds__(128)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           const int* __restrict__ valid_n, float* __restrict__ out_d,
           long long* __restrict__ out_i, int N, int S, int k) {
  __shared__ float4 keys[PCI_KNN_TILE];
  const int b = blockIdx.y;
  const int Nb = valid_n ? max(0, min(valid_n[b], N)) : N;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int ss = min(s, S - 1);
  const float* QX = query + ((size_t)b * S + ss) * 3;
  const float qx = QX[0], qy = QX[1], qz = QX[2];
  const float* P = points + (size_t)b * N * 3;

  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = 0x7fffffff;
  }
  for (int base = 0; base < Nb; base += PCI_KNN_TILE) {
    const int n = min(PCI_KNN_TILE, Nb - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* p = P + (size_t)(base + t) * 3;
      keys[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4 p = keys[t];
      const float d = sqdist3(p.x, p.y, p.z, qx, qy, qz);
      if (d < bd[KM - 1]) {
        // bubble the new pair into place by (distance, index); every held
        // index is lower than base + t, so it goes after equal distances
        float cd = d;
        int ci = base + t;
#define PCI_KNN_STEP                                          \
  if (cd < bd[i] || (cd == bd[i] && ci < bi[i])) {            \
    const float td = bd[i];                                   \
    const int ti = bi[i];                                     \
    bd[i] = cd;                                               \
    bi[i] = ci;                                               \
    cd = td;                                                  \
    ci = ti;                                                  \
  }
        if constexpr (KM <= 64) {
#pragma unroll
          for (int i = 0; i < KM; ++i) { PCI_KNN_STEP }
        } else {
#pragma unroll 1
          for (int i = 0; i < KM; ++i) { PCI_KNN_STEP }
        }
#undef PCI_KNN_STEP
      }
    }
  }
  if (s < S) {
    float* od = out_d + ((size_t)b * S + s) * k;
    long long* oi = out_i + ((size_t)b * S + s) * k;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i < k) {
        // slots past the prefix: the masked keys in index order
        od[i] = i < Nb ? bd[i] : 1e30f;
        oi[i] = i < Nb ? bi[i] : i;
      }
    }
  }
}

template <int KM>
static cudaError_t launch_knn(const float* q, const float* p, const int* vn,
                              float* od, long long* oi, int B, int N, int S,
                              int k, cudaStream_t stream) {
  dim3 grid((S + 127) / 128, B);
  knn_kernel<KM><<<grid, 128, 0, stream>>>(q, p, vn, od, oi, N, S, k);
  return cudaGetLastError();
}

// query [B, S, 3], points [B, N, 3] fp32, valid_n [B] int32 or null ->
// out_d [B, S, k] fp32, out_i [B, S, k] int64; 1 <= k <= min(128, N).
extern "C" int pci_knn(const void* query, const void* points,
                       const void* valid_n, void* out_d, void* out_i, int B,
                       int N, int S, int k, void* stream) {
  if (k < 1 || k > 128 || k > N || S < 1) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  const int* vn = static_cast<const int*>(valid_n);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return (int)launch_knn<1>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 4) return (int)launch_knn<4>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 8) return (int)launch_knn<8>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 16) return (int)launch_knn<16>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 32) return (int)launch_knn<32>(q, p, vn, od, oi, B, N, S, k, st);
  if (k <= 64) return (int)launch_knn<64>(q, p, vn, od, oi, B, N, S, k, st);
  return (int)launch_knn<128>(q, p, vn, od, oi, B, N, S, k, st);
}
