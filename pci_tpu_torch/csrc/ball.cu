// Multi-scale ball query: for each query and each (radius, K) scale, the
// first K keys in radius IN INDEX ORDER, all scales in one scan of the keys.
//
// Replaces pci_tpu/ops/pallas_kernels/ball_tpu.py:ball_query_pallas plus
// its finish_ball_idx.  Semantics are those of pci_tpu/ops/ball.py:
// in radius means (dx*dx + dy*dy) + dz*dz <= r*r in fp32 (every product
// and sum rounded on its own, csrc/common.cuh sqdist3); a never-filled
// slot repeats the first hit; a query with no hit at all holds N - 1 in
// every slot (the JAX package's clip of its sentinel).
//
// What bounds it on the H100: neither bytes (the keys of PointNet++'s sa1,
// 65,536 points, are 786 KB; the indices out are 393 KB) nor operations
// (about ten per key scanned), but the scan's latency: each query walks
// the keys in order until every scale holds K hits.  The TPU kernel
// counted in-radius prefixes with a [TK, TK] triangular matmul on its
// matrix unit; here a warp's ballot and popc give the prefix in two
// instructions (common.cuh ball_place).  The design: one warp a query,
// the block's keys staged tile by tile through shared memory (read once
// per block of 8 queries, not once per query), and the block stops
// loading tiles as soon as all of its queries are full (early exit: on
// the dense flow clouds most queries fill within the first few tiles).
// Nothing of size S x N is formed.
#include "common.cuh"

#define PCI_BALL_MAX_SCALES 8
#define PCI_BALL_TILE 2048

struct BallScales {
  int n;
  float r2[PCI_BALL_MAX_SCALES];
  int K[PCI_BALL_MAX_SCALES];
  long long off[PCI_BALL_MAX_SCALES];  // scale s's [B, S, K_s] block in `out`
};

__global__ void __launch_bounds__(256)
ball_kernel(const float* __restrict__ xyz, const float* __restrict__ qxyz,
            long long* __restrict__ out, BallScales sc, int N, int S) {
  __shared__ float4 keys[PCI_BALL_TILE];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = q < S;
  const int qq = min(q, S - 1);
  const float* X = xyz + (size_t)b * N * 3;
  const float* QX = qxyz + ((size_t)b * S + qq) * 3;
  const float qx = QX[0], qy = QX[1], qz = QX[2];

  int count[PCI_BALL_MAX_SCALES];
  long long* id[PCI_BALL_MAX_SCALES];
#pragma unroll
  for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
    count[s] = 0;
    id[s] = out + (s < sc.n ? sc.off[s] + ((size_t)b * S + qq) * sc.K[s] : 0);
  }
  bool done = !active;
  for (int base = 0; base < N; base += PCI_BALL_TILE) {
    // every thread reaches this barrier; the block stops once all are full
    if (!__syncthreads_or(!done)) break;
    const int n = min(PCI_BALL_TILE, N - base);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* p = X + (size_t)(base + t) * 3;
      keys[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int t0 = 0; t0 < n && !done; t0 += 32) {
      const int t = t0 + lane;
      float d = CUDART_INF_F;
      if (t < n) {
        const float4 p = keys[t];
        d = sqdist3(p.x, p.y, p.z, qx, qy, qz);
      }
      done = true;
#pragma unroll
      for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
        if (s < sc.n) {
          count[s] = ball_place(t < n && d <= sc.r2[s], base + t, count[s],
                                sc.K[s], id[s]);
          done = done && count[s] >= sc.K[s];
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s)
      if (s < sc.n) ball_pad(id[s], count[s], sc.K[s], (long long)(N - 1));
  }
}

// r2 / K: host arrays of the n_scales squared radii and budgets; out: one
// int64 buffer holding the scales' [B, S, K_s] blocks back to back.
extern "C" int pci_ball(const void* xyz, const void* qxyz, void* out,
                        const float* r2, const int* K, int n_scales, int B,
                        int N, int S, void* stream) {
  if (n_scales < 1 || n_scales > PCI_BALL_MAX_SCALES || N < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  BallScales sc;
  sc.n = n_scales;
  long long off = 0;
  for (int s = 0; s < PCI_BALL_MAX_SCALES; ++s) {
    sc.r2[s] = s < n_scales ? r2[s] : 0.f;
    sc.K[s] = s < n_scales ? K[s] : 0;
    sc.off[s] = off;
    if (s < n_scales) {
      if (K[s] < 1) return (int)cudaErrorInvalidValue;
      off += (long long)B * S * K[s];
    }
  }
  const int warps = 8;
  dim3 grid((S + warps - 1) / warps, B);
  ball_kernel<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(qxyz),
      static_cast<long long*>(out), sc, N, S);
  return (int)cudaGetLastError();
}
