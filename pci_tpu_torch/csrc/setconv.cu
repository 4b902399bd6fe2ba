// Fused set-conv tail: ball query (first K in-radius keys in index order)
// + row gather + folded-BN MLP + max over the K slots.
//
// Replaces pci_tpu/ops/pallas_kernels/setconv_tpu.py:setconv_fused.
// Semantics are those of pci_tpu/ops/ball.py:ball_query: the first K hits
// by key index, a shortfall padded with the first hit, an empty query
// reading key 0.  The MLP input of a slot is [key_xyz - query, key_feats].
//
// What bounds it on the H100: on FlowNet3D's four stages it moves under
// 1 MB and computes under 0.15 GFLOP a call, so it is bound by neither:
// the scan latency of the ball query and the MLP's shared-memory traffic
// decide its time.  The design: one warp a query scans the keys in index
// order, 32 at a time, and places hits with __ballot_sync/__popc, stopping
// as soon as K are found (no S x N distance matrix); a block of Q queries
// then gathers its Q*K rows into shared memory and runs the whole MLP chain
// there in chunks of R rows, keeping only a running max per query.  The
// weights stay in global memory (set_conv4's 256x512 layer is 512 KB, more
// than a block's 227 KB of shared memory) and reach the threads through
// L1/L2, one load feeding 8 rows.
#include "common.cuh"

__global__ void __launch_bounds__(256)
setconv_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
               const float* __restrict__ qxyz, const float* __restrict__ wbuf,
               MlpSpec mlp, float* __restrict__ out, int N, int S, int D,
               float r2, int K, int Q, int R, int ld) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RR = round_up(R, 8);
  const int cout = mlp.dims[mlp.n];
  float* bufA = smem;
  float* bufB = bufA + (size_t)RR * ld;
  float* best = bufB + (size_t)RR * ld;
  int* sidx = reinterpret_cast<int*>(best + round_up(Q * cout, 4));

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * Q;
  const float* X = xyz + (size_t)b * N * 3;
  const float* F = feats + (size_t)b * N * D;
  const float* QX = qxyz + (size_t)b * S * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // 1. ball query: one warp a query, keys in index order, early exit
  for (int qi = warp; qi < Q; qi += nwarps) {
    int* id = sidx + qi * K;
    const int q = min(q0 + qi, S - 1);  // a tail block repeats the last query
    const float qx = QX[q * 3], qy = QX[q * 3 + 1], qz = QX[q * 3 + 2];
    int count = 0;
    for (int base = 0; base < N && count < K; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < N) hit = sqdist3(X[j * 3], X[j * 3 + 1], X[j * 3 + 2], qx, qy, qz) <= r2;
      count = ball_place(hit, j, count, K, id);
    }
    ball_pad(id, count, K, 0);  // an empty query reads key 0
  }
  for (int t = threadIdx.x; t < Q * cout; t += blockDim.x) best[t] = -CUDART_INF_F;
  __syncthreads();

  // 2. gather [dxyz | feats] rows chunk by chunk, MLP, running max
  const int C = 3 + D;
  const int rows = Q * K;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    for (int e = threadIdx.x; e < nr * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C;
      const int row = r0 + r;
      const int q = min(q0 + row / K, S - 1);
      const int j = sidx[row];
      bufA[(size_t)r * ld + c] =
          c < 3 ? X[j * 3 + c] - QX[q * 3 + c] : F[(size_t)j * D + (c - 3)];
    }
    __syncthreads();
    const float* h = mlp_rows(wbuf, mlp, bufA, bufB, ld, nr);
    const int qa = r0 / K, qb = (r0 + nr - 1) / K;
    for (int e = threadIdx.x; e < (qb - qa + 1) * cout; e += blockDim.x) {
      const int qi = qa + e / cout, o = e % cout;
      const int ra = max(qi * K, r0) - r0, rb = min(qi * K + K, r0 + nr) - r0;
      float m = best[qi * cout + o];
      for (int r = ra; r < rb; ++r) m = fmaxf(m, h[(size_t)r * ld + o]);
      best[qi * cout + o] = m;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < Q * cout; e += blockDim.x) {
    const int q = q0 + e / cout;
    if (q < S) out[((size_t)b * S + q) * cout + (e % cout)] = best[e];
  }
}

// dims: host array of the n+1 layer widths (dims[0] == 3 + D).
extern "C" int pci_setconv(const void* xyz, const void* feats, const void* qxyz,
                           const void* wbuf, const int* dims, int n_layers,
                           void* out, int B, int N, int S, int D, float r2,
                           int K, int Q, int R, void* stream) {
  if (n_layers < 1 || n_layers > PCI_MAX_LAYERS || dims[0] != 3 + D)
    return (int)cudaErrorInvalidValue;
  const MlpSpec m = make_mlp_spec(dims, n_layers, 0);
  int ld = 0;
  for (int l = 0; l <= n_layers; ++l) ld = std::max(ld, dims[l]);
  ld = round_up(ld, 4);
  const int cout = dims[n_layers];
  const size_t smem = sizeof(float) * (2 * (size_t)round_up(R, 8) * ld +
                                       round_up(Q * cout, 4)) +
                      sizeof(int) * (size_t)Q * K;
  cudaError_t e = allow_smem(setconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + Q - 1) / Q, B);
  setconv_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(feats),
      static_cast<const float*>(qxyz), static_cast<const float*>(wbuf), m,
      static_cast<float*>(out), N, S, D, r2, K, Q, R, ld);
  return (int)cudaGetLastError();
}
