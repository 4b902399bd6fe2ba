// Fused set-conv tail: ball query (first K in-radius keys in index order)
// + row gather + folded-BN MLP + max over the K slots.
//
// Replaces pci_tpu/ops/pallas_kernels/setconv_tpu.py:setconv_fused.
// Semantics are those of pci_tpu/ops/ball.py:ball_query: the first K hits
// by key index, a shortfall padded with the first hit, an empty query
// reading key 0.  The MLP input of a slot is [key_xyz - query, key_feats].
// The body is ball_conv_tile (csrc/stages.cuh), which the FlowNet3D
// megakernels (csrc/flowenc.cu, csrc/flowmid.cu) run too.
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
#include "stages.cuh"

__global__ void __launch_bounds__(256) setconv_kernel(const __grid_constant__ BallConvStage st) {
  extern __shared__ float4 smem4[];
  ball_conv_tile(st, blockIdx.y, blockIdx.x * st.Q, reinterpret_cast<float*>(smem4));
}

// dims: host array of the n+1 layer widths (dims[0] == 3 + D).
extern "C" int pci_setconv(const void* xyz, const void* feats, const void* qxyz,
                           const void* wbuf, const int* dims, int n_layers,
                           void* out, int B, int N, int S, int D, float r2,
                           int K, void* stream) {
  if (n_layers < 1 || n_layers > PCI_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  BallConvStage st;
  st.xyz = static_cast<const float*>(xyz);
  st.feats = static_cast<const float*>(feats);
  st.qxyz = static_cast<const float*>(qxyz);
  st.w = static_cast<const float*>(wbuf);
  st.out = static_cast<float*>(out);
  st.m = make_mlp_spec(dims, n_layers, 0);
  st.N = N, st.S = S, st.D = D, st.K = K, st.r2 = r2;
  if (!ball_conv_plan(st, B, SIZE_MAX)) return (int)cudaErrorInvalidValue;
  const size_t smem = ball_conv_smem(st);
  cudaError_t e = allow_smem(setconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + st.Q - 1) / st.Q, B);
  setconv_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(st);
  return (int)cudaGetLastError();
}
