// FlowNet3D's encoder in one launch: set_conv1 over the input cloud at
// given centres, greedy FPS of set_conv2's centres from set_conv1's, and
// set_conv2 over [centres1 | f_1].
//
// Replaces pci_tpu/ops/pallas_kernels/flowenc_tpu.py:flowenc_fused.  On
// FlowNet3D's path: 16,384 points -> 1,024 centres (r 0.5, K 16, MLP
// 6 -> 32 -> 32 -> 64), FPS 1,024 -> 256 (exact greedy from index 0), then
// 1,024 keys -> 256 centres (r 1.0, K 16, MLP 67 -> 64 -> 64 -> 128).
// Returns f_1, f_2 and centres2.  The stage bodies are those of the
// per-stage kernels (ball_conv_tile, fps_chain in csrc/stages.cuh), so the
// fused and the per-stage routes give the same bits.
//
// What bounds it on the H100: under 1 MB a stream moves and ~0.2 GFLOP
// (the two MLPs over 1,024 x 16 and 256 x 16 slots) plus the ball scans are
// done, so neither bytes nor operations: the dependent chain (the FPS's 256
// iterations, then set_conv2 after set_conv1) and the MLPs' shared-memory
// traffic decide its time.  The TPU ran each stream's whole chain in one
// grid step; one block a stream would leave most of the 132 SMs idle, so
// this is a cooperative launch: every block strides over (stream, tile)
// items in each stage, with a grid barrier between the stages.  Stage 1
// holds set_conv1's tiles and, one block a stream, the FPS (it needs only
// centres1); stage 2 holds set_conv2's tiles, reading f_1 back from device
// memory, where it stays in L2 (256 KB a stream).
#include "stages.cuh"

struct FlowencParams {
  BallConvStage sc1;  // keys the input cloud, centres c1 -> f_1
  BallConvStage sc2;  // keys [c1 | f_1], centres c2 -> f_2
  const float* c1;    // [B][S1][3]
  float* c2;          // [B][S2][3], picked in stage 1
  unsigned int* bar;  // the grid barrier's counter, zeroed
  int B, S1, S2;
};

__global__ void __launch_bounds__(256) flowenc_kernel(const __grid_constant__ FlowencParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int passed = 0;
  // stage 1: the FPS items (one a stream), then set_conv1's tiles
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    fps_centres(p.c1 + (size_t)b * p.S1 * 3, p.S1, p.S2,
                p.c2 + (size_t)b * p.S2 * 3, smem);
  grid_tiles(p.B, p.S1, p.sc1.Q, p.B, [&](int b, int q0) {
    ball_conv_tile(p.sc1, b, q0, smem);
  });
  grid_sync(p.bar, passed);
  // stage 2: set_conv2 over [centres1 | f_1]
  grid_tiles(p.B, p.S2, p.sc2.Q, 0, [&](int b, int q0) {
    ball_conv_tile(p.sc2, b, q0, smem);
  });
}

// xyz [B][N][3], feats [B][N][D], c1 [B][S1][3]; w1/dims1/n1 and
// w2/dims2/n2 the two folded MLPs (dims: host arrays of n + 1 widths);
// outputs f1 [B][S1][dims1[n1]], f2 [B][S2][dims2[n2]], c2 [B][S2][3];
// bar: one zeroed unsigned int.
extern "C" int pci_flowenc(const void* xyz, const void* feats, const void* c1,
                           const void* w1, const int* dims1, int n1,
                           const void* w2, const int* dims2, int n2, void* f1,
                           void* f2, void* c2, void* bar, int B, int N, int D,
                           int S1, int S2, float r1sq, int K1, float r2sq,
                           int K2, void* stream) {
  if (n1 < 1 || n1 > PCI_MAX_LAYERS || n2 < 1 || n2 > PCI_MAX_LAYERS ||
      S1 < 1 || S2 < 1 || S1 > 16 * 256)
    return (int)cudaErrorInvalidValue;
  const size_t budget = 110 * 1024;  // two blocks an SM
  FlowencParams p;
  p.sc1.xyz = static_cast<const float*>(xyz);
  p.sc1.feats = static_cast<const float*>(feats);
  p.sc1.qxyz = p.c1 = static_cast<const float*>(c1);
  p.sc1.w = static_cast<const float*>(w1);
  p.sc1.out = static_cast<float*>(f1);
  p.sc1.m = make_mlp_spec(dims1, n1, 0);
  p.sc1.N = N, p.sc1.S = S1, p.sc1.D = D, p.sc1.K = K1, p.sc1.r2 = r1sq;
  p.c2 = static_cast<float*>(c2);
  p.sc2.xyz = p.c1;
  p.sc2.feats = static_cast<const float*>(f1);
  p.sc2.qxyz = p.c2;
  p.sc2.w = static_cast<const float*>(w2);
  p.sc2.out = static_cast<float*>(f2);
  p.sc2.m = make_mlp_spec(dims2, n2, 0);
  p.sc2.N = S1, p.sc2.S = S2, p.sc2.D = dims1[n1], p.sc2.K = K2, p.sc2.r2 = r2sq;
  if (!ball_conv_plan(p.sc1, B, budget) || !ball_conv_plan(p.sc2, B, budget))
    return (int)cudaErrorInvalidValue;
  p.bar = static_cast<unsigned int*>(bar);
  p.B = B, p.S1 = S1, p.S2 = S2;
  const size_t smem = std::max({ball_conv_smem(p.sc1), ball_conv_smem(p.sc2),
                                sizeof(float) * 3 * (size_t)S1});
  const int items = std::max(B + B * ((S1 + p.sc1.Q - 1) / p.sc1.Q),
                             B * ((S2 + p.sc2.Q - 1) / p.sc2.Q));
  return launch_cooperative(flowenc_kernel, p, smem, items,
                            static_cast<cudaStream_t>(stream));
}
