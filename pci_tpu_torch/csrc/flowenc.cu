// FlowNet3D's encoder in one launch: set_conv1 over the input cloud at
// given centres, greedy FPS of set_conv2's centres from set_conv1's, and
// set_conv2 over [centres1 | f_1].
//
// Replaces pci_tpu/ops/pallas_kernels/flowenc_tpu.py:flowenc_fused.  On
// FlowNet3D's path: 16,384 points -> 1,024 centres (r 0.5, K 16, MLP
// 6 -> 32 -> 32 -> 64), FPS 1,024 -> 256 (exact greedy from index 0), then
// 1,024 keys -> 256 centres (r 1.0, K 16, MLP 67 -> 64 -> 64 -> 128).
// Returns f_1, f_2 and centres2.  The stage bodies are stages.cuh's
// (ball_conv_tile, fps_warp_chain): the per-stage route's selections and
// picks, bit for bit.
//
// What bounds it on the H100: under 1 MB a stream moves and ~0.2 GFLOP
// (the two MLPs over 1,024 x 16 and 256 x 16 slots) plus the ball scans are
// done, so neither bytes nor operations: the dependent chain (the FPS's 256
// iterations, then set_conv2 after set_conv1) decides its time at one
// stream, the set-conv tiles at eight.  The TPU ran each stream's whole
// chain in one grid step; one block a stream would leave most of the 132
// SMs idle, so this is a cooperative launch: every block strides over
// (stream, tile) items in each stage, with a grid barrier between the
// stages.  Stage 1 holds set_conv1's tiles and, one block a stream, the FPS
// (it needs only centres1), run by one warp with no block barrier in its
// loop (fps_warp_chain: the distances in registers, two warp reductions an
// iteration) while the block's other warps wait; stage 2 holds set_conv2's
// tiles, reading f_1 back from device memory, where it stays in L2 (256 KB
// a stream).  Both set-convs run their MLPs on the tensor cores in 3xTF32
// (TensorMlp, csrc/mma_tf32.cuh; the weights split once per weight set on
// the host), two blocks an SM.
#include "stages.cuh"

struct FlowencParams {
  BallConvStage sc1;  // keys the input cloud, centres c1 -> f_1
  BallConvStage sc2;  // keys [c1 | f_1], centres c2 -> f_2
  const float* c1;    // [B][S1][3]
  float* c2;          // [B][S2][3], picked in stage 1
  unsigned int* bar;  // the grid barrier's counter, zeroed
  unsigned long long* stamps;  // [grid][FLOWENC_STAMPS] %globaltimer ns, or null
  int B, S1, S2;
};

// The stage stamps a block writes when p.stamps is set (a measurement
// launch; the production launch passes null): its start, the end of its
// FPS items, its arrival at the grid barrier, its release, its end, each
// once all its threads are there.
#define FLOWENC_STAMPS 5

__device__ __forceinline__ void stamp(const FlowencParams& p, int i) {
  if (p.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[(size_t)blockIdx.x * FLOWENC_STAMPS + i] = t;
  }
}

__global__ void __launch_bounds__(256, 2) flowenc_kernel(const __grid_constant__ FlowencParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int passed = 0;
  stamp(p, 0);
  // stage 1: the FPS items (one a stream), then set_conv1's tiles
  for (int b = blockIdx.x; b < p.B && threadIdx.x < 32; b += gridDim.x)
    fps_centres_warp(p.c1 + (size_t)b * p.S1 * 3, p.S1, p.S2,
                     p.c2 + (size_t)b * p.S2 * 3, smem);
  stamp(p, 1);
  // set_conv1's tiles over the blocks without an FPS item (over all blocks
  // when the grid holds no other)
  const int skip = (int)gridDim.x > p.B ? p.B : 0;
  const int t1 = (p.S1 + p.sc1.Q - 1) / p.sc1.Q;
  for (int it = (int)blockIdx.x - skip; it >= 0 && it < p.B * t1; it += (int)gridDim.x - skip)
    ball_conv_tile<TensorMlp>(p.sc1, it / t1, (it % t1) * p.sc1.Q, smem);
  stamp(p, 2);
  grid_sync(p.bar, passed);
  stamp(p, 3);
  // stage 2: set_conv2 over [centres1 | f_1]
  grid_tiles(p.B, p.S2, p.sc2.Q, 0, [&](int b, int q0) {
    ball_conv_tile<TensorMlp>(p.sc2, b, q0, smem);
  });
  stamp(p, 4);
}

static size_t last_smem = 0;  // dynamic shared bytes of the last launch

// xyz [B][N][3], feats [B][N][D], c1 [B][S1][3] (S1 <= 1,024); w1/dims1/n1
// and w2/dims2/n2 the two folded MLPs, each split for the tensor cores
// (mma_tf32.cuh layout, _build.pack_tf32; dims: host arrays of n + 1 widths);
// outputs f1 [B][S1][dims1[n1]], f2 [B][S2][dims2[n2]], c2 [B][S2][3];
// bar: one zeroed unsigned int; stamps: null, or FLOWENC_STAMPS unsigned
// 64-bit ints for each block the grid may hold.
extern "C" int pci_flowenc(const void* xyz, const void* feats, const void* c1,
                           const void* w1, const int* dims1, int n1,
                           const void* w2, const int* dims2, int n2, void* f1,
                           void* f2, void* c2, void* bar, void* stamps, int B, int N,
                           int D, int S1, int S2, float r1sq, int K1, float r2sq,
                           int K2, void* stream) {
  if (n1 < 1 || n1 > PCI_MAX_LAYERS || n2 < 1 || n2 > PCI_MAX_LAYERS ||
      S1 < 1 || S2 < 1 || S1 > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t budget = 110 * 1024;  // two blocks an SM (__launch_bounds__)
  FlowencParams p;
  p.sc1.xyz = static_cast<const float*>(xyz);
  p.sc1.feats = static_cast<const float*>(feats);
  p.sc1.qxyz = p.c1 = static_cast<const float*>(c1);
  p.sc1.w = static_cast<const float*>(w1);
  p.sc1.out = static_cast<float*>(f1);
  p.sc1.m = make_tf32_spec(dims1, n1, 0);
  p.sc1.N = N, p.sc1.S = S1, p.sc1.D = D, p.sc1.K = K1, p.sc1.r2 = r1sq;
  p.c2 = static_cast<float*>(c2);
  p.sc2.xyz = p.c1;
  p.sc2.feats = static_cast<const float*>(f1);
  p.sc2.qxyz = p.c2;
  p.sc2.w = static_cast<const float*>(w2);
  p.sc2.out = static_cast<float*>(f2);
  p.sc2.m = make_tf32_spec(dims2, n2, 0);
  p.sc2.N = S1, p.sc2.S = S2, p.sc2.D = dims1[n1], p.sc2.K = K2, p.sc2.r2 = r2sq;
  if (!ball_conv_plan(p.sc1, B, budget) || !ball_conv_plan(p.sc2, B, budget))
    return (int)cudaErrorInvalidValue;
  p.bar = static_cast<unsigned int*>(bar);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.B = B, p.S1 = S1, p.S2 = S2;
  const size_t smem = std::max({ball_conv_smem(p.sc1), ball_conv_smem(p.sc2),
                                sizeof(float4) * (size_t)fps_warp_slots(S1)});
  const int items = std::max(B + B * ((S1 + p.sc1.Q - 1) / p.sc1.Q),
                             B * ((S2 + p.sc2.Q - 1) / p.sc2.Q));
  last_smem = smem;
  return launch_cooperative(flowenc_kernel, p, smem, items,
                            static_cast<cudaStream_t>(stream));
}

// The kernel's resources at its last launch's shared memory (common.cuh's
// kernel_attrs).
extern "C" int pci_flowenc_attrs(int* out) {
  return kernel_attrs(flowenc_kernel, last_smem, out);
}
