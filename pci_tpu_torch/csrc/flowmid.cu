// FlowNet3D's decode mid-section in one launch: FlowEmbedding, set_conv3 and
// set_conv4 (their centres picked in the kernel by greedy FPS), then
// set_upconv1..3; only nf_1 leaves it.
//
// Replaces pci_tpu/ops/pallas_kernels/flowmid_tpu.py:flowmid_fused.  On
// FlowNet3D's path, a stream (a = the query cloud, b = the other one):
//   FPS pa_2 256 -> x3 64, FPS x3 64 -> x4 16 (exact greedy from index 0);
//   FlowEmbedding  q pa_2, keys pb_2, k 64, slot [dxyz | fb_2 | fa_2]
//                  259 -> 128 -> 128 -> 128, max              -> emb [256, 128]
//   set_conv3      centres x3, keys [pa_2 | emb], r 2, K 8,
//                  131 -> 128 -> 128 -> 256                    -> fa_3 [64, 256]
//   set_conv4      centres x4, keys [x3 | fa_3], r 4, K 8,
//                  259 -> 256 -> 256 -> 512                    -> fa_4 [16, 512]
//   set_upconv1    q x3, keys [x4 | fa_4], k 8, no MLP1, skip fa_3,
//                  771 -> 256 -> 256                           -> nf_3 [64, 256]
//   set_upconv2    q pa_2, keys [x3 | nf_3], k 8, 259 -> 128 -> 128 -> 256,
//                  skip [fa_2 | emb], 512 -> 256               -> nf_2 [256, 256]
//   set_upconv3    q pa_1, keys [pa_2 | nf_2], k 8, 259 -> 128 -> 128 -> 256,
//                  skip fa_1, 320 -> 256                       -> nf_1 [1024, 256]
// The stage bodies are the per-stage kernels' (knn_conv_tile,
// ball_conv_tile, fps_centres in csrc/stages.cuh): exact selection, ties to
// the lower index, so the fused and the per-stage routes pick the same
// points; their MLP sums differ in order and precision (3xTF32 here).
//
// What bounds it on the H100: per stream ~4.3 GFLOP of MLP (FlowEmbedding's
// 256 x 64 slots x 259 -> 128 -> 128 -> 128 the most, then set_upconv3's
// 1,024 x 8) against ~3.7 MB of weights and activations, so operations;
// and the serial dependency of the six stages.  The TPU ran each stream's
// chain in one grid step; here a cooperative launch strides every block
// over (stream, tile) items in each stage, with a grid barrier between
// stages (five a launch).  The FPS runs, one block a stream, beside
// FlowEmbedding's tiles; the intermediates go to device scratch, where they
// stay in L2 (under 1 MB a stream).
//
// The stage MLPs run on the tensor cores (TensorMlp, csrc/mma_tf32.cuh:
// mma.sync m16n8k8 in 3xTF32, fp32 accuracy), in tiles of up to 64 MLP
// rows: FlowEmbedding one query's 64 slots, set_upconv1-3 8 queries x 8
// slots, set_conv3/4 8 centres x 8, MLP2 the tile's pooled rows; the
// shared-memory budget halves a tile's rows (to 16) where its buffers do
// not fit two blocks an SM.  A stage's weights do not fit in shared memory
// (FlowEmbedding's first layer alone is 270 KB split), so each layer
// streams its weights in k-step slices (8 inputs x 128 outputs, hi and lo,
// 8 KB) through a three-slot ring by cp.async, two slices ahead of the
// mma: a block reads each weight once a tile, where the scalar routine
// read it again through the read-only cache for every 8 rows.  The
// selections, the FPS and the scratch layout are the per-stage kernels';
// its kNN-conv tiles are the per-stage kNN-conv kernel's, its set-conv
// tiles ball_conv_tile<TensorMlp>, as the per-stage set-conv kernel's
// where its plan takes that tile.
#include "stages.cuh"

struct FlowmidParams {
  KnnConvStage fe, su1, su2, su3;
  BallConvStage sc3, sc4;
  const float* pa2;   // FPS source [B][N2][3]
  float* x3;          // [B][S3][3]
  float* x4;          // [B][S4][3]
  unsigned int* bar;  // the grid barrier's counter, zeroed
  int B, N2, S3, S4;
};


__global__ void __launch_bounds__(256, 1) flowmid_kernel(const __grid_constant__ FlowmidParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int passed = 0;
  // stage 1: FPS (one block a stream) beside FlowEmbedding's tiles
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float* x3 = p.x3 + (size_t)b * p.S3 * 3;
    fps_centres(p.pa2 + (size_t)b * p.N2 * 3, p.N2, p.S3, x3, smem);
    fps_centres(x3, p.S3, p.S4, p.x4 + (size_t)b * p.S4 * 3, smem);
  }
  grid_tiles(p.B, p.fe.S, p.fe.Q, p.B, [&](int b, int q0) { knn_conv_tile(p.fe, b, q0, smem); });
  grid_sync(p.bar, passed);
  grid_tiles(p.B, p.sc3.S, p.sc3.Q, 0, [&](int b, int q0) { ball_conv_tile<TensorMlp>(p.sc3, b, q0, smem); });
  grid_sync(p.bar, passed);
  grid_tiles(p.B, p.sc4.S, p.sc4.Q, 0, [&](int b, int q0) { ball_conv_tile<TensorMlp>(p.sc4, b, q0, smem); });
  grid_sync(p.bar, passed);
  grid_tiles(p.B, p.su1.S, p.su1.Q, 0, [&](int b, int q0) { knn_conv_tile(p.su1, b, q0, smem); });
  grid_sync(p.bar, passed);
  grid_tiles(p.B, p.su2.S, p.su2.Q, 0, [&](int b, int q0) { knn_conv_tile(p.su2, b, q0, smem); });
  grid_sync(p.bar, passed);
  grid_tiles(p.B, p.su3.S, p.su3.Q, 0, [&](int b, int q0) { knn_conv_tile(p.su3, b, q0, smem); });
}

static size_t last_smem = 0;  // dynamic shared bytes of the last launch

static KnnConvStage knn_stage(const float* q, const float* kx, const float* kf,
                              const float* qf, const float* skip, const float* skip2,
                              const float* w1, const int* dims1, int n1,
                              const float* w2, const int* dims2, int n2,
                              float* out, int N, int S, int D, int C1, int Cs,
                              int Cs2, int k) {
  KnnConvStage s;
  s.qxyz = q, s.kxyz = kx, s.kfeat = kf, s.qfeat = qf, s.skip = skip, s.skip2 = skip2;
  s.w1 = w1, s.w2 = w2;
  s.out = out;
  s.m1 = make_tf32_spec(dims1, n1, 0);
  s.m2 = make_tf32_spec(dims2, n2, 0);
  s.N = N, s.S = S, s.D = D, s.C1 = C1, s.Cs = Cs, s.Cs2 = Cs2, s.k = k;
  s.interp = 0, s.recip_eps = 0, s.n_final = 0;
  return s;
}

static BallConvStage ball_stage(const float* xyz, const float* feats,
                                const float* q, const float* w, const int* dims,
                                int n, float* out, int N, int S, int D, int K,
                                float r2) {
  BallConvStage s;
  s.xyz = xyz, s.feats = feats, s.qxyz = q, s.w = w, s.out = out;
  s.m = make_tf32_spec(dims, n, 0);
  s.N = N, s.S = S, s.D = D, s.K = K, s.r2 = r2;
  return s;
}

// Inputs pa1 [B][N1][3], fa1 [B][N1][C1], pa2/pb2 [B][N2][3], fa2/fb2
// [B][N2][C2].  w[g], dims + doff[g], nl[g]: the eight folded MLP groups in
// flowmid_tpu's _N_LAYERS order (fe, sc3, sc4, su1.conv2, su2.conv1,
// su2.conv2, su3.conv1, su3.conv2), each its own buffer split for the
// tensor cores (mma_tf32.cuh layout, _build.pack_tf32) and its nl[g] + 1
// widths at offset doff[g] of the host array dims.  Scratch: x3
// [B][S3][3], x4 [B][S4][3], emb [B][N2][*], fa3 [B][S3][*], fa4
// [B][S4][*], nf3 [B][S3][*], nf2 [B][N2][*]; out nf1 [B][N1][*]; bar one
// unsigned int, zeroed here on the stream before the launch.
extern "C" int pci_flowmid(const void* pa1, const void* fa1, const void* pa2,
                           const void* fa2, const void* pb2, const void* fb2,
                           const void* const* w, const int* dims,
                           const int* doff, const int* nl, void* x3, void* x4,
                           void* emb, void* fa3, void* fa4, void* nf3,
                           void* nf2, void* nf1, void* bar, int B, int N1,
                           int N2, int C1, int C2, int S3, int S4, int k_fe,
                           float r3sq, int ns3, float r4sq, int ns4, int k_up,
                           void* stream) {
  for (int g = 0; g < 8; ++g)
    if (nl[g] < 1 || nl[g] > PCI_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  if (N2 > 16 * 256 || S3 > 16 * 256) return (int)cudaErrorInvalidValue;
  // one block an SM, its tiles as full as 220 KB allow (227 KB a block less
  // the FPS's static shared memory): a tile streams its stage's weights
  // once a chunk of rows, so fewer, larger chunks read less
  const size_t budget = 220 * 1024;
  auto F = [](const void* v) { return static_cast<const float*>(v); };
  auto O = [](void* v) { return static_cast<float*>(v); };
  const int* d = dims;
  const int c_emb = d[doff[0] + nl[0]], c_fa3 = d[doff[1] + nl[1]];
  const int c_fa4 = d[doff[2] + nl[2]], c_nf3 = d[doff[3] + nl[3]];
  const int c_nf2 = d[doff[5] + nl[5]];
  FlowmidParams p;
  auto W = [w](int g) { return static_cast<const float*>(w[g]); };
  auto Dm = [d, doff](int g) { return d + doff[g]; };
  p.fe = knn_stage(F(pa2), F(pb2), F(fb2), F(fa2), nullptr, nullptr, W(0), Dm(0),
                   nl[0], nullptr, Dm(0), 0, O(emb), N2, N2, C2, C2, 0, 0, k_fe);
  p.sc3 = ball_stage(F(pa2), O(emb), O(x3), W(1), Dm(1), nl[1], O(fa3), N2, S3,
                     c_emb, ns3, r3sq);
  p.sc4 = ball_stage(O(x3), O(fa3), O(x4), W(2), Dm(2), nl[2], O(fa4), S3, S4,
                     c_fa3, ns4, r4sq);
  p.su1 = knn_stage(O(x3), O(x4), O(fa4), nullptr, O(fa3), nullptr, nullptr, Dm(3),
                    0, W(3), Dm(3), nl[3], O(nf3), S4, S3, c_fa4, 0, c_fa3, 0, k_up);
  p.su2 = knn_stage(F(pa2), O(x3), O(nf3), nullptr, F(fa2), O(emb), W(4), Dm(4),
                    nl[4], W(5), Dm(5), nl[5], O(nf2), S3, N2, c_nf3, 0, C2, c_emb,
                    k_up);
  p.su3 = knn_stage(F(pa1), F(pa2), O(nf2), nullptr, F(fa1), nullptr, W(6), Dm(6),
                    nl[6], W(7), Dm(7), nl[7], O(nf1), N2, N1, c_nf2, 0, C1, 0, k_up);
  if (!knn_conv_plan(p.fe, budget, B) || !knn_conv_plan(p.su1, budget, B) ||
      !knn_conv_plan(p.su2, budget, B) || !knn_conv_plan(p.su3, budget, B) ||
      !ball_conv_plan(p.sc3, B, budget) || !ball_conv_plan(p.sc4, B, budget))
    return (int)cudaErrorInvalidValue;
  p.pa2 = F(pa2);
  p.x3 = O(x3), p.x4 = O(x4);
  p.bar = static_cast<unsigned int*>(bar);
  p.B = B, p.N2 = N2, p.S3 = S3, p.S4 = S4;
  const size_t smem = std::max(
      {knn_conv_smem(p.fe), knn_conv_smem(p.su1), knn_conv_smem(p.su2),
       knn_conv_smem(p.su3), ball_conv_smem(p.sc3), ball_conv_smem(p.sc4),
       fps_centres_smem(N2, 256)});
  auto tiles = [B](int S, int Q) { return B * ((S + Q - 1) / Q); };
  const int items = std::max({B + tiles(N2, p.fe.Q), tiles(S3, p.sc3.Q),
                              tiles(S4, p.sc4.Q), tiles(S3, p.su1.Q),
                              tiles(N2, p.su2.Q), tiles(N1, p.su3.Q)});
  last_smem = smem;
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned int), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return launch_cooperative(flowmid_kernel, p, smem, items,
                            static_cast<cudaStream_t>(stream));
}

// The kernel's resources at its last launch's shared memory (common.cuh's
// kernel_attrs).
extern "C" int pci_flowmid_attrs(int* out) {
  return kernel_attrs(flowmid_kernel, last_smem, out);
}
