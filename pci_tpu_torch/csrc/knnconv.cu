// Fused kNN set-conv tail: exact k-nearest grouping + MLP1 + max over the
// k slots + skip concat + MLP2, or (interp) 3-NN inverse-distance
// interpolation + skip concat + MLP2; the last n_final MLP2 layers are
// linear, so FlowNet3D's classifier (its BatchNorm folded) rides the
// FeaturePropagation's chain.
//
// Replaces pci_tpu/ops/pallas_kernels/knnconv_tpu.py:knnconv_fused.  It
// serves FlowEmbedding, SetUpConv and FeaturePropagation (+ the classifier
// with n_final=1, FlowNet3D's fused decode), and PointNet++'s FP levels
// (interp with no MLP).  A slot's MLP1 input is [key_xyz - query,
// key_feats, query_feats]; the MLP2 input is [pooled, skip].  Interp
// weights come from the chosen keys' distances: 1 / max(d, 1e-10)
// ("clamp", FlowNet3D's FeaturePropagation) or 1 / (d + 1e-8) ("eps",
// PointNet++'s FeaturePropagationP2; pci_tpu/ops/interpolate.py).  The
// bodies are knn_conv_tile (grouped, which csrc/flowmid.cu runs too) and
// knn_interp_tile (csrc/stages.cuh).
//
// Selection is exact: the k least (squared distance, key index) pairs in
// that lexicographic order, so ties go to the lower index and duplicate
// points are taken one by one (grouped: k warp argmin rounds; interp: one
// pass keeping each lane's three least pairs, then three rounds over the
// lanes).  The TPU kernel's mantissa-packed ranking was a TPU workaround
// and is not carried over.
//
// What bounds it on the H100: operations.  On FlowNet3D's main path (the
// FeaturePropagation + classifier, 16,384 queries a stream into 1,024
// keys, MLP2 259 -> 256 -> 256 -> 128 -> 3) the MLP is 5.4 GFLOP a stream
// against ~20 MB moved, the 3-NN scan about 1% of that.  So every MLP runs
// on the tensor cores in 3xTF32 (TensorMlp, csrc/mma_tf32.cuh; the weights
// split once per weight set on the host), and the interp mode takes 64
// queries a tile: the split chain (1.3 MB) streams from L2 through the
// weight ring once for 64 rows, each warp's item covering the four row
// tiles.  The tile stages its keys in shared memory, so the one-pass 3-NN
// reads them at shared-memory latency.  The grouped mode takes flowmid's
// tensor plan.  PointNet++'s FP levels (interp, no MLP, up to 65,536
// queries into 1,024 keys) are the 3-NN and a gather of the keys' rows:
// their own kernel, without the MLP's registers, several blocks an SM.
#include "stages.cuh"

// the interp kernels' blocks an SM: with MLP2 (its budget of shared
// memory follows), without
#define INTERP_MLP_BLOCKS 1
#define INTERP_BARE_BLOCKS 4

__global__ void __launch_bounds__(256, 1) knnconv_kernel(const __grid_constant__ KnnConvStage st) {
  extern __shared__ float4 smem4[];
  knn_conv_tile(st, blockIdx.y, blockIdx.x * st.Q, reinterpret_cast<float*>(smem4));
}

template <bool kMlp>
__global__ void __launch_bounds__(256, kMlp ? INTERP_MLP_BLOCKS : INTERP_BARE_BLOCKS)
    knninterp_kernel(const __grid_constant__ KnnConvStage st) {
  extern __shared__ float4 smem4[];
  knn_interp_tile<kMlp>(st, blockIdx.y, blockIdx.x * st.Q, reinterpret_cast<float*>(smem4));
}

// a launch of `kernel` on grid x 256 threads after its shared-memory opt-in
template <typename K>
static int launch(K kernel, dim3 grid, size_t smem, cudaStream_t s, const KnnConvStage& st) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 256, smem, s>>>(st);
  return (int)cudaGetLastError();
}

static size_t last_smem = 0;  // dynamic shared bytes of the last interp launch with MLP2

// w1 / w2: MLP1 and MLP2 split for the tensor cores (mma_tf32.cuh layout,
// _build.pack_tf32), each its own buffer (or null for an empty chain);
// dims1/dims2: host arrays of their widths (n1 + 1 and n2 + 1 entries).
extern "C" int pci_knnconv(const void* qxyz, const void* kxyz,
                           const void* kfeat, const void* qfeat,
                           const void* skip, const void* w1, const void* w2,
                           const int* dims1, int n1, const int* dims2, int n2,
                           void* out, int B, int N, int S, int D, int C1, int Cs,
                           int k, int interp, int recip_eps, int n_final, void* stream) {
  if (n1 < 0 || n1 > PCI_MAX_LAYERS || n2 < 0 || n2 > PCI_MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  KnnConvStage st;
  st.qxyz = static_cast<const float*>(qxyz);
  st.kxyz = static_cast<const float*>(kxyz);
  st.kfeat = static_cast<const float*>(kfeat);
  st.qfeat = static_cast<const float*>(qfeat);
  st.skip = static_cast<const float*>(skip);
  st.skip2 = nullptr;
  st.w1 = static_cast<const float*>(w1);
  st.w2 = static_cast<const float*>(w2);
  st.out = static_cast<float*>(out);
  st.m1 = make_tf32_spec(dims1, n1, 0);
  st.m2 = make_tf32_spec(dims2, n2, 0);
  st.N = N, st.S = S, st.D = D, st.C1 = C1, st.Cs = Cs, st.Cs2 = 0, st.k = k;
  st.interp = interp, st.recip_eps = recip_eps, st.n_final = n_final;
  // the shared memory of one of a kernel's blocks an SM (grouped: one, as
  // flowmid: fuller tiles stream the weights less often)
  const int blocks = !interp ? 1 : (n2 ? INTERP_MLP_BLOCKS : INTERP_BARE_BLOCKS);
  const size_t budget = (228 * 1024) / blocks - 8 * 1024;
  // (an interp tile too wide for its blocks an SM takes one block's budget)
  const bool ok = interp ? knn_interp_plan(st, budget) || knn_interp_plan(st, 220 * 1024)
                         : knn_conv_plan(st, budget, B);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + st.Q - 1) / st.Q, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!interp) return launch(knnconv_kernel, grid, knn_conv_smem(st), s, st);
  if (!n2) return launch(knninterp_kernel<false>, grid, knn_interp_smem(st), s, st);
  last_smem = knn_interp_smem(st);
  return launch(knninterp_kernel<true>, grid, last_smem, s, st);
}

// The interp kernel with MLP2's resources at its last launch's shared
// memory (FlowNet3D's FeaturePropagation + classifier; common.cuh's
// kernel_attrs).
extern "C" int pci_knnconv_attrs(int* out) {
  return kernel_attrs(knninterp_kernel<true>, last_smem, out);
}
