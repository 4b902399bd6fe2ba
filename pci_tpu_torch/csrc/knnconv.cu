// Fused kNN set-conv tail: exact k-nearest grouping + MLP1 + max over the
// k slots + skip concat + MLP2, or (interp) 3-NN inverse-distance
// interpolation + skip concat + MLP2; the last n_final MLP2 layers are
// linear, so FlowNet3D's classifier (its BatchNorm folded) rides the
// FeaturePropagation's chain.
//
// Replaces pci_tpu/ops/pallas_kernels/knnconv_tpu.py:knnconv_fused.  It
// serves FlowEmbedding, SetUpConv and FeaturePropagation (+ the classifier
// with n_final=1, FlowNet3D's fused decode).  A slot's MLP1 input is
// [key_xyz - query, key_feats, query_feats]; the MLP2 input is [pooled,
// skip].  Interp weights come from distances recomputed from the chosen
// keys: 1 / max(d, 1e-10) ("clamp", FlowNet3D's FeaturePropagation) or
// 1 / (d + 1e-8) ("eps", PointNet++'s FeaturePropagationP2;
// pci_tpu/ops/interpolate.py).  The body is knn_conv_tile
// (csrc/stages.cuh), which csrc/flowmid.cu runs too.
//
// Selection is exact: k rounds of a warp-wide lexicographic argmin over
// (squared distance, key index), each round taking the least pair after
// the previous winner, so ties go to the lower index and duplicate points
// are taken one by one.  The TPU kernel's mantissa-packed ranking was a
// TPU workaround and is not carried over.
//
// What bounds it on the H100: keys are at most 1,024 on FlowNet3D's path
// and the work is small (FE, the largest, ~2.2 GFLOP and ~0.3 MB), so
// neither bytes nor FLOPs: the per-slot MLP's shared-memory traffic and
// the k serial selection rounds decide its time.  PointNet++'s FP levels
// (eps interpolation, up to 65,536 queries into 1,024 keys) are the
// three selection rounds over the keys and a gather of the keys' rows.  The design keeps the
// grouped rows in shared memory, never writes the [S, k, C] block to
// device memory, and runs MLP1 over chunks of R rows with a running max,
// then MLP2 over the block's Q pooled rows.
#include "stages.cuh"

__global__ void __launch_bounds__(256) knnconv_kernel(const __grid_constant__ KnnConvStage st) {
  extern __shared__ float4 smem4[];
  knn_conv_tile(st, blockIdx.y, blockIdx.x * st.Q, reinterpret_cast<float*>(smem4));
}

// dims1/dims2: host arrays of the MLP widths (n1 + 1 and n2 + 1 entries;
// either chain may be empty).  The packed buffer holds MLP1 then MLP2.
extern "C" int pci_knnconv(const void* qxyz, const void* kxyz,
                           const void* kfeat, const void* qfeat,
                           const void* skip, const void* wbuf, const int* dims1,
                           int n1, const int* dims2, int n2, void* out, int B,
                           int N, int S, int D, int C1, int Cs, int k,
                           int interp, int recip_eps, int n_final, void* stream) {
  if (n1 < 0 || n1 > PCI_MAX_LAYERS || n2 < 0 || n2 > PCI_MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  KnnConvStage st;
  st.qxyz = static_cast<const float*>(qxyz);
  st.kxyz = static_cast<const float*>(kxyz);
  st.kfeat = static_cast<const float*>(kfeat);
  st.qfeat = static_cast<const float*>(qfeat);
  st.skip = static_cast<const float*>(skip);
  st.skip2 = nullptr;
  st.w1 = st.w2 = static_cast<const float*>(wbuf);
  st.out = static_cast<float*>(out);
  st.m1 = make_mlp_spec(dims1, n1, 0);
  st.m2 = make_mlp_spec(dims2, n2, mlp_floats(dims1, n1));
  st.N = N, st.S = S, st.D = D, st.C1 = C1, st.Cs = Cs, st.Cs2 = 0, st.k = k;
  st.interp = interp, st.recip_eps = recip_eps, st.n_final = n_final;
  if (!knn_conv_plan(st, SIZE_MAX)) return (int)cudaErrorInvalidValue;
  const size_t smem = knn_conv_smem(st);
  cudaError_t e = allow_smem(knnconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + st.Q - 1) / st.Q, B);
  knnconv_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(st);
  return (int)cudaGetLastError();
}
