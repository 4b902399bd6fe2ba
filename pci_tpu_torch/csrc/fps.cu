// Greedy farthest point sampling, exact or as P interleaved chains.
//
// Replaces pci_tpu/ops/pallas_kernels/fps_tpu.py: fps_pallas (P == 1) and
// fps_pallas_interleaved (P > 1).  Chain s owns the strided subset of
// global indices s, s+P, s+2P, ...; it starts at local index start // P
// (clamped to the subset) and makes npoint / P greedy picks; the output is
// interleaved iteration-major, out[b, i*P + s] = chain s's i-th pick.
//
// What bounds it on the H100: not bytes (16,384 points are 196 KB) and not
// operations (10 per point per iteration, 1.7e8 for 16k -> 1024), but the
// sequential dependency: every iteration needs the previous argmax.  Each
// iteration is one relax pass plus a block-wide argmax, so its latency is
// two __syncthreads and a shuffle tree.  The design keeps every chain's
// cloud in shared memory and its distances in registers (one block per
// (batch, chain), up to 16 points a thread), so an iteration touches no
// device memory; interleaved chains run as independent blocks in parallel.
// Ties go to the lowest index, as jnp.argmax breaks them; once every
// distance is 0 (npoint > N) the argmax is index 0 again, as in the XLA loop.
// The chain is fps_chain (csrc/stages.cuh), which the FlowNet3D
// megakernels run for their in-kernel centres.
#include "stages.cuh"

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint, int P) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int L = (N - s + P - 1) / P;  // points in subset s
  float* sy = sx + L;
  float* sz = sy + L;

  const float* X = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const size_t g = (size_t)(s + (size_t)j * P) * 3;
    sx[j] = X[g];
    sy[j] = X[g + 1];
    sz[j] = X[g + 2];
  }
  const int far = min(start[b] / P, L - 1);
  __syncthreads();
  fps_chain<PPT>(sx, sy, sz, L, npoint / P, far, [&](int it, int f) {
    out[(size_t)b * npoint + (size_t)it * P + s] = f * P + s;
  });
}

template <int PPT>
static cudaError_t launch_fps(const float* xyz, const int* start, int* out,
                              int B, int N, int npoint, int P, int threads,
                              cudaStream_t stream) {
  const int L0 = (N + P - 1) / P;  // the longest subset
  const size_t smem = (size_t)L0 * 3 * sizeof(float);
  cudaError_t e = allow_smem(fps_kernel<PPT>, smem);
  if (e != cudaSuccess) return e;
  fps_kernel<PPT><<<dim3(P, B), threads, smem, stream>>>(xyz, start, out, N,
                                                         npoint, P);
  return cudaGetLastError();
}

extern "C" int pci_fps(const void* xyz, const void* start, void* out, int B,
                       int N, int npoint, int P, void* stream) {
  const int L0 = (N + P - 1) / P;
  const int threads = std::min(1024, round_up(L0, 32));
  const int ppt = (L0 + threads - 1) / threads;
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ppt <= 1) return launch_fps<1>(x, st, o, B, N, npoint, P, threads, s);
  if (ppt <= 2) return launch_fps<2>(x, st, o, B, N, npoint, P, threads, s);
  if (ppt <= 4) return launch_fps<4>(x, st, o, B, N, npoint, P, threads, s);
  if (ppt <= 8) return launch_fps<8>(x, st, o, B, N, npoint, P, threads, s);
  if (ppt <= 16) return launch_fps<16>(x, st, o, B, N, npoint, P, threads, s);
  return (int)cudaErrorInvalidValue;  // > 16,384 points a chain
}
