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
// sequential dependency: every iteration needs the previous argmax, so the
// time is npoint / P times the latency of one iteration.  Design: each
// (batch, chain) is one block of W warps (fps_group_chain, csrc/stages.cuh),
// about one warp an SM sub-partition: a thread keeps its points' distances
// and, up to 16 points a thread, their coordinates in registers; only the
// centre comes from shared memory; a warp reduces with two redux.sync (max
// over the distance bits, min over the indices at it) and the warps trade
// their winners through double-buffered shared slots with one named barrier
// an iteration, each warp then reducing the W slots itself.  W is 8 up to
// 2,048 points a chain and 16 above (on the H100 wider chains won over
// narrower ones at every path shape, and the 8-warp chain over the one-warp
// chain at 1,024 points); an exact chain of at most 256 points (P == 1)
// runs on one warp (fps_warp_chain, no barrier at all).  Ties go to the
// lowest index, as
// jnp.argmax breaks them; once every distance is 0 (npoint > N) the argmax is
// index 0 again, as in the XLA loop.
//
// A chain of more than 16,384 points (exact FPS over a large cloud; the JAX
// op runs its kernel at any size) does not fit in one block's shared memory
// and registers: fps_long_kernel keeps its points (x, y, z as a float4) and
// running distances in a global scratch the wrapper allocates, 20 bytes a
// point, L2-resident (32,768 points: 640 KB); one block of 32 warps a
// chain, each thread owning the points g, g + 1024, ... (coalesced), the
// same compares and the same two-level reduction with one block barrier an
// iteration.  Only that route reads global memory in its loop; the chains
// up to 16,384 points are unchanged.
#include "stages.cuh"

#define FPS_MAX_WARPS 16
#define FPS_BAR 1  // the chain's named barrier

template <int PPL>
__global__ void __launch_bounds__(32 * FPS_MAX_WARPS)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint, int P) {
  extern __shared__ float4 smem4[];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int L = (N - s + P - 1) / P;  // points in subset s
  const int nw = blockDim.x >> 5;
  const int Lp = blockDim.x * PPL;  // the arrays' padded length
  float* sx = reinterpret_cast<float*>(smem4);
  float* sy = sx + Lp;
  float* sz = sy + Lp;
  uint2* slots = reinterpret_cast<uint2*>(sz + Lp);

  const float* X = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < Lp; j += blockDim.x) {
    const size_t g = (size_t)(s + (size_t)j * P) * 3;
    sx[j] = j < L ? X[g] : 0.f;
    sy[j] = j < L ? X[g + 1] : 0.f;
    sz[j] = j < L ? X[g + 2] : 0.f;
  }
  const int far = min((start ? start[b] : 0) / P, L - 1);
  __syncthreads();
  auto emit = [&](int it, int f) {
    out[(size_t)b * npoint + (size_t)it * P + s] = f * P + s;
  };
  fps_group_chain<PPL, (PPL <= 16)>(sx, sy, sz, L, npoint / P, far, threadIdx.x, nw,
                                    FPS_BAR, slots, emit);
}

// The exact chain (P == 1) of at most 32 * PPL <= 256 points by one warp.
template <int PPL>
__global__ void __launch_bounds__(32)
fps_warp_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                int* __restrict__ out, int N, int npoint) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const float* X = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < 32 * PPL; j += 32)
    smem4[j] = j < N ? make_float4(X[j * 3], X[j * 3 + 1], X[j * 3 + 2], 0.f)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  fps_warp_chain<PPL>(smem4, N, npoint, min(start ? start[b] : 0, N - 1), [&](int it, int f) {
    out[(size_t)b * npoint + it] = f;
  });
}

#define FPS_LONG_WARPS 32

// One chain of any length: pts [L] (x, y, z, 0) and dist [L] in scratch.
__global__ void __launch_bounds__(32 * FPS_LONG_WARPS)
fps_long_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                int* __restrict__ out, float4* __restrict__ scratch, int N, int npoint,
                int P, int Lp) {
  __shared__ uint2 slots[2][FPS_LONG_WARPS];
  const int s = blockIdx.x, b = blockIdx.y;
  const int L = (N - s + P - 1) / P;
  const int g = threadIdx.x, lane = g & 31, warp = g >> 5, stride = blockDim.x;
  float4* pts = scratch + ((size_t)b * P + s) * Lp;
  float* dist = reinterpret_cast<float*>(scratch + (size_t)gridDim.y * P * Lp) +
                ((size_t)b * P + s) * Lp;
  const float* X = xyz + (size_t)b * N * 3;
  for (int j = g; j < L; j += stride) {
    const size_t q = (size_t)(s + (size_t)j * P) * 3;
    pts[j] = make_float4(X[q], X[q + 1], X[q + 2], 0.f);
    dist[j] = CUDART_INF_F;
  }
  int far = min((start ? start[b] : 0) / P, L - 1);
  __syncthreads();  // every point is in scratch before any centre is read
  for (int it = 0; it < npoint / P; ++it) {
    if (g == 0) out[(size_t)b * npoint + (size_t)it * P + s] = far * P + s;
    const float4 c = pts[far];
    float bd = -1.f;
    unsigned bj = 0x7fffffffu;
    for (int j = g; j < L; j += stride) {  // j grows: the first maximum is kept
      const float4 p = pts[j];
      const float d = fminf(dist[j], sqdist3(p.x, p.y, p.z, c.x, c.y, c.z));
      dist[j] = d;
      if (d > bd) bd = d, bj = (unsigned)j;
    }
    const unsigned bits = bd < 0.f ? 0u : __float_as_uint(bd);  // no point: 0
    unsigned top = __reduce_max_sync(0xffffffffu, bits);
    unsigned win = __reduce_min_sync(0xffffffffu, bits == top ? bj : 0x7fffffffu);
    uint2* sl = slots[it & 1];
    if (lane == 0) sl[warp] = make_uint2(top, win);
    __syncthreads();
    const uint2 o = lane < FPS_LONG_WARPS ? sl[lane] : make_uint2(0u, 0x7fffffffu);
    top = __reduce_max_sync(0xffffffffu, o.x);
    win = __reduce_min_sync(0xffffffffu, o.x == top ? o.y : 0x7fffffffu);
    far = (int)win;
  }
}

template <int PPL>
static cudaError_t launch_group(const float* xyz, const int* start, int* out, int B, int N,
                                int npoint, int P, int W, cudaStream_t stream) {
  const size_t smem = (size_t)32 * W * PPL * 3 * sizeof(float) + 2 * W * sizeof(uint2);
  cudaError_t e = allow_smem(fps_kernel<PPL>, smem);
  if (e != cudaSuccess) return e;
  fps_kernel<PPL><<<dim3(P, B), 32 * W, smem, stream>>>(xyz, start, out, N, npoint, P);
  return cudaGetLastError();
}

template <int PPL>
static cudaError_t launch_warp(const float* xyz, const int* start, int* out, int B, int N,
                               int npoint, cudaStream_t stream) {
  fps_warp_kernel<PPL><<<dim3(1, B), 32, 32 * PPL * sizeof(float4), stream>>>(
      xyz, start, out, N, npoint);
  return cudaGetLastError();
}

// xyz [B, N, 3] fp32, start [B] int32 or null (0) -> out [B, npoint] int32; at most
// 16,384 points a chain (pci_fps_long above).
extern "C" int pci_fps(const void* xyz, const void* start, void* out, int B, int N,
                       int npoint, int P, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L0 = (N + P - 1) / P;  // the longest subset
  if (P == 1 && L0 <= 256) {
    const int ppl = fps_warp_slots(L0) / 32;
    if (ppl <= 1) return launch_warp<1>(x, st, o, B, N, npoint, s);
    if (ppl <= 2) return launch_warp<2>(x, st, o, B, N, npoint, s);
    if (ppl <= 4) return launch_warp<4>(x, st, o, B, N, npoint, s);
    return launch_warp<8>(x, st, o, B, N, npoint, s);
  }
  const int W = L0 <= 2048 ? 8 : 16;
  const int ppl = (L0 + 32 * W - 1) / (32 * W);
  if (ppl <= 1) return launch_group<1>(x, st, o, B, N, npoint, P, W, s);
  if (ppl <= 2) return launch_group<2>(x, st, o, B, N, npoint, P, W, s);
  if (ppl <= 4) return launch_group<4>(x, st, o, B, N, npoint, P, W, s);
  if (ppl <= 8) return launch_group<8>(x, st, o, B, N, npoint, P, W, s);
  if (ppl <= 16) return launch_group<16>(x, st, o, B, N, npoint, P, W, s);
  if (ppl <= 32) return launch_group<32>(x, st, o, B, N, npoint, P, W, s);
  return (int)cudaErrorInvalidValue;  // > 16,384 points a chain
}

// pci_fps's function for chains of any length (the wrapper takes it above
// 16,384 points a chain); scratch: at least B * P * ceil(N / P) * 5 floats.
extern "C" int pci_fps_long(const void* xyz, const void* start, void* out, void* scratch,
                            int B, int N, int npoint, int P, void* stream) {
  if (B < 1 || N < 1 || P < 1 || npoint % P) return (int)cudaErrorInvalidValue;
  const int Lp = (N + P - 1) / P;
  fps_long_kernel<<<dim3(P, B), 32 * FPS_LONG_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(start), static_cast<int*>(out),
      static_cast<float4*>(scratch), N, npoint, P, Lp);
  return (int)cudaGetLastError();
}
