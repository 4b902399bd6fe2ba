// Shared device helpers for the point-cloud kernels of pci_tpu_torch.
//
// Every kernel here is bound through a plain C interface (extern "C"
// functions taking pointers, ints and the stream) and loaded with ctypes;
// each C function returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#define PCI_MAX_LAYERS 8

// A folded (BatchNorm-free) MLP chain in one float buffer: its widths and
// each layer's weight and bias offsets (csrc/mma_tf32.cuh's
// make_tf32_spec lays the weights out for the tensor cores).
struct MlpSpec {
  int n;
  int dims[PCI_MAX_LAYERS + 1];
  long long woff[PCI_MAX_LAYERS];
  long long boff[PCI_MAX_LAYERS];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// %globaltimer in ns, for a kernel's optional stage stamps.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The vector-attention tail's weight buffer (csrc/attention.cu and
// csrc/attention_bwd.cu), fp32, row-major [in][out]: Wd0 [3][d], bd0 [d],
// Wd1 [d][d], bd1 [d], Wg0 [d][d], bg0 [d], Wg1 [d][d], bg1 [d].
__host__ __device__ inline int attn_weight_floats(int d) {
  return 3 * d + d + 3 * (d * d + d);
}

// Squared distance with every product and sum rounded on its own (no FMA
// contraction): bit-identical to the plain PyTorch versions, which compute
// (dx*dx + dy*dy) + dz*dz as separate elementwise ops.  Selection (FPS
// argmax, ball membership, k-nearest order) therefore agrees exactly.
__device__ __forceinline__ float sqdist3(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The three-FMA mark of the exact scans (csrc/fusion_knn.cu's residual kNN,
// csrc/knn.cu's nearest neighbour).  A key staged as (x, y, z, |k|^2), with
// |k|^2 = (x*x + y*y) + z*z, and a query q given as q2 = -2 q: mark_dot is
// |k|^2 - 2 q.k in three FMAs, a pair's whole cost where the key is not
// marked.  A key is marked when mark_dot falls below mark_limit(bound,
// |q|^2, r2), r2 = (|k|max + |q|)^2 over the staged keys: sqdist3(k, q) <
// bound implies mark_dot < (bound - |q|^2) + MARK_MARGIN (bound + r2).
// The two sides' rounding errors are below 7u bound and 12u (|k| + |q|)^2
// (u = 2^-24, every partial sum below (|k| + |q|)^2, sqdist3's relative
// error below 5u), and computing the limit itself adds a few u more; the
// margin is 32u.  So the marked keys are a superset of those the exact test
// passes, and only they are measured with sqdist3 and compared.
#define MARK_MARGIN 1.9073486e-06f
__device__ __forceinline__ float mark_dot(float4 k, float qx2, float qy2, float qz2) {
  return __fmaf_rn(qx2, k.x, __fmaf_rn(qy2, k.y, __fmaf_rn(qz2, k.z, k.w)));
}
__device__ __forceinline__ float mark_limit(float bound, float qq, float r2) {
  return bound < CUDART_INF_F ? (bound - qq) + MARK_MARGIN * (bound + r2) : CUDART_INF_F;
}

// The ball scan shared by csrc/ball.cu and csrc/setconv.cu: one warp a
// query walks the keys in index order, 32 at a time (lane l holds key
// j = base + l).  One step places this step's in-radius keys in the
// query's slots count, count + 1, ... by a ballot and a popc prefix, so
// the slots hold the first K hits in index order; hits past K are
// dropped.  Returns the hit count after the step (it may exceed K; the
// count is warp-uniform, so `count >= K` is a uniform early exit).
template <typename T>
__device__ __forceinline__ int ball_place(bool hit, int j, int count, int K,
                                          T* id) {
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  const int slot = count + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
  if (hit && slot < K) id[slot] = static_cast<T>(j);
  return count + __popc(m);
}

// Finishes a scanned row: never-filled slots repeat the first hit; a row
// with no hit at all holds `empty` in every slot.
template <typename T>
__device__ __forceinline__ void ball_pad(T* id, int count, int K, T empty) {
  __syncwarp();
  const T fill = count > 0 ? id[0] : empty;
  for (int s = min(count, K) + (threadIdx.x & 31); s < K; s += 32) id[s] = fill;
}

// Lexicographic (distance, index) minimum across a warp.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// Shared memory past 48 KB, the kernel's static arrays counted, needs an
// opt-in per kernel and device.  The static size is queried and the
// opt-in raised once per (kernel, device) and kept, so a launch that needs
// no more than before makes no runtime call here.  The lock covers
// launches from autograd's backward thread.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  struct Seen {
    const void* fn;
    int dev;
    size_t static_bytes;
    size_t allowed;  // dynamic bytes the kernel may take without a new opt-in
  };
  static std::mutex mu;
  static Seen seen[16];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  Seen* s = nullptr;
  for (int i = 0; i < n_seen && s == nullptr; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev) s = &seen[i];
  Seen fresh;
  if (s == nullptr) {
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    size_t free48 = a.sharedSizeBytes < 48 * 1024 ? 48 * 1024 - a.sharedSizeBytes : 0;
    fresh = {fn, dev, a.sharedSizeBytes, free48};
    s = n_seen < 16 ? &(seen[n_seen++] = fresh) : &fresh;
  }
  if (bytes <= s->allowed) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) s->allowed = bytes;
  return e;
}

// A kernel's resources at `smem` dynamic shared bytes a block of `threads`:
// out = {registers a thread, static shared bytes, dynamic shared bytes,
// resident blocks an SM, threads a block, local (spill) bytes a thread}.
// The C entries pci_*_attrs return it (_build.kernel_attrs).
template <typename K>
static inline int kernel_attrs(K kernel, size_t smem, int* out, int threads = 256) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = threads;
  out[5] = (int)a.localSizeBytes;
  return 0;
}
