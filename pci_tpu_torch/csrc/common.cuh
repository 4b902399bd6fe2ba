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

#define PCI_MAX_LAYERS 8

// A folded (BatchNorm-free) MLP chain packed into one float buffer:
// for each layer l, W_l row-major [dims[l]][dims[l+1]] (input-major, so
// neighbouring threads read neighbouring output channels), then b_l.
struct MlpSpec {
  int n;
  int dims[PCI_MAX_LAYERS + 1];
  long long woff[PCI_MAX_LAYERS];
  long long boff[PCI_MAX_LAYERS];
};

// Builds the spec from the layer widths dims[0..n] (host side) with the
// packing above, starting at float offset `base` of the buffer.
static inline MlpSpec make_mlp_spec(const int* dims, int n, long long base) {
  MlpSpec s;
  s.n = n;
  long long off = base;
  for (int l = 0; l <= n && l <= PCI_MAX_LAYERS; ++l) s.dims[l] = dims[l];
  for (int l = 0; l < n && l < PCI_MAX_LAYERS; ++l) {
    s.woff[l] = off;
    off += (long long)dims[l] * dims[l + 1];
    s.boff[l] = off;
    off += dims[l + 1];
  }
  return s;
}

static inline long long mlp_floats(const int* dims, int n) {
  long long t = 0;
  for (int l = 0; l < n; ++l) t += (long long)dims[l] * dims[l + 1] + dims[l + 1];
  return t;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// One dense layer over R rows held in shared memory:
//   hout[r][o] = act(b[o] + sum_i hin[r][i] * W[i][o])
// W is [cin][cout] in global memory (read through L1/L2: the widest layer
// of the path, set_conv4's 256x512, does not fit in shared memory).  Each
// thread owns one output channel for RT consecutive rows, so one weight
// load feeds RT FMAs and the row reads are warp-wide broadcasts.  hin rows
// are ldi floats apart, ldi % 4 == 0 and the buffer holds whole RT-row
// groups (rows >= R are computed from whatever is there and never stored).
template <int RT>
__device__ void dense_rows(const float* __restrict__ W,
                           const float* __restrict__ b, const float* hin,
                           int ldi, float* hout, int ldo, int R, int cin,
                           int cout, bool relu) {
  const int groups = (R + RT - 1) / RT;
  const int cin4 = cin & ~3;
  for (int w = threadIdx.x; w < cout * groups; w += blockDim.x) {
    const int o = w % cout;
    const int r0 = (w / cout) * RT;
    float acc[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.f;
    for (int i = 0; i < cin4; i += 4) {
      const float w0 = __ldg(W + (size_t)(i + 0) * cout + o);
      const float w1 = __ldg(W + (size_t)(i + 1) * cout + o);
      const float w2 = __ldg(W + (size_t)(i + 2) * cout + o);
      const float w3 = __ldg(W + (size_t)(i + 3) * cout + o);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const float4 h =
            *reinterpret_cast<const float4*>(hin + (size_t)(r0 + rr) * ldi + i);
        acc[rr] = fmaf(h.x, w0, acc[rr]);
        acc[rr] = fmaf(h.y, w1, acc[rr]);
        acc[rr] = fmaf(h.z, w2, acc[rr]);
        acc[rr] = fmaf(h.w, w3, acc[rr]);
      }
    }
    for (int i = cin4; i < cin; ++i) {
      const float wv = __ldg(W + (size_t)i * cout + o);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
        acc[rr] = fmaf(hin[(size_t)(r0 + rr) * ldi + i], wv, acc[rr]);
    }
    const float bo = __ldg(b + o);
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      if (r0 + rr < R) {
        const float v = acc[rr] + bo;
        hout[(size_t)(r0 + rr) * ldo + o] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// Runs the whole chain over R rows, ping-ponging between two buffers of
// `ld` floats a row; returns the buffer that holds the last layer's output
// (a == input when the chain is empty).  Every layer ends in ReLU.
__device__ __forceinline__ float* mlp_rows(const float* __restrict__ wbuf,
                                           const MlpSpec& m, float* a,
                                           float* b, int ld, int R) {
  for (int l = 0; l < m.n; ++l) {
    dense_rows<8>(wbuf + m.woff[l], wbuf + m.boff[l], a, ld, b, ld, R,
                  m.dims[l], m.dims[l + 1], true);
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
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

// Shared memory past 48 KB needs an opt-in per kernel.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
