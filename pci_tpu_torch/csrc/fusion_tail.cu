// The fusion's attention head over given residuals: score MLP over
// [resi | safe_norm(resi)] (4 -> 64 -> 64 -> 128, BatchNorm folded, ReLU
// each), max over channels, fp32 softmax over the k slots, then combined +
// sum_k w * resi and, for a payload, sum_k w * extra.
//
// Replaces pci_tpu/ops/pallas_kernels/fusion_tail_tpu.py:
// fusion_attention_tail, the eval route of PointsFusion with the one-shot
// kernel off (after the residual kNN, csrc/fusion_knn.cu
// fusion_resi_kernel).  The head is the one-shot kernels'
// (csrc/fusion_head.cuh), so the residual kNN and this tail give the rows
// the one-shot kernel gives for the same neighbours.
//
// What bounds it on the H100: at B = 8, N = 16,384, k = 32 the residuals
// are 50 MB (15 us at 3.35 TB/s) and the MLP 52 GFLOP, 157 GFLOP of TF32
// products in the 3xTF32 split (0.32 ms at 495 TFLOP/s), against 1.6 ms of
// the same MLP in scalar fp32: operations, on the tensor cores.  The design:
//   - the head on the tensor cores (fusion_head.cuh head_weight: one warp a
//     query, lane L slot L, two 16-slot row tiles through the three layers
//     on mma.sync in 3xTF32, the activations in registers as accumulator
//     fragments); a query with k <= 16 runs one tile; lanes at or past k
//     are inactive (zero residual, weight 0);
//   - persistent blocks of TAIL_WARPS warps, one an SM: each copies the
//     split weights (_build.pack_tf32(chain=True), 101 KB, the layout rows
//     4 and 12 take) into shared memory once, instead of each of N / 8
//     blocks reading 51 KB again.  One block of 12 warps at 168 registers
//     (104 bytes spilled a thread) ran faster than two of 8 at 128
//     registers (320 bytes spilled), the head's fragments living in
//     registers;
//   - a warp takes rows gw, gw + W, gw + 2 W, ... (W the grid's warps) and
//     prefetches the next row's k x 3 residuals into its other buffer by
//     cp.async while the head of the current row runs; a payload is read
//     from device memory after the head;
//   - the softmax is a warp max and warp sums; lane 0 writes the row;
//   - k <= 64 (PointINet2's ring fusions with the one-shot kernel off) is
//     the S = 2 instantiation: two slots a lane, up to four 16-slot tiles
//     through the same head (head_weight2), a 64 x 3 row buffer; k <= 32
//     keeps its own; any k past 64 the streaming kernel
//     (fusion_tail_stream_kernel, an online softmax over 32-slot chunks).
#include "fusion_head.cuh"

#define TAIL_WARPS 12
#define TAIL_BUF (32 * 3)  // floats a row's buffer, for 32 slots
#define TAIL_BLOCKS_PER_SM 1

struct TailParams {
  const float* comb;   // [rows][3]
  const float* resi;   // [rows][k][3]
  const float* extra;  // [rows][k][Ce], or null for Ce == 0
  const float* wtc;    // the split score MLP, ONE_NW floats
  float* out;          // [rows][3 + Ce]
  long long rows;      // B N
  int k, Ce;
};

// Row `row`'s residuals into `buf` by cp.async, one group (empty past the
// last row).
__device__ __forceinline__ void tail_stage(const TailParams& p, long long row, float* buf,
                                           int lane) {
  if (row < p.rows) {
    const float* r = p.resi + row * p.k * 3;
    for (int e = lane; e < 3 * p.k; e += 32) cp_async4(buf + e, r + e);
  }
  cp_async_commit();
}

// S = 1 serves k <= 32 (lane L slot L, one or two 16-slot tiles); S = 2
// serves k <= 64: lane L holds slots L and 32 + L, up to four 16-slot
// tiles through the same head (fusion_head.cuh head_weight2), a row buffer
// of 64 x 3 floats.
template <int S>
__global__ void __launch_bounds__(TAIL_WARPS * 32, TAIL_BLOCKS_PER_SM)
fusion_tail_kernel(const __grid_constant__ TailParams p) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int BUF = S * TAIL_BUF;
  float* bufs = sw + ONE_NW + warp * 2 * BUF;
  for (int e = threadIdx.x; e < ONE_NW / 4; e += blockDim.x)
    cp_async16(smem4 + e, reinterpret_cast<const float4*>(p.wtc) + e);
  cp_async_commit();
  const long long gw = (long long)blockIdx.x * TAIL_WARPS + warp;
  const long long W = (long long)gridDim.x * TAIL_WARPS;
  tail_stage(p, gw, bufs, lane);
  cp_async_wait<0>();
  __syncthreads();  // the weights and every warp's first row are in
  const int k = p.k, Ce = p.Ce, tiles = k > 16 ? 2 : 1;
  const bool active = lane < k;
  int cur = 0;
  for (long long row = gw; row < p.rows; row += W) {
    tail_stage(p, row + W, bufs + (cur ^ 1) * BUF, lane);  // the next row, in flight
    const float* buf = bufs + cur * BUF;
    float rx = 0.f, ry = 0.f, rz = 0.f;
    if (active) {
      rx = buf[3 * lane];
      ry = buf[3 * lane + 1];
      rz = buf[3 * lane + 2];
    }
    if constexpr (S == 1) {
      const float w = head_weight(sw, rx, ry, rz, active, tiles);
      const float sw_ = warp_sum(w), ax = warp_sum(w * rx), ay = warp_sum(w * ry),
                  az = warp_sum(w * rz);
      float* o = p.out + row * (3 + Ce);
      if (lane == 0) {
        o[0] = p.comb[row * 3] + ax / sw_;
        o[1] = p.comb[row * 3 + 1] + ay / sw_;
        o[2] = p.comb[row * 3 + 2] + az / sw_;
      }
      const float* x = p.extra + (row * k + lane) * Ce;  // slot `lane`'s channels
      payload_sums(w, sw_, active, Ce, [&](int c) { return x[c]; }, o + 3);
    } else {
      const bool act1 = 32 + lane < k;  // slot 32 + lane
      float rx1 = 0.f, ry1 = 0.f, rz1 = 0.f;
      if (act1) {
        rx1 = buf[3 * (32 + lane)];
        ry1 = buf[3 * (32 + lane) + 1];
        rz1 = buf[3 * (32 + lane) + 2];
      }
      float w0, w1, sw_;
      const float3 f = fused_row2(sw, p.comb[row * 3], p.comb[row * 3 + 1], p.comb[row * 3 + 2],
                                  rx, ry, rz, rx1, ry1, rz1, active, act1, (k + 15) / 16, w0,
                                  w1, sw_);
      float* o = p.out + row * (3 + Ce);
      const float* x = p.extra + (row * k + lane) * Ce;  // slots `lane` and 32 + lane's channels
      if (lane == 0) {
        o[0] = f.x;
        o[1] = f.y;
        o[2] = f.z;
      }
      payload_sums2(w0, w1, sw_, active, act1, Ce,
                    [&](int c, int h) { return x[h * 32 * Ce + c]; }, o + 3);
    }
    cp_async_wait<0>();
    __syncwarp();  // the next row is in for every lane; this one is read
    cur ^= 1;
  }
  cp_async_wait<0>();
}

// Any k past 64 (the TPU kernel's tail has no k limit): one warp a row
// streams the row's slots 32 at a time (lane L slot c0 + L of chunk c0),
// loading the next chunk's residuals into registers while the head scores
// this one (head_score: one or two 16-slot tiles), and keeps an online
// softmax: a running max m over the slots seen, and the sums of exp(s - m)
// times 1, the residual and each payload channel, rescaled by exp(m_old -
// m) when a chunk raises m (fusion_knn_tpu.py:online_softmax_step).  No
// row buffer and no instantiation by k; payloads of at most PAYLOAD_MAX
// channels (their sums live in registers).
__global__ void __launch_bounds__(TAIL_WARPS * 32, TAIL_BLOCKS_PER_SM)
fusion_tail_stream_kernel(const __grid_constant__ TailParams p) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < ONE_NW / 4; e += blockDim.x)
    cp_async16(smem4 + e, reinterpret_cast<const float4*>(p.wtc) + e);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the weights are in
  const long long W = (long long)gridDim.x * TAIL_WARPS;
  const int k = p.k, Ce = p.Ce;
  for (long long row = (long long)blockIdx.x * TAIL_WARPS + warp; row < p.rows; row += W) {
    const float* r = p.resi + row * k * 3;
    float nx = 0.f, ny = 0.f, nz = 0.f;  // the next chunk's slot
    if (lane < k) {
      nx = __ldg(r + 3 * lane);
      ny = __ldg(r + 3 * lane + 1);
      nz = __ldg(r + 3 * lane + 2);
    }
    float m = -CUDART_INF_F, wsum = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
    float acc[PAYLOAD_MAX];
#pragma unroll
    for (int c = 0; c < PAYLOAD_MAX; ++c) acc[c] = 0.f;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int s = c0 + lane;
      const bool active = s < k;
      const float rx = nx, ry = ny, rz = nz;
      if (s + 32 < k) {
        nx = __ldg(r + 3 * (s + 32));
        ny = __ldg(r + 3 * (s + 32) + 1);
        nz = __ldg(r + 3 * (s + 32) + 2);
      }
      const float score = head_score(sw, rx, ry, rz, k - c0 > 16 ? 2 : 1);
      float cm = active ? score : -CUDART_INF_F;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, off));
      const float mn = fmaxf(m, cm), scale = expf(m - mn);  // exp(-inf) = 0 at the first chunk
      const float w = active ? expf(score - mn) : 0.f;
      wsum = wsum * scale + warp_sum(w);
      ax = ax * scale + warp_sum(w * rx);
      ay = ay * scale + warp_sum(w * ry);
      az = az * scale + warp_sum(w * rz);
      const float* x = p.extra + (row * k + s) * Ce;  // slot s's channels
#pragma unroll
      for (int c = 0; c < PAYLOAD_MAX; ++c)
        if (c < Ce) acc[c] = acc[c] * scale + warp_sum(active ? w * __ldg(x + c) : 0.f);
      m = mn;
    }
    if (lane == 0) {
      float* o = p.out + row * (3 + Ce);
      o[0] = p.comb[row * 3] + ax / wsum;
      o[1] = p.comb[row * 3 + 1] + ay / wsum;
      o[2] = p.comb[row * 3 + 2] + az / wsum;
#pragma unroll
      for (int c = 0; c < PAYLOAD_MAX; ++c)
        if (c < Ce) o[3 + c] = acc[c] / wsum;
    }
  }
}

static size_t tail_smem(int S) {
  return sizeof(float) * (ONE_NW + TAIL_WARPS * 2 * S * TAIL_BUF);
}

// comb [B, N, 3], resi [B, N, k, 3], extra [B, N, k, Ce] (null for Ce == 0)
// fp32; wtc the score MLP (4 -> h1 -> h2 -> h3) split by
// _build.pack_tf32(..., chain=True); out [B, N, 3 + Ce]; k >= 1 (the
// kernel by k: S = 2 past 32, the streaming kernel past 64, with Ce <=
// PAYLOAD_MAX there).  A grid of TAIL_BLOCKS_PER_SM blocks an SM (at most
// one a warp's row).
extern "C" int pci_fusion_tail(const void* comb, const void* resi,
                               const void* extra, const void* wtc, int h1,
                               int h2, int h3, void* out, int B, int N, int k,
                               int Ce, void* stream) {
  if (h1 != ONE_H1 || h2 != ONE_H2 || h3 != ONE_H3 || k < 1 || Ce < 0 ||
      (k > 64 && Ce > PAYLOAD_MAX) || (Ce > 0 && extra == nullptr) || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int S = k > 64 ? 0 : k > 32 ? 2 : 1;
  const auto fusion_tail_kernel_s = S == 0 ? fusion_tail_stream_kernel
                                    : S == 2 ? fusion_tail_kernel<2> : fusion_tail_kernel<1>;
  const size_t smem = tail_smem(S);
  cudaError_t e = allow_smem(fusion_tail_kernel_s, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fusion_tail_kernel_s,
                                                    TAIL_WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  TailParams p;
  p.comb = static_cast<const float*>(comb);
  p.resi = static_cast<const float*>(resi);
  p.extra = static_cast<const float*>(extra);
  p.wtc = static_cast<const float*>(wtc);
  p.out = static_cast<float*>(out);
  p.rows = (long long)B * N;
  p.k = k;
  p.Ce = Ce;
  const long long blocks = (p.rows + TAIL_WARPS - 1) / TAIL_WARPS;
  const int grid = (int)std::max(1LL, std::min((long long)std::max(per_sm, 1) * sms, blocks));
  fusion_tail_kernel_s<<<grid, TAIL_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The tail kernel's resources (common.cuh's kernel_attrs), k <= 32 and k <= 64.
extern "C" int pci_fusion_tail_attrs(int* out) {
  return kernel_attrs(fusion_tail_kernel<1>, tail_smem(1), out, TAIL_WARPS * 32);
}
extern "C" int pci_fusion_tail64_attrs(int* out) {
  return kernel_attrs(fusion_tail_kernel<2>, tail_smem(2), out, TAIL_WARPS * 32);
}
extern "C" int pci_fusion_tail_stream_attrs(int* out) {
  return kernel_attrs(fusion_tail_stream_kernel, tail_smem(0), out, TAIL_WARPS * 32);
}
