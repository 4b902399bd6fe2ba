// Dense layers on the tensor cores at fp32 accuracy (3xTF32), shared by the
// one-shot fusion (csrc/fusion_knn.cu), the FlowNet3D megakernels
// (csrc/flowmid.cu, csrc/flowenc.cu), kNN-conv and the vector-attention
// tail (csrc/attention.cu, csrc/attention_bwd.cu).
//
// The split.  A TF32 operand keeps 10 of fp32's 23 mantissa bits (about
// 5e-4 relative), too coarse for the fusion's scores, which pass through
// exp.  So every operand is split in two TF32 values, x_hi =
// cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x - x_hi), and a product is
// accumulated as a_hi*w_lo + a_lo*w_hi + a_hi*w_hi in fp32 (the a_lo*w_lo
// term, ~2^-22 relative, is dropped): close to fp32 at three times the
// tensor work, still far above the scalar rate (495 TF32 TFLOP/s against
// 67 fp32 on an H100 SXM).  The weights are split once on the host
// (_build.PackedLayers.tf32); the activations in the kernel.
//
// The instruction is mma.sync.aligned.m16n8k8 with .tf32 operands, not
// wgmma: a warp owns a 16-row tile on its own, so the fusion keeps each
// query's 32 slots in one warp's registers from layer to layer (no shared
// memory, no warpgroup barrier between the key scan and the head), and the
// decode megakernel's tiles of 16-64 rows need no 64-row warpgroup tile.
// Its A operand comes from registers either way.
//
// Summation order.  Every output is acc = 0 and small = 0, then for each
// k-step of 8 inputs in order acc += a_hi*w_hi (summed by the tensor core
// from zero) and small += a_hi*w_lo + a_lo*w_hi (mma_3xtf32_apart), then
// (acc + small) + bias (then ReLU).  The order over K depends on neither
// the tile plan nor the batch, so a stream and its single request, or a
// re-run, give the same bits.
//
// Weight layout (a layer, fp32, written by _build._tf32_pack): W^T padded
// with zeros to [K8][N8] (multiples of 8), then for each k-step kt and
// n-tile nt (kt-major) 32 float4s, lane L's = (hi[k0][n], hi[k1][n],
// lo[k0][n], lo[k1][n]) with n = 8 nt + L / 4 and, t = L % 4, k0 = 8 kt + t,
// k1 = k0 + 4 (the mma's B fragment); then the bias padded to N8.  A
// "chained" layer, one that takes its A operand straight from the previous
// layer's accumulators, has k0 = 8 kt + 2 t, k1 = k0 + 1 instead (the
// accumulator fragment's columns).  A k-step's slice for a run of n-tiles
// is one contiguous block, so it streams with plain 16-byte copies.
#pragma once

#include "common.cuh"

// Float offsets of the split layers in a buffer laid out as above: for each
// layer l, the fragments at woff[l] (K8 * N8 * 2 floats), the bias at
// boff[l] (N8 floats).  dims are the true widths.
static inline MlpSpec make_tf32_spec(const int* dims, int n, long long base) {
  MlpSpec s;
  s.n = n;
  long long off = base;
  for (int l = 0; l <= n && l <= PCI_MAX_LAYERS; ++l) s.dims[l] = dims[l];
  for (int l = 0; l < n && l < PCI_MAX_LAYERS; ++l) {
    const long long k8 = round_up(dims[l], 8), n8 = round_up(dims[l + 1], 8);
    s.woff[l] = off;
    off += k8 * n8 * 2;
    s.boff[l] = off;
    off += n8;
  }
  return s;
}

// x -> (hi, lo) TF32 bit patterns, x ~= hi + lo to ~2^-22 relative.  Each
// half is cvt.rna.tf32.f32 (nearest, ties away from zero) done in integer
// arithmetic on the bits, the same bits for every finite x (and
// _build.tf32_round's formula): the conversion instruction issues at a
// quarter of the integer rate, and a kernel that splits both operands of
// every product (csrc/attention_bwd.cu) was bound by it.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float r = x - __uint_as_float(h);
  hi = h;
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16x8x8 step of d += a * w in 3xTF32, w = this lane's float4 of the
// layout above.  The tensor core truncates as it adds into its
// accumulator, an ulp of the running sum a step over a long K, so the
// products are kept apart: a_hi*w_lo + a_lo*w_hi go into `small`, a
// running sum some 2^-11 of the result, whose truncation does not show,
// and a_hi*w_hi alone (from zero) into d by an fp32 add, which rounds to
// nearest.  The caller adds small into d at the end.
__device__ __forceinline__ void mma_3xtf32_apart(float (&d)[4], float (&small)[4],
                                                 const uint32_t (&ahi)[4],
                                                 const uint32_t (&alo)[4], float4 w) {
  const uint32_t bh0 = __float_as_uint(w.x), bh1 = __float_as_uint(w.y);
  const uint32_t bl0 = __float_as_uint(w.z), bl1 = __float_as_uint(w.w);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(small, alo, bh0, bh1);
  float p0, p1, p2, p3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(p0), "=f"(p1), "=f"(p2), "=f"(p3)
      : "r"(ahi[0]), "r"(ahi[1]), "r"(ahi[2]), "r"(ahi[3]), "r"(bh0), "r"(bh1), "f"(0.f));
  d[0] += p0, d[1] += p1, d[2] += p2, d[3] += p3;
}

// The chained A fragment of a k-step from the previous layer's n-tile acc:
// (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1), split.
__device__ __forceinline__ void split_chained(const float (&acc)[4], uint32_t (&ahi)[4],
                                              uint32_t (&alo)[4]) {
  tf32_split(acc[0], ahi[0], alo[0]);
  tf32_split(acc[2], ahi[1], alo[1]);
  tf32_split(acc[1], ahi[2], alo[2]);
  tf32_split(acc[3], ahi[3], alo[3]);
}

// The A fragment of rows r0 + g, r0 + g + 8 (g = lane / 4), columns
// k0 + t, k0 + t + 4 (t = lane % 4) of a row-major fp32 tile, split.  With
// ld % 8 == 4 the 32 lanes read 32 different banks.
__device__ __forceinline__ void load_a_split(const float* h, int ld, int r0, int k0,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = h + (size_t)(r0 + g) * ld + k0 + t;
  tf32_split(p[0], hi[0], lo[0]);
  tf32_split(p[(size_t)8 * ld], hi[1], lo[1]);
  tf32_split(p[4], hi[2], lo[2]);
  tf32_split(p[(size_t)8 * ld + 4], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- block-wide layers over rows in shared memory (csrc/flowmid.cu) ------

#define MMA_NTW 4    // n-tiles (32 outputs) a k-step of the weight ring, at most
#define MMA_DEPTH 4  // weight k-steps a thread keeps in its ring
#define MMA_THREADS 256
// floats of a weight ring of `ntw` n-tiles a k-step (each thread's
// MMA_DEPTH x ntw float4 slots, slot-major so a warp's lanes read
// neighbouring float4s)
#define MMA_RING_FLOATS(ntw) (MMA_DEPTH * (ntw) * 4 * MMA_THREADS)

// A weight ring in shared memory: its floats and n-tiles a k-step.
struct MmaRing {
  float* buf;
  int ntw;
};

// One dense layer over MT 16-row tiles held in shared memory, by every
// thread of the block:
//   hout[r][o] = act(b[o] + sum_i hin[r][i] * W[i][o]),  o < N8
// hin holds whole 16-row tiles (rows >= R are computed from whatever is
// there and their outputs are never read as real rows), its columns
// [cin, K8) are zero; hout's columns [cout, N8) come out zero.  ldi and
// ldo are % 8 == 4.
//
// The work is items of up to NTW n-tiles over all MT row tiles, so the
// block reads each weight once a layer; the items stride over the warps
// (fewer n-tiles an item where that leaves a warp without one), and a warp
// walks its item's K on its own, with no block barrier until the layer
// ends.  The weights stream through a ring in shared memory by cp.async:
// each lane copies the B fragments it will read (16 bytes an n-tile a
// k-step) MMA_DEPTH - 1 k-steps ahead of its mma, into its own slots
// (`ring`), so its cp.async.wait_group alone makes them visible; a slot is
// refilled one k-step after its mma read it.
template <int MT, int NTW>
__device__ __forceinline__ void mma_dense_tiles(const float* __restrict__ wf,
                                                const float* __restrict__ bias,
                                                const float* hin, int ldi, float* hout,
                                                int ldo, int cin, int cout, bool relu,
                                                MmaRing ring) {
  const int KT = round_up(cin, 8) / 8, NT = round_up(cout, 8) / 8;
  const int nwarps = blockDim.x >> 5;
  const int ntw = min(min(ring.ntw, NTW), NT >= 4 * nwarps ? 4 : (NT >= 2 * nwarps ? 2 : 1));
  const int items = (NT + ntw - 1) / ntw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float4* wf4 = reinterpret_cast<const float4*>(wf);
  float4* mine = reinterpret_cast<float4*>(ring.buf) + threadIdx.x;  // slot s: mine[s * blockDim.x]
  for (int it = warp; it < items; it += nwarps) {
    const int n0 = it * ntw, nn = min(ntw, NT - n0);
    auto issue = [&](int kt) {  // this lane's fragments of k-step kt
      if (kt < KT) {
        const float4* src = wf4 + ((size_t)kt * NT + n0) * 32 + lane;
        float4* dst = mine + (kt % MMA_DEPTH) * ring.ntw * blockDim.x;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (j < nn) cp_async16(dst + j * blockDim.x, src + j * 32);
      }
      cp_async_commit();
    };
    float acc[MT][NTW][4], small[MT][NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = small[m][j][e] = 0.f;
#pragma unroll
    for (int d = 0; d < MMA_DEPTH - 1; ++d) issue(d);
    for (int kt = 0; kt < KT; ++kt) {
      issue(kt + MMA_DEPTH - 1);      // into the slot k-step kt - 1 read
      cp_async_wait<MMA_DEPTH - 1>();  // k-step kt's fragments are in
      const float4* s = mine + (kt % MMA_DEPTH) * ring.ntw * blockDim.x;
      float4 w[NTW];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < nn) w[j] = s[j * blockDim.x];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ahi[4], alo[4];
        load_a_split(hin, ldi, m * 16, kt * 8, ahi, alo);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (j < nn) mma_3xtf32_apart(acc[m][j], small[m][j], ahi, alo, w[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < nn) {
        const int c = (n0 + j) * 8 + 2 * t;
        const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float v0 = (acc[m][j][0] + small[m][j][0]) + b0;
          float v1 = (acc[m][j][1] + small[m][j][1]) + b1;
          float v2 = (acc[m][j][2] + small[m][j][2]) + b0;
          float v3 = (acc[m][j][3] + small[m][j][3]) + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f), v2 = fmaxf(v2, 0.f), v3 = fmaxf(v3, 0.f);
          }
          const int r = m * 16 + g;
          *reinterpret_cast<float2*>(hout + (size_t)r * ldo + c) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(hout + (size_t)(r + 8) * ldo + c) = make_float2(v2, v3);
        }
      }
    }
  }
  __syncthreads();  // hout is whole for the next layer
}

// mma_dense_tiles over R <= 64 rows: 1, 2 or 4 row tiles (at most 32
// accumulators a thread, and as many for the small products).
__device__ __forceinline__ void mma_dense_rows(const float* __restrict__ wf,
                                               const float* __restrict__ bias,
                                               const float* hin, int ldi, float* hout,
                                               int ldo, int R, int cin, int cout, bool relu,
                                               MmaRing ring) {
  if (R <= 16)
    mma_dense_tiles<1, 4>(wf, bias, hin, ldi, hout, ldo, cin, cout, relu, ring);
  else if (R <= 32)
    mma_dense_tiles<2, 4>(wf, bias, hin, ldi, hout, ldo, cin, cout, relu, ring);
  else
    mma_dense_tiles<4, 2>(wf, bias, hin, ldi, hout, ldo, cin, cout, relu, ring);
}

// The chain over R rows on the tensor cores, ping-ponging between a (lda floats a row) and b (ldb), both % 8 ==
// 4 and wide enough for the layers that land there, whole 16-row tiles,
// a's columns [dims[0], K8) zero; returns the buffer that holds the last
// layer's output and its row stride in ld_out.  wbuf / m: make_tf32_spec's
// layout.
__device__ __forceinline__ float* mma_mlp_rows(const float* __restrict__ wbuf,
                                               const MlpSpec& m, float* a, int lda,
                                               float* b, int ldb, int R, int n_linear,
                                               MmaRing ring, int& ld_out) {
  for (int l = 0; l < m.n; ++l) {
    mma_dense_rows(wbuf + m.woff[l], wbuf + m.boff[l], a, lda, b, ldb, R, m.dims[l],
                   m.dims[l + 1], l < m.n - n_linear, ring);
    float* t = a;
    a = b;
    b = t;
    const int tl = lda;
    lda = ldb;
    ldb = tl;
  }
  ld_out = lda;
  return a;
}

// The MLP routine of csrc/stages.cuh's tiles on the tensor cores (see
// ball_conv_tile there): rows in 16-row tiles, row strides % 8 == 4, the
// layers' input pads zeroed by the tile, a weight ring after the tile's
// buffers.
struct TensorMlp {
  static constexpr bool kTensor = true;
  static constexpr int kRows = 16;
  __device__ static __forceinline__ float* run(const float* __restrict__ w, const MlpSpec& m,
                                               float* a, int lda, float* b, int ldb, int R,
                                               int n_linear, MmaRing ring, int& ld_out) {
    return mma_mlp_rows(w, m, a, lda, b, ldb, R, n_linear, ring, ld_out);
  }
};
