// PointNet++ MSG mid-section in one launch: sa2, sa3, sa4 (centres by greedy
// FPS inside, two ball scales a level, GroupNorm MLPs, slot max), then fp4,
// fp3, fp2 (3-NN inverse-distance interpolation, [skip | interp], GroupNorm
// MLPs); only fp2's rows leave it.
//
// Replaces pci_tpu/ops/pallas_kernels/pn2mid_tpu.py:pn2mid_fused.  On the
// ISAPCInet path, a sample (l1 = sa1's 1,024 centres with 96 channels):
//   FPS l1 1024 -> c2 256 -> c3 64 -> c4 16 (exact greedy from index 0);
//   sa2  centres c2, keys [l1 | l1_f], r .2 / .4, K 16 / 32,
//        99 -> 64 -> 64 -> 128 and 99 -> 64 -> 96 -> 128       -> l2_f [256, 256]
//   sa3  centres c3, keys [c2 | l2_f], r .4 / .8, K 16 / 32,
//        259 -> 128 -> 196 -> 256 (both)                       -> l3_f [64, 512]
//   sa4  centres c4, keys [c3 | l3_f], r .8 / 1.6, K 16 / 32,
//        515 -> 256 -> 256 -> 512, 515 -> 256 -> 384 -> 512    -> l4_f [16, 1024]
//   fp4  q c3, keys [c4 | l4_f], skip l3_f, 1536 -> 256 -> 256 -> l3' [64, 256]
//   fp3  q c2, keys [c3 | l3'], skip l2_f, 512 -> 256 -> 256   -> l2' [256, 256]
//   fp2  q l1, keys [c2 | l2'], skip l1_f, 352 -> 256 -> 128   -> out [1024, 128]
// Every layer is Dense -> GroupNorm(4, eps 1e-5) -> ReLU; a group's
// statistics run over all rows of a sample and the group's channels, with
// var = max(E[x^2] - mean^2, 0) (pn2mid_tpu.py:_gn_relu).  A ball takes the
// first K keys within the radius in index order and pads with the first
// hit; an empty ball reads key row 0 (pn2mid_tpu.py:126-129; the centres
// are FPS picks of the keys, so none is empty here).  The 3-NN is exact,
// ties to the lower index (not the TPU's mantissa-packed keys), with
// weights 1 / (d + 1e-8) from the exact distances, num / den.
//
// What bounds it on the H100: ~1.1 GFMA of dense layers a sample (sa2's
// 12,288 slot rows the most) against ~3 MB of weights: operations, ~0.02
// ms in 3xTF32 on the tensor cores.  In practice the latency of its 19
// dependent phases: GroupNorm's statistics are global per sample, so every
// layer ends at a grid barrier.  Design:
//   - a cooperative launch (as csrc/flowmid.cu), two blocks an SM, strides
//     every block over the phase's items; an item is a tile of 64 rows (an
//     SA level's first layer: whole centres, 64 / K of them) x a column
//     tile of 2 or 4 n-tiles (16 or 32 output channels), the columns cut
//     finer where a layer has few row tiles, so every layer spreads over
//     the SMs; an FP level's first layer (1,536, 512 and 352 inputs at
//     ISAPCInet's widths) is also split by input chunks of 256 (fp4's 64
//     rows: 96 items, not one), its chunks' partial products summed in
//     order by a short phase of their own;
//   - every dense product on the tensor cores in 3xTF32 (mma_tf32.cuh,
//     weights split once on the host, pn2mid_cuda.pack_tc), the A operand
//     the input rows built in shared memory 256 columns at a time ([feats |
//     dxyz] from the ball ids, [skip | interp] from the 3-NN, or the
//     previous layer's rows, copied by cp.async and normalised in place),
//     each of the 8 warps one 16-row m-tile x half the column tile's
//     n-tiles, the B fragments read from L2 three k-steps ahead;
//   - a tile writes its pre-activations to device scratch (they stay in
//     L2) and its per-group sums, in fp64 and in a fixed order, to its own
//     slot; after the barrier every block reduces the slots in order, so a
//     run gives the same bits every time;
//   - no finishing pass between levels: an SA level's last layer keeps,
//     per centre and channel, the max and the min of its pre-activations
//     over the K slots, and the reader of the level's features (the next
//     level's first layer, an FP layer's skip or keys) applies
//     relu(GroupNorm) to the max, or to the min where the channel's scale
//     is negative (the map is monotone, so this is the max over the slots
//     of the normalised values, bit for bit); an FP level's rows are
//     normalised by their reader the same way; only fp2's output is
//     finished in a last pass;
//   - the FPS on stages.cuh:fps_centres (the group chain on the block's
//     8 warps above 256 points, its one-warp chain up to 256), c3 and c4
//     beside sa2's first layer; the three FP levels' 3-NN once, beside
//     sa2's second layer, one warp a query over the whole grid.
// Optional %globaltimer stamps (a measurement launch) give each block's
// arrival at and leaving of every phase's barrier and its time in each
// part of its items (chip_smoke.py's `stages pn2mid` line).
#include "stages.cuh"

#define PN_CHAINS 9
#define PN_MAXB 16
#define PN_MAXL 3
#define PN_THREADS 256
#define PN_ROWS 64           // rows a tile: 4 m-tiles of 16
#define PN_KC 256            // input columns built a pass
#define PN_LDX (PN_KC + 4)   // % 8 == 4: conflict-free A fragments
#define PN_MAXNT 4           // n-tiles a column tile at most (2 a warp)
#define PN_LDH (8 * PN_MAXNT + 4)
#define PN_PREF 4            // k-steps of B fragments a warp keeps in flight
#define PN_SLOTS (PN_CHAINS + 2)  // statistics: each chain's last layer, the phase's previous layers
#define PN_PHASES 21  // start, FPS, 3 x 3 SA layers, 3 x (2 FP layers, a sum), finish
// a phase's stamps, a block: its arrival at and leaving of the phase's grid
// barrier (%globaltimer ns), then its summed time in each part of its
// items (ball / 3-NN ids, the chunks' column tables, the input rows, the
// products, the output and statistics; between its block barriers, on
// thread 0's clock) and its items
#define PN_ST 8
#define PN_T_IDS 2
#define PN_T_COLS 3
#define PN_T_BUILD 4
#define PN_T_MMA 5
#define PN_T_OUT 6
#define PN_T_ITEMS 7

// Features [B][n][C]: plain rows (x), or the output of one or two chains
// (g0's cout channels, then g1's), normalised by their reader.
struct PnView {
  const float* x;
  int n, C, g0, g1, c0;
};

struct PnLayer {
  const float* wtc;  // split W (mma_tf32.cuh layout), then the bias padded to N8
  const float* aux;  // [3][cout]: dense bias, gn scale, gn bias
  float* H;          // pre-activations [B][rows][cout] (not an SA chain's last layer)
  double* part;      // per-tile group sums [B][rt * ct][4][2]
  float* Pp;         // split K: the chunks' partial products [ks][B][rows][cout]
  int cin, cout, rt, ct, nti;  // row tiles, column tiles, n-tiles a column tile
  int ks;            // input chunks computed apart (split K; 1: none)
};

// One MLP chain: a scale of an SA level (rows = S centres x K slots) or an
// FP level (rows = S queries).  Keys kx [B][Nk][3] with features kf;
// centres (queries) c [B][S][3]; FP: skip.  Its output as a view: an SA
// chain's per-centre max and min of the last layer (mx, mn [B][S][cout]),
// an FP chain's last layer (mx = mn = its H).
struct PnChain {
  PnLayer L[PN_MAXL];
  PnView kf, skip;
  const float* c;
  const float* kx;
  const float* mx;
  const float* mn;
  float* mxw;  // SA: where the last layer's tiles write mx and mn
  float* mnw;
  int* nn_i;   // FP: each query's 3-NN [B][S][3] and their weights
  float* nn_w;
  int nl, fp, rows, S, Nk, K;
  float r2;
};

struct PnParams {
  PnChain ch[PN_CHAINS];
  const float* l1x;   // [B][N1][3]
  float* cx[3];       // c2, c3, c4: [B][S][3]
  float* out;         // [B][N1][cout of fp2]
  unsigned int* bar;  // the grid barrier's counter, zeroed
  unsigned long long* stamps;  // [grid][PN_PHASES][PN_ST], or null
  int B, N1, S[3];
};

struct PnStats {
  float mean[PN_SLOTS][PN_MAXB][4], rstd[PN_SLOTS][PN_MAXB][4];
};

// A block's clock for its items' parts in one phase (null: no stamps).
struct PnClock {
  unsigned long long* s;
  unsigned long long t;
};

__device__ __forceinline__ void pn_tick(PnClock& c, int part) {
  if (!c.s || threadIdx.x) return;
  const unsigned long long now = global_ns();
  if (part >= 0) c.s[part] += now - c.t;
  c.t = now;
}

// Group statistics of layer l of chain g into st slot `slot`, from the
// item slots (every block alike): a warp a (sample, group), lane L summing
// slots L, L + 32, ..., then a butterfly over the lanes: a fixed order.
__device__ void pn_fill(const PnParams& p, int slot, int g, int l, PnStats& st) {
  const PnChain& ch = p.ch[g];
  const PnLayer& L = ch.L[l];
  const int items = L.rt * L.ct;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < p.B * 4; e += blockDim.x >> 5) {
    const int bb = e / 4, gg = e % 4;
    const double* pt = L.part + (size_t)bb * items * 8 + gg * 2;
    double s = 0.0, ss = 0.0;
    for (int t = lane; t < items; t += 32) {
      s += pt[t * 8];
      ss += pt[t * 8 + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      const double n = (double)ch.rows * (L.cout / 4);
      const float mean = (float)(s / n), mean2 = (float)(ss / n);
      const float var = fmaxf(mean2 - mean * mean, 0.f);
      st.mean[slot][bb][gg] = mean;
      st.rstd[slot][bb][gg] = rsqrtf(var + 1e-5f);
    }
  }
}

// The statistics a view's reader needs: its chains' last layers.
__device__ __forceinline__ void pn_fill_view(const PnParams& p, const PnView& v, PnStats& st) {
  if (v.x || v.g0 < 0) return;  // plain rows, or none (an SA chain's skip)
  pn_fill(p, v.g0, v.g0, p.ch[v.g0].nl - 1, st);
  if (v.g1 >= 0) pn_fill(p, v.g1, v.g1, p.ch[v.g1].nl - 1, st);
}

// relu(GroupNorm(h)) of channel c of a chain's layer L, with the statistics
// in st slot `slot`, sample b: (h - mean) * (rstd * scale) + bias.
__device__ __forceinline__ float pn_norm(const PnLayer& L, const PnStats& st, int slot, int b,
                                         int c, float h) {
  const int g = c / (L.cout / 4);
  return fmaxf((h - st.mean[slot][b][g]) * (st.rstd[slot][b][g] * L.aux[L.cout + c]) +
                   L.aux[2 * L.cout + c],
               0.f);
}

// How the build reads an input column: src[row * ld] from the column's
// source rows of sample b, raw or normalised, relu((h - mean) * mul +
// bias).  A chain's view reads its max where the map rises with h and its
// min where it falls (a negative scale): the max over slots of the
// normalised values.
struct PnCol {
  const float* src;
  int ld, norm;
  float mean, mul, bias, pad;
};

__device__ __forceinline__ PnCol pn_col_view(const PnParams& p, const PnView& v,
                                             const PnStats& st, int b, int c) {
  PnCol t;
  if (v.x) {
    t.src = v.x + (size_t)b * v.n * v.C + c;
    t.ld = v.C, t.norm = 0;
    t.mean = 0.f, t.mul = 1.f, t.bias = 0.f;
    return t;
  }
  const bool first = c < v.c0;
  const int g = first ? v.g0 : v.g1, cc = first ? c : c - v.c0;
  const PnChain& ch = p.ch[g];
  const PnLayer& L = ch.L[ch.nl - 1];
  const int gg = cc / (L.cout / 4);
  t.mean = st.mean[g][b][gg];
  t.mul = st.rstd[g][b][gg] * L.aux[L.cout + cc];
  t.bias = L.aux[2 * L.cout + cc];
  t.src = (t.mul >= 0.f ? ch.mx : ch.mn) + (size_t)b * ch.S * L.cout + cc;
  t.ld = L.cout, t.norm = 1;
  return t;
}

__device__ __forceinline__ float pn_val(const PnCol& t, int row) {
  const float h = t.src[(size_t)row * t.ld];
  return t.norm ? fmaxf((h - t.mean) * t.mul + t.bias, 0.f) : h;
}

// Shared memory of an item: the input chunk, the output tile, the chunk's
// columns, the column sums, the ball / 3-NN ids and weights.
struct PnSmem {
  float X[PN_ROWS * PN_LDX];
  float Hs[PN_ROWS * PN_LDH];
  PnCol col[PN_KC];
  double csum[8 * 8 * PN_MAXNT * 2];
  int sidx[3 * PN_ROWS];
  float swt[3 * PN_ROWS];
};

// The tile's pre-activations (in sm.Hs, columns local to the column tile)
// out: to H, or for the last SA layer each centre's max and min over its K
// slots; its per-group sums to its slot.
__device__ void pn_tile_out(const PnChain& ch, const PnLayer& L, int l, int b, int t, int u,
                            PnSmem& sm, PnClock& ck) {
  const int cout = L.cout, NT = round_up(cout, 8) / 8;
  const int r0 = t * PN_ROWS, nr = min(PN_ROWS, ch.rows - r0);
  const int j0 = u * L.nti, nj = min(L.nti, NT - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int c0 = 8 * j0, cw = min(8 * nj, cout - c0);  // the tile's real columns
  if (!ch.fp && l == ch.nl - 1) {
    // the last SA layer: each centre's max and min over its K slots
    const int K = ch.K, s0 = r0 / K, Q = nr / K;
    for (int e = threadIdx.x; e < Q * cw; e += blockDim.x) {
      const int qi = e / cw, cl = e - qi * cw;
      float mx = -CUDART_INF_F, mn = CUDART_INF_F;
      for (int k = 0; k < K; ++k) {
        const float v = sm.Hs[(qi * K + k) * PN_LDH + cl];
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
      }
      const size_t o = ((size_t)b * ch.S + s0 + qi) * cout + c0 + cl;
      ch.mxw[o] = mx;
      ch.mnw[o] = mn;
    }
  } else {
    float* Hg = L.H + ((size_t)b * ch.rows + r0) * cout + c0;
    for (int r = warp; r < nr; r += nwarps)
      for (int cl = lane; cl < cw; cl += 32) Hg[(size_t)r * cout + cl] = sm.Hs[r * PN_LDH + cl];
  }
  // column sums: 8 threads a column, each over rows r = j, j + 8, ...;
  // then each column's 8 parts, then a group's columns, in order
  for (int e = threadIdx.x; e < 8 * cw; e += blockDim.x) {
    const int cl = e >> 3, j = e & 7;
    double s = 0.0, ss = 0.0;
    for (int r = j; r < nr; r += 8) {
      const float v = sm.Hs[r * PN_LDH + cl];
      s += v;
      ss += v * v;  // rounded to fp32, as the plain version squares
    }
    sm.csum[2 * e] = s;
    sm.csum[2 * e + 1] = ss;
  }
  __syncthreads();
  for (int cl = threadIdx.x; cl < cw; cl += blockDim.x) {  // a column's 8 parts, in order
    double s = sm.csum[16 * cl], ss = sm.csum[16 * cl + 1];
    for (int j = 1; j < 8; ++j) {
      s += sm.csum[16 * cl + 2 * j];
      ss += sm.csum[16 * cl + 2 * j + 1];
    }
    sm.csum[16 * cl] = s;
    sm.csum[16 * cl + 1] = ss;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int g = threadIdx.x, gsz = cout / 4;
    double s = 0.0, ss = 0.0;
    for (int cl = 0; cl < cw; ++cl) {
      if ((c0 + cl) / gsz != g) continue;
      s += sm.csum[16 * cl];
      ss += sm.csum[16 * cl + 1];
    }
    double* slot = L.part + ((size_t)b * L.rt * L.ct + (size_t)t * L.ct + u) * 8 + g * 2;
    slot[0] = s;
    slot[1] = ss;
  }
  pn_tick(ck, PN_T_OUT);
}

// Item (row tile t, column tile u, input chunk ks of a split layer, -1
// for all) of layer l of chain ch (index ci in the phase) for sample b.
__device__ void pn_item(const PnParams& p, const PnChain& ch, int ci, int l, int b, int t,
                        int u, int ks, const PnStats& st, PnSmem& sm, PnClock& ck) {
  const PnLayer& L = ch.L[l];
  const int cin = L.cin, cout = L.cout, NT = round_up(cout, 8) / 8;
  const int r0 = t * PN_ROWS, nr = min(PN_ROWS, ch.rows - r0);
  const int j0 = u * L.nti, nj = min(L.nti, NT - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const float* KX = ch.kx + (size_t)b * ch.Nk * 3;
  const float* CX = ch.c + (size_t)b * ch.S * 3;
  __syncthreads();  // the block's previous item is done with the buffers
  pn_tick(ck, -1);
  if (ck.s && threadIdx.x == 0) ++ck.s[PN_T_ITEMS];
  if (l == 0 && !ch.fp) {
    // ball query: one warp a centre, the first K keys in index order
    const int K = ch.K, s0 = r0 / K, Q = nr / K;
    for (int qi = warp; qi < Q; qi += nwarps) {
      int* id = sm.sidx + qi * K;
      const float qx = CX[(s0 + qi) * 3], qy = CX[(s0 + qi) * 3 + 1],
                  qz = CX[(s0 + qi) * 3 + 2];
      int count = 0;
      for (int base = 0; base < ch.Nk && count < K; base += 32) {
        const int j = base + lane;
        bool hit = false;
        if (j < ch.Nk)
          hit = sqdist3(KX[j * 3], KX[j * 3 + 1], KX[j * 3 + 2], qx, qy, qz) <= ch.r2;
        count = ball_place(hit, j, count, K, id);
      }
      ball_pad(id, count, K, 0);  // an empty ball reads key row 0
    }
  } else if (l == 0) {  // the rows' 3-NN, found in an earlier phase (pn_three_nn)
    for (int e = threadIdx.x; e < 3 * nr; e += blockDim.x) {
      sm.sidx[e] = ch.nn_i[((size_t)b * ch.S + r0) * 3 + e];
      sm.swt[e] = ch.nn_w[((size_t)b * ch.S + r0) * 3 + e];
    }
  }
  // the warp's share of the dense product: m-tile mw, the column tile's
  // n-tiles nh, nh + 2, ...
  const int mw = warp & 3, nh = warp >> 2;
  const bool mlive = 16 * mw < nr;
  float acc[PN_MAXNT / 2][4], small[PN_MAXNT / 2][4];
#pragma unroll
  for (int i = 0; i < PN_MAXNT / 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = small[i][e] = 0.f;
  const float4* w4 = reinterpret_cast<const float4*>(L.wtc);
  const int kend = ks < 0 ? cin : min(cin, (ks + 1) * PN_KC);
  for (int kc0 = ks < 0 ? 0 : ks * PN_KC; kc0 < kend; kc0 += PN_KC) {
    const int kcn = min(PN_KC, cin - kc0), kcp = round_up(kcn, 8);
    __syncthreads();  // the ids are in; the previous chunk's products are done
    pn_tick(ck, kc0 == (ks < 0 ? 0 : ks * PN_KC) ? PN_T_IDS : PN_T_MMA);
    // the chunk's columns: where each reads, raw or normalised
    for (int c = threadIdx.x; c < kcn; c += blockDim.x) {
      const int cc = kc0 + c;
      PnCol cd;
      if (l > 0) {  // the previous layer's statistics (its rows come by cp.async)
        const PnLayer& P = ch.L[l - 1];
        const int slot = PN_CHAINS + ci, gg = cc / (cin / 4);
        cd.mean = st.mean[slot][b][gg];
        cd.mul = st.rstd[slot][b][gg] * P.aux[cin + cc];
        cd.bias = P.aux[2 * cin + cc];
      } else if (!ch.fp) {  // [feats | dxyz]: the dxyz columns read no table
        cd = cc < ch.kf.C ? pn_col_view(p, ch.kf, st, b, cc) : PnCol{};
      } else {  // [skip | interp]
        cd = cc < ch.skip.C ? pn_col_view(p, ch.skip, st, b, cc)
                            : pn_col_view(p, ch.kf, st, b, cc - ch.skip.C);
      }
      sm.col[c] = cd;
    }
    __syncthreads();
    pn_tick(ck, PN_T_COLS);
    // a first layer's inputs: rows r = warp + 8 i (i < 8) of column c = lane
    // + 32 j, the 8 rows' loads of a column independent, in flight together
    auto col_vals = [&](int c, float (&v)[PN_ROWS / 8]) {
      const int cc = kc0 + c;
      if (c >= kcn) {
#pragma unroll
        for (int i = 0; i < PN_ROWS / 8; ++i) v[i] = 0.f;
      } else if (!ch.fp) {
        const int K = ch.K;
        if (cc < ch.kf.C) {  // the key's features
          const PnCol cd = sm.col[c];
#pragma unroll
          for (int i = 0; i < PN_ROWS / 8; ++i) {
            const int r = warp + 8 * i;
            v[i] = r < nr ? pn_val(cd, sm.sidx[r]) : 0.f;
          }
        } else {  // the key's offset from its centre
          const int d = cc - ch.kf.C;
#pragma unroll
          for (int i = 0; i < PN_ROWS / 8; ++i) {
            const int r = warp + 8 * i;
            v[i] = r < nr ? KX[sm.sidx[r] * 3 + d] - CX[((r0 + r) / K) * 3 + d] : 0.f;
          }
        }
      } else if (cc < ch.skip.C) {  // the query's skip features
        const PnCol cd = sm.col[c];
#pragma unroll
        for (int i = 0; i < PN_ROWS / 8; ++i) {
          const int r = warp + 8 * i;
          v[i] = r < nr ? pn_val(cd, r0 + r) : 0.f;
        }
      } else {  // the 3-NN interpolation, num / den
        const PnCol cd = sm.col[c];
#pragma unroll
        for (int i = 0; i < PN_ROWS / 8; ++i) {
          const int r = warp + 8 * i;
          float num = 0.f, den = 0.f;
          if (r < nr) {
            const float f0 = pn_val(cd, sm.sidx[r * 3]), f1 = pn_val(cd, sm.sidx[r * 3 + 1]),
                        f2 = pn_val(cd, sm.sidx[r * 3 + 2]);
            const float w0 = sm.swt[r * 3], w1 = sm.swt[r * 3 + 1], w2 = sm.swt[r * 3 + 2];
            num = w0 * f0;
            den = w0;
            num += w1 * f1;
            den += w1;
            num += w2 * f2;
            den += w2;
          }
          v[i] = r < nr ? num / den : 0.f;
        }
      }
    };
    if (l > 0) {
      // the previous layer's rows: copied raw by cp.async (16 bytes a copy,
      // every copy in flight at once), then normalised in place
      const float* H = ch.L[l - 1].H + ((size_t)b * ch.rows + r0) * cin + kc0;
      const int q4 = kcp / 4;
      for (int e = threadIdx.x; e < PN_ROWS * q4; e += blockDim.x) {
        const int r = e / q4, c = 4 * (e - r * q4);
        float* dst = sm.X + r * PN_LDX + c;
        if (r < nr && c < kcn) cp_async16(dst, H + (size_t)r * cin + c);
        else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = threadIdx.x; e < nr * kcn; e += blockDim.x) {
        const int r = e / kcn, c = e - r * kcn;
        const PnCol& cd = sm.col[c];
        float& x = sm.X[r * PN_LDX + c];
        x = fmaxf((x - cd.mean) * cd.mul + cd.bias, 0.f);
      }
    } else {
      for (int c = lane; c < kcp; c += 32) {
        float v[PN_ROWS / 8];
        col_vals(c, v);
#pragma unroll
        for (int i = 0; i < PN_ROWS / 8; ++i) sm.X[(warp + 8 * i) * PN_LDX + c] = v[i];
      }
    }
    __syncthreads();
    pn_tick(ck, PN_T_BUILD);
    if (mlive) {
      // the B fragments of the warp's n-tiles, PN_PREF - 1 k-steps ahead in
      // a register ring (static slots: the loop is unrolled by PN_PREF)
      const int ks0 = kc0 / 8, nks = kcp / 8;
      float4 wr[PN_PREF][PN_MAXNT / 2];
      auto fetch = [&](int kt, float4 (&dst)[PN_MAXNT / 2]) {
#pragma unroll
        for (int i = 0; i < PN_MAXNT / 2; ++i) {
          const int jj = nh + 2 * i;
          if (jj < nj && kt < nks) dst[i] = __ldg(w4 + ((size_t)(ks0 + kt) * NT + j0 + jj) * 32 + lane);
        }
      };
#pragma unroll
      for (int d = 0; d < PN_PREF - 1; ++d) fetch(d, wr[d]);
      for (int kt0 = 0; kt0 < nks; kt0 += PN_PREF) {
#pragma unroll
        for (int d = 0; d < PN_PREF; ++d) {
          const int kt = kt0 + d;
          fetch(kt + PN_PREF - 1, wr[(d + PN_PREF - 1) % PN_PREF]);
          if (kt < nks) {
            uint32_t ahi[4], alo[4];
            load_a_split(sm.X, PN_LDX, 16 * mw, 8 * kt, ahi, alo);
#pragma unroll
            for (int i = 0; i < PN_MAXNT / 2; ++i)
              if (nh + 2 * i < nj) mma_3xtf32_apart(acc[i], small[i], ahi, alo, wr[d][i]);
          }
        }
      }
    }
  }
  if (ks >= 0) {  // a chunk's partial products, summed by the next phase
    if (mlive) {
      float* Pg = L.Pp + (((size_t)ks * p.B + b) * ch.rows + r0) * cout;
#pragma unroll
      for (int i = 0; i < PN_MAXNT / 2; ++i) {
        const int jj = nh + 2 * i;
        const int c = 8 * (j0 + jj) + 2 * tq, r = 16 * mw + gq;
        if (jj < nj && c < cout) {
          if (r < nr)
            *reinterpret_cast<float2*>(Pg + (size_t)r * cout + c) =
                make_float2(acc[i][0] + small[i][0], acc[i][1] + small[i][1]);
          if (r + 8 < nr)
            *reinterpret_cast<float2*>(Pg + (size_t)(r + 8) * cout + c) =
                make_float2(acc[i][2] + small[i][2], acc[i][3] + small[i][3]);
        }
      }
    }
    pn_tick(ck, PN_T_MMA);
    return;
  }
  // pre-activations into the output tile (columns local to the column tile)
  if (mlive) {
    const float* bias = L.wtc + (size_t)round_up(cin, 8) * NT * 8 * 2;
#pragma unroll
    for (int i = 0; i < PN_MAXNT / 2; ++i) {
      const int jj = nh + 2 * i;
      if (jj < nj) {
        const int cl = 8 * jj + 2 * tq, c = 8 * j0 + cl;
        const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
        const int r = 16 * mw + gq;
        *reinterpret_cast<float2*>(sm.Hs + r * PN_LDH + cl) =
            make_float2((acc[i][0] + small[i][0]) + b0, (acc[i][1] + small[i][1]) + b1);
        *reinterpret_cast<float2*>(sm.Hs + (r + 8) * PN_LDH + cl) =
            make_float2((acc[i][2] + small[i][2]) + b0, (acc[i][3] + small[i][3]) + b1);
      }
    }
  }
  __syncthreads();
  pn_tick(ck, PN_T_MMA);
  pn_tile_out(ch, L, l, b, t, u, sm, ck);
}

// A split layer's tile: its chunks' partial products summed in order, then
// the bias, into the output tile, and out as pn_item's.
__device__ void pn_sum_item(const PnParams& p, const PnChain& ch, int l, int b, int t, int u,
                            PnSmem& sm, PnClock& ck) {
  const PnLayer& L = ch.L[l];
  const int cout = L.cout, NT = round_up(cout, 8) / 8;
  const int r0 = t * PN_ROWS, nr = min(PN_ROWS, ch.rows - r0);
  const int j0 = u * L.nti, nj = min(L.nti, NT - j0);
  const int c0 = 8 * j0, cw = min(8 * nj, cout - c0);
  const float* bias = L.wtc + (size_t)round_up(L.cin, 8) * NT * 8 * 2;
  const size_t split = (size_t)p.B * ch.rows * cout;
  __syncthreads();  // the block's previous item is done with the buffers
  pn_tick(ck, -1);
  if (ck.s && threadIdx.x == 0) ++ck.s[PN_T_ITEMS];
  for (int e = threadIdx.x; e < nr * cw; e += blockDim.x) {
    const int r = e / cw, cl = e - r * cw;
    const float* src = L.Pp + ((size_t)b * ch.rows + r0 + r) * cout + c0 + cl;
    float v = src[0];
    for (int k = 1; k < L.ks; ++k) v += src[k * split];
    sm.Hs[r * PN_LDH + cl] = v + __ldg(bias + c0 + cl);
  }
  __syncthreads();
  pn_tick(ck, PN_T_BUILD);
  pn_tile_out(ch, L, l, b, t, u, sm, ck);
}

// The sums of a split layer l of chain g, every tile strided over the grid.
__device__ void pn_sum_layer(const PnParams& p, int g, int l, int ph, PnSmem& sm) {
  const PnLayer& L = p.ch[g].L[l];
  if (L.ks < 2) return;
  PnClock ck{p.stamps ? p.stamps + ((size_t)blockIdx.x * PN_PHASES + ph) * PN_ST : nullptr, 0};
  const int per = L.rt * L.ct;
  for (int it = blockIdx.x; it < p.B * per; it += gridDim.x) {
    const int bb = it / per, tu = it - bb * per;
    pn_sum_item(p, p.ch[g], l, bb, tu / L.ct, tu % L.ct, sm, ck);
  }
}

// The exact 3-NN of query q of sample b of FP chain ch, by one warp: three
// (distance, index) argmin rounds, weights 1 / (d + 1e-8).
__device__ void pn_three_nn(const PnChain& ch, int b, int q) {
  const int lane = threadIdx.x & 31;
  const float* KX = ch.kx + (size_t)b * ch.Nk * 3;
  const float* CX = ch.c + (size_t)b * ch.S * 3;
  const float qx = CX[q * 3], qy = CX[q * 3 + 1], qz = CX[q * 3 + 2];
  float pd = -1.f;
  int pi = -1;
  for (int s = 0; s < 3; ++s) {
    float bd = CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int j = lane; j < ch.Nk; j += 32) {
      const float d = sqdist3(KX[j * 3], KX[j * 3 + 1], KX[j * 3 + 2], qx, qy, qz);
      const bool after = d > pd || (d == pd && j > pi);
      if (after && d < bd) {
        bd = d;
        bi = j;
      }
    }
    warp_argmin(bd, bi);
    if (lane == 0) {
      ch.nn_i[((size_t)b * ch.S + q) * 3 + s] = bi;
      ch.nn_w[((size_t)b * ch.S + q) * 3 + s] = 1.f / (bd + 1e-8f);
    }
    pd = bd;
    pi = bi;
  }
}

// Every FP level's 3-NN (their keys and queries are the FPS centres and
// l1), one warp a query, strided over the grid's warps: once, off the FP
// layers' path.
__device__ void pn_nn_tasks(const PnParams& p) {
  const int nw = blockDim.x >> 5;
  const int w = blockIdx.x * nw + (threadIdx.x >> 5), all = gridDim.x * nw;
  int base = 0;
  for (int g = 6; g < PN_CHAINS; ++g) {
    const PnChain& ch = p.ch[g];
    const int n = p.B * ch.S;
    for (int t = w - base; t < n; t += all)
      if (t >= 0) pn_three_nn(ch, t / ch.S, t % ch.S);
    base = (base + n) % all;
  }
}

// Layer l of chains a and b (b < 0: one chain): the statistics it reads,
// then every (chain, sample, row tile, column tile) item, strided over the
// grid from block `first` on.
__device__ void pn_layer(const PnParams& p, int a, int b, int l, int first, int ph,
                         PnStats& st, PnSmem& sm) {
  PnClock ck{p.stamps ? p.stamps + ((size_t)blockIdx.x * PN_PHASES + ph) * PN_ST : nullptr, 0};
  __syncthreads();  // the block is done reading st
  if (l > 0) {
    pn_fill(p, PN_CHAINS, a, l - 1, st);
    if (b >= 0) pn_fill(p, PN_CHAINS + 1, b, l - 1, st);
  } else {  // a level's scales share their inputs
    pn_fill_view(p, p.ch[a].kf, st);
    pn_fill_view(p, p.ch[a].skip, st);
  }
  __syncthreads();
  // an item a (sample, row tile, column tile) and, for a split layer, a chunk
  const PnLayer& La = p.ch[a].L[l];
  const int na = p.B * La.rt * La.ct * La.ks;
  const int nb = b < 0 ? 0 : p.B * p.ch[b].L[l].rt * p.ch[b].L[l].ct * p.ch[b].L[l].ks;
  for (int it = (int)blockIdx.x - first; it < na + nb; it += gridDim.x) {
    if (it < 0) continue;
    const int ci = it < na ? 0 : 1;
    const PnChain& ch = p.ch[ci ? b : a];
    const PnLayer& L = ch.L[l];
    const int idx = ci ? it - na : it, per = L.rt * L.ct;
    const int ks = idx % L.ks, tile = idx / L.ks;
    const int bb = tile / per, tu = tile - bb * per;
    pn_item(p, ch, ci, l, bb, tu / L.ct, tu % L.ct, L.ks > 1 ? ks : -1, st, sm, ck);
  }
}

// Stamps phase `ph` of this block: its arrival at the phase's grid barrier
// and its leaving it (%globaltimer ns); the last phase has no barrier.
__device__ __forceinline__ void pn_sync(const PnParams& p, unsigned int& passed, int& ph,
                                        bool last = false) {
  unsigned long long* s =
      p.stamps ? p.stamps + ((size_t)blockIdx.x * PN_PHASES + ph) * PN_ST : nullptr;
  if (s && threadIdx.x == 0) s[0] = global_ns();
  if (last) __syncthreads();
  else grid_sync(p.bar, passed);
  if (s && threadIdx.x == 0) s[1] = global_ns();
  ++ph;
}

__global__ void __launch_bounds__(PN_THREADS, 2) pn2mid_kernel(const __grid_constant__ PnParams p) {
  extern __shared__ float4 smem4[];
  PnSmem& sm = *reinterpret_cast<PnSmem*>(smem4);
  float* fps_smem = reinterpret_cast<float*>(smem4);
  __shared__ PnStats st;
  unsigned int passed = 0;
  int ph = 0;
  pn_sync(p, passed, ph, true);  // the start
  // FPS l1 -> c2, one block a sample
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    fps_centres(p.l1x + (size_t)b * p.N1 * 3, p.N1, p.S[0], p.cx[0] + (size_t)b * p.S[0] * 3,
                fps_smem);
  pn_sync(p, passed, ph);
  // sa2 .. sa4: the level's two scales side by side; c3 and c4 by FPS on
  // blocks [0, B) beside sa2's first layer
  for (int lv = 0; lv < 3; ++lv) {
    for (int l = 0; l < p.ch[2 * lv].nl; ++l) {
      int first = 0;
      if (lv == 0 && l == 0) {
        for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
          float* c3 = p.cx[1] + (size_t)b * p.S[1] * 3;
          fps_centres(p.cx[0] + (size_t)b * p.S[0] * 3, p.S[0], p.S[1], c3, fps_smem);
          fps_centres(c3, p.S[1], p.S[2], p.cx[2] + (size_t)b * p.S[2] * 3, fps_smem);
        }
        first = p.B;
      }
      if (lv == 0 && l == 1) pn_nn_tasks(p);  // the centres are all picked
      pn_layer(p, 2 * lv, 2 * lv + 1, l, first, ph, st, sm);
      pn_sync(p, passed, ph);
    }
  }
  // fp4, fp3, fp2
  for (int g = 6; g < PN_CHAINS; ++g) {
    for (int l = 0; l < p.ch[g].nl; ++l) {
      pn_layer(p, g, -1, l, 0, ph, st, sm);
      pn_sync(p, passed, ph);
      if (l == 0) {  // the split first layer's sums (its inputs are wide)
        pn_sum_layer(p, g, 0, ph, sm);
        pn_sync(p, passed, ph);
      }
    }
  }
  // fp2's output, normalised
  __syncthreads();
  pn_fill(p, PN_CHAINS - 1, PN_CHAINS - 1, p.ch[PN_CHAINS - 1].nl - 1, st);
  __syncthreads();
  const PnChain& last = p.ch[PN_CHAINS - 1];
  const PnLayer& L = last.L[last.nl - 1];
  const int total = p.B * last.S * L.cout;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const int c = e % L.cout, bb = e / (L.cout * last.S);
    p.out[e] = pn_norm(L, st, PN_CHAINS - 1, bb, c, L.H[e]);
  }
  pn_sync(p, passed, ph, true);
}

// Host side: the column tiles of a layer with `rt` row tiles a sample: the
// most n-tiles a tile (4, 2) that still gives 128 items over the B samples
// (about one an SM), else 2.
static inline int pn_nti(int B, int rt, int NT) {
  for (int nti = PN_MAXNT; nti > 2; nti /= 2)
    if ((long long)B * rt * ((NT + nti - 1) / nti) >= 128) return nti;
  return 2;
}

// Host side: lays out the chains over the scratch (fbase floats, dbase
// doubles; null bases give offsets only) and plans the items.  dims: the 9
// groups' widths, nl[g] + 1 each from doff[g]; group g layer l's dense
// weights W [cin][cout] then aux [3][cout] at consecutive offsets of wbuf,
// its split weights (K8 * N8 * 2 floats, then the bias padded to N8) at
// consecutive offsets of wtc.  Returns false for widths that do not chain.
static bool pn_plan(PnParams& p, size_t& nfloat, size_t& ndouble, int& items,
                    const float* wbuf, const float* wtc, const int* dims, const int* doff,
                    const int* nl, float* fbase, double* dbase, const float* l1x,
                    const float* l1f, float* out, int B, int N1, int C1, const int* S,
                    const int* ks, const float* r2) {
  nfloat = 0;
  ndouble = 0;
  auto F = [&](size_t n) {
    float* ptr = fbase ? fbase + nfloat : nullptr;
    nfloat += (n + 3) / 4 * 4;
    return ptr;
  };
  auto D = [&](size_t n) {
    double* ptr = dbase ? dbase + ndouble : nullptr;
    ndouble += n;
    return ptr;
  };
  p.l1x = l1x;
  p.out = out;
  p.B = B, p.N1 = N1;
  for (int i = 0; i < 3; ++i) {
    p.S[i] = S[i];
    p.cx[i] = F((size_t)B * S[i] * 3);
  }
  int wout[PN_CHAINS];
  for (int g = 0; g < PN_CHAINS; ++g) {
    if (nl[g] < 1 || nl[g] > PN_MAXL) return false;
    wout[g] = dims[doff[g] + nl[g]];
  }
  // the level outputs as views: l2_f, l3_f, l4_f (two scales side by
  // side), l3' (fp4), l2' (fp3)
  PnView lf[3];
  for (int lv = 0; lv < 3; ++lv)
    lf[lv] = {nullptr, S[lv], wout[2 * lv] + wout[2 * lv + 1], 2 * lv, 2 * lv + 1,
              wout[2 * lv]};
  const PnView l1 = {l1f, N1, C1, -1, -1, 0};
  size_t woff = 0, toff = 0;
  items = 0;
  for (int g = 0; g < PN_CHAINS; ++g) {
    PnChain& ch = p.ch[g];
    ch.nl = nl[g];
    ch.fp = g >= 6;
    ch.mx = ch.mn = ch.mxw = ch.mnw = nullptr;
    ch.nn_i = nullptr;
    ch.nn_w = nullptr;
    if (!ch.fp) {
      const int lv = g / 2;
      ch.c = p.cx[lv];
      ch.kx = lv ? p.cx[lv - 1] : l1x;
      ch.kf = lv ? lf[lv - 1] : l1;
      ch.skip = {nullptr, 0, 0, -1, -1, 0};  // no skip (C = 0)
      ch.Nk = lv ? S[lv - 1] : N1;
      ch.S = S[lv];
      ch.K = ks[g];
      ch.r2 = r2[g];
      ch.rows = ch.S * ch.K;
      if (dims[doff[g]] != ch.kf.C + 3 || ch.K < 1 || PN_ROWS % ch.K) return false;
      ch.mxw = F((size_t)B * ch.S * wout[g]);
      ch.mnw = F((size_t)B * ch.S * wout[g]);
      ch.mx = ch.mxw, ch.mn = ch.mnw;
    } else {
      const int lv = 8 - g;  // fp4: queries c3 (lv 1), keys c4; fp2: queries l1
      ch.c = lv ? p.cx[lv - 1] : l1x;
      ch.S = lv ? S[lv - 1] : N1;
      ch.kx = p.cx[lv];
      ch.Nk = S[lv];
      ch.kf = g == 6 ? lf[2] : PnView{nullptr, S[lv], wout[g - 1], g - 1, -1, wout[g - 1]};
      ch.skip = lv ? lf[lv - 1] : l1;
      ch.K = 3;
      ch.r2 = 0.f;
      ch.rows = ch.S;
      ch.nn_i = reinterpret_cast<int*>(F((size_t)B * ch.S * 3));
      ch.nn_w = F((size_t)B * ch.S * 3);
      if (dims[doff[g]] != ch.skip.C + ch.kf.C || ch.Nk < 3) return false;
    }
    for (int l = 0; l < ch.nl; ++l) {
      PnLayer& L = ch.L[l];
      L.cin = dims[doff[g] + l];
      L.cout = dims[doff[g] + l + 1];
      if (L.cout % 4 || (l > 0 && L.cin != ch.L[l - 1].cout)) return false;
      L.aux = wbuf ? wbuf + woff + (size_t)L.cin * L.cout : nullptr;
      woff += (size_t)L.cin * L.cout + 3 * (size_t)L.cout;
      const int NT = round_up(L.cout, 8) / 8;
      L.wtc = wtc ? wtc + toff : nullptr;
      toff += (size_t)round_up(L.cin, 8) * NT * 8 * 2 + NT * 8;
      L.rt = (ch.rows + PN_ROWS - 1) / PN_ROWS;
      L.nti = pn_nti(B, L.rt, NT);
      L.ct = (NT + L.nti - 1) / L.nti;
      // an FP level's first layer (1536, 512, 352 inputs at ISAPCInet's
      // widths, few rows) computes its input chunks apart: each item then
      // builds 256 columns, not all of them
      L.ks = ch.fp && l == 0 ? (L.cin + PN_KC - 1) / PN_KC : 1;
      L.Pp = L.ks > 1 ? F((size_t)L.ks * B * ch.rows * L.cout) : nullptr;
      const bool sa_last = !ch.fp && l == ch.nl - 1;
      L.H = sa_last ? nullptr : F((size_t)B * ch.rows * L.cout);
      L.part = D((size_t)B * L.rt * L.ct * 8);
    }
    if (ch.fp) ch.mx = ch.mn = ch.L[ch.nl - 1].H;
  }
  for (int lv = 0; lv < 3; ++lv) {
    if (p.ch[2 * lv].nl != p.ch[2 * lv + 1].nl) return false;  // scales share barriers
    for (int l = 0; l < p.ch[2 * lv].nl; ++l) {
      const PnLayer &La = p.ch[2 * lv].L[l], &Lb = p.ch[2 * lv + 1].L[l];
      items = std::max(items, B * (La.rt * La.ct + Lb.rt * Lb.ct + (lv == 0 && l == 0)));
    }
  }
  for (int g = 6; g < PN_CHAINS; ++g)
    for (int l = 0; l < p.ch[g].nl; ++l)
      items = std::max(items, B * p.ch[g].L[l].rt * p.ch[g].L[l].ct * p.ch[g].L[l].ks);
  return true;
}

static size_t pn_smem(int N1) {
  return std::max(sizeof(PnSmem), fps_centres_smem(N1, PN_THREADS));
}

// Scratch sizes for pci_pn2mid: floats (fp32) and doubles, through out[0..1].
extern "C" int pci_pn2mid_scratch(const int* dims, const int* doff, const int* nl,
                                  int B, int N1, int C1, const int* S,
                                  const int* ks, const float* r2,
                                  long long* sizes) {
  PnParams p;
  size_t nf, nd;
  int items;
  if (B < 1 || B > PN_MAXB ||
      !pn_plan(p, nf, nd, items, nullptr, nullptr, dims, doff, nl, nullptr, nullptr, nullptr,
               nullptr, nullptr, B, N1, C1, S, ks, r2))
    return (int)cudaErrorInvalidValue;
  sizes[0] = (long long)nf;
  sizes[1] = (long long)nd;
  return 0;
}

// l1x [B][N1][3], l1f [B][N1][C1], wbuf the 24 layers (group order sa2 s0,
// sa2 s1, sa3 s0, sa3 s1, sa4 s0, sa4 s1, fp4, fp3, fp2; each layer W
// [cin][cout] then dense bias, gn scale, gn bias), wtc the same layers' W
// and dense bias split for the tensor cores (_build.pack_tf32, a layer
// after another), fscratch / dscratch as pci_pn2mid_scratch sizes them, out
// [B][N1][C_out], bar one zeroed unsigned int.  S = (S2, S3, S4) centres a
// level; ks / r2: each SA group's K and squared radius.  stamps: [grid,
// PN_PHASES, PN_ST] unsigned 64-bit (zeroed; grid at most the SMs x 2), or
// null.
extern "C" int pci_pn2mid(const void* l1x, const void* l1f, const void* wbuf,
                          const int* dims, const int* doff, const int* nl,
                          void* fscratch, void* dscratch, void* out, void* bar,
                          int B, int N1, int C1, const int* S, const int* ks,
                          const float* r2, const void* wtc, void* stamps, void* stream) {
  if (B < 1 || B > PN_MAXB || N1 > 16 * PN_THREADS || S[0] > N1 || S[1] > S[0] ||
      S[2] > S[1])
    return (int)cudaErrorInvalidValue;
  PnParams p;
  size_t nf, nd;
  int items;
  if (!pn_plan(p, nf, nd, items, static_cast<const float*>(wbuf),
               static_cast<const float*>(wtc), dims, doff, nl, static_cast<float*>(fscratch),
               static_cast<double*>(dscratch), static_cast<const float*>(l1x),
               static_cast<const float*>(l1f), static_cast<float*>(out), B, N1, C1, S, ks,
               r2))
    return (int)cudaErrorInvalidValue;
  p.bar = static_cast<unsigned int*>(bar);
  p.stamps = static_cast<unsigned long long*>(stamps);
  return launch_cooperative(pn2mid_kernel, p, pn_smem(N1), items,
                            static_cast<cudaStream_t>(stream), PN_THREADS);
}

// The kernel's resources at 1,024 points a sample (common.cuh's kernel_attrs).
extern "C" int pci_pn2mid_attrs(int* out) {
  return kernel_attrs(pn2mid_kernel, pn_smem(1024), out, PN_THREADS);
}
