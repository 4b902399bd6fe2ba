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
// weights 1 / (d + 1e-8) from the exact distances, num / den.  The first
// layer of a stage reads [feats | dxyz] (SA) or [skip | interp] (FP) rows
// built in shared memory, so no concatenation is written.
//
// What bounds it on the H100: ~1.1 GFMA of dense layers a sample (sa2's
// 12,288 slot rows the most) against ~3 MB of weights: operations (0.033
// ms at 67 TFLOP/s fp32).  GroupNorm's statistics are global per sample,
// so every layer ends at a grid barrier: a cooperative launch (as
// csrc/flowmid.cu) strides every block over (chain, sample, row tile)
// items; a tile writes its pre-activations to device scratch (they stay in
// L2) and its per-group sums, in fp64 and in a fixed order, to its own
// slot; after the barrier every block reduces the slots in tile order, so
// a run gives the same bits every time.  The next layer normalises, applies
// ReLU and multiplies in one pass over a tile held in shared memory.  The
// dense products are scalar fp32 loops (dense_rows); tensor cores are
// later work.
#include "stages.cuh"

#define PN_CHAINS 9
#define PN_MAXB 16
#define PN_MAXL 3

struct PnLayer {
  const float* W;    // [cin][cout], then b, gn scale, gn bias [cout] each
  float* H;          // pre-activations [B][rows][cout]
  double* part;      // per-tile group sums [B][tiles][4][2]
  int cin, cout, R, tiles;
};

// One MLP chain: a scale of an SA level (rows = S centres x K slots) or an
// FP level (rows = S queries).  Keys kx [B][Nk][3] with features kf
// [B][Nk][Cf]; centres (queries) c [B][S][3]; FP: skip [B][S][Cs].  The
// chain's output, relu(gn(last layer)) (max over slots for SA), goes to
// out [B][S][out_ld] at channel out_off.
struct PnChain {
  PnLayer L[PN_MAXL];
  int nl, fp, rows;
  const float* c;
  const float* kx;
  const float* kf;
  const float* skip;
  float* out;
  int S, Nk, Cf, Cs, K, out_ld, out_off;
  float r2;
};

struct PnParams {
  PnChain ch[PN_CHAINS];
  const float* l1x;   // [B][N1][3]
  float* cx[3];       // c2, c3, c4: [B][S][3]
  unsigned int* bar;  // the grid barrier's counter, zeroed
  int B, N1, S[3];
};

struct PnStats {
  float mean[2][PN_MAXB][4], rstd[2][PN_MAXB][4];
};

// Group statistics of layer `l` of chains a and b (b < 0: one chain), each
// block computing them alike from the tile slots in tile order.
__device__ void pn_stats(const PnParams& p, int a, int b, int l, PnStats& st) {
  __syncthreads();
  const int nch = b < 0 ? 1 : 2;
  for (int e = threadIdx.x; e < nch * p.B * 4; e += blockDim.x) {
    const int ci = e / (p.B * 4), bb = (e / 4) % p.B, g = e % 4;
    const PnLayer& L = p.ch[ci ? b : a].L[l];
    const double* pt = L.part + (size_t)bb * L.tiles * 8;
    double s = 0.0, ss = 0.0;
    for (int t = 0; t < L.tiles; ++t) {
      s += pt[t * 8 + g * 2];
      ss += pt[t * 8 + g * 2 + 1];
    }
    const double n = (double)p.ch[ci ? b : a].rows * (L.cout / 4);
    const float mean = (float)(s / n), mean2 = (float)(ss / n);
    const float var = fmaxf(mean2 - mean * mean, 0.f);
    st.mean[ci][bb][g] = mean;
    st.rstd[ci][bb][g] = rsqrtf(var + 1e-5f);
  }
  __syncthreads();
}

// One row tile of layer l of chain ch (index ci in the phase) for sample b:
// the input rows into shared memory, the dense layer, the pre-activations
// out, the tile's per-group sums into its slot.
__device__ void pn_layer_tile(const PnParams& p, const PnChain& ch, int ci, int l,
                              int b, int t, const PnStats& st, float* smem) {
  const PnLayer& L = ch.L[l];
  const int cin = L.cin, cout = L.cout;
  const int ldi = round_up(cin, 4), ldo = round_up(cout, 4), RR = round_up(L.R, 8);
  const int r0 = t * L.R, nr = min(L.R, ch.rows - r0);
  float* X = smem;
  float* Hs = X + (size_t)RR * ldi;
  double* csum = reinterpret_cast<double*>(Hs + (size_t)RR * ldo);  // [cout][2]
  int* sidx = reinterpret_cast<int*>(csum + 2 * (size_t)cout);  // [3 R] ball / 3-NN ids
  float* swt = reinterpret_cast<float*>(sidx + 3 * (size_t)L.R);  // [3 R] 3-NN weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float* KX = ch.kx + (size_t)b * ch.Nk * 3;
  const float* KF = ch.kf + (size_t)b * ch.Nk * ch.Cf;
  const float* CX = ch.c + (size_t)b * ch.S * 3;
  __syncthreads();  // the block's previous tile is done with the buffers
  if (l == 0 && !ch.fp) {
    // ball query: one warp a centre, the first K keys in index order
    const int K = ch.K, s0 = r0 / K, Q = nr / K;
    for (int qi = warp; qi < Q; qi += nwarps) {
      int* id = sidx + qi * K;
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
    __syncthreads();
    for (int e = threadIdx.x; e < nr * cin; e += blockDim.x) {
      const int r = e / cin, c = e - r * cin;
      const int j = sidx[r];
      const int s = s0 + r / K;
      X[(size_t)r * ldi + c] = c < ch.Cf ? KF[(size_t)j * ch.Cf + c]
                                         : KX[j * 3 + (c - ch.Cf)] - CX[s * 3 + (c - ch.Cf)];
    }
  } else if (l == 0) {
    // exact 3-NN: one warp a query, three (distance, index) argmin rounds
    for (int r = warp; r < nr; r += nwarps) {
      const int q = r0 + r;
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
          sidx[r * 3 + s] = bi;
          swt[r * 3 + s] = 1.f / (bd + 1e-8f);
        }
        pd = bd;
        pi = bi;
      }
    }
    __syncthreads();
    const float* SK = ch.skip + (size_t)b * ch.S * ch.Cs;
    for (int e = threadIdx.x; e < nr * cin; e += blockDim.x) {
      const int r = e / cin, c = e - r * cin;
      float v;
      if (c < ch.Cs) {
        v = SK[(size_t)(r0 + r) * ch.Cs + c];
      } else {
        float num = 0.f, den = 0.f;
        for (int s = 0; s < 3; ++s) {
          const float w = swt[r * 3 + s];
          num += w * KF[(size_t)sidx[r * 3 + s] * ch.Cf + (c - ch.Cs)];
          den += w;
        }
        v = num / den;
      }
      X[(size_t)r * ldi + c] = v;
    }
  } else {
    // the previous layer's rows, normalised, through ReLU
    const PnLayer& P = ch.L[l - 1];
    const float* aux = P.W + (size_t)P.cin * P.cout;
    const float* Hp = P.H + ((size_t)b * ch.rows + r0) * cin;
    const int gsz = cin / 4;
    for (int e = threadIdx.x; e < nr * cin; e += blockDim.x) {
      const int r = e / cin, c = e - r * cin, g = c / gsz;
      const float v = (Hp[(size_t)r * cin + c] - st.mean[ci][b][g]) *
                          (st.rstd[ci][b][g] * aux[cin + c]) +
                      aux[2 * cin + c];
      X[(size_t)r * ldi + c] = fmaxf(v, 0.f);
    }
  }
  __syncthreads();
  dense_rows<8>(L.W, L.W + (size_t)cin * cout, X, ldi, Hs, ldo, nr, cin, cout, false);
  __syncthreads();
  float* Hg = L.H + ((size_t)b * ch.rows + r0) * cout;
  for (int e = threadIdx.x; e < nr * cout; e += blockDim.x) {
    const int r = e / cout, c = e - r * cout;
    Hg[(size_t)r * cout + c] = Hs[(size_t)r * ldo + c];
  }
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    double s = 0.0, ss = 0.0;
    for (int r = 0; r < nr; ++r) {
      const float v = Hs[(size_t)r * ldo + c];
      s += v;
      ss += v * v;  // rounded to fp32, as the plain version squares
    }
    csum[2 * c] = s;
    csum[2 * c + 1] = ss;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int g = threadIdx.x, gsz = cout / 4;
    double s = 0.0, ss = 0.0;
    for (int c = g * gsz; c < (g + 1) * gsz; ++c) {
      s += csum[2 * c];
      ss += csum[2 * c + 1];
    }
    double* slot = L.part + ((size_t)b * L.tiles + t) * 8 + g * 2;
    slot[0] = s;
    slot[1] = ss;
  }
}

// Layer l of chains a and b (b < 0: one chain): statistics of layer l - 1,
// then every (chain, sample, tile) item, strided over the grid from block
// `first` on.
__device__ void pn_layer(const PnParams& p, int a, int b, int l, int first,
                         PnStats& st, float* smem) {
  if (l > 0) pn_stats(p, a, b, l - 1, st);
  const int na = p.B * p.ch[a].L[l].tiles;
  const int nb = b < 0 ? 0 : p.B * p.ch[b].L[l].tiles;
  for (int it = (int)blockIdx.x - first; it < na + nb; it += gridDim.x) {
    if (it < 0) continue;
    const int ci = it < na ? 0 : 1;
    const int idx = ci ? it - na : it;
    const PnChain& ch = p.ch[ci ? b : a];
    pn_layer_tile(p, ch, ci, l, idx / ch.L[l].tiles, idx % ch.L[l].tiles, st, smem);
  }
}

// The chains' outputs: relu(gn(last layer)), the max over each centre's K
// slots for SA.
__device__ void pn_finish(const PnParams& p, int a, int b, PnStats& st) {
  const int nch = b < 0 ? 1 : 2;
  pn_stats(p, a, b, p.ch[a].nl - 1, st);
  for (int ci = 0; ci < nch; ++ci) {
    const PnChain& ch = p.ch[ci ? b : a];
    const PnLayer& L = ch.L[ch.nl - 1];
    const float* aux = L.W + (size_t)L.cin * L.cout;
    const int K = ch.fp ? 1 : ch.K, gsz = L.cout / 4;
    const int total = p.B * ch.S * L.cout;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += gridDim.x * blockDim.x) {
      const int c = e % L.cout, s = (e / L.cout) % ch.S, bb = e / (L.cout * ch.S);
      const int g = c / gsz;
      const float mean = st.mean[ci][bb][g], mul = st.rstd[ci][bb][g] * aux[L.cout + c];
      const float bias = aux[2 * L.cout + c];
      const float* h = L.H + ((size_t)bb * ch.rows + (size_t)s * K) * L.cout + c;
      float m = -CUDART_INF_F;
      for (int k = 0; k < K; ++k)
        m = fmaxf(m, fmaxf((h[(size_t)k * L.cout] - mean) * mul + bias, 0.f));
      ch.out[((size_t)bb * ch.S + s) * ch.out_ld + ch.out_off + c] = m;
    }
  }
}

__global__ void __launch_bounds__(256) pn2mid_kernel(const __grid_constant__ PnParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ PnStats st;
  unsigned int passed = 0;
  // FPS l1 -> c2, one block a sample
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    fps_centres(p.l1x + (size_t)b * p.N1 * 3, p.N1, p.S[0],
                p.cx[0] + (size_t)b * p.S[0] * 3, smem);
  grid_sync(p.bar, passed);
  // sa2 .. sa4: the level's two scales side by side; c3 and c4 by FPS on
  // blocks [0, B) beside sa2's first layer
  for (int lv = 0; lv < 3; ++lv) {
    int first = 0;
    if (lv == 0) {
      for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        float* c3 = p.cx[1] + (size_t)b * p.S[1] * 3;
        fps_centres(p.cx[0] + (size_t)b * p.S[0] * 3, p.S[0], p.S[1], c3, smem);
        fps_centres(c3, p.S[1], p.S[2], p.cx[2] + (size_t)b * p.S[2] * 3, smem);
      }
      first = p.B;
    }
    for (int l = 0; l < p.ch[2 * lv].nl; ++l) {
      pn_layer(p, 2 * lv, 2 * lv + 1, l, l == 0 ? first : 0, st, smem);
      grid_sync(p.bar, passed);
    }
    pn_finish(p, 2 * lv, 2 * lv + 1, st);
    grid_sync(p.bar, passed);
  }
  // fp4, fp3, fp2
  for (int g = 6; g < PN_CHAINS; ++g) {
    for (int l = 0; l < p.ch[g].nl; ++l) {
      pn_layer(p, g, -1, l, 0, st, smem);
      grid_sync(p.bar, passed);
    }
    pn_finish(p, g, -1, st);
    if (g + 1 < PN_CHAINS) grid_sync(p.bar, passed);
  }
}

static size_t pn_tile_smem(const PnChain& ch, int l, int R) {
  const int cin = ch.L[l].cin, cout = ch.L[l].cout;
  return sizeof(float) * (size_t)round_up(R, 8) * (round_up(cin, 4) + round_up(cout, 4)) +
         sizeof(double) * 2 * cout + (sizeof(int) + sizeof(float)) * 3 * (size_t)R;
}

// Host side: lays out the chains over the scratch (fbase floats, dbase
// doubles; null bases give offsets only) and plans the tiles.  dims: the 9
// groups' widths, nl[g] + 1 each from doff[g]; the weights of group g layer
// l at woff (floats into wbuf, W then b, gn scale, gn bias).  Returns false
// for widths that do not chain.
static bool pn_plan(PnParams& p, size_t& nfloat, size_t& ndouble, size_t& smem,
                    int& items, const float* wbuf, const int* dims,
                    const int* doff, const int* nl, float* fbase, double* dbase,
                    const float* l1x, const float* l1f, float* out, int B, int N1,
                    int C1, const int* S, const int* ks, const float* r2) {
  const size_t budget = 110 * 1024;  // two blocks an SM
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
  // level outputs: l2_f, l3_f, l4_f (the two scales side by side), l3', l2'
  const int cl[3] = {wout[0] + wout[1], wout[2] + wout[3], wout[4] + wout[5]};
  float* lf[3];
  for (int i = 0; i < 3; ++i) lf[i] = F((size_t)B * S[i] * cl[i]);
  float* l3p = F((size_t)B * S[1] * wout[6]);
  float* l2p = F((size_t)B * S[0] * wout[7]);
  size_t woff = 0;
  smem = sizeof(float) * 3 * (size_t)N1;  // the FPS
  items = 0;
  for (int g = 0; g < PN_CHAINS; ++g) {
    PnChain& ch = p.ch[g];
    ch.nl = nl[g];
    ch.fp = g >= 6;
    if (!ch.fp) {
      const int lv = g / 2;
      ch.c = p.cx[lv];
      ch.kx = lv ? p.cx[lv - 1] : l1x;
      ch.kf = lv ? lf[lv - 1] : l1f;
      ch.Nk = lv ? S[lv - 1] : N1;
      ch.Cf = lv ? cl[lv - 1] : C1;
      ch.S = S[lv];
      ch.K = ks[g];
      ch.r2 = r2[g];
      ch.skip = nullptr;
      ch.Cs = 0;
      ch.rows = ch.S * ch.K;
      ch.out = lf[lv];
      ch.out_ld = cl[lv];
      ch.out_off = g % 2 ? wout[g - 1] : 0;
      if (dims[doff[g]] != ch.Cf + 3) return false;
    } else {
      const int lv = 8 - g;  // fp4: queries c3 (lv 1), keys c4; fp2: queries l1
      ch.c = lv ? p.cx[lv - 1] : l1x;
      ch.S = lv ? S[lv - 1] : N1;
      ch.kx = p.cx[lv];
      ch.Nk = S[lv];
      ch.kf = g == 6 ? lf[2] : g == 7 ? l3p : l2p;
      ch.Cf = g == 6 ? cl[2] : wout[g - 1];
      ch.skip = lv ? lf[lv - 1] : l1f;
      ch.Cs = lv ? cl[lv - 1] : C1;
      ch.K = 3;
      ch.r2 = 0.f;
      ch.rows = ch.S;
      ch.out = g == 6 ? l3p : g == 7 ? l2p : out;
      ch.out_ld = wout[g];
      ch.out_off = 0;
      if (dims[doff[g]] != ch.Cs + ch.Cf || ch.Nk < 3) return false;
    }
    for (int l = 0; l < ch.nl; ++l) {
      PnLayer& L = ch.L[l];
      L.cin = dims[doff[g] + l];
      L.cout = dims[doff[g] + l + 1];
      if (L.cout % 4 || (l > 0 && L.cin != ch.L[l - 1].cout)) return false;
      L.W = wbuf ? wbuf + woff : nullptr;
      woff += (size_t)L.cin * L.cout + 3 * (size_t)L.cout;
      if (l == 0 && !ch.fp) {  // a tile holds whole centres: R = Q K
        int Q = std::max(1, 64 / ch.K);
        while (Q > 1 && pn_tile_smem(ch, l, Q * ch.K) > budget) Q /= 2;
        L.R = Q * ch.K;
      } else {
        L.R = 64;
        while (L.R > 8 && pn_tile_smem(ch, l, L.R) > budget) L.R /= 2;
      }
      if (pn_tile_smem(ch, l, L.R) > budget) return false;
      smem = std::max(smem, pn_tile_smem(ch, l, L.R));
      L.tiles = (ch.rows + L.R - 1) / L.R;
      L.H = F((size_t)B * ch.rows * L.cout);
      L.part = D((size_t)B * L.tiles * 8);
    }
  }
  for (int lv = 0; lv < 3; ++lv) {
    if (p.ch[2 * lv].nl != p.ch[2 * lv + 1].nl) return false;  // scales share barriers
    for (int l = 0; l < p.ch[2 * lv].nl; ++l)
      items = std::max(items, B * (p.ch[2 * lv].L[l].tiles + p.ch[2 * lv + 1].L[l].tiles +
                                   (lv == 0 && l == 0)));
  }
  for (int g = 6; g < PN_CHAINS; ++g)
    for (int l = 0; l < p.ch[g].nl; ++l) items = std::max(items, B * p.ch[g].L[l].tiles);
  return true;
}

// Scratch sizes for pci_pn2mid: floats (fp32) and doubles, through out[0..1].
extern "C" int pci_pn2mid_scratch(const int* dims, const int* doff, const int* nl,
                                  int B, int N1, int C1, const int* S,
                                  const int* ks, const float* r2,
                                  long long* sizes) {
  PnParams p;
  size_t nf, nd, smem;
  int items;
  if (B < 1 || B > PN_MAXB ||
      !pn_plan(p, nf, nd, smem, items, nullptr, dims, doff, nl, nullptr, nullptr,
               nullptr, nullptr, nullptr, B, N1, C1, S, ks, r2))
    return (int)cudaErrorInvalidValue;
  sizes[0] = (long long)nf;
  sizes[1] = (long long)nd;
  return 0;
}

// l1x [B][N1][3], l1f [B][N1][C1], wbuf the 24 layers (group order sa2 s0,
// sa2 s1, sa3 s0, sa3 s1, sa4 s0, sa4 s1, fp4, fp3, fp2; each layer W
// [cin][cout] then dense bias, gn scale, gn bias), fscratch / dscratch as
// pci_pn2mid_scratch sizes them, out [B][N1][C_out], bar one zeroed
// unsigned int.  S = (S2, S3, S4) centres a level; ks / r2: each SA
// group's K and squared radius.
extern "C" int pci_pn2mid(const void* l1x, const void* l1f, const void* wbuf,
                          const int* dims, const int* doff, const int* nl,
                          void* fscratch, void* dscratch, void* out, void* bar,
                          int B, int N1, int C1, const int* S, const int* ks,
                          const float* r2, void* stream) {
  if (B < 1 || B > PN_MAXB || N1 > 16 * 256 || S[0] > 16 * 256 || S[0] > N1 ||
      S[1] > S[0] || S[2] > S[1])
    return (int)cudaErrorInvalidValue;
  PnParams p;
  size_t nf, nd, smem;
  int items;
  if (!pn_plan(p, nf, nd, smem, items, static_cast<const float*>(wbuf), dims, doff, nl,
               static_cast<float*>(fscratch), static_cast<double*>(dscratch),
               static_cast<const float*>(l1x), static_cast<const float*>(l1f),
               static_cast<float*>(out), B, N1, C1, S, ks, r2))
    return (int)cudaErrorInvalidValue;
  p.bar = static_cast<unsigned int*>(bar);
  return launch_cooperative(pn2mid_kernel, p, smem, items,
                            static_cast<cudaStream_t>(stream));
}
