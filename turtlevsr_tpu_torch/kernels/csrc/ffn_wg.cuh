// The device code of row 1's Hopper body (ffn_wg.cu, whose note has the
// design and the rounding points): the copy thread's loads of one 8 x 8
// output tile and the consumers' work on it, as functions of (batch entry,
// tile) and the weight ring, so that a kernel may run one tile a block
// (ffn_wg.cu) or walk many tiles with one block an SM (row 14's runs,
// level_wg.cu, whose ring goes on from the statistics body's).
#pragma once

#include "ffn_tile.cuh"
#include "pipe.cuh"

namespace turtle {

constexpr int WG_STAGE = 16384;       // bytes of a ring stage
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_HS = 128;            // row stride of the fp32 hidden chunk (swizzled)
constexpr int WG_KB = 64;             // rows of K of a pw1 stage (two 64-column panels)
constexpr int WG_PW1_PANEL = WG_KB * 128;  // bytes of a pw1 panel
constexpr size_t WG_SMEM_MAX = 232448;

struct WgMaps {
  CUtensorMap w1, w2, po;  // po: unset without po
  CUtensorMap fw1, fw2;    // the chained FFW's pw4 and pw5, unset without it
};

// the forms of the chain (an instantiation takes one): at most one x2 map, a
// list of maps, the chained FFW
enum WgForm { WG_ONE = 0, WG_LIST = 1, WG_FFW2 = 2 };

// activation columns a chunk, rows of w2 a stage
__host__ __device__ constexpr int wg_aw(int gate) { return gate ? 64 : 128; }
__host__ __device__ constexpr int wg_r2(int C, int gate) {
  return (8192 / C) < wg_aw(gate) ? (8192 / C) : wg_aw(gate);
}

// bytes of the parts after the ring; the ring takes as many stages as fit
__host__ __device__ inline size_t wg_rest(int C, int gate) {
  return (size_t)NPH * (C + XPAD) * 2 + (size_t)NPH * WG_HS * 4 +
         (size_t)P * (wg_aw(gate) + XPAD) * 2;
}
__host__ __device__ inline int wg_stages(int C, int gate) {
  const size_t room = WG_SMEM_MAX - WG_ALIGN - wg_rest(C, gate);
  const int s = (int)(room / (WG_STAGE + 2 * sizeof(uint64_t)));
  return s < WG_MAX_STAGES ? s : WG_MAX_STAGES;
}
__host__ __device__ inline size_t wg_smem(int C, int gate) {
  const int s = wg_stages(C, gate);
  return WG_ALIGN + (size_t)s * WG_STAGE + wg_rest(C, gate) + 2 * s * sizeof(uint64_t);
}

// the fp32 hidden chunk: row r (a halo pixel), column c (0 .. 127); the
// columns are swizzled by the row so that a warp's accumulator stores spread
// over the banks
__device__ __forceinline__ int hid_at(int r, int c) { return r * WG_HS + (c ^ ((r & 3) << 3)); }

// LN pass of the prologue (the 256 consumer threads): x' = xn as the po
// product left it (has_po), or x (+ x2) rounded; LN(x') rounded into xn (row
// stride C + XPAD, zero rows outside the image) for the 100 halo pixels, and
// x' of the interior pixels into out. The LN pass of ln_prologue (common.cuh)
// with the copy warpgroup left out of its barriers, x' kept in the output map
// instead of shared memory and four pixels a lane loaded together.
template <int CR>
__device__ void wg_ln_pass(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ x2, bool has_po,
                           const __nv_bfloat16* __restrict__ ln_w,
                           const __nv_bfloat16* __restrict__ ln_b, int H, int W, int C, int y0,
                           int x0, __nv_bfloat16* xn, __nv_bfloat16* out) {
  using T = __nv_bfloat16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int XS = C + XPAD;
  // a pixel's C channels over a group of GL lanes in vectors of 8
  constexpr int VJ = CR > 8 ? 2 : 1;
  int GL = 32;
  while (GL > 1 && (GL / 2) * 8 * VJ >= C) GL /= 2;
  const int PP = 32 / GL, sub = lane / GL, l = lane % GL;
  float gw[VJ][8], bt[VJ][8];
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int c8 = (l + GL * j) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) { gw[j][i] = 0.f; bt[j][i] = 0.f; }
    if (c8 < C) {
      load8(ln_w + c8, gw[j]);
      if (ln_b != nullptr) load8(ln_b + c8, bt[j]);
    }
  }
  // U pixels a lane at a time: their loads are in flight together
  constexpr int U = 4;
  for (int p0 = warp * PP; p0 < NPH; p0 += NW * PP * U) {
    float v[U][VJ][8];
    bool inside[U];
    size_t goff[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NW * PP + sub;
      inside[u] = halo_inside(p, H, W, y0, x0);
      goff[u] = inside[u] ? halo_offset(p, W, C, y0, x0) : 0;
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int c8 = (l + GL * j) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][j][i] = 0.f;
        if (!inside[u] || c8 >= C) continue;
        if (has_po) {
          load8(xn + p * XS + c8, v[u][j]);
        } else {
          load8(x + goff[u] + c8, v[u][j]);
          if (x2 != nullptr) {
            float v2[8];
            load8(x2 + goff[u] + c8, v2);
#pragma unroll
            for (int i = 0; i < 8; ++i) v[u][j][i] = round_to<T>(v[u][j][i] + v2[i]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NW * PP + sub;
      const int py = p / PH - 1, px = p % PH - 1;
      const bool interior = inside[u] && py >= 0 && py < TS && px >= 0 && px < TS;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        if (!inside[u] || (l + GL * j) * 8 >= C) continue;
        if (interior) store8(out + goff[u] + (l + GL * j) * 8, v[u][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[u][j][i];
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        if (m < GL) sum += __shfl_xor_sync(0xffffffffu, sum, m);
      const float mu = sum / (float)C;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < VJ; ++j)
        if (inside[u] && (l + GL * j) * 8 < C) {
#pragma unroll
          for (int i = 0; i < 8; ++i) q += (v[u][j][i] - mu) * (v[u][j][i] - mu);
        }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        if (m < GL) q += __shfl_xor_sync(0xffffffffu, q, m);
      const float inv = 1.0f / sqrtf(q / (float)C + LN_EPS);
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int c8 = (l + GL * j) * 8;
        if (p >= NPH || c8 >= C) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!inside[u]) v[u][j][i] = 0.f;
          else if (ln_b != nullptr) v[u][j][i] = (v[u][j][i] - mu) * inv * gw[j][i] + bt[j][i];
          else v[u][j][i] = v[u][j][i] * inv * gw[j][i];
        }
        store8(xn + p * XS + c8, v[u][j]);
      }
    }
  }
  consumers_sync();
}

// Depthwise 3x3 of hidden chunk column col (channel ch) down the tile column
// px, from the fp32 chunk: dw_column of common.cuh on this chunk's layout
__device__ __forceinline__ void wg_dw_column(const float* hid, const __nv_bfloat16* __restrict__ wd,
                                             const __nv_bfloat16* __restrict__ bd, int CH,
                                             int px, int col, int ch, float (&out)[TS]) {
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = to_f(wd[i * CH + ch]);
  const float bias = bd != nullptr ? to_f(bd[ch]) : 0.f;
  float r[3][3];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    r[0][tx] = hid[hid_at(px + tx, col)];
    r[1][tx] = hid[hid_at(PH + px + tx, col)];
  }
#pragma unroll
  for (int py = 0; py < TS; ++py) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) r[2][tx] = hid[hid_at((py + 2) * PH + px + tx, col)];
    float a = 0.f;
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) a += r[ty][tx] * w[ty * 3 + tx];
    out[py] = a + bias;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) { r[0][tx] = r[1][tx]; r[1][tx] = r[2][tx]; }
  }
}

// LN2 of the chained FFW on the 64 pixel rows of ybuf (y rounded to bf16, row
// stride C + XPAD), in place, rounded: a pixel's C channels over C / 8 lanes
// in vectors of 8, fp32 statistics as in warp_layer_norm (common.cuh)
template <int C>
__device__ void wg_ffw2_ln(__nv_bfloat16* ybuf, const __nv_bfloat16* __restrict__ ln_w,
                           const __nv_bfloat16* __restrict__ ln_b) {
  constexpr int GL = C / 8, PP = 32 / GL, XS = C + XPAD;  // lanes a pixel, pixels a warp
  static_assert(GL <= 32 && P % (NW * PP) == 0, "every lane has a pixel each round");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane % GL;
  float gw[8], bt[8];
  load8(ln_w + 8 * l, gw);
#pragma unroll
  for (int i = 0; i < 8; ++i) bt[i] = 0.f;
  if (ln_b != nullptr) load8(ln_b + 8 * l, bt);
  for (int pix = warp * PP + lane / GL; pix < P; pix += NW * PP) {
    float v[8];
    load8(ybuf + pix * XS + 8 * l, v);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mu = sum / (float)C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.0f / sqrtf(q / (float)C + LN_EPS);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = ln_b != nullptr ? (v[i] - mu) * inv * gw[i] + bt[i] : v[i] * inv * gw[i];
    store8(ybuf + pix * XS + 8 * l, v);
  }
}

// the block's threads: two consumer warpgroups and a copy warpgroup, which
// hands most of its registers to the consumers
constexpr int WG_NT = NT + 128;
constexpr int WG_REGS_CONSUMER = 232, WG_REGS_COPY = 40;

// the B operand of 16 rows of K at row k of a stage of 64-column panels of
// `rows` rows each, starting at panel p
__device__ __forceinline__ uint64_t stage_desc(const unsigned char* stage, int rows, int p,
                                               int k) {
  return panel_desc(stage + p * rows * 128 + k * 16 * 128, rows * 128);
}

// 4 bytes of a map: through the read-only cache (NC), or by a plain load
// where blocks of the same launch wrote the map before (level_wg.cu)
template <bool NC>
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  if constexpr (NC) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return *reinterpret_cast<const unsigned int*>(p);
}

// C: the map's width (128, 256, 512); GATE: the mode; FORM: a WgForm.
//
// The ring's loads, in the order the copy thread starts them and the
// consumers take them: with po, C / 128 passes of 128 columns of po, in
// each the maps in order (one, or the list's), C / 64 stages of 64 rows a
// map; then chunk by chunk NS1 stages of 64 rows of w1 (the chunk's two
// 64-column panels) and NS2 of R2 rows of w2; with the chained FFW then C /
// FR1 stages of FR1 rows of f_w1 (all F columns) and F / FR2 of FR2 rows of
// f_w2 (all C columns). The consumers commit one wgmma group a stage and
// keep one group in flight: a stage goes back to the copy thread once the
// group after it has been started and the wait for all but that one
// returned.
//
// The copy thread's loads of one output tile of batch entry b into the ring
// r (its li carried in and out). Z3: w1 and w2 are 3-D maps of stacked
// matrices, (N, C, CH) and (N, E, C), read at layer z (row 14's runs); else
// 2-D maps.
template <int C, bool GATE, int FORM, bool Z3 = false>
__device__ __forceinline__ void wg_copy_tile(const FfnArgs& a, const WgMaps& maps, int b,
                                             WgRing& r, int z = 0) {
  constexpr int AW = wg_aw(GATE), R2 = wg_r2(C, GATE);
  constexpr int NS1 = C / WG_KB, NS2 = AW / R2;
  constexpr int NPW = 128;
  constexpr int FF = 2 * C, FR1 = 8192 / FF, FR2 = 8192 / C;
  const int S = r.S, E = a.E;
  const int n_chunks = (E + AW - 1) / AW;
  unsigned char* ring = r.ring;
  uint64_t* full = r.full;
  int& li = r.li;
  auto next = [&](int bytes) {
    const int s = li % S;
    if (li >= S) mbar_wait(&r.empty[s], (li / S - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    ++li;
    return s;
  };
  // a box of w1 or w2 at (c0, c1) of the block's matrix
  auto load_w = [&](void* dst, const CUtensorMap* m, int c0, int c1, int s) {
    if constexpr (Z3)
      tma_load_3d(dst, m, c0, c1, z, &full[s]);
    else
      tma_load_2d(dst, m, c0, c1, &full[s]);
  };
  if (a.po_w != nullptr) {
    // po_m of this batch entry: rows (m B + b) C .. of the stacked
    // (M, B, C, C) matrices, or m C .. of (M, C, C)
    const int n_po = FORM == WG_LIST ? a.n_x2 : 1;
    for (int np = 0; np < C / NPW; ++np)
      for (int m = 0; m < n_po; ++m) {
        const int row0 = (a.po_batched ? m * a.B + b : m) * C;
        for (int kb = 0; kb < C / WG_KB; ++kb) {
          const int s = next(NPW * WG_KB * 2);
          for (int p = 0; p < NPW / 64; ++p)
            tma_load_2d(ring + (size_t)s * WG_STAGE + p * WG_PW1_PANEL, &maps.po,
                        np * NPW + 64 * p, row0 + kb * WG_KB, &full[s]);
        }
      }
  }
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int e0 = ck * AW;
    for (int i = 0; i < NS1; ++i) {
      const int s = next(2 * WG_PW1_PANEL);
      unsigned char* dst = ring + (size_t)s * WG_STAGE;
      load_w(dst, &maps.w1, e0, i * WG_KB, s);
      load_w(dst + WG_PW1_PANEL, &maps.w1, GATE ? E + e0 : e0 + 64, i * WG_KB, s);
    }
    for (int i = 0; i < NS2; ++i) {
      const int s = next(R2 * C * 2);
      for (int p = 0; p < C / 64; ++p)
        load_w(ring + (size_t)s * WG_STAGE + p * R2 * 128, &maps.w2, 64 * p, e0 + i * R2, s);
    }
  }
  if constexpr (FORM == WG_FFW2) {
    for (int i = 0; i < C / FR1; ++i) {
      const int s = next(FR1 * FF * 2);
      for (int p = 0; p < FF / 64; ++p)
        tma_load_2d(ring + (size_t)s * WG_STAGE + p * FR1 * 128, &maps.fw1, 64 * p,
                    i * FR1, &full[s]);
    }
    for (int i = 0; i < FF / FR2; ++i) {
      const int s = next(FR2 * C * 2);
      for (int p = 0; p < C / 64; ++p)
        tma_load_2d(ring + (size_t)s * WG_STAGE + p * FR2 * 128, &maps.fw2, 64 * p,
                    i * FR2, &full[s]);
    }
  }
}

// The consumers' work on output tile `tile` of batch entry b (the 256
// threads of the two consumer warpgroups), in the order of wg_copy_tile's
// loads. xmap, outmap: the input and output maps; ln_w, ln_b, wd: the LN and
// depthwise weights (a's for row 1; the run's block for row 14); the rest
// from a. Shared memory: the LN halo xn, the fp32 hidden chunk hid, the
// activation chunk act. The ring r: its li and rel carried in and out; every
// stage taken is handed back before the return, and no product is left in
// flight. NC: x read through the read-only cache. NJ2 products of
// m64nBN2k16 a k-step make a warpgroup's pw2 columns.
template <int C, bool GATE, int FORM, bool NC = true>
__device__ __forceinline__ void wg_tile(const FfnArgs& a, const __nv_bfloat16* xmap,
                                        __nv_bfloat16* outmap, const __nv_bfloat16* ln_w,
                                        const __nv_bfloat16* ln_b, const __nv_bfloat16* wd,
                                        int b, int tile, WgRing& r, __nv_bfloat16* xn,
                                        float* hid, __nv_bfloat16* act) {
  using T = __nv_bfloat16;
  constexpr int CR = C / 32 > 2 ? C / 32 : 2;
  constexpr int NW2 = C / 2;                        // pw2 columns of a warpgroup
  constexpr int BN2 = NW2 >= 128 ? 128 : 64;        // N of one pw2 product
  constexpr int NJ2 = NW2 / BN2;
  constexpr int AW = wg_aw(GATE), R2 = wg_r2(C, GATE), AS = AW + XPAD, XS = C + XPAD;
  constexpr int NS1 = C / WG_KB, NS2 = AW / R2;    // ring stages of pw1, pw2 a chunk
  constexpr int KS2 = R2 / 16;                     // k-steps of a pw2 stage
  constexpr int NPW = 128;                         // po columns a pass
  // the chained FFW: F, the activation's row stride, rows of f_w1 and f_w2
  // a ring stage
  constexpr int FF = 2 * C, GS = FF + XPAD, FR1 = 8192 / FF, FR2 = 8192 / C;
  static_assert(FORM != WG_LIST || (GATE && C <= 256),
                "lists: gate, a halo tile of x2 within the hid chunk");
  static_assert(FORM != WG_FFW2 || (!GATE && C == 128),
                "the chained FFW: gelu at C = 128 (y and its activation within the LN "
                "halo and the hid chunk, one pw2 product a warpgroup)");
  const int S = r.S;
  unsigned char* ring = r.ring;
  uint64_t* full = r.full;
  uint64_t* empty = r.empty;
  const int H = a.H, W = a.W, E = a.E, CH = a.CH;
  const int tiles_x = (W + TS - 1) / TS;
  const int y0 = (tile / tiles_x) * TS, x0 = (tile % tiles_x) * TS;
  const int n_chunks = (E + AW - 1) / AW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_po = a.po_w != nullptr;

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  // the ring as the consumers see it: li the next load, rel the next to hand
  // back (one arrival a warpgroup)
  int& li = r.li;
  int& rel = r.rel;
  auto take = [&]() {
    const int s = li % S;
    mbar_wait(&full[s], (li / S) & 1);
    ++li;
    return ring + (size_t)s * WG_STAGE;
  };
  auto release_upto = [&](int n) {
    for (; rel < n; ++rel)
      if (lane == 0 && q == 0) mbar_arrive(&empty[rel % S]);
  };

  const size_t boff = (size_t)b * H * W * C;
  const T* x = xmap + boff;
  const T* x2 = a.n_x2 > 0 ? static_cast<const T*>(a.x2[0]) + (size_t)b * a.x2_bs[0] : nullptr;
  T* out = outmap + boff;
  // warpgroup wg multiplies halo rows 64 wg .. 64 wg + 63 (rows past the
  // 100th read row 0 and are dropped); ldmatrix row lane & 15 of warp q
  const int hrow = 64 * wg + 16 * q + (lane & 15);
  const T* arow1 = xn + (hrow < NPH ? hrow : 0) * XS + (lane >> 4) * 8;

  if (has_po) {
    // x' = x + sum_m x2_m @ po_m on the halo tile in passes of 128 columns:
    // a map's halo tile, all of its K, in every warp's registers
    const T* po_b = static_cast<const T*>(a.po_b);
    // this thread's two accumulator rows: halo pixel, inside, x there
    int prow[2];
    bool prow_in[2];
    const T* prow_x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      prow[h] = 64 * wg + 16 * q + g + 8 * h;
      prow_in[h] = prow[h] < NPH && halo_inside(prow[h], H, W, y0, x0);
      prow_x[h] = x + (prow_in[h] ? halo_offset(prow[h], W, C, y0, x0) : 0);
    }
    // pa = the tile in xf times this pass's 128 columns of po_m (the next
    // C / 64 stages of the ring)
    auto po_product = [&](float (&pa)[NPW / 2], const AFrag<T> (&xf)[C / 16]) {
#pragma unroll
      for (int i = 0; i < NPW / 2; ++i) pa[i] = 0.f;
#pragma unroll
      for (int kb = 0; kb < C / WG_KB; ++kb) {
        const unsigned char* bs = take();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < WG_KB / 16; ++k)
          wgmma_rs<NPW>(pa, xf[kb * 4 + k], stage_desc(bs, WG_KB, 0, k));
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          release_upto(li - 1);
        }
      }
      wgmma_wait<0>();
      pin(pa);
      release_upto(li);
    };
    // the product at this thread's column pair j of row h of pass np rounded
    // to bf16, and with po_b (map 0 only) rounded again
    auto rounded = [&](const float (&pa)[NPW / 2], int np, int j, int h, bool first) {
      float a0 = round_to<T>(pa[4 * j + 2 * h]), a1 = round_to<T>(pa[4 * j + 2 * h + 1]);
      if (first && po_b != nullptr) {
        const float2 pb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(po_b + np * NPW + 8 * j + 2 * t));
        a0 = round_to<T>(a0 + pb.x);
        a1 = round_to<T>(a1 + pb.y);
      }
      return make_float2(a0, a1);
    };
    if constexpr (FORM == WG_LIST) {
      // the maps in order, their sum in fp32 registers from x on. Map m's
      // halo tile is staged in the hid chunk (row p at p C, its 16-byte
      // pieces swizzled by p & 7 so that ldmatrix's eight rows hit eight
      // bank groups) and the next map's tile comes in behind map m's
      // products; at C = 256 each pass stages every map once
      T* stg = reinterpret_cast<T*>(hid);
      auto stage = [&](int m) {
        const T* src = static_cast<const T*>(a.x2[m]) + (size_t)b * a.x2_bs[m];
        constexpr int c8n = C / 8;
        for (int idx = tid; idx < NPH * c8n; idx += NT) {
          const int p = idx / c8n, j = idx - p * c8n;
          T* dst = stg + p * C + ((j ^ (p & 7)) << 3);
          if (halo_inside(p, H, W, y0, x0))
            cp_async16(dst, src + halo_offset(p, W, C, y0, x0) + 8 * j);
          else
            zero16(dst);
        }
        cp_async_commit();
      };
      const int srow = hrow < NPH ? hrow : 0, sw = srow & 7, half = lane >> 4;
      const T* arow_s = stg + srow * C;
      const int nm = a.n_x2;
      stage(0);
#pragma unroll 1
      for (int np = 0; np < C / NPW; ++np) {
        float sum[NPW / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NPW / 8; ++j) {
            float2 xx = make_float2(0.f, 0.f);
            if (prow_in[h]) {
              const uint32_t xv = ld_u32<NC>(prow_x[h] + np * NPW + 8 * j + 2 * t);
              xx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
            }
            sum[4 * j + 2 * h] = xx.x;
            sum[4 * j + 2 * h + 1] = xx.y;
          }
#pragma unroll 1
        for (int m = 0; m < nm; ++m) {
          cp_async_wait<0>();
          consumers_sync();
          AFrag<T> xf[C / 16];
#pragma unroll
          for (int k = 0; k < C / 16; ++k)
            ldsm_a(xf[k], arow_s + (((2 * k + half) ^ sw) << 3));
          consumers_sync();  // every warp holds its fragments: the next tile may come in
          if (m + 1 < nm)
            stage(m + 1);
          else if (np + 1 < C / NPW)
            stage(0);
          float pa[NPW / 2];
          po_product(pa, xf);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < NPW / 8; ++j) {
              const float2 p2 = rounded(pa, np, j, h, m == 0);
              sum[4 * j + 2 * h] += p2.x;
              sum[4 * j + 2 * h + 1] += p2.y;
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!prow_in[h]) continue;
#pragma unroll
          for (int j = 0; j < NPW / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(xn + prow[h] * XS + np * NPW + 8 * j + 2 * t) =
                __floats2bfloat162_rn(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // one map: its tile in xn, every warp's fragments of it taken once,
      // then xn overwritten pass by pass (a warp writes only the rows it
      // read)
      const int c8n = C / 8;
      for (int idx = tid; idx < NPH * c8n; idx += NT) {
        const int p = idx / c8n, c8 = (idx - p * c8n) * 8;
        if (halo_inside(p, H, W, y0, x0))
          cp_async16(xn + p * XS + c8, x2 + halo_offset(p, W, C, y0, x0) + c8);
        else
          zero16(xn + p * XS + c8);
      }
      cp_async_commit();
      cp_async_wait<0>();
      consumers_sync();
      AFrag<T> xf[C / 16];
#pragma unroll
      for (int k = 0; k < C / 16; ++k) ldsm_a(xf[k], arow1 + 16 * k);
#pragma unroll 1
      for (int np = 0; np < C / NPW; ++np) {
        float pa[NPW / 2];
        po_product(pa, xf);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!prow_in[h]) continue;
          uint32_t xv[NPW / 8];  // x at this thread's column pairs, loaded together
#pragma unroll
          for (int j = 0; j < NPW / 8; ++j)
            xv[j] = ld_u32<NC>(prow_x[h] + np * NPW + 8 * j + 2 * t);
#pragma unroll
          for (int j = 0; j < NPW / 8; ++j) {
            const float2 p2 = rounded(pa, np, j, h, true);
            const float2 xx =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[j]));
            *reinterpret_cast<__nv_bfloat162*>(xn + prow[h] * XS + np * NPW + 8 * j + 2 * t) =
                __floats2bfloat162_rn(xx.x + p2.x, xx.y + p2.y);
          }
        }
      }
    }
    consumers_sync();
  }
  wg_ln_pass<CR>(x, x2, has_po, ln_w, ln_b, H, W, C, y0, x0, xn, out);

  const T* b1 = static_cast<const T*>(a.b1);
  const T* bd = static_cast<const T*>(a.bd);
  // pw2: the 64 pixels, rows of the activation chunk
  const T* arow2 = act + (16 * q + (lane & 15)) * AS + (lane >> 4) * 8;

  float acc[NJ2][BN2 / 2];
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int i = 0; i < BN2 / 2; ++i) acc[j][i] = 0.f;

  // this thread's two rows of the pw1 accumulators in the halo tile
  bool hrow_ok[2], hrow_in[2];
  int hrow_at[2], hrow_swz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * q + g + 8 * h;
    hrow_ok[h] = row < NPH;
    hrow_in[h] = hrow_ok[h] && halo_inside(row, H, W, y0, x0);
    hrow_at[h] = row * WG_HS;
    hrow_swz[h] = (row & 3) << 3;
  }

#pragma unroll 1
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int e0 = ck * AW, ne = min(AW, E - e0);
    // pw1 on the halo tile: 128 hidden columns, K = C in stages of 64 rows
    float h1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) h1[i] = 0.f;
    AFrag<T> af[2][WG_KB / 16];
#pragma unroll
    for (int kb = 0; kb < NS1; ++kb) {
      const unsigned char* bs = take();
#pragma unroll
      for (int k = 0; k < WG_KB / 16; ++k) ldsm_a(af[kb & 1][k], arow1 + kb * WG_KB + k * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < WG_KB / 16; ++k)
        wgmma_rs<128>(h1, af[kb & 1][k], stage_desc(bs, WG_KB, 0, k));
      wgmma_commit();
      wgmma_wait<1>();  // the group before (the last pw2 stage, or pw1's) is done
      release_upto(li - 1);
    }
    wgmma_wait<0>();
    pin(h1);
    release_upto(li);
    // + b1, zero outside the image and for columns without a channel;
    // column pairs as float2
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const bool on = (GATE ? (col & 63) : col) < ne;  // ne is a multiple of 32
      const int ch = GATE ? (col < 64 ? e0 + col : E + e0 + col - 64) : e0 + col;
      const float2 bias =
          (b1 != nullptr && on)
              ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + ch))
              : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!hrow_ok[h]) continue;
        const bool keep = on && hrow_in[h];
        *reinterpret_cast<float2*>(hid + hrow_at[h] + (col ^ hrow_swz[h])) =
            make_float2(keep ? h1[4 * j + 2 * h] + bias.x : 0.f,
                        keep ? h1[4 * j + 2 * h + 1] + bias.y : 0.f);
      }
    }
    consumers_sync();
    // dw 3x3 + activation, rounded to bf16 as the pw2 operand
    for (int item = tid; item < AW * TS; item += NT) {
      const int col = item % AW, px = item / AW;
      float va[TS], vb[TS];
      if (col < ne) {
        wg_dw_column(hid, wd, bd, CH, px, col, e0 + col, va);
        if (GATE) wg_dw_column(hid, wd, bd, CH, px, col + 64, E + e0 + col, vb);
      }
#pragma unroll
      for (int py = 0; py < TS; ++py) {
        float v = 0.f;
        if (col < ne) {
          v = gelu_exact(va[py]);
          if (GATE) v *= vb[py];
        }
        act[(py * TS + px) * AS + col] = from_f<T>(v);
      }
    }
    consumers_sync();
    // pw2: rows e0 .. e0 + AW of w2 in NS2 stages of R2 rows; the last
    // group stays in flight into the next chunk's pw1
    AFrag<T> a2f[NS2 > 1 ? 2 : 1][KS2];
#pragma unroll
    for (int j2 = 0; j2 < NS2; ++j2) {
      const unsigned char* bs = take();
      constexpr int NB = NS2 > 1 ? 2 : 1;
#pragma unroll
      for (int k = 0; k < KS2; ++k)
        ldsm_a(a2f[j2 % NB][k], arow2 + j2 * R2 + k * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS2; ++k) {
#pragma unroll
        for (int n = 0; n < NJ2; ++n)
          wgmma_rs<BN2>(acc[n], a2f[j2 % NB][k],
                        stage_desc(bs, R2, wg * (NW2 / 64) + n * (BN2 / 64), k));
      }
      wgmma_commit();
      wgmma_wait<1>();
      release_upto(li - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NJ2; ++n) pin(acc[n]);
  release_upto(li);

  // epilogue: y = (acc + b2) * scale + x', x' read back from the output map
  // (this block wrote it there in the prologue), one rounding; with the
  // chained FFW y stays in acc, rounded (zero for pixels outside the image)
  const T* b2 = static_cast<const T*>(a.b2);
  const T* sc = static_cast<const T*>(a.scale);
  __nv_bfloat162* orow[2];
  bool oin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = 16 * q + g + 8 * h;
    const int gy = y0 + pix / TS, gx = x0 + pix % TS;
    oin[h] = gy < H && gx < W;
    orow[h] = reinterpret_cast<__nv_bfloat162*>(out + (oin[h] ? ((size_t)gy * W + gx) * C : 0));
  }
#pragma unroll
  for (int n = 0; n < NJ2; ++n) {
    const int cb = wg * NW2 + n * BN2 + 2 * t;  // + 8 j
    __nv_bfloat162 xr[2][BN2 / 8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN2 / 8; ++j)
        if (oin[h]) xr[h][j] = orow[h][(cb + 8 * j) / 2];
#pragma unroll
    for (int j = 0; j < BN2 / 8; ++j) {
      const int c = cb + 8 * j;
      const float bb0 = b2 ? to_f(b2[c]) : 0.f, bb1 = b2 ? to_f(b2[c + 1]) : 0.f;
      const float s0 = sc ? to_f(sc[c]) : 1.f, s1 = sc ? to_f(sc[c + 1]) : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        if (!oin[h]) {
          acc[n][i] = acc[n][i + 1] = 0.f;
          continue;
        }
        const float2 xx = __bfloat1622float2(xr[h][j]);
        const __nv_bfloat162 yv = __floats2bfloat162_rn((acc[n][i] + bb0) * s0 + xx.x,
                                                        (acc[n][i + 1] + bb1) * s1 + xx.y);
        if constexpr (FORM == WG_FFW2) {
          const float2 yf = __bfloat1622float2(yv);
          acc[n][i] = yf.x;
          acc[n][i + 1] = yf.y;
        } else {
          orow[h][c / 2] = yv;
        }
      }
    }
  }

  if constexpr (FORM == WG_FFW2) {
    // the chained FFW on y, M = 64 pixels: y meets in the LN halo's space
    // (ybuf, row stride XS) and LN2(y) overwrites it; pw4's F columns are
    // split between the warpgroups, gelu(h2 + b4) goes to the hid chunk's
    // space (gbuf, row stride GS), pw5 gives each warpgroup the columns of
    // its y. Both spaces are free: every warp passed the barrier after the
    // last chunk's dw, the last reader of xn and hid.
    T* ybuf = xn;
    T* gbuf = reinterpret_cast<T*>(hid);
    static_assert(P * GS * 2 <= NPH * WG_HS * 4, "the activation fits the hid chunk");
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN2 / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ybuf + (16 * q + g + 8 * h) * XS + wg * NW2 + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]);
    consumers_sync();
    wg_ffw2_ln<C>(ybuf, static_cast<const T*>(a.f_ln_w), static_cast<const T*>(a.f_ln_b));
    consumers_sync();
    // pw4: columns [wg F / 2, (wg + 1) F / 2) of h2, K = C in stages of FR1
    // rows of all F columns
    const T* arow4 = ybuf + (16 * q + (lane & 15)) * XS + (lane >> 4) * 8;
    float h2[FF / 4];
#pragma unroll
    for (int i = 0; i < FF / 4; ++i) h2[i] = 0.f;
#pragma unroll
    for (int st = 0; st < C / FR1; ++st) {
      const unsigned char* bs = take();
      AFrag<T> af[FR1 / 16];
#pragma unroll
      for (int k = 0; k < FR1 / 16; ++k) ldsm_a(af[k], arow4 + st * FR1 + k * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < FR1 / 16; ++k)
        wgmma_rs<FF / 2>(h2, af[k], stage_desc(bs, FR1, wg * (FF / 128), k));
      wgmma_commit();
      wgmma_wait<1>();
      release_upto(li - 1);
    }
    wgmma_wait<0>();
    pin(h2);
    release_upto(li);
    const T* f_b1 = static_cast<const T*>(a.f_b1);
#pragma unroll
    for (int j = 0; j < FF / 16; ++j) {
      const int f = wg * (FF / 2) + 8 * j + 2 * t;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b1 + f));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(gbuf + (16 * q + g + 8 * h) * GS + f) =
            __floats2bfloat162_rn(gelu_exact(h2[4 * j + 2 * h] + bias.x),
                                  gelu_exact(h2[4 * j + 2 * h + 1] + bias.y));
    }
    consumers_sync();
    // pw5: this warpgroup's C / 2 columns, K = F in stages of FR2 rows of all
    // C columns
    const T* arow5 = gbuf + (16 * q + (lane & 15)) * GS + (lane >> 4) * 8;
    float o2[NW2 / 2];
#pragma unroll
    for (int i = 0; i < NW2 / 2; ++i) o2[i] = 0.f;
#pragma unroll
    for (int st = 0; st < FF / FR2; ++st) {
      const unsigned char* bs = take();
      AFrag<T> af[FR2 / 16];
#pragma unroll
      for (int k = 0; k < FR2 / 16; ++k) ldsm_a(af[k], arow5 + st * FR2 + k * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < FR2 / 16; ++k)
        wgmma_rs<NW2>(o2, af[k], stage_desc(bs, FR2, wg * (NW2 / 64), k));
      wgmma_commit();
      wgmma_wait<1>();
      release_upto(li - 1);
    }
    wgmma_wait<0>();
    pin(o2);
    release_upto(li);
    // out = (o2 + b5) * scale2 + y, one rounding
    const T* f_b2 = static_cast<const T*>(a.f_b2);
    const T* f_sc = static_cast<const T*>(a.f_scale);
#pragma unroll
    for (int j = 0; j < NW2 / 8; ++j) {
      const int c = wg * NW2 + 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b2 + c));
      const float2 ss = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_sc + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!oin[h]) continue;
        const int i = 4 * j + 2 * h;
        orow[h][c / 2] = __floats2bfloat162_rn((o2[i] + bb.x) * ss.x + acc[0][i],
                                               (o2[i + 1] + bb.y) * ss.y + acc[0][i + 1]);
      }
    }
  }
}

}  // namespace turtle
