// Two chained depthwise stages of the conv-only levels in one pass over the
// map (row 13 of the port's kernel table):
//
//   stage s:  y' = y + scale_s * (pw2(act(dw3x3(pw1(LN y) + b1) + bd)) + b2)
//             act = gelu, or gelu(a) * b on the two halves of the hidden
//             axis (gate); optionally followed by the pointwise FFW half
//             y'' = y' + scale_f * (pw5(gelu(pw4(LN2 y') + b4)) + b5)
//   out = stage 2 (stage 1 (x))
//
// A pair of ReducedAttn+FFW blocks (enc1, enc2) is stage 1 = block A's
// ReducedAttn and FFW, stage 2 = block B's; a ReducedAttn+GFFW block (the
// refinement) is stage 1 = its ReducedAttn half, stage 2 = its gated FFN.
//
// Replaces fused_two_stage in turtlevsr_tpu/kernels/chain2.py (_dw2_kernel).
// On an H100 the chain is bound by operations at C = 128 and by bytes at
// C = 64, as row 1's; what the fusion saves is one write and one read of the
// map between the stages. A block owns an 8x8 output tile. Stage 1 reads LN(x)
// on the 12x12 tile with a two-pixel halo and produces y on the 10x10 ring
// around the tile into shared memory, rounded to T as the split route stores
// it (so stage 1 is recomputed on that one-pixel ring by the neighbouring
// blocks); stage 2 consumes that ring as its halo tile. Border rule: a
// depthwise stage zero-pads its HIDDEN map, so a hidden value at a position
// outside the image is zero after pw1 and its bias b1 (b1 alone otherwise),
// and y outside the image is a zero row for stage 2's LayerNorm. Each
// pixel's arithmetic (LayerNorm lane layout, mma.sync k order, tap order,
// rounding points) is that of ffn.cu; measured on an H100, the result
// equals two launches of ffn.cu up to a last-place difference now and then.
// The pointwise FFW runs in chunks of 64 hidden columns. mma.sync tiles from
// common.cuh, no TMA, no wgmma yet.
#include "common.cuh"

namespace turtle {

struct StageArgs {
  const void *ln_w, *ln_b, *w1, *b1, *wd, *bd, *w2, *b2, *scale;  // the dw stage
  const void *f_ln_w, *f_ln_b, *f_w1, *f_b1, *f_w2, *f_b2, *f_scale;  // its FFW (f_w1 null: none)
  int CH, E, gate, F;
};

struct TwoStageArgs {
  const void* x;
  void* out;
  StageArgs st[2];
  int B, H, W, C;
};

constexpr int RING = TS + 2;        // side of stage 1's output ring tile
constexpr int N_RING = RING * RING; // 100 pixels
constexpr int SI1 = TS + 4;         // side of stage 1's input tile
constexpr int N_IN1 = SI1 * SI1;    // 144 pixels
constexpr int FC = 64;              // hidden columns of one FFW chunk

// Geometry of a stage whose output tile has side SO (10: stage 1, 8: stage
// 2) and whose input tile has side SO + 2; `off` = (SO - 8) / 2.
template <int SO>
struct Geo {
  static constexpr int SI = SO + 2, NI = SI * SI, NO = SO * SO;
  static constexpr int MT_I = (NI + 15) / 16, MT_O = (NO + 15) / 16;
  static constexpr int OFF = (SO - TS) / 2;
  // input pixel p lies inside the image
  static __device__ __forceinline__ bool in_inside(int p, int H, int W, int y0, int x0) {
    const int gy = y0 - 1 - OFF + p / SI, gx = x0 - 1 - OFF + p % SI;
    return p < NI && gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// LayerNorm of the NI input pixels of a stage into xn (row stride C + XPAD),
// in the lane layout of ln_prologue (common.cuh): row(p) gives the pixel's
// channels (global memory or shared), null for a pixel outside the image,
// which gets a zero row.
template <class T, int CR, int SO, class Row>
__device__ void ln_rows(Row row_of, const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                        int C, T* xn) {
  using G = Geo<SO>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int XS = C + XPAD;
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
  for (int p0 = warp * PP; p0 < G::NI; p0 += NW * PP) {
    const int p = p0 + sub;
    const T* src = p < G::NI ? row_of(p) : nullptr;
    const bool inside = src != nullptr;
    float v[VJ][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int c8 = (l + GL * j) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
      if (inside && c8 < C) {
        load8(src + c8, v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[j][i];
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mu = sum / (float)C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j)
      if (inside && (l + GL * j) * 8 < C) {
#pragma unroll
        for (int i = 0; i < 8; ++i) q += (v[j][i] - mu) * (v[j][i] - mu);
      }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.0f / sqrtf(q / (float)C + LN_EPS);
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int c8 = (l + GL * j) * 8;
      if (p >= G::NI || c8 >= C) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!inside) v[j][i] = 0.f;
        else if (ln_b != nullptr) v[j][i] = (v[j][i] - mu) * inv * gw[j][i] + bt[j][i];
        else v[j][i] = v[j][i] * inv * gw[j][i];
      }
      store8(xn + p * XS + c8, v[j]);
    }
  }
  __syncthreads();
}

// pw1_chunk of common.cuh over the NI input pixels of a stage
template <class T, int SO>
__device__ void pw1_region(const T* xn, const T* __restrict__ w1, const T* __restrict__ b1,
                           int H, int W, int C, int CH, int y0, int x0, ChunkCols cols,
                           float* hid) {
  using G = Geo<SO>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD;
  if (cols.chan(warp * 8) < 0) {
#pragma unroll
    for (int mi = 0; mi < G::MT_I; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mi * 16 + g + 8 * (i >> 1);
        if (row < G::NI) hid[row * HS + warp * 8 + 2 * t + (i & 1)] = 0.f;
      }
    return;
  }
  const int nb_ = cols.chan(warp * 8 + g);
  float acc[G::MT_I][4];
#pragma unroll
  for (int mi = 0; mi < G::MT_I; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mi][i] = 0.f;
  for (int k0 = 0; k0 < C; k0 += 16) {
    BFrag<T> bf;
    load_b(bf, w1, (size_t)CH, k0, C, nb_);
#pragma unroll
    for (int mi = 0; mi < G::MT_I; ++mi) {
      const int rlo = mi * 16 + g, rhi = rlo + 8;
      AFrag<T> af;
      load_a(af, rlo < G::NI ? xn + rlo * XS : nullptr,
             rhi < G::NI ? xn + rhi * XS : nullptr, k0);
      tile_mma(acc[mi], af, bf);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = warp * 8 + 2 * t + (i & 1);
    const int ch = cols.chan(col);
    const float bias = (ch >= 0 && b1 != nullptr) ? to_f(b1[ch]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < G::MT_I; ++mi) {
      const int row = mi * 16 + g + 8 * (i >> 1);
      if (row < G::NI)
        hid[row * HS + col] =
            (ch >= 0 && G::in_inside(row, H, W, y0, x0)) ? acc[mi][i] + bias : 0.f;
    }
  }
}

// dw_column of common.cuh down output column px of a stage (SO pixels)
template <class T, int SO>
__device__ __forceinline__ void dw_region_column(const float* hid, const T* __restrict__ wd,
                                                 const T* __restrict__ bd, int CH, int px,
                                                 int col, int ch, float (&out)[SO]) {
  constexpr int SI = SO + 2;
  const float* base = hid + px * HS + col;
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = to_f(wd[i * CH + ch]);
  const float bias = bd != nullptr ? to_f(bd[ch]) : 0.f;
  float r[3][3];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    r[0][tx] = base[tx * HS];
    r[1][tx] = base[(SI + tx) * HS];
  }
#pragma unroll
  for (int py = 0; py < SO; ++py) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) r[2][tx] = base[((py + 2) * SI + tx) * HS];
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

// pixel_tile_product of common.cuh over the first n_rows rows of A (MT
// 16-row tiles; rows past n_rows read as zeros)
template <class T, int NTW, int MT>
__device__ __forceinline__ void region_product(float (&acc)[NTW][MT][4], const T* A, int lda,
                                               int K, const T* __restrict__ w, int kmax, int N,
                                               int n_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  for (int k0 = 0; k0 < K; k0 += 32) {
    BFrag<T> bf[2][NTW];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = (warp + NW * j) * 8 + g;
        load_b(bf[s][j], w, (size_t)N, k0 + 16 * s, kmax, n < N ? n : -1);
      }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (k0 + 16 * s >= K) continue;
      AFrag<T> af[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int rlo = mi * 16 + g, rhi = rlo + 8;
        load_a(af[mi], rlo < n_rows ? A + rlo * lda : nullptr,
               rhi < n_rows ? A + rhi * lda : nullptr, k0 + 16 * s);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if ((warp + NW * j) * 8 >= N) continue;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) tile_mma(acc[j][mi], af[mi], bf[s][j]);
      }
    }
  }
}

// The dw stage on LN(input) in xn: acc = pw2(act(dw(pw1(xn) + b1) + bd)) for
// the NO output pixels, the hidden axis in chunks of 64 columns (32 + 32
// partners for the gate). Ends with the last product; hid and act are free
// again, xn after the next barrier.
template <class T, int NTW, int SO>
__device__ void stage_chain(const StageArgs& s, const T* xn, float* hid, T* act, int H, int W,
                            int C, int y0, int x0, float (&acc)[NTW][Geo<SO>::MT_O][4]) {
  using G = Geo<SO>;
  const int tid = threadIdx.x;
  const T* w1 = static_cast<const T*>(s.w1);
  const T* b1 = static_cast<const T*>(s.b1);
  const T* wd = static_cast<const T*>(s.wd);
  const T* bd = static_cast<const T*>(s.bd);
  const T* w2 = static_cast<const T*>(s.w2);
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mi = 0; mi < G::MT_O; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][mi][i] = 0.f;
  const int E = s.E, EA = s.gate ? SEG : HC;
  for (int e0 = 0; e0 < E; e0 += EA) {
    const int ne = min(EA, E - e0);
    const ChunkCols cols = s.gate ? ChunkCols{e0, ne, E + e0, ne}
                                  : ChunkCols{e0, min(ne, SEG), e0 + SEG, max(ne - SEG, 0)};
    pw1_region<T, SO>(xn, w1, b1, H, W, C, s.CH, y0, x0, cols, hid);
    __syncthreads();
    for (int item = tid; item < EA * SO; item += NT) {
      const int col = item % EA, px = item / EA;
      float va[SO], vb[SO];
      if (col < ne) {
        dw_region_column<T, SO>(hid, wd, bd, s.CH, px, col, e0 + col, va);
        if (s.gate) dw_region_column<T, SO>(hid, wd, bd, s.CH, px, col + SEG, E + e0 + col, vb);
      }
#pragma unroll
      for (int py = 0; py < SO; ++py) {
        float v = 0.f;
        if (col < ne) {
          v = gelu_exact(va[py]);
          if (s.gate) v *= vb[py];
        }
        act[(py * SO + px) * AS + col] = from_f<T>(v);
      }
    }
    __syncthreads();
    region_product<T, NTW, G::MT_O>(acc, act, AS, EA, w2 + (size_t)e0 * C, ne, C, G::NO);
  }
}

// y = round_T((acc + b2) * scale + residual) into ybuf (NO rows, stride
// C + XPAD); res(pix, c) is the residual of output pixel pix
template <class T, int NTW, int MT, class Res>
__device__ __forceinline__ void stage_epilogue(const StageArgs& s, float (&acc)[NTW][MT][4],
                                               int n_out, int C, Res res, T* ybuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD;
  const T* b2 = static_cast<const T*>(s.b2);
  const T* sc = static_cast<const T*>(s.scale);
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (warp + NW * j) * 8 + 2 * t + (i & 1);
      if (c >= C) continue;
      const float bb = b2 ? to_f(b2[c]) : 0.f;
      const float ss = sc ? to_f(sc[c]) : 1.f;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int pix = mi * 16 + g + 8 * (i >> 1);
        if (pix < n_out) ybuf[pix * XS + c] = from_f<T>((acc[j][mi][i] + bb) * ss + res(pix, c));
      }
    }
  __syncthreads();
}

// The pointwise FFW on the n_out rows of ybuf (y already rounded to T), in
// place: y + scale_f * (pw5(gelu(pw4(LN2 y) + b4)) + b5), rounded to T.
// lnbuf (n_out rows, stride C + XPAD) and act are scratch.
template <class T, int NTW, int MT>
__device__ void ffw_rows(const StageArgs& s, T* ybuf, T* lnbuf, T* act, int n_out, int C) {
  constexpr int CR = 2 * NTW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD, F = s.F;
  const T* f_w1 = static_cast<const T*>(s.f_w1);
  const T* f_b1 = static_cast<const T*>(s.f_b1);
  const T* f_w2 = static_cast<const T*>(s.f_w2);
  const T* f_b2 = static_cast<const T*>(s.f_b2);
  const T* f_sc = static_cast<const T*>(s.f_scale);
  {  // LN2 in the lane layout of ffn_tile's chained FFW
    float gw[CR], bt[CR];
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const int c = lane + 32 * j;
      gw[j] = c < C ? to_f(static_cast<const T*>(s.f_ln_w)[c]) : 0.f;
      bt[j] = (c < C && s.f_ln_b) ? to_f(static_cast<const T*>(s.f_ln_b)[c]) : 0.f;
    }
    for (int pix = warp; pix < n_out; pix += NW) {
      float v[CR];
#pragma unroll
      for (int j = 0; j < CR; ++j)
        v[j] = lane + 32 * j < C ? to_f(ybuf[pix * XS + lane + 32 * j]) : 0.f;
      warp_layer_norm<CR>(v, lane, C, gw, bt, s.f_ln_b != nullptr);
#pragma unroll
      for (int j = 0; j < CR; ++j)
        if (lane + 32 * j < C) lnbuf[pix * XS + lane + 32 * j] = from_f<T>(v[j]);
    }
  }
  __syncthreads();
  float o2[NTW][MT][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) o2[j][mi][i] = 0.f;
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nf = min(FC, F - f0);
    {  // h = gelu(pw4(LN2 y) + b4) for columns f0 .. f0 + nf: warp w owns 8 of them
      const int n = warp * 8 + g;
      float h[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) h[mi][i] = 0.f;
      if (warp * 8 < nf) {
        for (int k0 = 0; k0 < C; k0 += 16) {
          BFrag<T> bf;
          load_b(bf, f_w1 + f0, (size_t)F, k0, C, n < nf ? n : -1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const int rlo = mi * 16 + g, rhi = rlo + 8;
            AFrag<T> af;
            load_a(af, rlo < n_out ? lnbuf + rlo * XS : nullptr,
                   rhi < n_out ? lnbuf + rhi * XS : nullptr, k0);
            tile_mma(h[mi], af, bf);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = warp * 8 + 2 * t + (i & 1);
        const float bb = col < nf ? to_f(f_b1[f0 + col]) : 0.f;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int pix = mi * 16 + g + 8 * (i >> 1);
          if (pix < n_out)
            act[pix * AS + col] = from_f<T>(col < nf ? gelu_exact(h[mi][i] + bb) : 0.f);
        }
      }
    }
    __syncthreads();
    region_product<T, NTW, MT>(o2, act, AS, nf, f_w2 + (size_t)f0 * C, nf, C, n_out);
    __syncthreads();  // the next chunk rewrites act
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (warp + NW * j) * 8 + 2 * t + (i & 1);
      if (c >= C) continue;
      const float bb = to_f(f_b2[c]), ss = to_f(f_sc[c]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int pix = mi * 16 + g + 8 * (i >> 1);
        if (pix < n_out)
          ybuf[pix * XS + c] = from_f<T>((o2[j][mi][i] + bb) * ss + to_f(ybuf[pix * XS + c]));
      }
    }
  __syncthreads();
}

// shared memory: xn T[144][XS] | hid f32[144][HS] | act T[100][AS] | yb T[100][XS]
__host__ __device__ inline size_t two_stage_smem(int C, int is_bf16) {
  const size_t ts = is_bf16 ? 2 : 4, xs = (size_t)(C + XPAD);
  return (size_t)N_IN1 * xs * ts + (size_t)N_IN1 * HS * 4 + (size_t)N_RING * AS * ts +
         (size_t)N_RING * xs * ts;
}

// NTW: 8-column output tiles per warp (C <= 64 NTW). The narrow level (C <=
// 64) is held to 128 registers so that two blocks share an SM, as ffn.cu.
template <class T, int NTW>
__global__ void __launch_bounds__(NT, (NTW <= 1 ? 2 : 1)) two_stage_kernel(
    const __grid_constant__ TwoStageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CR = 2 * NTW;
  using G1 = Geo<RING>;
  using G2 = Geo<TS>;
  const int C = a.C, H = a.H, W = a.W, XS = C + XPAD;
  const int b = blockIdx.y, tiles_x = (W + TS - 1) / TS;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;
  T* xn = reinterpret_cast<T*>(smem);
  float* hid = reinterpret_cast<float*>(xn + N_IN1 * XS);
  T* act = reinterpret_cast<T*>(hid + N_IN1 * HS);
  T* yb = act + N_RING * AS;
  const size_t boff = (size_t)b * H * W * C;
  const T* x = static_cast<const T*>(a.x) + boff;

  // ---- stage 1: LN(x) on the 12x12 tile, y on the 10x10 ring ----
  const StageArgs& s1 = a.st[0];
  ln_rows<T, CR, RING>(
      [&](int p) -> const T* {
        const int gy = y0 - 2 + p / SI1, gx = x0 - 2 + p % SI1;
        return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? x + ((size_t)gy * W + gx) * C
                                                        : nullptr;
      },
      static_cast<const T*>(s1.ln_w), static_cast<const T*>(s1.ln_b), C, xn);
  {
    float acc[NTW][G1::MT_O][4];
    stage_chain<T, NTW, RING>(s1, xn, hid, act, H, W, C, y0, x0, acc);
    stage_epilogue<T, NTW, G1::MT_O>(
        s1, acc, N_RING, C,
        [&](int pix, int c) -> float {
          const int gy = y0 - 1 + pix / RING, gx = x0 - 1 + pix % RING;
          return (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? to_f(x[((size_t)gy * W + gx) * C + c])
                     : 0.f;
        },
        yb);
  }
  if (s1.f_w1 != nullptr) ffw_rows<T, NTW, G1::MT_O>(s1, yb, xn, act, N_RING, C);

  // ---- stage 2: LN(y) on the ring (zero rows outside the image), the tile ----
  const StageArgs& s2 = a.st[1];
  ln_rows<T, CR, TS>(
      [&](int p) -> const T* {
        const int gy = y0 - 1 + p / RING, gx = x0 - 1 + p % RING;
        return (gy >= 0 && gy < H && gx >= 0 && gx < W) ? yb + p * XS : nullptr;
      },
      static_cast<const T*>(s2.ln_w), static_cast<const T*>(s2.ln_b), C, xn);
  T* ybuf = xn;            // the output tile, once the last pw1 has read xn
  T* lnbuf = xn + P * XS;  // LN2 of the chained FFW
  {
    float acc[NTW][G2::MT_O][4];
    stage_chain<T, NTW, TS>(s2, xn, hid, act, H, W, C, y0, x0, acc);
    stage_epilogue<T, NTW, G2::MT_O>(
        s2, acc, P, C,
        [&](int pix, int c) -> float {
          return to_f(yb[((pix / TS + 1) * RING + pix % TS + 1) * XS + c]);
        },
        ybuf);
  }
  if (s2.f_w1 != nullptr) ffw_rows<T, NTW, G2::MT_O>(s2, ybuf, lnbuf, act, P, C);

  T* out = static_cast<T*>(a.out) + boff;
  const int c8n = C / 8;
  for (int idx = threadIdx.x; idx < P * c8n; idx += NT) {
    const int pix = idx / c8n, c8 = (idx - pix * c8n) * 8;
    const int gy = y0 + pix / TS, gx = x0 + pix % TS;
    if (gy < H && gx < W) copy8(out + ((size_t)gy * W + gx) * C + c8, ybuf + pix * XS + c8);
  }
}

template <class T, int NTW>
static int launch_two_stage(const TwoStageArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = two_stage_kernel<T, NTW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_two_stage_smem(int C, int is_bf16) {
  return turtle::two_stage_smem(C, is_bf16);
}

// ptrs: x, out, then for each stage: ln_w, ln_b, w1, b1, wd, bd, w2, b2,
//       scale, f_ln_w, f_ln_b, f_w1, f_b1, f_w2, f_b2, f_scale (null = absent)
// ints: B, H, W, C, then for each stage: CH, E, gate, F
// Returns the CUDA error code (0 = launched), -1 for a shape not taken.
extern "C" int turtle_two_stage_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  TwoStageArgs a;
  a.x = ptrs[0];
  a.out = ptrs[1];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3];
  for (int k = 0; k < 2; ++k) {
    void* const* p = ptrs + 2 + 16 * k;
    StageArgs& s = a.st[k];
    s.ln_w = p[0]; s.ln_b = p[1]; s.w1 = p[2]; s.b1 = p[3]; s.wd = p[4]; s.bd = p[5];
    s.w2 = p[6]; s.b2 = p[7]; s.scale = p[8];
    s.f_ln_w = p[9]; s.f_ln_b = p[10]; s.f_w1 = p[11]; s.f_b1 = p[12]; s.f_w2 = p[13];
    s.f_b2 = p[14]; s.f_scale = p[15];
    const int* q = ints + 4 + 4 * k;
    s.CH = q[0]; s.E = q[1]; s.gate = q[2]; s.F = q[3];
    if (s.ln_w == nullptr || s.w1 == nullptr || s.wd == nullptr || s.w2 == nullptr ||
        s.E < 1 || s.CH != (s.gate ? 2 * s.E : s.E))
      return -1;
    if (s.f_w1 != nullptr &&
        (s.F < 16 || s.F % 16 != 0 || s.f_ln_w == nullptr || s.f_b1 == nullptr ||
         s.f_w2 == nullptr || s.f_b2 == nullptr || s.f_scale == nullptr))
      return -1;
  }
  if (a.C % 16 != 0 || a.C < 16 || a.C > 128 || a.B < 1 || a.B > 65535 || a.H < 1 || a.W < 1)
    return -1;
  const size_t smem = two_stage_smem(a.C, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (a.C <= 64) return launch_two_stage<__nv_bfloat16, 1>(a, smem, s);
    return launch_two_stage<__nv_bfloat16, 2>(a, smem, s);
  }
  if (a.C <= 64) return launch_two_stage<float, 1>(a, smem, s);
  return launch_two_stage<float, 2>(a, smem, s);
}
