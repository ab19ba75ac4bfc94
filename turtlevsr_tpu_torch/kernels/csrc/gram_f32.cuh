// The float32 Gram pass of rows 3 and 6 (qkv_f32.cu, chm_f32.cu): after
// f32_tile.cuh's product has written the hidden maps, the depthwise taps of
// the head's q, k and v, v written, and the per-head Gram q^T k with the
// sums of q^2 and k^2 over all pixels of a batch entry.
//
// f32_gram_kernel is a persistent grid of G blocks a head, batch entry and
// part: block (g, head, b * NP + j) walks tiles g, g + G, .. of 4 x 16 pixels
// of entry b; for each it takes the head's q, k and v by f32_tile.cuh's taps
// (four channels and four rows a thread; the head's weights in shared
// memory, loaded once a block), writes v, keeps q and k of the tile in
// shared memory and adds the tile's 64 x 64 Gram (a 4 x 4 block of it a
// thread, in registers across the block's tiles) and the 128 norms. Part j
// = 0 is the current map: q, k, v from h (B, H, W, 3C) through wd0 / bd0.
// Row 6's parts j = 1 .. NP - 1 are its aligned frames: q from h as for j =
// 0 (its taps taken again: C floats a pixel read once more, against the 64
// x 64 register Grams of NP parts that one block would have to hold), k_j
// and v_j from frame j - 1 of hh (B NF, H, W, 2C) through wd1. A block sums
// its tiles in R chunks and writes its part of one partial row a chunk
// (row g R + ck of entry b):
//   [gram (NP, heads, 64, 64) | sum q^2 (C) | sum k_j^2 (NP, C)]
// (row 3: NP = 1, [gram | sum q^2 | sum k^2], R = 1; row 6: chm_stats.cu's
// layout, chunks of at most 8 tiles: at a batch of tiles G falls to one
// block an entry, and an fp32 sum in registers over all 25,600 pixels of
// dec2's 160 x 160 drifts past the float32 limit); turtle_reduce_rows
// (qkv_stats.cu) sums the G R rows in a fixed order, so a result does not
// change from run to run.
#pragma once

#include "f32_tile.cuh"

namespace turtle {

constexpr int QG_CT = 64;              // channels a head
constexpr int QG_TH = 4, QG_TW = 16;   // a tile of 4 x 16 pixels
constexpr int QG_P = QG_TH * QG_TW;

struct F32GramArgs {
  const float *h, *wd0, *bd0;  // h (B, H, W, 3C), wd0 (3, 3, 3C), bd0 (3C) or null
  const float *hh, *wd1;       // NP > 1: hh (B NF, H, W, 2C), wd1 (3, 3, 2C)
  float *v, *vh;               // v (B, H, W, C); NP > 1: vh (B, NF, H, W, C)
  float* part;                 // (B, G R, NP heads 64^2 + (NP + 1) C)
  int H, W, C, heads, NP;
  int R;                       // partial rows a block: its tiles in R chunks
};

// the static shared memory of f32_gram_kernel
constexpr size_t f32_gram_smem() { return sizeof(float) * (2 * QG_P + 30) * QG_CT; }

__global__ void __launch_bounds__(256, 2) f32_gram_kernel(const __grid_constant__ F32GramArgs a) {
  __shared__ __align__(16) float qs[QG_P][QG_CT];
  __shared__ __align__(16) float ks[QG_P][QG_CT];
  __shared__ __align__(16) float taps[3][10][QG_CT];  // the head's q, k, v: 9 taps, bias
  const int tid = threadIdx.x;
  const int g = blockIdx.x, G = gridDim.x, hd = blockIdx.y;
  const int b = blockIdx.z / a.NP, j = blockIdx.z % a.NP;
  const int H = a.H, W = a.W, C = a.C, NF = a.NP - 1;
  // where part p (0 q, 1 k, 2 v) lives: frame parts (j > 0, p > 0) in hh
  auto frame = [&](int p) { return j > 0 && p > 0; };
  auto pitch = [&](int p) { return frame(p) ? 2 * C : 3 * C; };
  auto base = [&](int p) { return frame(p) ? (p - 1) * C : p * C; };
  for (int idx = tid; idx < 3 * 10 * (QG_CT / 4); idx += blockDim.x) {
    const int p = idx / (10 * (QG_CT / 4)), i = idx / (QG_CT / 4) % 10,
              c = 4 * (idx % (QG_CT / 4));
    const int ch = base(p) + hd * QG_CT + c;
    const float* wd = frame(p) ? a.wd1 : a.wd0;
    const float* bd = frame(p) ? nullptr : a.bd0;
    st4(&taps[p][i][c], i < 9 ? ldg4(wd + i * pitch(p) + ch)
                              : (bd != nullptr ? ldg4(bd + ch) : zero4()));
  }
  __syncthreads();
  const int tiles_x = (W + QG_TW - 1) / QG_TW;
  const int n_tiles = ((H + QG_TH - 1) / QG_TH) * tiles_x;
  const long long HW = (long long)H * W;
  const float* hb = a.h + b * HW * 3 * C;
  const float* hhb = j > 0 ? a.hh + ((long long)b * NF + j - 1) * HW * 2 * C : nullptr;
  float* vb = j > 0 ? a.vh + ((long long)b * NF + j - 1) * HW * C : a.v + b * HW * C;
  const int c4 = tid & 15, px = tid >> 4;  // taps: channels 4 c4 .., tile column px
  const int gi = tid >> 4, gj = tid & 15;  // Gram: q channels 4 gi .., k channels 4 gj ..
  // thread t < 128: sum q^2 (t < 64, part 0 only) or k_j^2 of channel t % 64
  const bool norm = tid < 2 * QG_CT && (j == 0 || tid >= QG_CT);
  const int grams = a.NP * a.heads * QG_CT * QG_CT;
  const int n_mine = g < n_tiles ? (n_tiles - 1 - g) / G + 1 : 0;  // tiles g, g + G, ..

  // chunk ck: the block's tiles g + k G for k in [ck n_mine / R, (ck + 1)
  // n_mine / R), summed in registers, then written as partial row g R + ck
#pragma unroll 1
  for (int ck = 0; ck < a.R; ++ck) {
    float gacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) gacc[i][k] = 0.f;
    float nacc = 0.f;
    const int k_end = (int)((long long)(ck + 1) * n_mine / a.R);
    for (int k = (int)((long long)ck * n_mine / a.R); k < k_end; ++k) {
      const int tile = g + k * G;
      const int y0 = (tile / tiles_x) * QG_TH, x = (tile % tiles_x) * QG_TW + px;
#pragma unroll 1
      for (int p = 0; p < 3; ++p) {
        const int ch = base(p) + hd * QG_CT + 4 * c4;
        float(*dst)[QG_CT] = p == 0 ? qs : ks;
        const float(*tp)[QG_CT] = taps[p];
        auto tap = [&](int i) { return *reinterpret_cast<const float4*>(&tp[i][4 * c4]); };
        auto emit = [&](int r, float4 v) {
          const bool in = y0 + r < H;
          if (p < 2)
            st4(&dst[r * QG_TW + px][4 * c4], in ? v : zero4());
          else if (in)
            st4(vb + ((long long)(y0 + r) * W + x) * C + hd * QG_CT + 4 * c4, v);
        };
        if (x < W) {
          dw_column4<QG_TH, true>(frame(p) ? hhb : hb, H, W, pitch(p), y0, x, ch, tap, tap(9),
                                  emit);
        } else if (p < 2) {  // pixels outside the map add nothing
#pragma unroll
          for (int r = 0; r < QG_TH; ++r) st4(&dst[r * QG_TW + px][4 * c4], zero4());
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int q = 0; q < QG_P; ++q) {
        const float4 qv4 = *reinterpret_cast<const float4*>(&qs[q][4 * gi]);
        const float4 kv4 = *reinterpret_cast<const float4*>(&ks[q][4 * gj]);
        const float qv[4] = {qv4.x, qv4.y, qv4.z, qv4.w}, kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) gacc[i][k] = fmaf(qv[i], kv[k], gacc[i][k]);
      }
      if (norm) {
        const float(*src)[QG_CT] = tid < QG_CT ? qs : ks;
        const int ci = tid % QG_CT;
        for (int q = 0; q < QG_P; ++q) nacc = fmaf(src[q][ci], src[q][ci], nacc);
      }
      __syncthreads();  // the next tile rewrites qs and ks
    }

    float* row = a.part + (((long long)b * G + g) * a.R + ck) * (grams + (a.NP + 1) * C);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(row + (j * a.heads + hd) * QG_CT * QG_CT + (4 * gi + i) * QG_CT + 4 * gj,
          make_float4(gacc[i][0], gacc[i][1], gacc[i][2], gacc[i][3]));
    if (norm)
      row[grams + (tid < QG_CT ? 0 : (1 + j) * C) + hd * QG_CT + tid % QG_CT] = nacc;
  }
}

// the Gram pass over B batch entries and NP parts, G blocks a head, entry
// and part: -1 for a grid the card does not take
static int run_f32_gram(const F32GramArgs& a, int B, int G, cudaStream_t s) {
  if (G < 1 || a.R < 1 || a.heads < 1 || a.heads > 65535 || a.NP < 1 || B < 1 ||
      (long long)B * a.NP > 65535 || a.C != QG_CT * a.heads)
    return -1;
  f32_gram_kernel<<<dim3(G, a.heads, B * a.NP), dim3(256), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace turtle
