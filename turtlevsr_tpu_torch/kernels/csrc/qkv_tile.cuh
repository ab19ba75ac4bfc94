// The per-tile device code of the channel-attention front, shared by
// qkv_stats.cu (one tile per block) and level.cu (a block walks many tiles).
// What it computes is in the note of qkv_stats.cu.
#pragma once

#include "common.cuh"

namespace turtle {

struct QkvArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *wd, *bd;
  void* v;
  float* part;  // (B, n_tiles, width)
  int B, H, W, C, heads;
};

// One 8x8 tile: tile `tile` of the n_tiles of batch entry b; smem is the
// block's dynamic shared memory (qkv_tile_smem bytes). Every thread of the
// block takes part; it ends in a barrier (linear_chunk_to_global), so the
// same block may go on with another tile. XN_DEV: the LN halo lives in
// device memory (common.cuh), this tile's slice of xn_dev (NPH * (C + XPAD)
// elements a tile, batch-major); the shared memory then starts at hid.
template <class T, int CR, bool XN_DEV = false>
__device__ __forceinline__ void qkv_tile(const QkvArgs& a, int b, int tile, int n_tiles,
                                         unsigned char* smem, T* xn_dev = nullptr) {
  const int C = a.C, CH = 3 * a.C, H = a.H, W = a.W, heads = a.heads;
  const int ctok = C / heads;
  const int tid = threadIdx.x;
  const int tiles_x = (W + TS - 1) / TS;
  const int y0 = (tile / tiles_x) * TS, x0 = (tile % tiles_x) * TS;

  // shared memory: xn T[NPH*(C+XPAD)] | hid f32[NPH*HS] | qs, ks f32[P*ctok];
  // XN_DEV: xn in device memory
  T* xn;
  float* hid;
  if constexpr (XN_DEV) {
    xn = xn_dev + ((size_t)b * n_tiles + tile) * NPH * (C + XPAD);
    hid = reinterpret_cast<float*>(smem);
  } else {
    xn = reinterpret_cast<T*>(smem);
    hid = reinterpret_cast<float*>(xn + NPH * (C + XPAD));
  }
  float* qs = hid + NPH * HS;
  float* ks = qs + P * ctok;

  const size_t boff = (size_t)b * H * W * C;
  const T* x = static_cast<const T*>(a.x) + boff;
  ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W, C,
                     y0, x0, xn);

  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wd = static_cast<const T*>(a.wd);
  const T* bd = static_cast<const T*>(a.bd);
  const int width = heads * ctok * ctok + 2 * C;
  float* row = a.part + ((size_t)b * n_tiles + tile) * width;

  for (int h = 0; h < heads; ++h) {
    for (int part = 0; part < 2; ++part) {
      float* dst = part == 0 ? qs : ks;
      // one chunk holds the head's ctok <= 64 channels of q (or k)
      const int cbase = part * C + h * ctok;
      const ChunkCols cols = {cbase, min(ctok, SEG), cbase + SEG, max(ctok - SEG, 0)};
      pw1_chunk<T>(xn, w1, b1, H, W, C, CH, y0, x0, cols, hid);
      __syncthreads();
      for (int item = tid; item < HC * TS; item += NT) {
        const int col = item % HC, px = item / HC;
        if (col >= ctok) continue;
        float v[TS];
        dw_column<T>(hid, wd, bd, CH, px, col, cbase + col, v);
#pragma unroll
        for (int py = 0; py < TS; ++py) {
          const bool inside = y0 + py < H && x0 + px < W;
          dst[(py * TS + px) * ctok + col] = inside ? round_to<T>(v[py]) : 0.f;
        }
      }
      __syncthreads();
    }
    for (int idx = tid; idx < ctok * ctok; idx += NT) {
      const int i = idx / ctok, j = idx % ctok;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += qs[p * ctok + i] * ks[p * ctok + j];
      row[h * ctok * ctok + idx] = s;
    }
    for (int idx = tid; idx < 2 * ctok; idx += NT) {
      const int part = idx / ctok, i = idx % ctok;
      const float* src = part == 0 ? qs : ks;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += src[p * ctok + i] * src[p * ctok + i];
      row[heads * ctok * ctok + part * C + h * ctok + i] = s;
    }
    __syncthreads();
  }

  T* v = static_cast<T*>(a.v) + boff;
  for (int cb = 0; cb < C; cb += HC)
    linear_chunk_to_global<T>(xn, w1, b1, wd, bd, H, W, C, CH, y0, x0, 2 * C + cb,
                              min(HC, C - cb), hid, v, C, cb);
}

// shared memory of one qkv_tile, in bytes (xn_dev: the halo in device memory)
__host__ __device__ inline size_t qkv_tile_smem(int C, int heads, int is_bf16,
                                                int xn_dev = 0) {
  return (xn_dev ? 0 : (size_t)NPH * (C + XPAD) * (is_bf16 ? 2 : 4)) +
         (size_t)NPH * HS * 4 + (size_t)2 * P * (C / heads) * 4;
}

}  // namespace turtle
