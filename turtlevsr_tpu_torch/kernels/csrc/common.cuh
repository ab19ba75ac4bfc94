// Shared device helpers of the conv-FFN kernels (sm_90a, plain C interface).
//
// Every kernel here works on one 8x8 tile of output pixels per block of 256
// threads (8 warps) with a one-pixel halo (10x10 = 100 halo pixels), NHWC
// maps, element type T = __nv_bfloat16 or float, fp32 accumulation. Matrix
// products run as warp tiles D(16x8) += A(16x16) B(16x8) with A in shared
// memory and B read from the weights in device memory: mma.sync (bf16
// tensor cores) for T = __nv_bfloat16, the same tile by FMA and shuffles for
// T = float (the type of the tight on-card comparisons, not of serving).
// Operands are values of T (exact in fp32), sums are fp32. Offsets into the
// maps are 64-bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace turtle {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int TS = 8;              // tile side (output pixels)
constexpr int P = TS * TS;         // output pixels per tile
constexpr int PH = TS + 2;         // halo tile side
constexpr int NPH = PH * PH;       // halo pixels per tile
constexpr int PPW = (NPH + NW - 1) / NW;  // halo pixels owned by one warp
constexpr int MT_H = (NPH + 15) / 16;     // 16-row tiles over the halo pixels
constexpr int MT_P = P / 16;       // 16-row tiles over the output pixels
constexpr int SEG = 32;            // hidden columns per segment
constexpr int HC = 2 * SEG;        // hidden columns per chunk: two segments
constexpr int HS = HC + 8;         // row stride of the fp32 hidden chunk
constexpr int AS = HC + 8;         // row stride of the activation chunk (T)
constexpr int XPAD = 8;            // row padding of T tiles: A loads hit 32 banks
constexpr int KG = 4;              // k-steps whose weight loads are issued together
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// the value v takes when it is stored as T and read back
template <class T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// copy 8 consecutive elements of T (16-byte aligned for bf16, 32 for float)
template <class T> __device__ __forceinline__ void copy8(T* dst, const T* src) {
  if (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  }
}
template <class T> __device__ __forceinline__ void zero8(T* dst) {
  const uint4 z = {0u, 0u, 0u, 0u};
  reinterpret_cast<uint4*>(dst)[0] = z;
  if (sizeof(T) == 4) reinterpret_cast<uint4*>(dst)[1] = z;
}

// 8 consecutive elements -> fp32 and back (same alignment rule as copy8)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xffff0000u);
  o[4] = __uint_as_float(v.z << 16); o[5] = __uint_as_float(v.z & 0xffff0000u);
  o[6] = __uint_as_float(v.w << 16); o[7] = __uint_as_float(v.w & 0xffff0000u);
}
template <class T> __device__ __forceinline__ void store8(T* p, const float* v) {
  alignas(16) T tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tmp[i] = from_f<T>(v[i]);
  copy8(p, tmp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// Warp tiles. Lane = 4 g + t. Of A (16 rows x 16 k, row-major) a lane holds
// rows g ("lo") and g + 8 ("hi") at k = 2t, 2t+1, 2t+8, 2t+9; of B (16 k x 8
// n) column g at the same four k; of D (16 x 8) rows g and g + 8 at columns
// 2t, 2t+1: d[0], d[1] = D[g][2t], D[g][2t+1]; d[2], d[3] = D[g+8][..]. This
// is the fragment layout of mma.sync.m16n8k16.
// ---------------------------------------------------------------------------

template <class T> struct AFrag;
template <class T> struct BFrag;
template <> struct AFrag<float> { float v[8]; };   // lo k0 k1, hi k0 k1, lo k8 k9, hi k8 k9
template <> struct BFrag<float> { float v[4]; };   // k0 k1 k8 k9
template <> struct AFrag<__nv_bfloat16> { uint32_t r[4]; };
template <> struct BFrag<__nv_bfloat16> { uint32_t r[2]; };

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  uint16_t a, b;
  a = *reinterpret_cast<const uint16_t*>(&lo);
  b = *reinterpret_cast<const uint16_t*>(&hi);
  return (uint32_t)a | ((uint32_t)b << 16);
}

// lo, hi: the two rows of this lane (pointers to their first element, null
// for a row of zeros), k: first of the 16 k. Rows are 4-byte aligned at even k.
__device__ __forceinline__ void load_a(AFrag<__nv_bfloat16>& a, const __nv_bfloat16* lo,
                                       const __nv_bfloat16* hi, int k) {
  const int t = threadIdx.x & 3;
  a.r[0] = lo ? *reinterpret_cast<const uint32_t*>(lo + k + 2 * t) : 0u;
  a.r[1] = hi ? *reinterpret_cast<const uint32_t*>(hi + k + 2 * t) : 0u;
  a.r[2] = lo ? *reinterpret_cast<const uint32_t*>(lo + k + 2 * t + 8) : 0u;
  a.r[3] = hi ? *reinterpret_cast<const uint32_t*>(hi + k + 2 * t + 8) : 0u;
}
__device__ __forceinline__ void load_a(AFrag<float>& a, const float* lo, const float* hi,
                                       int k) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = k + 2 * t + 8 * h;
    a.v[4 * h + 0] = lo ? lo[kk] : 0.f;
    a.v[4 * h + 1] = lo ? lo[kk + 1] : 0.f;
    a.v[4 * h + 2] = hi ? hi[kk] : 0.f;
    a.v[4 * h + 3] = hi ? hi[kk + 1] : 0.f;
  }
}

// B[k][n] = w[(k0 + k) * ld + n] for k0 + k < kmax, else 0; n < 0: a column
// of zeros. The weights keep their (K, N) row-major layout in device memory:
// the two k of a register are fetched by two 16-bit loads.
template <class T>
__device__ __forceinline__ void load_b_vals(T (&v)[4], const T* __restrict__ w, size_t ld,
                                            int k0, int kmax, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 2 * t + (i & 1) + 8 * (i >> 1);
    v[i] = (n >= 0 && k < kmax) ? w[(size_t)k * ld + n] : from_f<T>(0.f);
  }
}
__device__ __forceinline__ void load_b(BFrag<__nv_bfloat16>& b,
                                       const __nv_bfloat16* __restrict__ w, size_t ld, int k0,
                                       int kmax, int n) {
  __nv_bfloat16 v[4];
  load_b_vals<__nv_bfloat16>(v, w, ld, k0, kmax, n);
  b.r[0] = pack_bf16(v[0], v[1]);
  b.r[1] = pack_bf16(v[2], v[3]);
}
__device__ __forceinline__ void load_b(BFrag<float>& b, const float* __restrict__ w,
                                       size_t ld, int k0, int kmax, int n) {
  load_b_vals<float>(b.v, w, ld, k0, kmax, n);
}

// D += A B by FMA: every lane fetches the 16 k of its two rows and two
// columns from the lanes that hold them
__device__ __forceinline__ void tile_mma(float (&d)[4], const AFrag<float>& a,
                                         const BFrag<float>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int src_t = (kk & 7) >> 1, h = kk >> 3, odd = kk & 1;
    const float alo = __shfl_sync(0xffffffffu, a.v[4 * h + odd], g * 4 + src_t);
    const float ahi = __shfl_sync(0xffffffffu, a.v[4 * h + 2 + odd], g * 4 + src_t);
    const float b0 = __shfl_sync(0xffffffffu, b.v[2 * h + odd], (2 * t) * 4 + src_t);
    const float b1 = __shfl_sync(0xffffffffu, b.v[2 * h + odd], (2 * t + 1) * 4 + src_t);
    d[0] += alo * b0; d[1] += alo * b1; d[2] += ahi * b0; d[3] += ahi * b1;
  }
}
__device__ __forceinline__ void tile_mma(float (&d)[4], const AFrag<__nv_bfloat16>& a,
                                         const BFrag<__nv_bfloat16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

// Channel LayerNorm of one pixel whose C channels are spread over a warp
// (lane holds channels lane + 32 j). Biased variance, eps inside the sqrt;
// without a bias vector the mean is not subtracted in the numerator.
template <int CR>
__device__ __forceinline__ void warp_layer_norm(float (&v)[CR], int lane, int C,
                                                const float* g, const float* bt,
                                                bool has_bias) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CR; ++j) if (lane + 32 * j < C) s += v[j];
  const float mu = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CR; ++j) if (lane + 32 * j < C) q += (v[j] - mu) * (v[j] - mu);
  const float inv = 1.0f / sqrtf(warp_sum(q) / (float)C + LN_EPS);
#pragma unroll
  for (int j = 0; j < CR; ++j) {
    if (lane + 32 * j < C)
      v[j] = has_bias ? (v[j] - mu) * inv * g[j] + bt[j] : v[j] * inv * g[j];
  }
}

__device__ __forceinline__ bool halo_inside(int p, int H, int W, int y0, int x0) {
  const int gy = y0 - 1 + p / PH, gx = x0 - 1 + p % PH;
  return p < NPH && gy >= 0 && gy < H && gx >= 0 && gx < W;
}
__device__ __forceinline__ size_t halo_offset(int p, int W, int C, int y0, int x0) {
  return ((size_t)(y0 - 1 + p / PH) * W + (x0 - 1 + p % PH)) * C;
}

// Prologue of the chain kernels: x' = x (+ x2, or + x2 @ po (+ po_b)), rounded
// to T; xn = LN(x') rounded to T, for the 100 halo pixels of the tile, into
// shared memory (row stride C + XPAD). Halo pixels outside the image get zero
// rows (their hidden values are forced to zero later, never computed from
// these). xres (optional, row stride C) receives x' of the 64 interior
// pixels. x, x2 point at this batch's map, po at its (C, C) matrix [k][c].
// CR: channels per lane (C <= 32 CR); C is a multiple of 16.
template <class T, int CR>
__device__ void ln_prologue(const T* __restrict__ x, const T* __restrict__ x2,
                            const T* __restrict__ po, const T* __restrict__ po_b,
                            const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                            int H, int W, int C, int y0, int x0, T* xn, T* xres) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD;
  if (po != nullptr) {
    // stage the x2 halo tile in the xn buffer, then x' = x + x2 @ po in
    // place: warp w owns rows 16 w .. 16 w + 15, keeps all their k in
    // registers and overwrites them column tile by column tile
    const int c8n = C / 8;
    for (int idx = tid; idx < NPH * c8n; idx += NT) {
      const int p = idx / c8n, c8 = (idx - p * c8n) * 8;
      if (halo_inside(p, H, W, y0, x0))
        copy8(xn + p * XS + c8, x2 + halo_offset(p, W, C, y0, x0) + c8);
      else
        zero8(xn + p * XS + c8);
    }
    __syncthreads();
    if (warp < MT_H) {
      constexpr int KS = 2 * CR;  // C / 16 <= 2 CR, a multiple of KG
      const int rlo = warp * 16 + g, rhi = rlo + 8;
      const T* plo = rlo < NPH ? xn + rlo * XS : nullptr;
      const T* phi = rhi < NPH ? xn + rhi * XS : nullptr;
      AFrag<T> af[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks * 16 < C) load_a(af[ks], plo, phi, ks * 16);
      __syncwarp();
      for (int n0 = 0; n0 < C; n0 += 8) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks0 = 0; ks0 < KS; ks0 += KG) {
          if (ks0 * 16 >= C) continue;
          BFrag<T> bf[KG];  // KG k-steps of weights in flight at once
#pragma unroll
          for (int s = 0; s < KG; ++s) load_b(bf[s], po, (size_t)C, (ks0 + s) * 16, C, n0 + g);
#pragma unroll
          for (int s = 0; s < KG; ++s)
            if ((ks0 + s) * 16 < C) tile_mma(d, af[ks0 + s], bf[s]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = (i < 2) ? rlo : rhi, c = n0 + 2 * t + (i & 1);
          if (!halo_inside(row, H, W, y0, x0)) continue;
          float a2 = round_to<T>(d[i]);
          if (po_b != nullptr) a2 = round_to<T>(a2 + to_f(po_b[c]));
          const float xv = to_f(x[halo_offset(row, W, C, y0, x0) + c]);
          xn[row * XS + c] = from_f<T>(xv + a2);
        }
      }
    }
    __syncthreads();
  }
  // LN pass: a pixel's C channels go over a group of GL lanes in vectors of
  // 8 (lane l of the group holds channels 8 (l + GL j) ..); 32 / GL pixels
  // per warp at a time. Two 16-byte loads fetch what 16 scalar loads would.
  constexpr int VJ = CR > 8 ? 2 : 1;  // vectors per lane
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
  for (int p0 = warp * PP; p0 < NPH; p0 += NW * PP) {
    const int p = p0 + sub;
    const bool inside = halo_inside(p, H, W, y0, x0);
    const size_t goff = inside ? halo_offset(p, W, C, y0, x0) : 0;
    T* row = xn + (p < NPH ? p : 0) * XS;
    float v[VJ][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int c8 = (l + GL * j) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
      if (inside && c8 < C) {
        if (po != nullptr) {
          load8(row + c8, v[j]);
        } else {
          load8(x + goff + c8, v[j]);
          if (x2 != nullptr) {
            float v2[8];
            load8(x2 + goff + c8, v2);
#pragma unroll
            for (int i = 0; i < 8; ++i) v[j][i] = round_to<T>(v[j][i] + v2[i]);
          }
        }
        const int py = p / PH - 1, px = p % PH - 1;
        if (xres != nullptr && py >= 0 && py < TS && px >= 0 && px < TS)
          store8(xres + (py * TS + px) * C + c8, v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[j][i];
      }
    }
    // every lane takes part in the shuffles; lanes without a pixel carry zeros
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
      if (p >= NPH || c8 >= C) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!inside) v[j][i] = 0.f;  // halo pixels outside the image: zero rows
        else if (ln_b != nullptr) v[j][i] = (v[j][i] - mu) * inv * gw[j][i] + bt[j][i];
        else v[j][i] = v[j][i] * inv * gw[j][i];
      }
      store8(row + c8, v[j]);
    }
  }
  __syncthreads();
}

// The hidden channel of chunk column col: two segments of 32 columns,
// [0, na) -> ca + col and [32, 32 + nb) -> cb + col - 32; -1: no channel.
struct ChunkCols {
  int ca, na, cb, nb;
  __device__ __forceinline__ int chan(int col) const {
    if (col < SEG) return col < na ? ca + col : -1;
    return col - SEG < nb ? cb + col - SEG : -1;
  }
};

// hid[p][col] = pw1(xn)[p][chan(col)] + b1 for the 100 halo pixels and the 64
// columns of a chunk; zero for halo pixels outside the image: the hidden map
// is zero-padded AFTER pw1 and its bias. w1 is (C, CH) row-major. Warp w
// computes columns 8 w .. 8 w + 7 for all seven 16-row tiles.
template <class T>
__device__ void pw1_chunk(const T* xn, const T* __restrict__ w1, const T* __restrict__ b1,
                          int H, int W, int C, int CH, int y0, int x0, ChunkCols cols,
                          float* hid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD;
  if (cols.chan(warp * 8) < 0) {  // the whole column tile is empty (warp-uniform)
#pragma unroll
    for (int mi = 0; mi < MT_H; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mi * 16 + g + 8 * (i >> 1);
        if (row < NPH) hid[row * HS + warp * 8 + 2 * t + (i & 1)] = 0.f;
      }
    return;
  }
  const int nb_ = cols.chan(warp * 8 + g);
  float acc[MT_H][4];
#pragma unroll
  for (int mi = 0; mi < MT_H; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mi][i] = 0.f;
  for (int k0 = 0; k0 < C; k0 += 16) {
    BFrag<T> bf;
    load_b(bf, w1, (size_t)CH, k0, C, nb_);
#pragma unroll
    for (int mi = 0; mi < MT_H; ++mi) {
      const int rlo = mi * 16 + g, rhi = rlo + 8;
      AFrag<T> af;
      load_a(af, rlo < NPH ? xn + rlo * XS : nullptr, rhi < NPH ? xn + rhi * XS : nullptr, k0);
      tile_mma(acc[mi], af, bf);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = warp * 8 + 2 * t + (i & 1);
    const int ch = cols.chan(col);
    const float bias = (ch >= 0 && b1 != nullptr) ? to_f(b1[ch]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < MT_H; ++mi) {
      const int row = mi * 16 + g + 8 * (i >> 1);
      if (row < NPH)
        hid[row * HS + col] =
            (ch >= 0 && halo_inside(row, H, W, y0, x0)) ? acc[mi][i] + bias : 0.f;
    }
  }
}

// Depthwise 3x3 of hidden column col (channel ch) down the tile column px:
// out[py] for the 8 pixels (py, px), with a sliding window over the halo
// rows, the nine taps in registers. wd is (3, 3, CH), bd (CH) or null; with
// wd null (no depthwise stage) out[py] is the pixel's own hidden value.
template <class T>
__device__ __forceinline__ void dw_column(const float* hid, const T* __restrict__ wd,
                                          const T* __restrict__ bd, int CH, int px, int col,
                                          int ch, float (&out)[TS]) {
  const float* base = hid + px * HS + col;  // halo pixel (hy, px + tx) at (hy * PH + tx) * HS
  if (wd == nullptr) {
#pragma unroll
    for (int py = 0; py < TS; ++py) out[py] = base[((py + 1) * PH + 1) * HS];
    return;
  }
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = to_f(wd[i * CH + ch]);
  const float bias = bd != nullptr ? to_f(bd[ch]) : 0.f;
  float r[3][3];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    r[0][tx] = base[tx * HS];
    r[1][tx] = base[(PH + tx) * HS];
  }
#pragma unroll
  for (int py = 0; py < TS; ++py) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) r[2][tx] = base[((py + 2) * PH + tx) * HS];
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

// One linear chain chunk dw3x3(pw1(xn)) for hidden channels [cbase, cbase+n)
// (n <= 64), written to a global map `out` of `ostride` channels at channel
// offset ocol, for the interior pixels inside the image.
template <class T>
__device__ void linear_chunk_to_global(const T* xn, const T* w1, const T* b1, const T* wd,
                                       const T* bd, int H, int W, int C, int CH, int y0,
                                       int x0, int cbase, int n, float* hid, T* out,
                                       int ostride, int ocol) {
  const ChunkCols cols = {cbase, min(n, SEG), cbase + SEG, max(n - SEG, 0)};
  pw1_chunk<T>(xn, w1, b1, H, W, C, CH, y0, x0, cols, hid);
  __syncthreads();
  for (int item = threadIdx.x; item < HC * TS; item += NT) {
    const int col = item % HC, px = item / HC;
    if (col >= n || x0 + px >= W) continue;
    float v[TS];
    dw_column<T>(hid, wd, bd, CH, px, col, cbase + col, v);
#pragma unroll
    for (int py = 0; py < TS; ++py)
      if (y0 + py < H)
        out[((size_t)(y0 + py) * W + x0 + px) * ostride + ocol + col] = from_f<T>(v[py]);
  }
  __syncthreads();
}

// Warp tile product over output pixels: acc[j][mi] += A[16 mi .. +15][0, K)
// @ w[k][n] for the column tiles 8 (warp + 8 j) .. of N columns, j < NTW.
// A: shared, 64 rows of stride lda; w: (kmax, N) row-major in device memory.
template <class T, int NTW>
__device__ __forceinline__ void pixel_tile_product(float (&acc)[NTW][MT_P][4], const T* A,
                                                   int lda, int K, const T* __restrict__ w,
                                                   int kmax, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  for (int k0 = 0; k0 < K; k0 += 32) {
    BFrag<T> bf[2][NTW];  // two k-steps of weights in flight at once
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = (warp + NW * j) * 8 + g;
        load_b(bf[s][j], w, (size_t)N, k0 + 16 * s, kmax, n < N ? n : -1);
      }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (k0 + 16 * s >= K) continue;  // warp-uniform
      AFrag<T> af[MT_P];
#pragma unroll
      for (int mi = 0; mi < MT_P; ++mi)
        load_a(af[mi], A + (mi * 16 + g) * lda, A + (mi * 16 + g + 8) * lda, k0 + 16 * s);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if ((warp + NW * j) * 8 >= N) continue;  // warp-uniform
#pragma unroll
        for (int mi = 0; mi < MT_P; ++mi) tile_mma(acc[j][mi], af[mi], bf[s][j]);
      }
    }
  }
}

}  // namespace turtle
