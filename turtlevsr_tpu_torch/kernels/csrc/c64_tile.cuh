// The halo-tile device code of the C = 64 bodies, shared by ffn_c64.cu (row
// 1's depthwise forms) and split_c64.cu (row 4's split projection): a
// persistent grid of one block (three warpgroups) an SM walks a contiguous,
// entry-major range of the (batch entry, tile) items; an output tile is 16
// rows x 8 columns, its 18 x 10 halo tile of x (64 channels, 128 bytes a
// pixel) comes in by TMA (a 4-D box, zeros outside the map, the 128-byte
// swizzle) into a ring of slots one tile ahead of the arithmetic; LN runs on
// the 180 halo rows, pw1 on wgmma (one m64 tile a warpgroup), and the nine
// taps on the CUDA cores from an fp32 chunk of 64 hidden columns.
#pragma once

#include "pipe.cuh"

namespace turtle {

constexpr int CT_C = 64;                          // the width these bodies take
constexpr int CT_TH = 16, CT_TW = 8;              // output tile: rows x columns
constexpr int CT_P = CT_TH * CT_TW;               // 128 output pixels
constexpr int CT_HW = CT_TW + 2;                  // halo tile: 18 x 10
constexpr int CT_NPH = (CT_TH + 2) * CT_HW;       // 180 halo pixels
constexpr int CT_HALO = CT_NPH * CT_C * 2;        // 23040 bytes of a halo tile
constexpr int CT_SLOT = 23552;                    // a ring slot (1024-byte multiple)
constexpr int CT_PANEL = 64 * 128;                // a 64-row panel of 64 bf16 columns
constexpr int CT_HS = 64;                         // columns of the fp32 hidden chunk
constexpr int CT_NT = 384;                        // three warpgroups
constexpr int CT_MAX_STAGES = 4;                  // ring slots at most
constexpr size_t CT_SMEM_MAX = 232448;

// a K x 64 panel in the 128-byte swizzle, row k's piece j from src + k ld +
// col(j)
template <class ColFn>
__device__ __forceinline__ void ct_panel(unsigned char* dst, const __nv_bfloat16* src, int ld,
                                         int K, ColFn col) {
  for (int idx = threadIdx.x; idx < K * 8; idx += CT_NT) {
    const int k = idx >> 3, j = idx & 7;
    *reinterpret_cast<uint4*>(dst + sw128(k, j)) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)k * ld + col(j)));
  }
}

// the fp32 hidden chunk: halo pixel r, column c; the columns swizzled by
// the row so that a warp's accumulator stores spread over the banks
__device__ __forceinline__ int ct_hid(int r, int c) { return r * CT_HS + (c ^ ((r & 3) << 3)); }

// the item it of the walk: batch entry and the tile's first row and column
struct CtTile {
  int b, y0, x0;
};
__device__ __forceinline__ CtTile ct_tile(long long it, int tiles_x, int nt) {
  const int b = (int)(it / nt), tile = (int)(it - (long long)b * nt);
  return {b, (tile / tiles_x) * CT_TH, (tile % tiles_x) * CT_TW};
}

// The ring of halo tiles: S slots of CT_SLOT bytes, a full mbarrier each;
// load li goes to slot li % S. Thread 0 starts the loads, every consumer
// waits on them.
struct CtRing {
  unsigned char* slots;
  uint64_t* full;
  int S;
  __device__ void init() const {  // thread 0, before the block's first barrier
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the halo tile of the output tile at (y0, x0) of batch entry b, from the
  // map m, into load li's slot
  __device__ void load(int li, const CUtensorMap* m, int b, int y0, int x0) const {
    const int s = li % S;
    mbar_expect_tx(&full[s], CT_HALO);
    tma_load_4d(slots + (size_t)s * CT_SLOT, m, 0, x0 - 1, y0 - 1, b, &full[s]);
  }
  __device__ unsigned char* wait(int li) const {
    mbar_wait(&full[li % S], (li / S) & 1);
    return slots + (size_t)(li % S) * CT_SLOT;
  }
};

// a halo map of a (B, H, W, 64) bf16 tensor whose entries lie batch_stride
// elements apart: (C, W, H, B), a halo tile a box
static bool ct_encode_halo(CUtensorMap* m, const void* base, int B, int H, int W,
                           uint64_t batch_stride) {
  const uint64_t c = CT_C, w = W, h = H;
  return encode_bf16<4>(m, base, {c, w, h, (uint64_t)B}, {c * 2, w * c * 2, batch_stride * 2},
                        {CT_C, CT_HW, CT_TH + 2, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

// LN of the 180 halo rows of src (x' in bf16, the swizzled layout) into xn,
// rounded, zero rows outside the image: 8 lanes a pixel, lane l its piece l
// (channels 8 l ..), fp32 statistics as ln_prologue's (common.cuh)
__device__ void ct_ln_pass(const unsigned char* src, unsigned char* xn, const float (&gw)[8],
                           const float (&bt)[8], bool has_b, int H, int W, int y0, int x0) {
  using T = __nv_bfloat16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, l = lane & 7;
  for (int p0 = warp * 4; p0 < CT_NPH; p0 += CT_NT / 8) {  // 180 = 45 x 4: every lane a pixel
    const int p = p0 + (lane >> 3);
    const int gy = y0 - 1 + p / CT_HW, gx = x0 - 1 + p % CT_HW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int off = sw128(p, l);
    float v[8];
    load8(reinterpret_cast<const T*>(src + off), v);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    const float mu = s / (float)CT_C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.0f / sqrtf(q / (float)CT_C + LN_EPS);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = !inside ? 0.f : has_b ? (v[i] - mu) * inv * gw[i] + bt[i] : v[i] * inv * gw[i];
    store8(reinterpret_cast<T*>(xn + off), v);
  }
}

// The taps of a chunk: dw3x3 of the fp32 hidden chunk + bd. A warpgroup takes
// output rows [row0, row0 + NR), its thread i the tile column px = i >> 4
// and the hidden columns 4k .. 4k + 3, k = i & 15 (one float4 a halo pixel):
// channels e0 + 4k .. (GATE false), or the a channels e0 + 2k, + 1 and their
// b partners E + e0 + 2k, + 1 (GATE, ffn_c64.cu's ct_chan). A sliding window
// of three halo rows, the nine taps in row-major order in fp32; out(row, px,
// k, o) takes the four sums of each output pixel.
template <bool GATE, int NR, class Out>
__device__ __forceinline__ void ct_taps(const float* hid, const __nv_bfloat16* wds,
                                        const __nv_bfloat16* __restrict__ bd, int CH, int E,
                                        int e0, int row0, int i, Out out) {
  const int k = i & 15, px = i >> 4;
  // the channels of the four columns, in pairs
  const int ch0 = GATE ? e0 + 2 * k : e0 + 4 * k;
  const int ch1 = GATE ? E + e0 + 2 * k : e0 + 4 * k + 2;
  float w[9][4], bias[4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wds + tap * CH + ch0));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wds + tap * CH + ch1));
    w[tap][0] = lo.x; w[tap][1] = lo.y; w[tap][2] = hi.x; w[tap][3] = hi.y;
  }
  {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (bd != nullptr) {
      lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bd + ch0));
      hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bd + ch1));
    }
    bias[0] = lo.x; bias[1] = lo.y; bias[2] = hi.x; bias[3] = hi.y;
  }
  auto ld = [&](int hy, int hx, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(hid + ct_hid(hy * CT_HW + hx, 4 * k));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  };
  float r[3][3][4];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    ld(row0, px + tx, r[0][tx]);
    ld(row0 + 1, px + tx, r[1][tx]);
  }
#pragma unroll
  for (int py = 0; py < NR; ++py) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) ld(row0 + py + 2, px + tx, r[2][tx]);
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) s += r[ty][tx][c] * w[ty * 3 + tx][c];
      o[c] = s + bias[c];
    }
    out(row0 + py, px, k, o);
#pragma unroll
    for (int tx = 0; tx < 3; ++tx)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[0][tx][c] = r[1][tx][c];
        r[1][tx][c] = r[2][tx][c];
      }
  }
}

}  // namespace turtle
