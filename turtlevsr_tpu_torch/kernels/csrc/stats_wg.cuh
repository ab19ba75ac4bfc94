// The Hopper body of the channel-attention statistics, shared by row 3
// (qkv_wg.cu: q, k, v of one map) and row 6 (chm_wg.cu: the same, then k and
// v of NF aligned frames through a second weight). What it computes, and
// where it rounds, is in the notes of qkv_stats.cu and chm_stats.cu: LN(x)
// rounded, pw1 in fp32, the nine taps in row-major order in fp32, q, k (and
// kh) rounded to bf16 before any sum takes them, the per-head Grams
// q_h^T k_h over the pixels and the per-channel sums of squares; v (and vh)
// written as maps. bf16, no biases, ctok = 64.
//
// The chains are bound by operations (2 C x 3C flop a pixel for pw1 against
// one map read and one third of a map written). What held the mma.sync
// bodies back: every 8 x 8 tile read w1 from device memory per warp with
// nothing in flight across its block barriers; the phases (pw1, the taps,
// the Gram as FMA) ran one after another; and each tile wrote an fp32 row of
// heads * 64^2 + 2C partial sums, more bytes than its own input. Here:
//
//   * a persistent grid: block g walks a static, contiguous range of the
//     flattened (batch entry, tile) sequence. Per batch entry it owns one
//     partial row in device memory (L2) and adds each tile's Grams and sums
//     of squares to it, read-modify-write by the thread that owns the
//     element: the rows per entry are the blocks whose range meets it, the
//     order of every sum is fixed (tiles in order, one owner an element, no
//     atomics), and turtle_reduce_rows sums the rows in a fixed order;
//   * the weights stream through a ring of 16 KB stages (two 64-column
//     panels of 64 rows of K, the 128-byte swizzle wgmma reads) filled by TMA
//     from a copy warpgroup on full / empty mbarriers, as in ffn_wg.cu;
//   * a tile is a sequence of passes, each one pw1 product of N = 128 on the
//     10 x 10 halo (two m64 wgmma tiles, one a consumer warpgroup, A from
//     registers by ldmatrix) and the taps on the CUDA cores: [q_h | k_h] a
//     head, then v 128 columns a pass; for row 6 then, per aligned frame,
//     [kh_2m | kh_2m+1] and vh (C = 64: one head; v's one panel is read
//     twice and half kept, and a frame's kh and vh share one pass);
//   * q_h and k_h go to bf16 tiles of 64 pixels x 64 channels in shared
//     memory in the swizzled layout, and the Gram q_h^T k_h runs as one
//     m64n64 wgmma over K = the 64 pixels (4 k-steps, A = the q tile read
//     transposed by its descriptor, B = the k tile). The products of bf16
//     values are exact in fp32; the Gram is added to the row after the
//     next pass's pw1, so that the row's read runs behind that product.
//
// Registers hold one Gram (32 a thread) at a time: the Grams of a batch
// entry (heads of them, (NF + 1) heads for row 6) do not fit a thread's
// registers beside pw1's 64 accumulators, so the running sums live in the
// block's rows.
#pragma once

#include "pipe.cuh"

namespace turtle {

constexpr int SW_STAGE = 16384;        // bytes of a ring stage
constexpr int SW_MAX_STAGES = 8;
constexpr int SW_HS = 128;             // row stride of the fp32 hidden chunk (swizzled)
constexpr int SW_KB = 64;              // rows of K of a stage
constexpr int SW_PANEL = SW_KB * 128;  // bytes of a 64-column panel of a stage
constexpr int SW_TILE = P * 128;       // bytes of a 64 pixel x 64 channel bf16 tile
constexpr size_t SW_SMEM_MAX = 232448;
constexpr int SW_NT = NT + 128;        // two consumer warpgroups and a copy warpgroup
constexpr int SW_REGS_CONSUMER = 232, SW_REGS_COPY = 40;

struct StatsWgArgs {
  const void *x, *xsp, *ln_w, *ln_b, *wd_qkv, *wd_kv;
  void *v, *vh;
  float* part;  // (B, R, width), zero before the launch
  int B, H, W, NF, R;
};
struct StatsWgMaps {
  CUtensorMap w_qkv, w_kv;  // w_kv: unset for row 3
};

// q tiles (row 6: one a head, kept over the aligned frames), k tiles
__host__ __device__ constexpr int sw_qtiles(int C, bool chm) { return chm ? C / 64 : 1; }
__host__ __device__ constexpr int sw_ktiles(bool chm) { return chm ? 2 : 1; }

// bytes of the parts after the ring; the ring takes as many stages as fit
__host__ __device__ inline size_t sw_rest(int C, bool chm) {
  return (size_t)(sw_qtiles(C, chm) + sw_ktiles(chm)) * SW_TILE + (size_t)NPH * SW_HS * 4 +
         (size_t)NPH * (C + XPAD) * 2;
}
__host__ __device__ inline int sw_stages(int C, bool chm) {
  const size_t room = SW_SMEM_MAX - WG_ALIGN - sw_rest(C, chm);
  const int s = (int)(room / (SW_STAGE + 2 * sizeof(uint64_t)));
  return s < SW_MAX_STAGES ? s : SW_MAX_STAGES;
}
__host__ __device__ inline size_t sw_smem(int C, bool chm) {
  const int s = sw_stages(C, chm);
  return WG_ALIGN + (size_t)s * SW_STAGE + sw_rest(C, chm) + 2 * s * sizeof(uint64_t);
}

// element (pixel p, channel c) of a 64 x 64 bf16 tile in the 128-byte swizzle
__device__ __forceinline__ int sw_tile_at(int p, int c) {
  return p * 64 + ((((c >> 3) ^ (p & 7))) << 3) + (c & 7);
}
// the fp32 hidden chunk: row r (a halo pixel), column c (0 .. 127), the
// columns swizzled by the row so that a warp's accumulator stores spread
// over the banks
__device__ __forceinline__ int sw_hid_at(int r, int c) { return r * SW_HS + (c ^ ((r & 3) << 3)); }

// the B operand of 16 rows of K at row k of a 64-row stage, starting at panel p
__device__ __forceinline__ uint64_t sw_stage_desc(const unsigned char* stage, int p, int k) {
  return panel_desc(stage + p * SW_PANEL + k * 16 * 128, SW_PANEL);
}

// d (m64n64, fp32) += a^T b over 16 pixels: a and b 64 x 64 bf16 tiles in
// shared memory (rows = pixels), both read transposed (MN-major) by their
// descriptors
__device__ __forceinline__ void wgmma_ss64_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, 1, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// LN pass of a tile (the 256 consumer threads): LN(x) rounded into xn (row
// stride C + XPAD, zero rows outside the image) for the 100 halo pixels;
// ln_w null: xn = x (the aligned frames). wg_ln_pass of ffn_wg.cu without
// its second map and without the copy of x to the output. STAGED: x is the
// tile's halo already in shared memory, row p at x + p C (split_wg.cu).
template <int C, bool STAGED = false>
__device__ void sw_ln_pass(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ ln_w,
                           const __nv_bfloat16* __restrict__ ln_b, int H, int W, int y0, int x0,
                           __nv_bfloat16* xn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int XS = C + XPAD;
  constexpr int CR = C / 32 > 2 ? C / 32 : 2;
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
    if (c8 < C && ln_w != nullptr) {
      load8(ln_w + c8, gw[j]);
      if (ln_b != nullptr) load8(ln_b + c8, bt[j]);
    }
  }
  // U pixels a lane at a time: their loads are in flight together (one or
  // two rounds for the 100 halo pixels at C <= 256)
  constexpr int U = C >= 512 ? 4 : 8;
  for (int p0 = warp * PP; p0 < NPH; p0 += NW * PP * U) {
    float v[U][VJ][8];
    bool inside[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NW * PP + sub;
      inside[u] = halo_inside(p, H, W, y0, x0);
      const size_t goff =
          inside[u] ? (STAGED ? (size_t)p * C : halo_offset(p, W, C, y0, x0)) : 0;
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int c8 = (l + GL * j) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][j][i] = 0.f;
        if (inside[u] && c8 < C) load8(x + goff + c8, v[u][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NW * PP + sub;
      float mu = 0.f, inv = 0.f;
      if (ln_w != nullptr) {  // block-uniform
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < VJ; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += v[u][j][i];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          if (m < GL) sum += __shfl_xor_sync(0xffffffffu, sum, m);
        mu = sum / (float)C;
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
        inv = 1.0f / sqrtf(q / (float)C + LN_EPS);
      }
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int c8 = (l + GL * j) * 8;
        if (p >= NPH || c8 >= C) continue;
        if (ln_w != nullptr) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (!inside[u]) v[u][j][i] = 0.f;
            else if (ln_b != nullptr) v[u][j][i] = (v[u][j][i] - mu) * inv * gw[j][i] + bt[j][i];
            else v[u][j][i] = v[u][j][i] * inv * gw[j][i];
          }
        }
        store8(xn + p * XS + c8, v[u][j]);
      }
    }
  }
  consumers_sync();
}

// Depthwise 3x3 of hidden chunk column col down the tile column px, from
// the fp32 chunk, with the column's nine taps w; no bias
__device__ __forceinline__ void sw_dw_column(const float* hid, const float (&w)[9], int px,
                                             int col, float (&out)[TS]) {
  float r[3][3];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    r[0][tx] = hid[sw_hid_at(px + tx, col)];
    r[1][tx] = hid[sw_hid_at(PH + px + tx, col)];
  }
#pragma unroll
  for (int py = 0; py < TS; ++py) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) r[2][tx] = hid[sw_hid_at((py + 2) * PH + px + tx, col)];
    float a = 0.f;
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) a += r[ty][tx] * w[ty * 3 + tx];
    out[py] = a;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) { r[0][tx] = r[1][tx]; r[1][tx] = r[2][tx]; }
  }
}

// The passes of a tile, in the order the copy thread loads their weights and
// the consumers take them. Pass kinds: QK (head h: the panels of q_h and
// k_h), V (v, 128 channels), KH (aligned frame n, heads 2m and 2m + 1: the
// panels of kh), VH (vh of frame n, 128 channels). At C = 64 a V pass reads
// v's one panel twice and keeps the first half, and a frame takes one KH
// pass whose panels are kh and vh.
enum SwKind { SW_QK, SW_V, SW_KH, SW_VH };
struct SwPass {
  int kind, idx, frame, c0, c1;  // c0, c1: the panels' first columns in their weight
};
template <int C, bool CHM>
__device__ __forceinline__ SwPass sw_pass(int p) {
  constexpr int HEADS = C / 64, NV = C >= 128 ? C / 128 : 1;
  if (p < HEADS) return {SW_QK, p, -1, 64 * p, C + 64 * p};
  p -= HEADS;
  if (p < NV) {
    const int c0 = 2 * C + 128 * p;
    return {SW_V, p, -1, c0, C >= 128 ? c0 + 64 : c0};
  }
  p -= NV;
  constexpr int PF = C >= 128 ? HEADS / 2 + NV : 1;  // passes of an aligned frame
  const int n = p / PF, s = p % PF;
  if (s < PF - NV || C < 128) return {SW_KH, s, n, 128 * s, 128 * s + 64};
  const int c0 = C + 128 * (s - HEADS / 2);
  return {SW_VH, s - HEADS / 2, n, c0, c0 + 64};
}
template <int C, bool CHM>
__device__ __forceinline__ int sw_passes(int NF) {
  constexpr int HEADS = C / 64, NV = C >= 128 ? C / 128 : 1;
  return HEADS + NV + (CHM ? NF * (C >= 128 ? HEADS / 2 + NV : 1) : 0);
}

// the block's range of the flattened (batch entry, tile) sequence, and the
// first block whose range meets batch entry b
__device__ __forceinline__ long long sw_item0(int g, long long total) {
  return (long long)g * total / gridDim.x;
}
__device__ __forceinline__ int sw_first_block(int b, int nt, long long total) {
  return (int)((((long long)b * nt + 1) * gridDim.x - 1) / total);
}

// The copy thread's walk over items [it0, it1) of the flattened (batch
// entry, tile) sequence: per item the passes' weights, NS stages of 64 rows
// of K a pass, into the ring r, whose li it carries in and out. Z3: the
// weights are 3-D maps of stacked matrices, (N, C, 3C), read at layer z
// (row 14's runs, level_wg.cu); else 2-D maps.
template <int C, bool CHM, bool Z3 = false>
__device__ __forceinline__ void sw_copy_walk(const StatsWgMaps& maps, long long it0,
                                             long long it1, int NF, WgRing& r, int z = 0) {
  constexpr int NS = C / SW_KB;
  const int n_pass = sw_passes<C, CHM>(NF);
  const int S = r.S;
  int& li = r.li;
  for (long long it = it0; it < it1; ++it)
    for (int p = 0; p < n_pass; ++p) {
      const SwPass ps = sw_pass<C, CHM>(p);
      const CUtensorMap* m = ps.kind <= SW_V ? &maps.w_qkv : &maps.w_kv;
      for (int kb = 0; kb < NS; ++kb) {
        const int s = li % S;
        if (li >= S) mbar_wait(&r.empty[s], (li / S - 1) & 1);
        mbar_expect_tx(&r.full[s], 2 * SW_PANEL);
        ++li;
        unsigned char* dst = r.ring + (size_t)s * SW_STAGE;
        if constexpr (Z3) {
          tma_load_3d(dst, m, ps.c0, kb * SW_KB, z, &r.full[s]);
          tma_load_3d(dst + SW_PANEL, m, ps.c1, kb * SW_KB, z, &r.full[s]);
        } else {
          tma_load_2d(dst, m, ps.c0, kb * SW_KB, &r.full[s]);
          tma_load_2d(dst + SW_PANEL, m, ps.c1, kb * SW_KB, &r.full[s]);
        }
      }
    }
}

// The consumers' passes over items [it0, it1) (the 256 threads of the two
// consumer warpgroups): v (and vh) into the maps, each tile's Grams and sums
// of squares added to this block's partial rows. x, ln_w, ln_b, wd_qkv: the
// current map and the weights of its chains (a's for rows 3 and 6; the run's
// block for row 14). Shared memory: the q tiles qt, the k tiles kt, the fp32
// hidden chunk hid, the LN halo xn. The ring r: its li and rel carried in and
// out; every stage taken is handed back before the return.
template <int C, bool CHM>
__device__ __forceinline__ void sw_consume(const StatsWgArgs& a, const __nv_bfloat16* x,
                                           const __nv_bfloat16* ln_w,
                                           const __nv_bfloat16* ln_b,
                                           const __nv_bfloat16* wd_qkv, long long it0,
                                           long long it1, WgRing& r, __nv_bfloat16* qt,
                                           __nv_bfloat16* kt, float* hid, __nv_bfloat16* xn) {
  using T = __nv_bfloat16;
  constexpr int HEADS = C / 64, XS = C + XPAD, NS = C / SW_KB, CH = 3 * C;
  constexpr int G2 = 64 * 64;  // a head's Gram
  const int S = r.S;
  unsigned char* ring = r.ring;
  uint64_t* full = r.full;
  uint64_t* empty = r.empty;
  const int H = a.H, W = a.W, NF = CHM ? a.NF : 0;
  const int tiles_x = (W + TS - 1) / TS, nt = tiles_x * ((H + TS - 1) / TS);
  const long long total = (long long)a.B * nt;
  const int n_pass = sw_passes<C, CHM>(NF);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  int& li = r.li;
  int& rel = r.rel;
  auto take = [&]() {
    const int s = li % S;
    mbar_wait(&full[s], (li / S) & 1);
    ++li;
    return ring + (size_t)s * SW_STAGE;
  };
  auto release_upto = [&](int n) {
    for (; rel < n; ++rel)
      if (lane == 0 && q == 0) mbar_arrive(&empty[rel % S]);
  };

  const T* wd_kv = static_cast<const T*>(a.wd_kv);
  const size_t map = (size_t)H * W * C;
  // the row's parts: Grams (NF + 1 sets of HEADS), then the sums of squares
  // [q | k | kh_0 .. kh_NF-1], C each
  const int n_gram = (NF + 1) * HEADS * G2;
  const int width = n_gram + (NF + 2) * C;
  // warpgroup wg multiplies halo rows 64 wg .. 64 wg + 63 (rows past the
  // 100th read row 0 and are dropped); ldmatrix row lane & 15 of warp q
  const int hrow = 64 * wg + 16 * q + (lane & 15);
  const T* arow = xn + (hrow < NPH ? hrow : 0) * XS + (lane >> 4) * 8;
  bool hrow_ok[2];
  int hrow_at[2], hrow_swz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * q + g + 8 * h;
    hrow_ok[h] = row < NPH;
    hrow_at[h] = row * SW_HS;
    hrow_swz[h] = (row & 3) << 3;
  }

  // the last Gram (issued and waited after a pass, added to the row after
  // the next pass's product): its accumulators and where they go
  float gacc[32];
  float* gdst = nullptr;
  auto add_gram = [&]() {
    if (gdst == nullptr) return;
    float2* d[16];
    float2 o[16];  // all loads in flight before the first store
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      d[i] = reinterpret_cast<float2*>(gdst + (16 * q + g + 8 * (i & 1)) * 64 + 8 * (i >> 1) +
                                       2 * t);
      o[i] = *d[i];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *d[i] = make_float2(o[i].x + gacc[2 * i], o[i].y + gacc[2 * i + 1]);
    gdst = nullptr;
  };

  for (long long it = it0; it < it1; ++it) {
    const int b = (int)(it / nt), tile = (int)(it - (long long)b * nt);
    const int y0 = (tile / tiles_x) * TS, x0 = (tile % tiles_x) * TS;
    float* row = a.part +
                 ((size_t)b * a.R + (blockIdx.x - sw_first_block(b, nt, total))) * width;
    bool hrow_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hrow_in[h] = hrow_ok[h] && halo_inside(64 * wg + 16 * q + g + 8 * h, H, W, y0, x0);

#pragma unroll 1
    for (int p = 0; p < n_pass; ++p) {
      const SwPass ps = sw_pass<C, CHM>(p);
      if (p == 0)
        sw_ln_pass<C>(x + (size_t)b * map, ln_w, ln_b, H, W, y0, x0, xn);
      else if (CHM && ps.kind == SW_KH && ps.idx == 0)  // a new aligned frame: no LN
        sw_ln_pass<C>(static_cast<const T*>(a.xsp) + ((size_t)b * NF + ps.frame) * map, nullptr,
                      nullptr, H, W, y0, x0, xn);
      // pw1 on the halo tile: 128 hidden columns, K = C in stages of 64 rows
      float h1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) h1[i] = 0.f;
      AFrag<T> af[2][SW_KB / 16];
#pragma unroll
      for (int kb = 0; kb < NS; ++kb) {
        const unsigned char* bs = take();
#pragma unroll
        for (int k = 0; k < SW_KB / 16; ++k) ldsm_a(af[kb & 1][k], arow + kb * SW_KB + k * 16);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < SW_KB / 16; ++k)
          wgmma_rs<128>(h1, af[kb & 1][k], sw_stage_desc(bs, 0, k));
        wgmma_commit();
        wgmma_wait<1>();  // the group before (a Gram, or pw1's) is done
        release_upto(li - 1);
      }
      wgmma_wait<0>();
      pin(h1);
      release_upto(li);
      // this thread's column of the taps (the same for its four tile
      // columns): its weights' loads run behind the stores and the barrier
      const int col = tid & 127;
      const T* wd = ps.kind <= SW_V ? wd_qkv : wd_kv;
      const int wch = ps.kind <= SW_V ? CH : 2 * C;
      float wt[9];
      {
        const int ch = (col < 64 ? ps.c0 : ps.c1) + (col & 63);
#pragma unroll
        for (int i = 0; i < 9; ++i) wt[i] = to_f(wd[i * wch + ch]);
      }
      add_gram();
      // zero outside the image: the hidden map is zero-padded after pw1
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!hrow_ok[h]) continue;
          *reinterpret_cast<float2*>(hid + hrow_at[h] + (col ^ hrow_swz[h])) =
              make_float2(hrow_in[h] ? h1[4 * j + 2 * h] : 0.f,
                          hrow_in[h] ? h1[4 * j + 2 * h + 1] : 0.f);
        }
      }
      consumers_sync();
      // the taps: bf16 tiles (QK, KH) or the v / vh map (V, VH; C = 64: the
      // second half of KH)
      const bool to_map = ps.kind == SW_V || ps.kind == SW_VH;
      const bool kv = C < 128 && ps.kind == SW_KH;
      T* mp = nullptr;
      if (ps.kind == SW_V) mp = static_cast<T*>(a.v) + (size_t)b * map;
      if (ps.kind == SW_VH || kv) mp = static_cast<T*>(a.vh) + ((size_t)b * NF + ps.frame) * map;
      T* t0 = ps.kind == SW_QK ? qt + (CHM ? ps.idx : 0) * P * 64 : kt;  // columns 0 .. 63
      T* t1 = ps.kind == SW_QK ? kt : kt + P * 64;                        // columns 64 .. 127
      const bool skip = C < 128 && ps.kind == SW_V && col >= 64;  // the panel read twice
      for (int px = tid >> 7; px < TS && !skip; px += NT / 128) {
        float v[TS];
        sw_dw_column(hid, wt, px, col, v);
        if (to_map || (kv && col >= 64)) {
          if (x0 + px >= W) continue;
          const int oc = ps.kind == SW_V ? ps.c0 - 2 * C + col
                         : ps.kind == SW_VH ? ps.c0 - C + col : col - 64;
#pragma unroll
          for (int py = 0; py < TS; ++py)
            if (y0 + py < H) mp[((size_t)(y0 + py) * W + x0 + px) * C + oc] = from_f<T>(v[py]);
        } else {
          T* dst = col < 64 ? t0 : t1;
#pragma unroll
          for (int py = 0; py < TS; ++py) {
            const bool inside = y0 + py < H && x0 + px < W;
            dst[sw_tile_at(py * TS + px, col & 63)] = from_f<T>(inside ? v[py] : 0.f);
          }
        }
      }
      if (!to_map) fence_proxy_async();
      consumers_sync();
      if (to_map) continue;
      // sums of squares: a thread a column, the pixels in order
      if (tid < (C < 128 && ps.kind == SW_KH ? 64 : 128)) {
        const T* src = tid < 64 ? t0 : t1;
        float s = 0.f;
        for (int pp = 0; pp < P; ++pp) {
          const float v = to_f(src[sw_tile_at(pp, tid & 63)]);
          s += v * v;
        }
        const int off = ps.kind == SW_QK ? (tid < 64 ? 0 : C) + 64 * ps.idx + (tid & 63)
                                         : (2 + ps.frame) * C + 128 * ps.idx + tid;
        row[n_gram + off] += s;
      }
      // the Gram(s): QK head h on warpgroup h & 1; KH heads 2m, 2m + 1 one a
      // warpgroup
      if (ps.kind == SW_QK ? (ps.idx & 1) == wg : 2 * ps.idx + wg < HEADS) {
        const int head = ps.kind == SW_QK ? ps.idx : 2 * ps.idx + wg;
        const T* qa = qt + (CHM ? head : 0) * P * 64;
        const T* kb_ = ps.kind == SW_QK ? kt : kt + wg * P * 64;
        gdst = row + (ps.kind == SW_QK ? head : (1 + ps.frame) * HEADS + head) * G2;
#pragma unroll
        for (int i = 0; i < 32; ++i) gacc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < P / 16; ++k)
          wgmma_ss64_tt(gacc, panel_desc(qa + k * 16 * 64, SW_TILE),
                        panel_desc(kb_ + k * 16 * 64, SW_TILE));
        wgmma_commit();
        // waited at once: a Gram left in flight behind the next pass's pw1
        // makes ptxas serialise every wgmma of the kernel
        wgmma_wait<0>();
        pin(gacc);
      }
    }
  }
  add_gram();
}

// C: the map's width (64 to 512; row 6: 64 to 256), CHM: row 6. grid: one
// block an SM (at most the number of tiles); part row (b, g - first block of
// b) is this block's.
template <int C, bool CHM>
__global__ void __launch_bounds__(SW_NT, 1)
    stats_wg_kernel(const __grid_constant__ StatsWgArgs a, const __grid_constant__ StatsWgMaps maps) {
  using T = __nv_bfloat16;
  constexpr int XS = C + XPAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int S = sw_stages(C, CHM);
  unsigned char* ring = smem;
  T* qt = reinterpret_cast<T*>(ring + (size_t)S * SW_STAGE);
  T* kt = qt + sw_qtiles(C, CHM) * P * 64;
  float* hid = reinterpret_cast<float*>(kt + sw_ktiles(CHM) * P * 64);
  T* xn = reinterpret_cast<T*>(hid + NPH * SW_HS);
  uint64_t* full = reinterpret_cast<uint64_t*>(xn + NPH * XS);
  uint64_t* empty = full + S;

  const int nt = ((a.W + TS - 1) / TS) * ((a.H + TS - 1) / TS);
  const long long total = (long long)a.B * nt;
  const long long it0 = sw_item0(blockIdx.x, total), it1 = sw_item0(blockIdx.x + 1, total);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  WgRing r = {ring, full, empty, S, 0, 0};
  if ((tid >> 5) >= NW) {  // the copy warpgroup: thread NT starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_COPY));
    if (tid == NT) sw_copy_walk<C, CHM>(maps, it0, it1, CHM ? a.NF : 0, r);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_CONSUMER));
  sw_consume<C, CHM>(a, static_cast<const T*>(a.x), static_cast<const T*>(a.ln_w),
                     static_cast<const T*>(a.ln_b), static_cast<const T*>(a.wd_qkv), it0, it1,
                     r, qt, kt, hid, xn);
}

template <int C, bool CHM>
static int launch_stats_wg(const StatsWgArgs& a, const void* w_qkv, const void* w_kv, int grid,
                           cudaStream_t stream) {
  StatsWgMaps maps;
  const uint64_t c = C;
  if (!encode_bf16<2>(&maps.w_qkv, w_qkv, {3 * c, c}, {3 * c * 2}, {64, SW_KB},
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      (CHM && !encode_bf16<2>(&maps.w_kv, w_kv, {2 * c, c}, {2 * c * 2}, {64, SW_KB},
                              CU_TENSOR_MAP_SWIZZLE_128B)))
    return -2;
  auto kern = stats_wg_kernel<C, CHM>;
  const size_t smem = sw_smem(C, CHM);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(grid), dim3(SW_NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace turtle
