// The Hopper bodies of the two chained depthwise stages (row 13 of the port's
// kernel table), for the forms the conv-only levels run in bf16:
//
//   * C = 64, a pair of ReducedAttn+FFW blocks (enc1): both stages gelu with
//     E a multiple of 64 and the chained FFW, F = 2 C;
//   * C = 64, a ReducedAttn+GFFW block (the refinement): stage 1 gelu (E a
//     multiple of 64), stage 2 gate (E a multiple of 32), no FFW;
//   * C = 128, a pair of ReducedAttn+FFW blocks (enc2): both stages gelu
//     with E a multiple of 128 and the chained FFW, F = 2 C.
//
// Replaces fused_two_stage in turtlevsr_tpu/kernels/chain2.py (_dw2_kernel)
// for these calls; kernels/chain2.py's _two_stage_plan sends them here and
// every other one (float32, other widths and forms) to chain2.cu. What it
// computes, and where it rounds, is the split route's: two launches of row
// 1's Hopper bodies (ffn_c64.cu at C = 64, ffn_wg.cu at C = 128), y rounded
// to bf16 between them. Each pixel takes those bodies' steps: the LayerNorm
// lane layouts, the wgmma k order (pw1 in k-steps of 16 over C, pw2 over the
// hidden axis in order), the nine taps in row-major order in fp32, and the
// rounding points of ffn_c64.cu's note.
//
// What the fusion saves is y's write and read (2 x 2 bytes a channel and
// pixel) and a launch; what it costs is stage 1's recomputation on the
// one-pixel ring around each output tile. For an output tile of TH x TW,
// stage 2 reads y on (TH + 2) x (TW + 2) and stage 1 reads x on (TH + 4) x
// (TW + 4). Stage 1 writes y, rounded, into a tile in shared memory; stage 2
// takes its LayerNorm and pw1 from there. y of the interior pixels also goes
// to the output map, where stage 2's epilogue reads its residual back and
// overwrites it (as ffn_wg.cu keeps x'), so y never leaves the chip but
// through L2.
//
// C = 64 (chain2_c64_kernel), on c64_tile.cuh's walk: a persistent grid of
// one block (three warpgroups) an SM over contiguous, entry-major ranges of
// (entry, tile) items; 16 x 8 output tiles, so stage 1 runs on the 20 x 12
// input box (4 m64 tiles of pw1, the fourth on warpgroup 0) and the 18 x 10
// ring (3 m64 tiles of pw2, one a warpgroup), stage 2 on ffn_c64.cu's 18 x
// 10 halo and 16 x 8 tile, each in ffn_c64.cu's chunks of 64 hidden columns
// (the fp32 chunk of 240 rows: 60 KB). Both stages' w1 and w2 stay resident
// in shared memory; the chained FFW's f_w1 and f_w2 (32 KB a stage) come by
// TMA into one buffer, stage 1's at the start of an item and stage 2's once
// stage 1's FFW has read the buffer. The input box comes by TMA (a 4-D box,
// zeros outside the map) into one slot; LN(x) overwrites it in place, stage
// 1 writes y over it (stage 2's input tile) once its last pw1 has read it,
// and the next item's box is started as soon as stage 2's last pw1 has read
// the y tile. The residual x of stage 1 comes from the map (L2).
//
// C = 128 (chain2_c128_kernel), on ffn_wg.cuh's ring: one 8 x 8 output tile
// a block, two consumer warpgroups and a copy warpgroup whose thread 0
// streams both stages' weights (w1, w2, f_w1, f_w2: 512 KB) through a ring
// of 16 KB TMA stages in wg_copy_tile's order, stage 1's and then stage 2's.
// Stage 1 runs on the 12 x 12 input halo (3 m64 tiles of pw1) and the 10 x
// 10 ring (2 m64 tiles of pw2, one a warpgroup, all 128 columns), stage 2 on
// ffn_wg.cu's 10 x 10 halo and 8 x 8 tile. Every product group is waited
// for before its stages go back.
//
// Registers: at C = 64 each stage is a function that is not inlined (PERF.md,
// row 14: two bodies inlined into one loop spilled; here, inlined, the
// kernel spilled and ran no faster on an H100, PERF.md row 13); at C = 128,
// one tile a block and no loop, the stages are inlined (called, ptxas
// serialised every wgmma of the kernel, C7510).
//
// C2_PHASES (measurement builds only, chip_smoke.py --phase
// two-stage-phases): a bit mask of the phases the C = 64 body runs, 1 the
// taps, 2 stage 2, 4 the chained FFW, 8 the products (pw1, pw2); the C = 128
// body reads bit 1 only. A build without a phase gives wrong outputs; only
// its time is read.
#include "c64_tile.cuh"
#include "ffn_wg.cuh"

#ifndef C2_PHASES
#define C2_PHASES 15
#endif

namespace turtle {

using bf16 = __nv_bfloat16;

struct C2Args {
  FfnArgs st[2];  // stage 1, stage 2 (x, out, B, H, W, C alike)
};

// the block's shared memory, aligned as the kernels align it
__device__ __forceinline__ unsigned char* c2_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return align_smem<WG_ALIGN>(smem_raw);
}

// ===========================================================================
// C = 64
// ===========================================================================

constexpr int K64_SLOT = (CT_TH + 4) * (CT_TW + 4) * 128;  // the 20 x 12 input box: 30720
constexpr int K64_FFW = 2 * CT_PANEL + 128 * 128;          // f_w1 (64 x 128), f_w2 (128 x 64)
constexpr int K64_HID = (CT_TH + 4) * (CT_TW + 4) * CT_HS * 4;   // 240 x 64 fp32: 61440
constexpr int K64_AS = 64 + XPAD;                          // row stride of the activation chunk
constexpr int K64_ACT = (CT_TH + 2) * (CT_TW + 2) * K64_AS * 2;   // 180 x 72 bf16: 25920

// the geometry of stage S: its input region (NI pixels, IW wide, origin
// IOFF up and left of the output tile), its output region (NO pixels, OW x
// OH, origin OOFF), m64 tiles of pw1 and pw2, and the taps' row groups
template <int S> struct K64Geo;
template <> struct K64Geo<1> {
  static constexpr int IW = CT_TW + 4, NI = (CT_TH + 4) * IW, IOFF = 2, MTI = 4;
  static constexpr int OW = CT_TW + 2, OH = CT_TH + 2, NO = OW * OH, OOFF = 1, MTO = 3;
  static constexpr int TG = 2, NRMAX = 9;  // 2 x 160 taps threads, 9 rows each
};
template <> struct K64Geo<2> {
  static constexpr int IW = CT_TW + 2, NI = (CT_TH + 2) * IW, IOFF = 1, MTI = 3;
  static constexpr int OW = CT_TW, OH = CT_TH, NO = OW * OH, OOFF = 0, MTO = 2;
  static constexpr int TG = 3, NRMAX = 6;  // 3 x 128 taps threads, 5 or 6 rows each
};

// bytes of one stage's resident weights: w1 (64 x CH) and w2 (E x 64) in
// the 128-byte swizzled panels wgmma reads
__host__ __device__ inline size_t k64_wbytes(int CH, int E) {
  return (size_t)128 * CH + (size_t)128 * E;
}
// the input box (later the y tile), both stages' w1 and w2, the FFW buffer
// (with the chained FFW), the hidden and activation chunks, both stages'
// taps (9 x CH bf16), two mbarriers
__host__ __device__ inline size_t k64_smem(int CH1, int E1, int CH2, int E2, int ffw) {
  return WG_ALIGN + K64_SLOT + k64_wbytes(CH1, E1) + k64_wbytes(CH2, E2) +
         (ffw ? K64_FFW : 0) + K64_HID + K64_ACT + (size_t)18 * (CH1 + CH2) +
         2 * sizeof(uint64_t);
}

// LN of the NPIX pixels of a tile WID pixels wide whose pixel 0 lies OFF
// rows and columns up and left of (y0, x0), in place at byte offset `at` of
// the block's shared memory, rounded, zero rows outside the image:
// ct_ln_pass's lanes and arithmetic (8 lanes a pixel)
template <int NPIX, int WID, int OFF>
__device__ __noinline__ void k64_ln(int at, const bf16* __restrict__ ln_w,
                                    const bf16* __restrict__ ln_b, int H, int W, int y0,
                                    int x0) {
  unsigned char* const buf = c2_smem() + at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, l = lane & 7;
  float gw[8], bt[8];
  load8(ln_w + 8 * l, gw);
#pragma unroll
  for (int i = 0; i < 8; ++i) bt[i] = 0.f;
  const bool has_b = ln_b != nullptr;
  if (has_b) load8(ln_b + 8 * l, bt);
  static_assert(NPIX % 4 == 0, "every lane has a pixel each round");
  for (int p0 = warp * 4; p0 < NPIX; p0 += CT_NT / 8) {
    const int p = p0 + (lane >> 3);
    const int gy = y0 - OFF + p / WID, gx = x0 - OFF + p % WID;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int off = sw128(p, l);
    float v[8];
    load8(reinterpret_cast<const bf16*>(buf + off), v);
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
    store8(reinterpret_cast<bf16*>(buf + off), v);
  }
}

// the channel of hidden chunk column c (chunk start e0): ffn_c64.cu's ct_chan
template <bool GATE>
__device__ __forceinline__ int k64_chan(int c, int e0, int E) {
  if (!GATE) return e0 + c;
  const int k = c >> 2, i = c & 3;
  return (i < 2 ? e0 : E + e0) + 2 * k + (i & 1);
}

// What stage S needs besides its FfnArgs: the byte offsets in the block's
// shared memory of its input tile (LN'd, swizzled 128-byte rows; stage 1
// writes y over it), its resident w1 and w2, the FFW buffer, the hidden and
// activation chunks and the mbarriers of the input box and of the FFW
// buffer (the stage rebuilds its pointers from the shared window, so that
// its accesses compile to shared-memory instructions, not generic ones),
// the tile, and the next item's box (stage 2 starts its load once its last
// pw1 has read the y tile)
struct K64Ctx {
  int in, w1s, w2s, fbuf, hid, act, wds, bar, fbar;
  int H, W, b, y0, x0;
  const CUtensorMap* map;
  int nb, ny0, nx0, next;
};

// One stage on its input tile: the chunk loop (pw1, taps, pw2, 64 hidden
// columns a chunk as ffn_c64.cu's) and the epilogue. Stage 1 writes y (with
// its FFW, y'') over its input box as stage 2's input tile, zero rows outside
// the image, and y of the 16 x 8 interior into the output map; stage 2
// reads that back as its residual and writes the output.
template <int S, bool GATE, bool FFW>
__device__ __noinline__ void k64_stage(const FfnArgs& a, const K64Ctx& cxr) {
  using G = K64Geo<S>;
  constexpr int AW = GATE ? 32 : 64;   // activations of a 64-column chunk
  const K64Ctx cx = cxr;
  unsigned char* const sm = c2_smem();
  unsigned char* const in = sm + cx.in;
  const unsigned char* const w1s = sm + cx.w1s;
  const unsigned char* const w2s = sm + cx.w2s;
  const unsigned char* const fw1s = sm + cx.fbuf;
  const unsigned char* const fw2s = fw1s + 2 * CT_PANEL;
  float* const hid = reinterpret_cast<float*>(sm + cx.hid);
  bf16* const act = reinterpret_cast<bf16*>(sm + cx.act);
  const bf16* const wd = reinterpret_cast<const bf16*>(sm + cx.wds);
  const int H = cx.H, W = cx.W, E = a.E, CH = a.CH, y0 = cx.y0, x0 = cx.x0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* bd = static_cast<const bf16*>(a.bd);
  const size_t boff = (size_t)cx.b * H * W * CT_C;
  bf16* out = static_cast<bf16*>(a.out) + boff;

  // pw1: this warpgroup's m64 tiles of the input region, wg and, at stage
  // 1, wg + 3: every warpgroup runs the second product (tiles 4 and 5 lie
  // past the region: their rows read row 0 and are dropped), so that no
  // wgmma sits on a divergent path (ptxas serialises them all there, C7520)
  constexpr bool TWO = G::MTI > 3;
  const int mt0 = wg, mt1 = wg + 3;
  auto a_at = [&](int mt, int kk) {
    int row = 64 * mt + 16 * q + (lane & 15);
    row = row < G::NI ? row : 0;
    return reinterpret_cast<const bf16*>(in + sw128(row, 2 * kk + (lane >> 4)));
  };
  // this thread's accumulator rows of those tiles, and whether they lie
  // inside the image
  bool hok[2][2], hin[2][2];
  int hrow[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (m ? mt1 : mt0) + 16 * q + g + 8 * h;
      const int gy = y0 - G::IOFF + r / G::IW, gx = x0 - G::IOFF + r % G::IW;
      hrow[m][h] = r;
      hok[m][h] = (m == 0 || TWO) && r < G::NI;
      hin[m][h] = hok[m][h] && gy >= 0 && gy < H && gx >= 0 && gx < W;
    }
  // a chunk's pw1 + b1 into the hidden chunk (zero outside the image)
  auto store = [&](const float (&h1)[32], int m, int e0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const int ch = k64_chan<GATE>(col, e0, E);
      const float2 bias = b1 != nullptr
                              ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + ch))
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!hok[m][h]) continue;
        *reinterpret_cast<float2*>(hid + ct_hid(hrow[m][h], col)) =
            make_float2(hin[m][h] ? h1[4 * j + 2 * h] + bias.x : 0.f,
                        hin[m][h] ? h1[4 * j + 2 * h + 1] + bias.y : 0.f);
      }
    }
  };

  // the taps: thread (row group, output column px, k) takes hidden columns
  // 4 k .. 4 k + 3 down its rows
  const int tk = tid & 15, trest = tid >> 4;
  const int tpx = trest % G::OW, trg = trest / G::OW;
  const bool taps_on = trg < G::TG;
  const int trow0 = trg * G::OH / G::TG, tnr = (trg + 1) * G::OH / G::TG - trow0;

  // pw2: output m64 tile wg (warpgroups 0 and 1 at stage 2)
  const bool pw2_on = wg < G::MTO;
  int arow2 = 64 * wg + 16 * q + (lane & 15);
  arow2 = arow2 < G::NO ? arow2 : 0;
  const bf16* arow2p = act + arow2 * K64_AS + (lane >> 4) * 8;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int n_chunks = E / AW;
#pragma unroll 1
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int e0 = ck * AW;
    if (C2_PHASES & 8) {
      float h1a[32], h1b[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) { h1a[i] = 0.f; h1b[i] = 0.f; }
      AFrag<bf16> a1[TWO ? 2 : 1][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_a(a1[0][kk], a_at(mt0, kk));
        if (TWO) ldsm_a(a1[TWO ? 1 : 0][kk], a_at(mt1, kk));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(h1a, a1[0][kk], panel_desc(w1s + ck * CT_PANEL + kk * 2048, CT_PANEL));
      if constexpr (TWO) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64>(h1b, a1[1][kk], panel_desc(w1s + ck * CT_PANEL + kk * 2048, CT_PANEL));
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(h1a);
      store(h1a, 0, e0);
      if constexpr (TWO) {
        pin(h1b);
        store(h1b, 1, e0);
      }
    }
    const bool refill = S == 2 && ck + 1 == n_chunks;
    if (refill) fence_proxy_async();  // generic writes to the box; the next TMA write follows
    __syncthreads();
    if (refill && tid == 0 && cx.next) {  // every warp has read the y tile
      uint64_t* bar = reinterpret_cast<uint64_t*>(sm + cx.bar);
      mbar_expect_tx(bar, K64_SLOT);
      tma_load_4d(in, cx.map, 0, cx.nx0 - 2, cx.ny0 - 2, cx.nb, bar);
    }
    if (taps_on && (C2_PHASES & 1)) {
      // ct_taps's arithmetic: the channels of the four columns in pairs
      const int ch0 = GATE ? e0 + 2 * tk : e0 + 4 * tk;
      const int ch1 = GATE ? E + e0 + 2 * tk : e0 + 4 * tk + 2;
      float w[9][4], bias[4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wd + tap * CH + ch0));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wd + tap * CH + ch1));
        w[tap][0] = lo.x; w[tap][1] = lo.y; w[tap][2] = hi.x; w[tap][3] = hi.y;
      }
      {
        float2 lo = make_float2(0.f, 0.f), hi = lo;
        if (bd != nullptr) {
          lo = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bd + ch0)));
          hi = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bd + ch1)));
        }
        bias[0] = lo.x; bias[1] = lo.y; bias[2] = hi.x; bias[3] = hi.y;
      }
      auto ld = [&](int iy, int ix, float (&v)[4]) {
        const float4 f = *reinterpret_cast<const float4*>(hid + ct_hid(iy * G::IW + ix, 4 * tk));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      };
      float rw[3][3][4];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        ld(trow0, tpx + tx, rw[0][tx]);
        ld(trow0 + 1, tpx + tx, rw[1][tx]);
      }
#pragma unroll
      for (int py = 0; py < G::NRMAX; ++py) {
        if (py < tnr) {
#pragma unroll
          for (int tx = 0; tx < 3; ++tx) ld(trow0 + py + 2, tpx + tx, rw[2][tx]);
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float sacc = 0.f;
#pragma unroll
            for (int ty = 0; ty < 3; ++ty)
#pragma unroll
              for (int tx = 0; tx < 3; ++tx) sacc += rw[ty][tx][c] * w[ty * 3 + tx][c];
            o[c] = sacc + bias[c];
          }
          bf16* dst = act + ((trow0 + py) * G::OW + tpx) * K64_AS;
          if (GATE) {
            *reinterpret_cast<__nv_bfloat162*>(dst + 2 * tk) =
                __floats2bfloat162_rn(gelu_exact(o[0]) * o[2], gelu_exact(o[1]) * o[3]);
          } else {
            __nv_bfloat162 v2[2] = {__floats2bfloat162_rn(gelu_exact(o[0]), gelu_exact(o[1])),
                                    __floats2bfloat162_rn(gelu_exact(o[2]), gelu_exact(o[3]))};
            *reinterpret_cast<uint2*>(dst + 4 * tk) = *reinterpret_cast<const uint2*>(v2);
          }
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              rw[0][tx][c] = rw[1][tx][c];
              rw[1][tx][c] = rw[2][tx][c];
            }
        }
      }
    }
    __syncthreads();
    // pw2: rows e0 .. e0 + AW of w2 into the accumulators of the outputs
    if (pw2_on && (C2_PHASES & 8)) {
      AFrag<bf16> a2[AW / 16];
#pragma unroll
      for (int kk = 0; kk < AW / 16; ++kk) ldsm_a(a2[kk], arow2p + 16 * kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AW / 16; ++kk)
        wgmma_rs<64>(acc, a2[kk], panel_desc(w2s + (e0 + 16 * kk) * 128, CT_PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
    }
  }
  if (!pw2_on) return;

  // epilogue: y = (acc + b2) * scale + residual, one rounding; the residual
  // is x (stage 1, from the map) or y (stage 2, from the output map, where
  // stage 1 put it)
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* sc = static_cast<const bf16*>(a.scale);
  const bf16* res = S == 1 ? static_cast<const bf16*>(a.x) + boff : out;
  int orow[2];
  bool oin[2], interior[2];
  size_t poff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * q + g + 8 * h;
    const int oy = r / G::OW, ox = r % G::OW;
    const int gy = y0 - G::OOFF + oy, gx = x0 - G::OOFF + ox;
    orow[h] = r;
    oin[h] = r < G::NO && gy >= 0 && gy < H && gx >= 0 && gx < W;
    interior[h] = oin[h] && oy >= G::OOFF && oy < G::OOFF + CT_TH && ox >= G::OOFF &&
                  ox < G::OOFF + CT_TW;
    poff[h] = oin[h] ? ((size_t)gy * W + gx) * CT_C : 0;
  }
  __nv_bfloat162 y[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = b2 != nullptr
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c))
                          : make_float2(0.f, 0.f);
    const float2 ss = sc != nullptr
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + c))
                          : make_float2(1.f, 1.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      y[h][j] = __floats2bfloat162_rn(0.f, 0.f);
      if (!oin[h]) continue;
      const float2 xx =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + poff[h] + c));
      y[h][j] = __floats2bfloat162_rn((acc[4 * j + 2 * h] + bb.x) * ss.x + xx.x,
                                      (acc[4 * j + 2 * h + 1] + bb.y) * ss.y + xx.y);
    }
  }
  if constexpr (FFW && (C2_PHASES & 4)) {
    // ffn_c64.cu's chained FFW on y, M = 64 pixels a warpgroup: LN2 by the
    // quads' shuffles, pw4 and pw5 with their A operands in registers, f_w1
    // and f_w2 from the FFW buffer (this stage's load: parity S - 1)
    mbar_wait(reinterpret_cast<uint64_t*>(sm + cx.fbar), S - 1);
    const bf16* f_ln_w = static_cast<const bf16*>(a.f_ln_w);
    const bf16* f_ln_b = static_cast<const bf16*>(a.f_ln_b);
    float yn[32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sa = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v = __bfloat1622float2(y[h][j]);
        sa += v.x + v.y;
      }
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      const float mu = sa / (float)CT_C;
      float qs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v = __bfloat1622float2(y[h][j]);
        qs += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
      }
      qs += __shfl_xor_sync(0xffffffffu, qs, 1);
      qs += __shfl_xor_sync(0xffffffffu, qs, 2);
      const float inv = 1.0f / sqrtf(qs / (float)CT_C + LN_EPS);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 v = __bfloat1622float2(y[h][j]);
        const float2 lw = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_ln_w + c));
        float n0, n1;
        if (f_ln_b != nullptr) {
          const float2 lb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_ln_b + c));
          n0 = (v.x - mu) * inv * lw.x + lb.x;
          n1 = (v.y - mu) * inv * lw.y + lb.y;
        } else {
          n0 = v.x * inv * lw.x;
          n1 = v.y * inv * lw.y;
        }
        yn[4 * j + 2 * h] = n0;
        yn[4 * j + 2 * h + 1] = n1;
      }
    }
    float h2[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) h2[i] = 0.f;
    {
      AFrag<bf16> a4[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a4[kk] = acc_afrag<64>(yn, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<128>(h2, a4[kk], panel_desc(fw1s + kk * 2048, CT_PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      pin(h2);
    }
    const bf16* f_b1 = static_cast<const bf16*>(a.f_b1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b1 + 8 * j + 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        h2[4 * j + 2 * h] = gelu_exact(h2[4 * j + 2 * h] + bb.x);
        h2[4 * j + 2 * h + 1] = gelu_exact(h2[4 * j + 2 * h + 1] + bb.y);
      }
    }
    float o2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o2[i] = 0.f;
    {
      AFrag<bf16> a5[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a5[kk] = acc_afrag<128>(h2, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<64>(o2, a5[kk], panel_desc(fw2s + kk * 2048, CT_PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o2);
    }
    const bf16* f_b2 = static_cast<const bf16*>(a.f_b2);
    const bf16* f_sc = static_cast<const bf16*>(a.f_scale);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b2 + c));
      const float2 ss = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_sc + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!oin[h]) continue;
        const float2 yy = __bfloat1622float2(y[h][j]);
        y[h][j] = __floats2bfloat162_rn((o2[4 * j + 2 * h] + bb.x) * ss.x + yy.x,
                                        (o2[4 * j + 2 * h + 1] + bb.y) * ss.y + yy.y);
      }
    }
  }
  // stage 1: y over the input box (stage 2's input tile) and the interior's
  // into the output map; stage 2: the output
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (S == 1 && orow[h] < G::NO) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(in + sw128(orow[h], j) + 4 * t) = y[h][j];
    }
    if ((S == 1 && interior[h]) || (S == 2 && oin[h])) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + poff[h] + 8 * j + 2 * t) = y[h][j];
    }
  }
}

// A stage's resident w1, w2 and taps, once a block: ffn_c64.cu's panels
template <bool GATE>
__device__ void k64_weights(const FfnArgs& a, unsigned char* w1s, unsigned char* w2s,
                            bf16* wds) {
  constexpr int AW = GATE ? 32 : 64;
  const int tid = threadIdx.x, E = a.E, CH = a.CH;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  for (int ck = 0; ck < E / AW; ++ck) {
    const int e0 = ck * AW;
    if (GATE) {
      for (int idx = tid; idx < CT_C * 32; idx += CT_NT) {
        const int k = idx >> 5, c = 2 * (idx & 31);
        *reinterpret_cast<uint32_t*>(w1s + ck * CT_PANEL + sw128(k, c >> 3) + 2 * (c & 7)) =
            __ldg(reinterpret_cast<const uint32_t*>(w1 + (size_t)k * CH + k64_chan<true>(c, e0, E)));
      }
    } else {
      ct_panel(w1s + ck * CT_PANEL, w1, CH, CT_C, [&](int j) { return e0 + 8 * j; });
    }
  }
  ct_panel(w2s, static_cast<const bf16*>(a.w2), CT_C, E, [](int j) { return 8 * j; });
  const uint4* src = static_cast<const uint4*>(a.wd);
  for (int idx = tid; idx < 9 * CH / 8; idx += CT_NT)
    reinterpret_cast<uint4*>(wds)[idx] = __ldg(src + idx);
}

struct K64Maps {
  CUtensorMap x;         // x as (C, W, H, B), a box the 20 x 12 input region
  CUtensorMap fw1[2];    // f_w1 of each stage as (F, C), a box 64 x 64
  CUtensorMap fw2[2];    // f_w2 of each stage as (C, F), a box 64 x 128
};

// the FFW buffer's load of stage s (thread 0)
__device__ __forceinline__ void k64_ffw_load(const K64Maps& m, int s, unsigned char* fbuf,
                                             uint64_t* fbar) {
  mbar_expect_tx(fbar, K64_FFW);
  tma_load_2d(fbuf, &m.fw1[s], 0, 0, fbar);
  tma_load_2d(fbuf + CT_PANEL, &m.fw1[s], 64, 0, fbar);
  tma_load_2d(fbuf + 2 * CT_PANEL, &m.fw2[s], 0, 0, fbar);
}

// G1: stage 1's mode is gate (no: gelu); G2 likewise; FFW: both stages
// chain the FFW. The input box of item it + 1 comes in once stage 2 of item
// it has read its y tile; with the FFW, stage 1's f_w1 and f_w2 come into
// the FFW buffer at the start of an item, stage 2's once stage 1's FFW is
// done.
template <bool G1, bool G2, bool FFW>
__global__ void __launch_bounds__(CT_NT, 1)
    chain2_c64_kernel(const __grid_constant__ C2Args a, const __grid_constant__ K64Maps maps) {
  unsigned char* smem = c2_smem();
  const FfnArgs& s1 = a.st[0];
  const FfnArgs& s2 = a.st[1];
  const int H = s1.H, W = s1.W;
  unsigned char* xs = smem;
  unsigned char* w1a = xs + K64_SLOT;
  unsigned char* w2a = w1a + 128 * s1.CH;
  unsigned char* w1b = w2a + 128 * s1.E;
  unsigned char* w2b = w1b + 128 * s2.CH;
  unsigned char* fbuf = w2b + 128 * s2.E;
  float* hid = reinterpret_cast<float*>(fbuf + (FFW ? K64_FFW : 0));
  bf16* act = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(hid) + K64_HID);
  bf16* wda = act + K64_ACT / 2;
  bf16* wdb = wda + 9 * s1.CH;
  uint64_t* full = reinterpret_cast<uint64_t*>(wdb + 9 * s2.CH);
  uint64_t* fbar = full + 1;

  const int tid = threadIdx.x;
  const int tiles_x = (W + CT_TW - 1) / CT_TW, nt = tiles_x * ((H + CT_TH - 1) / CT_TH);
  const long long total = (long long)s1.B * nt;
  const long long it0 = total * blockIdx.x / gridDim.x;
  const long long it1 = total * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(fbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && it0 < it1) {
    const CtTile tl = ct_tile(it0, tiles_x, nt);
    mbar_expect_tx(full, K64_SLOT);
    tma_load_4d(xs, &maps.x, 0, tl.x0 - 2, tl.y0 - 2, tl.b, full);
  }
  k64_weights<G1>(s1, w1a, w2a, wda);
  k64_weights<G2>(s2, w1b, w2b, wdb);
  fence_proxy_async();
  __syncthreads();

  auto off = [&](const void* p) {
    return (int)(static_cast<const unsigned char*>(p) - smem);
  };
#pragma unroll 1
  for (long long it = it0; it < it1; ++it) {
    const CtTile tl = ct_tile(it, tiles_x, nt);
    mbar_wait(full, (int)((it - it0) & 1));
    k64_ln<K64Geo<1>::NI, K64Geo<1>::IW, 2>(off(xs), static_cast<const bf16*>(s1.ln_w),
                                            static_cast<const bf16*>(s1.ln_b), H, W, tl.y0,
                                            tl.x0);
    __syncthreads();  // also: the last item's stage 2 FFW has read the FFW buffer
    if (FFW && tid == 0) k64_ffw_load(maps, 0, fbuf, fbar);
    K64Ctx cx{off(xs), off(w1a), off(w2a), off(fbuf), off(hid), off(act), off(wda), off(full),
              off(fbar), H, W, tl.b, tl.y0, tl.x0, &maps.x, 0, 0, 0, 0};
    k64_stage<1, G1, FFW>(s1, cx);
    __syncthreads();  // the y tile and the interior's y are complete
    if (FFW && tid == 0) k64_ffw_load(maps, 1, fbuf, fbar);
    if (!(C2_PHASES & 2)) {  // (measurement builds) the next box, stage 2 left out
      if (tid == 0 && it + 1 < it1) {
        const CtTile nx = ct_tile(it + 1, tiles_x, nt);
        fence_proxy_async();
        mbar_expect_tx(full, K64_SLOT);
        tma_load_4d(xs, &maps.x, 0, nx.x0 - 2, nx.y0 - 2, nx.b, full);
      }
      if (FFW) mbar_wait(fbar, 1);
      continue;
    }
    k64_ln<K64Geo<2>::NI, K64Geo<2>::IW, 1>(off(xs), static_cast<const bf16*>(s2.ln_w),
                                            static_cast<const bf16*>(s2.ln_b), H, W, tl.y0,
                                            tl.x0);
    __syncthreads();
    K64Ctx cy{off(xs), off(w1b), off(w2b), off(fbuf), off(hid), off(act), off(wdb), off(full),
              off(fbar), H, W, tl.b, tl.y0, tl.x0, &maps.x, 0, 0, 0, 0};
    if (it + 1 < it1) {
      const CtTile nx = ct_tile(it + 1, tiles_x, nt);
      cy.nb = nx.b; cy.ny0 = nx.y0; cy.nx0 = nx.x0; cy.next = 1;
    }
    k64_stage<2, G2, FFW>(s2, cy);
  }
}

template <bool G1, bool G2, bool FFW>
static int launch_c64(const C2Args& a, int blocks, cudaStream_t stream) {
  const FfnArgs& s1 = a.st[0];
  const FfnArgs& s2 = a.st[1];
  K64Maps maps;
  const uint64_t c = CT_C, w = s1.W, h = s1.H;
  if (!encode_bf16<4>(&maps.x, s1.x, {c, w, h, (uint64_t)s1.B}, {c * 2, w * c * 2, h * w * c * 2},
                      {CT_C, CT_TW + 4, CT_TH + 4, 1}, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  if (FFW)
    for (int k = 0; k < 2; ++k) {
      const FfnArgs& s = a.st[k];
      const uint64_t f = s.F;
      if (!encode_bf16<2>(&maps.fw1[k], s.f_w1, {f, c}, {f * 2}, {64, 64},
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
          !encode_bf16<2>(&maps.fw2[k], s.f_w2, {c, f}, {c * 2}, {64, 128},
                          CU_TENSOR_MAP_SWIZZLE_128B))
        return -2;
    }
  auto kern = chain2_c64_kernel<G1, G2, FFW>;
  const size_t smem = k64_smem(s1.CH, s1.E, s2.CH, s2.E, FFW);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks), dim3(CT_NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

// ===========================================================================
// C = 128
// ===========================================================================

constexpr int K128_C = 128, K128_XS = K128_C + XPAD;  // 136: the row stride of bf16 tiles
constexpr int K128_NI1 = (TS + 4) * (TS + 4);          // 144: stage 1's input halo
constexpr int K128_NR = PH * PH;                       // 100: the y ring, stage 2's halo
constexpr int K128_FF = 2 * K128_C;                    // F
constexpr int K128_GS = K128_FF + XPAD;                // the FFW activation's row stride
constexpr int K128_XN = K128_NI1 * K128_XS * 2;        // 39168
constexpr int K128_HID = K128_NI1 * WG_HS * 4;         // 73728
constexpr int K128_ACT = K128_NR * K128_XS * 2;        // 27200
constexpr int K128_YT = K128_NR * K128_XS * 2;         // 27200
constexpr int K128_REST = K128_XN + K128_HID + K128_ACT + K128_YT;
static_assert(K128_NR * K128_GS * 2 <= K128_HID, "the FFW activation fits the hid chunk");

__host__ __device__ inline int k128_stages() {
  const int s = (int)((WG_SMEM_MAX - WG_ALIGN - K128_REST) / (WG_STAGE + 2 * sizeof(uint64_t)));
  return s < WG_MAX_STAGES ? s : WG_MAX_STAGES;
}
__host__ __device__ inline size_t k128_smem() {
  const int s = k128_stages();
  return WG_ALIGN + (size_t)s * WG_STAGE + K128_REST + 2 * s * sizeof(uint64_t);
}

// LN of the NPIX pixels of a tile WID wide whose pixel 0 lies OFF rows and
// columns up and left of (y0, x0), from the map (src null: from dst, in
// place) into dst (row stride 136), rounded, zero rows outside the image:
// wg_ln_pass's lanes and arithmetic at C = 128 (16 lanes a pixel)
template <int NPIX, int WID, int OFF>
__device__ __forceinline__ void k128_ln(const bf16* __restrict__ src, bf16* dst,
                                     const bf16* __restrict__ ln_w,
                                     const bf16* __restrict__ ln_b, int H, int W, int y0,
                                     int x0) {
  constexpr int GL = 16, PP = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / GL, l = lane % GL, c8 = 8 * l;
  float gw[8], bt[8];
  load8(ln_w + c8, gw);
#pragma unroll
  for (int i = 0; i < 8; ++i) bt[i] = 0.f;
  const bool has_b = ln_b != nullptr;
  if (has_b) load8(ln_b + c8, bt);
  static_assert(NPIX % PP == 0, "every lane has a pixel each round");
  for (int p0 = warp * PP; p0 < NPIX; p0 += NW * PP) {
    const int p = p0 + sub;
    const int gy = y0 - OFF + p / WID, gx = x0 - OFF + p % WID;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    float sum = 0.f;
    if (inside) {
      load8(src != nullptr ? src + ((size_t)gy * W + gx) * K128_C + c8 : dst + p * K128_XS + c8,
            v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[i];
    }
#pragma unroll
    for (int m = GL / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mu = sum / (float)K128_C;
    float q = 0.f;
    if (inside) {
#pragma unroll
      for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
    }
#pragma unroll
    for (int m = GL / 2; m > 0; m >>= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.0f / sqrtf(q / (float)K128_C + LN_EPS);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!inside) v[i] = 0.f;
      else if (has_b) v[i] = (v[i] - mu) * inv * gw[i] + bt[i];
      else v[i] = v[i] * inv * gw[i];
    }
    store8(dst + p * K128_XS + c8, v);
  }
}

// LN2 of the chained FFW on the first n rows of ybuf (row stride 136), in
// place, rounded: wg_ffw2_ln's lanes and arithmetic at C = 128
__device__ __forceinline__ void k128_ln2(bf16* ybuf, int n, const bf16* __restrict__ ln_w,
                                      const bf16* __restrict__ ln_b) {
  constexpr int GL = 16, PP = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane % GL;
  float gw[8], bt[8];
  load8(ln_w + 8 * l, gw);
#pragma unroll
  for (int i = 0; i < 8; ++i) bt[i] = 0.f;
  if (ln_b != nullptr) load8(ln_b + 8 * l, bt);
  for (int p0 = warp * PP; p0 < n; p0 += NW * PP) {
    const int pix = p0 + lane / GL;
    const bool ok = pix < n;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    if (ok) load8(ybuf + pix * K128_XS + 8 * l, v);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mu = sum / (float)K128_C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < GL) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.0f / sqrtf(q / (float)K128_C + LN_EPS);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = ln_b != nullptr ? (v[i] - mu) * inv * gw[i] + bt[i] : v[i] * inv * gw[i];
    if (ok) store8(ybuf + pix * K128_XS + 8 * l, v);
  }
}

// the consumers' view of the ring: take the next stage, hand stages back
// (one arrival a warpgroup)
struct K128Ring {
  WgRing& r;
  __device__ const unsigned char* take() {
    const int s = r.li % r.S;
    mbar_wait(&r.full[s], (r.li / r.S) & 1);
    ++r.li;
    return r.ring + (size_t)s * WG_STAGE;
  }
  __device__ void release_all() {
    const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
    for (; r.rel < r.li; ++r.rel)
      if (lane == 0 && q == 0) mbar_arrive(&r.empty[r.rel % r.S]);
  }
};

// What a C = 128 stage needs besides its FfnArgs
struct K128Ctx {
  const bf16* in;  // LN'd input rows (stride 136)
  float* hid;
  bf16 *act, *xn, *yt;
  int H, W, b, y0, x0;
};

// The chunk loop of stage S (1: input 12 x 12, output the 10 x 10 ring;
// 2: input the ring, output the 8 x 8 tile): pw1, taps, pw2 into acc (S =
// 1: this warpgroup's m64 tile of the ring, all 128 columns; S = 2: the 64
// pixels, this warpgroup's 64 columns), the ring's stages in
// wg_copy_tile's order
template <int S, int NA>
__device__ __forceinline__ void k128_chunks(const FfnArgs& a, const K128Ctx& cx, K128Ring& ring,
                                            float (&acc)[NA]) {
  constexpr int SO = S == 1 ? PH : TS, SI = SO + 2, NI = SI * SI, NO = SO * SO;
  constexpr int MTI = (NI + 63) / 64, AS = K128_XS;
  const int H = cx.H, W = cx.W, E = a.E, CH = a.CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* wd = static_cast<const bf16*>(a.wd);
  const bf16* bd = static_cast<const bf16*>(a.bd);
  const int org = S == 1 ? 2 : 1;  // input pixel 0 lies org rows and columns up and left
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  int arow2 = (S == 1 ? 64 * wg : 0) + 16 * q + (lane & 15);
  arow2 = arow2 < NO ? arow2 : 0;
  const bf16* arow2p = cx.act + arow2 * AS + (lane >> 4) * 8;
  const int n_chunks = E / 128;
#pragma unroll 1
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int e0 = ck * 128;
    // pw1: the chunk's two stages of 64 rows of K, every m64 tile of this
    // warpgroup (wg, wg + 2) in turn
    const unsigned char* bs[2] = {ring.take(), ring.take()};
#pragma unroll 1
    for (int mt = wg; mt < MTI; mt += 2) {
      int arow = 64 * mt + 16 * q + (lane & 15);
      arow = arow < NI ? arow : 0;
      const bf16* ap = cx.in + arow * AS + (lane >> 4) * 8;
      float h1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) h1[i] = 0.f;
      AFrag<bf16> af[2][4];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int k = 0; k < 4; ++k) ldsm_a(af[kb][k], ap + kb * WG_KB + k * 16);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_rs<128>(h1, af[kb][k], stage_desc(bs[kb], WG_KB, 0, k));
      wgmma_commit();
      wgmma_wait<0>();
      pin(h1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * mt + 16 * q + g + 8 * h;
        if (r >= NI) continue;
        const int gy = cx.y0 - org + r / SI, gx = cx.x0 - org + r % SI;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 bias = b1 != nullptr
                                  ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                        b1 + e0 + col))
                                  : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(cx.hid + r * WG_HS + (col ^ ((r & 3) << 3))) =
              make_float2(in ? h1[4 * j + 2 * h] + bias.x : 0.f,
                          in ? h1[4 * j + 2 * h + 1] + bias.y : 0.f);
        }
      }
    }
    ring.release_all();
    consumers_sync();
    // dw 3x3 + gelu, rounded: thread (column, tile column) down SO rows
    for (int item = tid; (C2_PHASES & 1) && item < 128 * SO; item += NT) {
      const int col = item % 128, px = item / 128, ch = e0 + col;
      float w[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) w[i] = to_f(wd[i * CH + ch]);
      const float bias = bd != nullptr ? to_f(bd[ch]) : 0.f;
      float r[3][3];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        r[0][tx] = cx.hid[hid_at(px + tx, col)];
        r[1][tx] = cx.hid[hid_at(SI + px + tx, col)];
      }
#pragma unroll
      for (int py = 0; py < SO; ++py) {
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) r[2][tx] = cx.hid[hid_at((py + 2) * SI + px + tx, col)];
        float s = 0.f;
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx) s += r[ty][tx] * w[ty * 3 + tx];
        cx.act[(py * SO + px) * AS + col] = from_f<bf16>(gelu_exact(s + bias));
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) { r[0][tx] = r[1][tx]; r[1][tx] = r[2][tx]; }
      }
    }
    consumers_sync();
    // pw2: rows e0 .. e0 + 128 of w2 in two stages of 64
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2) {
      const unsigned char* b2s = ring.take();
      AFrag<bf16> a2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ldsm_a(a2[k], arow2p + j2 * 64 + k * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_rs<2 * NA>(acc, a2[k], stage_desc(b2s, 64, S == 1 ? 0 : wg, k));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      ring.release_all();
    }
  }
}

// Stage 1 at C = 128: the ring's y (with its FFW), into the y tile (zero
// outside the image) and the interior's into the output map
__device__ __forceinline__ void k128_stage1(const FfnArgs& a, const K128Ctx& cx, WgRing& r) {
  K128Ring ring{r};
  float acc[64];
  k128_chunks<1, 64>(a, cx, ring, acc);
  const int H = cx.H, W = cx.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  const size_t boff = (size_t)cx.b * H * W * K128_C;
  const bf16* x = static_cast<const bf16*>(a.x) + boff;
  bf16* out = static_cast<bf16*>(a.out) + boff;
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* sc = static_cast<const bf16*>(a.scale);
  int rr[2];
  bool oin[2], interior[2];
  size_t poff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = 64 * wg + 16 * q + g + 8 * h;
    const int oy = rr[h] / PH, ox = rr[h] % PH;
    const int gy = cx.y0 - 1 + oy, gx = cx.x0 - 1 + ox;
    oin[h] = rr[h] < K128_NR && gy >= 0 && gy < H && gx >= 0 && gx < W;
    interior[h] = oin[h] && oy >= 1 && oy <= TS && ox >= 1 && ox <= TS;
    poff[h] = oin[h] ? ((size_t)gy * W + gx) * K128_C : 0;
  }
  // y = (acc + b2) * scale + x, one rounding, into the y tile and (to be
  // normalised) the LN halo's space
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = b2 != nullptr
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c))
                          : make_float2(0.f, 0.f);
    const float2 ss = sc != nullptr
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + c))
                          : make_float2(1.f, 1.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rr[h] >= K128_NR) continue;
      __nv_bfloat162 yv = __floats2bfloat162_rn(0.f, 0.f);
      if (oin[h]) {
        const float2 xx =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + poff[h] + c));
        yv = __floats2bfloat162_rn((acc[4 * j + 2 * h] + bb.x) * ss.x + xx.x,
                                   (acc[4 * j + 2 * h + 1] + bb.y) * ss.y + xx.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(cx.yt + rr[h] * K128_XS + c) = yv;
      *reinterpret_cast<__nv_bfloat162*>(cx.xn + rr[h] * K128_XS + c) = yv;
    }
  }
  consumers_sync();
  k128_ln2(cx.xn, K128_NR, static_cast<const bf16*>(a.f_ln_w), static_cast<const bf16*>(a.f_ln_b));
  consumers_sync();
  // pw4: all F columns of this warpgroup's m64 tile, K = C in stages of 32
  // rows of all F columns (panels 0-1 and 2-3)
  int arow = 64 * wg + 16 * q + (lane & 15);
  arow = arow < K128_NR ? arow : 0;
  const bf16* arow4 = cx.xn + arow * K128_XS + (lane >> 4) * 8;
  float h2a[64], h2b[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) { h2a[i] = 0.f; h2b[i] = 0.f; }
  constexpr int FR1 = 8192 / K128_FF, FR2 = 8192 / K128_C;
#pragma unroll 1
  for (int st = 0; st < K128_C / FR1; ++st) {
    const unsigned char* bs = ring.take();
    AFrag<bf16> af[FR1 / 16];
#pragma unroll
    for (int k = 0; k < FR1 / 16; ++k) ldsm_a(af[k], arow4 + st * FR1 + k * 16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < FR1 / 16; ++k) {
      wgmma_rs<128>(h2a, af[k], stage_desc(bs, FR1, 0, k));
      wgmma_rs<128>(h2b, af[k], stage_desc(bs, FR1, 2, k));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(h2a);
    pin(h2b);
    ring.release_all();
  }
  // gelu(h2 + b4), rounded, into the hid chunk's space (row stride 264)
  bf16* gbuf = reinterpret_cast<bf16*>(cx.hid);
  const bf16* f_b1 = static_cast<const bf16*>(a.f_b1);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int f = 8 * j + 2 * t;
    const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b1 + f));
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b1 + 128 + f));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rr[h] >= K128_NR) continue;
      bf16* row = gbuf + rr[h] * K128_GS;
      *reinterpret_cast<__nv_bfloat162*>(row + f) =
          __floats2bfloat162_rn(gelu_exact(h2a[4 * j + 2 * h] + ba.x),
                                gelu_exact(h2a[4 * j + 2 * h + 1] + ba.y));
      *reinterpret_cast<__nv_bfloat162*>(row + 128 + f) =
          __floats2bfloat162_rn(gelu_exact(h2b[4 * j + 2 * h] + bb.x),
                                gelu_exact(h2b[4 * j + 2 * h + 1] + bb.y));
    }
  }
  consumers_sync();
  // pw5: all C columns, K = F in stages of 64 rows
  const bf16* arow5 = gbuf + arow * K128_GS + (lane >> 4) * 8;
  float o2[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o2[i] = 0.f;
#pragma unroll 1
  for (int st = 0; st < K128_FF / FR2; ++st) {
    const unsigned char* bs = ring.take();
    AFrag<bf16> af[FR2 / 16];
#pragma unroll
    for (int k = 0; k < FR2 / 16; ++k) ldsm_a(af[k], arow5 + st * FR2 + k * 16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < FR2 / 16; ++k) wgmma_rs<128>(o2, af[k], stage_desc(bs, FR2, 0, k));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o2);
    ring.release_all();
  }
  // y'' = (o2 + b5) * scale2 + y, one rounding, over y in the y tile; the
  // interior's also into the output map
  const bf16* f_b2 = static_cast<const bf16*>(a.f_b2);
  const bf16* f_sc = static_cast<const bf16*>(a.f_scale);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b2 + c));
    const float2 ss = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_sc + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!oin[h]) continue;
      __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(cx.yt + rr[h] * K128_XS + c);
      const float2 yy = __bfloat1622float2(*yp);
      const __nv_bfloat162 v = __floats2bfloat162_rn((o2[4 * j + 2 * h] + bb.x) * ss.x + yy.x,
                                                     (o2[4 * j + 2 * h + 1] + bb.y) * ss.y + yy.y);
      *yp = v;
      if (interior[h]) *reinterpret_cast<__nv_bfloat162*>(out + poff[h] + c) = v;
    }
  }
}

// Stage 2 at C = 128: ffn_wg.cu's tile with its chained FFW, the residual y
// read back from the output map
__device__ __forceinline__ void k128_stage2(const FfnArgs& a, const K128Ctx& cx, WgRing& r) {
  K128Ring ring{r};
  float acc[32];
  k128_chunks<2, 32>(a, cx, ring, acc);
  const int H = cx.H, W = cx.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  bf16* out = static_cast<bf16*>(a.out) + (size_t)cx.b * H * W * K128_C;
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* sc = static_cast<const bf16*>(a.scale);
  constexpr int NW2 = K128_C / 2, FF = K128_FF, GS = K128_GS, XS = K128_XS;
  __nv_bfloat162* orow[2];
  bool oin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = 16 * q + g + 8 * h;
    const int gy = cx.y0 + pix / TS, gx = cx.x0 + pix % TS;
    oin[h] = gy < H && gx < W;
    orow[h] = reinterpret_cast<__nv_bfloat162*>(out + (oin[h] ? ((size_t)gy * W + gx) * K128_C : 0));
  }
  const int cb = wg * NW2 + 2 * t;  // + 8 j
  __nv_bfloat162 xr[2][NW2 / 8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NW2 / 8; ++j)
      if (oin[h]) xr[h][j] = orow[h][(cb + 8 * j) / 2];
#pragma unroll
  for (int j = 0; j < NW2 / 8; ++j) {
    const int c = cb + 8 * j;
    const float bb0 = b2 ? to_f(b2[c]) : 0.f, bb1 = b2 ? to_f(b2[c + 1]) : 0.f;
    const float s0 = sc ? to_f(sc[c]) : 1.f, s1 = sc ? to_f(sc[c + 1]) : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      if (!oin[h]) {
        acc[i] = acc[i + 1] = 0.f;
        continue;
      }
      const float2 xx = __bfloat1622float2(xr[h][j]);
      const float2 yf = __bfloat1622float2(__floats2bfloat162_rn((acc[i] + bb0) * s0 + xx.x,
                                                                 (acc[i + 1] + bb1) * s1 + xx.y));
      acc[i] = yf.x;
      acc[i + 1] = yf.y;
    }
  }
  // the chained FFW on y, as ffn_wg.cuh's: y meets in the LN halo's space,
  // LN2(y) overwrites it, pw4's F columns split between the warpgroups, the
  // activation in the hid chunk's space, pw5 on each warpgroup's columns
  bf16* ybuf = cx.xn;
  bf16* gbuf = reinterpret_cast<bf16*>(cx.hid);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NW2 / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ybuf + (16 * q + g + 8 * h) * XS + wg * NW2 + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  consumers_sync();
  k128_ln2(ybuf, P, static_cast<const bf16*>(a.f_ln_w), static_cast<const bf16*>(a.f_ln_b));
  consumers_sync();
  constexpr int FR1 = 8192 / FF, FR2 = 8192 / K128_C;
  const bf16* arow4 = ybuf + (16 * q + (lane & 15)) * XS + (lane >> 4) * 8;
  float h2[FF / 4];
#pragma unroll
  for (int i = 0; i < FF / 4; ++i) h2[i] = 0.f;
#pragma unroll 1
  for (int st = 0; st < K128_C / FR1; ++st) {
    const unsigned char* bs = ring.take();
    AFrag<bf16> af[FR1 / 16];
#pragma unroll
    for (int k = 0; k < FR1 / 16; ++k) ldsm_a(af[k], arow4 + st * FR1 + k * 16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < FR1 / 16; ++k)
      wgmma_rs<FF / 2>(h2, af[k], stage_desc(bs, FR1, wg * (FF / 128), k));
    wgmma_commit();
    wgmma_wait<0>();
    pin(h2);
    ring.release_all();
  }
  const bf16* f_b1 = static_cast<const bf16*>(a.f_b1);
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
  const bf16* arow5 = gbuf + (16 * q + (lane & 15)) * GS + (lane >> 4) * 8;
  float o2[NW2 / 2];
#pragma unroll
  for (int i = 0; i < NW2 / 2; ++i) o2[i] = 0.f;
#pragma unroll 1
  for (int st = 0; st < FF / FR2; ++st) {
    const unsigned char* bs = ring.take();
    AFrag<bf16> af[FR2 / 16];
#pragma unroll
    for (int k = 0; k < FR2 / 16; ++k) ldsm_a(af[k], arow5 + st * FR2 + k * 16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < FR2 / 16; ++k)
      wgmma_rs<NW2>(o2, af[k], stage_desc(bs, FR2, wg * (NW2 / 64), k));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o2);
    ring.release_all();
  }
  const bf16* f_b2 = static_cast<const bf16*>(a.f_b2);
  const bf16* f_sc = static_cast<const bf16*>(a.f_scale);
#pragma unroll
  for (int j = 0; j < NW2 / 8; ++j) {
    const int c = wg * NW2 + 8 * j + 2 * t;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b2 + c));
    const float2 ss = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_sc + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!oin[h]) continue;
      const int i = 4 * j + 2 * h;
      orow[h][c / 2] = __floats2bfloat162_rn((o2[i] + bb.x) * ss.x + acc[i],
                                             (o2[i + 1] + bb.y) * ss.y + acc[i + 1]);
    }
  }
}

// One 8 x 8 output tile a block, grid (tiles, B): the copy warpgroup's
// thread streams stage 1's weights and then stage 2's (wg_copy_tile, the
// chained FFW form); the consumers run the two stages.
__global__ void __launch_bounds__(WG_NT, 1)
    chain2_c128_kernel(const __grid_constant__ C2Args a, const __grid_constant__ WgMaps m1,
                       const __grid_constant__ WgMaps m2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int S = k128_stages();
  unsigned char* ring = smem;
  bf16* xn = reinterpret_cast<bf16*>(ring + (size_t)S * WG_STAGE);
  float* hid = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xn) + K128_XN);
  bf16* act = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(hid) + K128_HID);
  bf16* yt = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(act) + K128_ACT);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(yt) + K128_YT);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const FfnArgs& s1 = a.st[0];
  const FfnArgs& s2 = a.st[1];
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_COPY));
    if (tid == NT) {
      wg_copy_tile<128, false, WG_FFW2>(s1, m1, blockIdx.y, r);
      wg_copy_tile<128, false, WG_FFW2>(s2, m2, blockIdx.y, r);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_CONSUMER));
  const int H = s1.H, W = s1.W, b = blockIdx.y;
  const int tiles_x = (W + TS - 1) / TS;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;
  const bf16* x = static_cast<const bf16*>(s1.x) + (size_t)b * H * W * K128_C;
  k128_ln<K128_NI1, TS + 4, 2>(x, xn, static_cast<const bf16*>(s1.ln_w),
                               static_cast<const bf16*>(s1.ln_b), H, W, y0, x0);
  consumers_sync();
  const K128Ctx c1{xn, hid, act, xn, yt, H, W, b, y0, x0};
  k128_stage1(s1, c1, r);
  consumers_sync();  // the y tile and the interior's y are complete
  k128_ln<K128_NR, PH, 1>(nullptr, yt, static_cast<const bf16*>(s2.ln_w),
                          static_cast<const bf16*>(s2.ln_b), H, W, y0, x0);
  consumers_sync();
  const K128Ctx c2{yt, hid, act, xn, yt, H, W, b, y0, x0};
  k128_stage2(s2, c2, r);
}

static int launch_c128(const C2Args& a, cudaStream_t stream) {
  WgMaps m[2];
  for (int k = 0; k < 2; ++k) {
    const FfnArgs& s = a.st[k];
    const uint64_t c = K128_C, ch = s.CH, e = s.E, f = s.F;
    constexpr int R2 = wg_r2(128, false), FR1 = 8192 / K128_FF, FR2 = 8192 / K128_C;
    if (!encode_bf16<2>(&m[k].w1, s.w1, {ch, c}, {ch * 2}, {64, WG_KB},
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_bf16<2>(&m[k].w2, s.w2, {c, e}, {c * 2}, {64, R2},
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_bf16<2>(&m[k].fw1, s.f_w1, {f, c}, {f * 2}, {64, FR1},
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_bf16<2>(&m[k].fw2, s.f_w2, {c, f}, {c * 2}, {64, FR2},
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
  }
  const size_t smem = k128_smem();
  cudaError_t err = cudaFuncSetAttribute(chain2_c128_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const FfnArgs& s1 = a.st[0];
  const long long tiles = (long long)((s1.H + TS - 1) / TS) * ((s1.W + TS - 1) / TS);
  if (tiles > 0x7fffffffLL || s1.B > 65535) return -1;
  chain2_c128_kernel<<<dim3((unsigned)tiles, s1.B), dim3(WG_NT), smem, stream>>>(a, m[0], m[1]);
  return (int)cudaGetLastError();
}

}  // namespace turtle

// bytes of shared memory of the body that takes a call at width C with the
// given stages (F 0: no FFW)
extern "C" size_t turtle_two_stage_wg_smem(int C, int CH1, int E1, int F1, int CH2, int E2,
                                           int F2) {
  using namespace turtle;
  return C == 64 ? k64_smem(CH1, E1, CH2, E2, F1 > 0 && F2 > 0) : k128_smem();
}

// ptrs and the first 12 ints: those of turtle_two_stage_launch (chain2.cu);
// ints[12]: the persistent grid's blocks (C = 64). Returns the CUDA error
// code (0 = launched), -1 for a call these bodies do not take, -2 when a
// tensor map is refused.
extern "C" int turtle_two_stage_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                          void* stream) {
  using namespace turtle;
  C2Args a = {};
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], blocks = ints[12];
  for (int k = 0; k < 2; ++k) {
    void* const* p = ptrs + 2 + 16 * k;
    FfnArgs& s = a.st[k];
    s.x = ptrs[0]; s.out = ptrs[1];
    s.ln_w = p[0]; s.ln_b = p[1]; s.w1 = p[2]; s.b1 = p[3]; s.wd = p[4]; s.bd = p[5];
    s.w2 = p[6]; s.b2 = p[7]; s.scale = p[8];
    s.f_ln_w = p[9]; s.f_ln_b = p[10]; s.f_w1 = p[11]; s.f_b1 = p[12]; s.f_w2 = p[13];
    s.f_b2 = p[14]; s.f_scale = p[15];
    const int* q = ints + 4 + 4 * k;
    s.B = B; s.H = H; s.W = W; s.C = C;
    s.CH = q[0]; s.E = q[1]; s.gate = q[2]; s.F = q[3];
    if (s.ln_w == nullptr || s.w1 == nullptr || s.wd == nullptr || s.w2 == nullptr ||
        s.E < 1 || s.CH != (s.gate ? 2 * s.E : s.E))
      return -1;
    const bool ffw = s.f_w1 != nullptr;
    if (ffw && (s.gate || s.F != 2 * C || s.f_ln_w == nullptr || s.f_b1 == nullptr ||
                s.f_w2 == nullptr || s.f_b2 == nullptr || s.f_scale == nullptr))
      return -1;
    if (!ffw) s.F = 0;
  }
  const FfnArgs& s1 = a.st[0];
  const FfnArgs& s2 = a.st[1];
  if (!is_bf16 || B < 1 || B > 65535 || H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f1 = s1.f_w1 != nullptr, f2 = s2.f_w1 != nullptr;
  if (C == 64) {
    if (blocks < 1 || k64_smem(s1.CH, s1.E, s2.CH, s2.E, f1 && f2) > CT_SMEM_MAX) return -1;
    if (s1.gate || s1.E % 64 != 0) return -1;
    if (f1 && f2 && !s2.gate && s2.E % 64 == 0)  // the pair
      return launch_c64<false, false, true>(a, blocks, st);
    if (!f1 && !f2 && s2.gate && s2.E % 32 == 0)  // ReducedAttn + GFFW
      return launch_c64<false, true, false>(a, blocks, st);
    return -1;
  }
  if (C == 128 && f1 && f2 && !s1.gate && !s2.gate && s1.E % 128 == 0 && s2.E % 128 == 0)
    return launch_c128(a, st);
  return -1;
}
