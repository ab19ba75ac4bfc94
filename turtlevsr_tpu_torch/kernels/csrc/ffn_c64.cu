// The Hopper body of the fused conv-FFN half (row 1) for its depthwise forms
// at C = 64: bf16, a depthwise stage, and one of
//
//   * no x2 map, mode gate (E a multiple of 32) or gelu (E a multiple of 64);
//   * x2 maps with po: one map, or a list of up to CT_MAX_MAPS maps (a
//     stacked entry read in place through its batch stride), each with its
//     own po, shared (C, C) or per batch (B, C, C), po_b on the first;
//   * the chained pointwise FFW, mode gelu, no x2, F = 2 C.
//
// Replaces fused_block_ffn's dw branch in turtlevsr_tpu/kernels/ffn.py for
// these calls. ffn.py's _ffn_plan sends the forms the serving paths run at
// C = 64 here (the refinement's GFFW and ReducedAttn halves, dec1's Channel
// and CHM halves, enc1's ReducedAttn+FFW blocks); C >= 128 goes to
// ffn_wg.cu, the FFW pass without dw at C = 128, 256 to ffn_pw.cu, the rest
// (float32, other forms) to ffn.cu. What it
// computes, and where it rounds, is in the note of ffn.cu: each x2_j @ po_j
// rounded to bf16, + po_b (map 0 only) rounded again, x' = x + those summed
// in fp32 in map order and rounded, LN(x') with fp32 statistics rounded, pw1
// + b1, the hidden map zero outside the image, the nine taps in row-major
// order and + bd in fp32, the activation rounded, pw2 + b2, * scale, + x' in
// fp32 and one rounding; with the chained FFW that is y, rounded, and out =
// y + scale2 * (pw5(gelu(pw4(LN2 y) + b4)) + b5) with LN2(y) and the
// activation rounded and one rounding at the end.
//
// At C = 64 the chain does about 75 kflop a pixel against 3-6 map reads of
// 128 bytes, so an H100 could run it near its memory rate. ffn.cu ran it at
// 19-31x that bound: each block owned one 8 x 8 tile, read all of w1, w2 and
// po (about 75 KB at the gate form) from L2 warp by warp with nothing in
// flight across its barriers, recomputed pw1 on 112 rows for 64 outputs and
// met two block barriers every 32 hidden columns. Here:
//
//   * a persistent grid of one block an SM walks a contiguous range of the
//     (batch entry, tile) items, ordered by entry. The weights (w1, w2, wd,
//     the po matrices, f_w1, f_w2) are loaded into shared memory once a
//     block, in the 128-byte swizzled layout wgmma reads; a per-batch po is
//     loaded again only where the walk enters a new entry;
//   * an output tile is 16 rows x 8 columns, its halo 18 x 10 = 180 pixels,
//     three m64 tiles of pw1 (one a warpgroup) for 128 outputs: 1.4x the
//     pw1 work of the outputs where ffn.cu did 1.75x;
//   * halo tiles come in by TMA (4-D boxes, zeros outside the map) into a
//     ring of S slots, one thread issuing each load as soon as its slot is
//     free: the next tile's x (and, with po, its x2 maps) is in flight while
//     the current tile computes, and a list's map m + 1 comes in behind map
//     m's po product;
//   * po, pw1, pw2 and the chained FFW's pw4 and pw5 run as wgmma, A from
//     registers (ldmatrix from the swizzled tiles; the FFW's operands
//     straight from the accumulators of the product before), B from the
//     resident panels. The taps run on the CUDA cores from the fp32 hidden
//     chunk (64 columns: gate 32 activations, gelu 64), each thread four
//     hidden columns down its share of a tile column with a sliding window
//     of vector loads; two block barriers a chunk.
//
// The walk, the ring of halo tiles, the LN pass and the taps are
// c64_tile.cuh's, shared with row 4's C = 64 body (split_c64.cu). Every
// form's shared memory is ct_smem: the ring takes as many slots (2 to
// CT_MAX_STAGES) as fit beside the rest.
#include "c64_tile.cuh"
#include "ffn_tile.cuh"

namespace turtle {

constexpr int CT_MAX_MAPS = 4;                    // x2 maps with po

// activations a chunk, and the row stride of the activation chunk
__host__ __device__ constexpr int ct_aw(int gate) { return gate ? 32 : 64; }
__host__ __device__ constexpr int ct_as(int gate) { return ct_aw(gate) + XPAD; }

// bytes of the parts after the ring: the LN(x') halo, w1 (C x CH), w2 (E x
// C), the po matrices, f_w1 and f_w2 (C x F, F x C), the fp32 hidden chunk,
// the activation chunk, wd (9 x CH); the ring takes as many slots as fit
__host__ __device__ inline size_t ct_rest(int CH, int E, int gate, int n_po, int F) {
  return (size_t)CT_SLOT + (size_t)128 * CH + (size_t)128 * E + (size_t)n_po * CT_PANEL +
         (size_t)256 * F + (size_t)CT_NPH * CT_HS * 4 + (size_t)CT_P * ct_as(gate) * 2 +
         (size_t)18 * CH;
}
__host__ __device__ inline int ct_stages(int CH, int E, int gate, int n_po, int F) {
  const size_t rest = ct_rest(CH, E, gate, n_po, F);
  if (rest + WG_ALIGN >= CT_SMEM_MAX) return 0;
  const int s = (int)((CT_SMEM_MAX - WG_ALIGN - rest) / (CT_SLOT + sizeof(uint64_t)));
  return s < CT_MAX_STAGES ? s : CT_MAX_STAGES;
}
__host__ __device__ inline size_t ct_smem(int CH, int E, int gate, int n_po, int F) {
  const int s = ct_stages(CH, E, gate, n_po, F);
  return WG_ALIGN + (size_t)s * CT_SLOT + ct_rest(CH, E, gate, n_po, F) + s * sizeof(uint64_t);
}

struct C64Maps {
  CUtensorMap m[1 + CT_MAX_MAPS];  // x, then the x2 maps: (C, W, H, B), a halo tile a box
};

// the channel of hidden chunk column c (chunk start e0): gelu e0 + c; gate
// column 4k + i holds a channel e0 + 2k + i (i < 2) or its b partner E + e0 +
// 2k + i - 2, so that a taps thread's a and b columns are one float4
template <bool GATE>
__device__ __forceinline__ int ct_chan(int c, int e0, int E) {
  if (!GATE) return e0 + c;
  const int k = c >> 2, i = c & 3;
  return (i < 2 ? e0 : E + e0) + 2 * k + (i & 1);
}

// GATE: the mode; FFW2: the chained FFW (gelu, no x2). The loads of the
// ring, in the order the consumers take them: item by item of the block's
// range, x's halo tile and then, with po, each x2 map's. Load li goes to
// slot li % S; thread 0 starts load li + S after the barrier that follows
// the last read of load li.
template <bool GATE, bool FFW2>
__global__ void __launch_bounds__(CT_NT, 1)
    ffn_c64_kernel(const __grid_constant__ FfnArgs a, const __grid_constant__ C64Maps maps) {
  using T = __nv_bfloat16;
  constexpr int AW = ct_aw(GATE), AS = ct_as(GATE);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int H = a.H, W = a.W, E = a.E, CH = a.CH, F = FFW2 ? a.F : 0;
  const bool has_po = a.po_w != nullptr;
  const int n_po = has_po ? a.n_x2 : 0;
  const int S = ct_stages(CH, E, GATE, n_po, F);
  unsigned char* stg = smem;
  unsigned char* xn = stg + (size_t)S * CT_SLOT;
  unsigned char* w1s = xn + CT_SLOT;
  unsigned char* w2s = w1s + 128 * CH;
  unsigned char* pos = w2s + 128 * E;
  unsigned char* fw1s = pos + n_po * CT_PANEL;
  unsigned char* fw2s = fw1s + 128 * F;
  float* hid = reinterpret_cast<float*>(fw2s + 128 * F);
  T* act = reinterpret_cast<T*>(hid + CT_NPH * CT_HS);
  T* wds = act + CT_P * AS;
  uint64_t* full = reinterpret_cast<uint64_t*>(wds + 9 * CH);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  const int tiles_x = (W + CT_TW - 1) / CT_TW, nt = tiles_x * ((H + CT_TH - 1) / CT_TH);
  const long long total = (long long)a.B * nt;
  const long long it0 = total * blockIdx.x / gridDim.x;
  const long long it1 = total * (blockIdx.x + 1) / gridDim.x;
  const int L = 1 + n_po;  // loads an item
  // without po maps (one load an item, two or more slots) x' = x, and x's
  // slot is held until the next item, whose first barrier follows this
  // item's epilogue: the epilogue reads x' there. Not with the chained FFW:
  // held, its kernel spilled and ran slower on an H100 (PERF.md, row 1)
  const bool hold = n_po == 0 && !FFW2;
  const int n_loads = (int)(it1 - it0) * L;

  const CtRing ring{stg, full, S};
  auto issue = [&](int li) {  // thread 0
    const int kind = li % L;
    const CtTile tl = ct_tile(it0 + li / L, tiles_x, nt);
    const CUtensorMap* m = &maps.m[0];
#pragma unroll
    for (int i = 1; i <= CT_MAX_MAPS; ++i)
      if (kind == i) m = &maps.m[i];
    ring.load(li, m, tl.b, tl.y0, tl.x0);
  };
  auto refill = [&](int li) {
    if (tid == 0 && li + S < n_loads) issue(li + S);
  };

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0)
    for (int li = 0; li < S && li < n_loads; ++li) issue(li);

  // the weights, once a block. w1: a panel a chunk, its columns in the
  // order of ct_chan (gate: pairs of a and b columns, four-byte pieces)
  const T* w1 = static_cast<const T*>(a.w1);
  for (int ck = 0; ck < E / AW; ++ck) {
    const int e0 = ck * AW;
    if (GATE) {
      for (int idx = tid; idx < CT_C * 32; idx += CT_NT) {
        const int k = idx >> 5, c = 2 * (idx & 31);
        *reinterpret_cast<uint32_t*>(w1s + ck * CT_PANEL + sw128(k, c >> 3) + 2 * (c & 7)) =
            __ldg(reinterpret_cast<const uint32_t*>(w1 + (size_t)k * CH + ct_chan<true>(c, e0, E)));
      }
    } else {
      ct_panel(w1s + ck * CT_PANEL, w1, CH, CT_C, [&](int j) { return e0 + 8 * j; });
    }
  }
  ct_panel(w2s, static_cast<const T*>(a.w2), CT_C, E, [](int j) { return 8 * j; });
  if (FFW2) {
    const T* fw1 = static_cast<const T*>(a.f_w1);
    for (int p = 0; p < F / 64; ++p)
      ct_panel(fw1s + p * CT_PANEL, fw1, F, CT_C, [&](int j) { return 64 * p + 8 * j; });
    ct_panel(fw2s, static_cast<const T*>(a.f_w2), CT_C, F, [](int j) { return 8 * j; });
  }
  {
    const uint4* src = static_cast<const uint4*>(a.wd);
    for (int idx = tid; idx < 9 * CH / 8; idx += CT_NT)
      reinterpret_cast<uint4*>(wds)[idx] = __ldg(src + idx);
  }
  fence_proxy_async();
  __syncthreads();

  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const T* po_w = static_cast<const T*>(a.po_w);
  const T* po_b = static_cast<const T*>(a.po_b);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* bd = static_cast<const T*>(a.bd);
  const T* b2 = static_cast<const T*>(a.b2);
  const T* sc = static_cast<const T*>(a.scale);
  float gw[8], bt[8];
  {
    const int l = lane & 7;
    load8(ln_w + 8 * l, gw);
#pragma unroll
    for (int i = 0; i < 8; ++i) bt[i] = 0.f;
    if (ln_b != nullptr) load8(ln_b + 8 * l, bt);
  }
  // warpgroup wg multiplies halo rows 64 wg .. 64 wg + 63 (po, pw1); rows
  // past the 180th read row 0 and are dropped. ldmatrix row lane & 15 of
  // warp q; this thread's accumulator rows hrow[h]
  const int arow = 64 * wg + 16 * q + (lane & 15) < CT_NPH ? 64 * wg + 16 * q + (lane & 15) : 0;
  auto a_at = [&](const unsigned char* tile, int kk) {
    return reinterpret_cast<const T*>(tile + sw128(arow, 2 * kk + (lane >> 4)));
  };
  int hrow[2];
  bool hrow_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    hrow[h] = 64 * wg + 16 * q + g + 8 * h;
    hrow_ok[h] = hrow[h] < CT_NPH;
  }

  int li = 0, po_entry = -1;
#pragma unroll 1
  for (long long it = it0; it < it1; ++it) {
    const CtTile tl = ct_tile(it, tiles_x, nt);
    const int b = tl.b, y0 = tl.y0, x0 = tl.x0;
    const size_t boff = (size_t)b * H * W * CT_C;
    T* out = static_cast<T*>(a.out) + boff;
    if (has_po && (po_entry < 0 || (a.po_batched && po_entry != b))) {
      // po_m of this entry: rows (m B + b) C .. of the stacked (M, B, C, C)
      // matrices, or m C .. of (M, C, C)
      for (int m = 0; m < n_po; ++m)
        ct_panel(pos + m * CT_PANEL,
                 po_w + (size_t)(a.po_batched ? m * a.B + b : m) * CT_C * CT_C, CT_C, CT_C,
                 [](int j) { return 8 * j; });
      fence_proxy_async();
      __syncthreads();
      po_entry = b;
    }
    bool hin[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 - 1 + hrow[h] / CT_HW, gx = x0 - 1 + hrow[h] % CT_HW;
      hin[h] = hrow_ok[h] && gy >= 0 && gy < H && gx >= 0 && gx < W;
    }

    // x' and LN(x') of the halo tile into xn; with po maps x' of the
    // interior pixels also goes to the output map, which the epilogue reads
    // and overwrites
    unsigned char* xs = ring.wait(li);
    if (!has_po) {
      ct_ln_pass(xs, xn, gw, bt, ln_b != nullptr, H, W, y0, x0);
      __syncthreads();
      if (!hold) refill(li);
      else if (li >= L) refill(li - L);  // the previous item's x
    } else {
      // x at this thread's accumulator rows and columns, then the maps in
      // order, their sum in fp32 registers
      float sum[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 v = make_float2(0.f, 0.f);
          if (hrow_ok[h])
            v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + sw128(hrow[h], j) + 4 * t));
          sum[h][2 * j] = v.x;
          sum[h][2 * j + 1] = v.y;
        }
#pragma unroll 1
      for (int m = 0; m < n_po; ++m) {
        const unsigned char* ms = ring.wait(li + 1 + m);
        AFrag<T> af[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_a(af[kk], a_at(ms, kk));
        __syncthreads();  // every warp holds its fragments (and x): the slots go back
        if (m == 0) refill(li);
        refill(li + 1 + m);
        float pa[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) pa[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64>(pa, af[kk], panel_desc(pos + m * CT_PANEL + kk * 2048, CT_PANEL));
        wgmma_commit();
        wgmma_wait<0>();
        pin(pa);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 pb = make_float2(0.f, 0.f);
          if (m == 0 && po_b != nullptr)
            pb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po_b + 8 * j + 2 * t));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = round_to<T>(pa[4 * j + 2 * h + e]);
              if (m == 0 && po_b != nullptr) v = round_to<T>(v + (e ? pb.y : pb.x));
              sum[h][2 * j + e] += v;
            }
        }
      }
      // x' rounded into xn; the interior pixels' x' also into the output
      // map, where the epilogue reads it back and overwrites it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!hrow_ok[h]) continue;
        const int hy = hrow[h] / CT_HW, hx = hrow[h] % CT_HW;
        const bool interior = hin[h] && hy >= 1 && hy <= CT_TH && hx >= 1 && hx <= CT_TW;
        T* orow = interior ? out + ((size_t)(y0 - 1 + hy) * W + (x0 - 1 + hx)) * CT_C : out;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(sum[h][2 * j], sum[h][2 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(xn + sw128(hrow[h], j) + 4 * t) = v;
          if (interior) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = v;
        }
      }
      __syncthreads();
      ct_ln_pass(xn, xn, gw, bt, ln_b != nullptr, H, W, y0, x0);
      __syncthreads();
    }
    li += L;

    float acc[32];  // pw2: output pixels 64 wg .., warpgroups 0 and 1
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int e0 = 0; e0 < E; e0 += AW) {
      // pw1 on the halo tile: the chunk's 64 hidden columns. Its A operand
      // (this warp's 16 halo rows, all of K) is read again each chunk: held
      // in registers over the chunk loop, ptxas gave its registers to pw2's
      // operand, and the chunks after the first multiplied the activations
      AFrag<T> a1[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_a(a1[kk], a_at(xn, kk));
      float h1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h1[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(h1, a1[kk], panel_desc(w1s + (e0 / AW) * CT_PANEL + kk * 2048, CT_PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      pin(h1);
      // + b1, zero outside the image
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const int ch = ct_chan<GATE>(col, e0, E);  // col is even: ch, ch + 1
        const float2 bias = b1 != nullptr
                                ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + ch))
                                : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!hrow_ok[h]) continue;
          *reinterpret_cast<float2*>(hid + ct_hid(hrow[h], col)) =
              make_float2(hin[h] ? h1[4 * j + 2 * h] + bias.x : 0.f,
                          hin[h] ? h1[4 * j + 2 * h + 1] + bias.y : 0.f);
        }
      }
      __syncthreads();
      // the taps: output rows 0-5, 6-10, 11-15 a warpgroup, the activation
      // rounded into act
      auto to_act = [&](int row, int px, int k, const float (&o)[4]) {
        T* dst = act + (row * CT_TW + px) * AS;
        if (GATE) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 2 * k) =
              __floats2bfloat162_rn(gelu_exact(o[0]) * o[2], gelu_exact(o[1]) * o[3]);
        } else {
          __nv_bfloat162 v2[2] = {__floats2bfloat162_rn(gelu_exact(o[0]), gelu_exact(o[1])),
                                  __floats2bfloat162_rn(gelu_exact(o[2]), gelu_exact(o[3]))};
          *reinterpret_cast<uint2*>(dst + 4 * k) = *reinterpret_cast<const uint2*>(v2);
        }
      };
      if (wg == 0)
        ct_taps<GATE, 6>(hid, wds, bd, CH, E, e0, 0, tid & 127, to_act);
      else
        ct_taps<GATE, 5>(hid, wds, bd, CH, E, e0, wg == 1 ? 6 : 11, tid & 127, to_act);
      __syncthreads();
      // pw2: rows e0 .. e0 + AW of w2 into the accumulators of the 64 pixels
      if (wg < 2) {
        const T* arow2 = act + (64 * wg + 16 * q + (lane & 15)) * AS + (lane >> 4) * 8;
        AFrag<T> a2[AW / 16];
#pragma unroll
        for (int kk = 0; kk < AW / 16; ++kk) ldsm_a(a2[kk], arow2 + 16 * kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < AW / 16; ++kk)
          wgmma_rs<64>(acc, a2[kk], panel_desc(w2s + (e0 + 16 * kk) * 128, CT_PANEL));
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
      }
    }
    if (wg >= 2) continue;

    // epilogue: y = (acc + b2) * scale + x', one rounding; x' from x's held
    // slot (halo row ri[h]), from x, or from the output map where the x'
    // stage put it
    const T* res = has_po ? out : static_cast<const T*>(a.x) + boff;
    size_t poff[2];
    bool oin[2];
    int ri[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = 64 * wg + 16 * q + g + 8 * h;
      const int gy = y0 + pix / CT_TW, gx = x0 + pix % CT_TW;
      oin[h] = gy < H && gx < W;
      poff[h] = oin[h] ? ((size_t)gy * W + gx) * CT_C : 0;
      ri[h] = (pix / CT_TW + 1) * CT_HW + pix % CT_TW + 1;
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
        const float2 xx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            hold ? static_cast<const void*>(xs + sw128(ri[h], j) + 4 * t)
                 : static_cast<const void*>(res + poff[h] + c)));
        y[h][j] = __floats2bfloat162_rn((acc[4 * j + 2 * h] + bb.x) * ss.x + xx.x,
                                        (acc[4 * j + 2 * h + 1] + bb.y) * ss.y + xx.y);
        if (!FFW2) *reinterpret_cast<__nv_bfloat162*>(out + poff[h] + c) = y[h][j];
      }
    }
    if constexpr (FFW2) {
      // the chained FFW on y, M = 64 pixels a warpgroup. A pixel's 64
      // channels lie in the four lanes of a quad: LN2's sums by two
      // shuffles; LN2(y) and the activation become the A operands of pw4 and
      // pw5 in registers
      const T* f_ln_w = static_cast<const T*>(a.f_ln_w);
      const T* f_ln_b = static_cast<const T*>(a.f_ln_b);
      float yn[32];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = __bfloat1622float2(y[h][j]);
          s += v.x + v.y;
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const float mu = s / (float)CT_C;
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
            const float2 lb =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_ln_b + c));
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
      // pw4: N = F = 128 (two panels), K = 64
      float h2[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) h2[i] = 0.f;
      {
        AFrag<T> a4[4];
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
      const T* f_b1 = static_cast<const T*>(a.f_b1);
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
      // pw5: N = C, K = F = 128
      float o2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o2[i] = 0.f;
      {
        AFrag<T> a5[8];
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
      // out = (o2 + b5) * scale2 + y, one rounding
      const T* f_b2 = static_cast<const T*>(a.f_b2);
      const T* f_sc = static_cast<const T*>(a.f_scale);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_b2 + c));
        const float2 ss = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f_sc + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!oin[h]) continue;
          const float2 yy = __bfloat1622float2(y[h][j]);
          *reinterpret_cast<__nv_bfloat162*>(out + poff[h] + c) =
              __floats2bfloat162_rn((o2[4 * j + 2 * h] + bb.x) * ss.x + yy.x,
                                    (o2[4 * j + 2 * h + 1] + bb.y) * ss.y + yy.y);
        }
      }
    }
  }
}

template <bool GATE, bool FFW2>
static int launch_ffn_c64(const FfnArgs& a, int blocks, cudaStream_t stream) {
  C64Maps maps;
  const int n_po = a.po_w != nullptr ? a.n_x2 : 0;
  if (!ct_encode_halo(&maps.m[0], a.x, a.B, a.H, a.W, (uint64_t)a.H * a.W * CT_C)) return -2;
  for (int j = 0; j < n_po; ++j)
    if (!ct_encode_halo(&maps.m[1 + j], a.x2[j], a.B, a.H, a.W, (uint64_t)a.x2_bs[j]))
      return -2;
  auto kern = ffn_c64_kernel<GATE, FFW2>;
  const size_t smem = ct_smem(a.CH, a.E, GATE, n_po, FFW2 ? a.F : 0);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks), dim3(CT_NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_ffn_c64_smem(int CH, int E, int gate, int n_po, int F) {
  return turtle::ct_smem(CH, E, gate, n_po, F);
}

// ptrs: those of turtle_ffn_launch (ffn.cu); ints: those of it, then the
// persistent grid's blocks. Returns the CUDA error code (0 = launched), -1
// for a call this body does not take, -2 when a tensor map is refused.
extern "C" int turtle_ffn_c64_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  FfnArgs a = {};
  a.x = ptrs[0]; a.po_w = ptrs[1]; a.po_b = ptrs[2];
  a.ln_w = ptrs[3]; a.ln_b = ptrs[4]; a.w1 = ptrs[5]; a.b1 = ptrs[6];
  a.wd = ptrs[7]; a.bd = ptrs[8]; a.w2 = ptrs[9]; a.b2 = ptrs[10]; a.scale = ptrs[11];
  a.f_ln_w = ptrs[12]; a.f_ln_b = ptrs[13]; a.f_w1 = ptrs[14]; a.f_b1 = ptrs[15];
  a.f_w2 = ptrs[16]; a.f_b2 = ptrs[17]; a.f_scale = ptrs[18]; a.out = ptrs[19];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.CH = ints[4];
  a.E = ints[5]; a.F = ints[6]; a.gate = ints[7]; a.po_batched = ints[8];
  a.n_x2 = ints[9];
  const int blocks = ints[15];
  if (a.n_x2 < 0 || a.n_x2 > CT_MAX_MAPS) return -1;
  for (int j = 0; j < MAX_X2; ++j) {
    a.x2[j] = j < a.n_x2 ? ptrs[20 + j] : nullptr;
    a.x2_bs[j] = ints[10 + j];
  }
  const bool ffw2 = a.f_w1 != nullptr;
  if (!is_bf16 || a.C != CT_C || a.wd == nullptr || a.ln_w == nullptr || a.E <= 0 ||
      a.E % ct_aw(a.gate) != 0 || a.CH != (a.gate ? 2 * a.E : a.E) ||
      (a.n_x2 > 0 && a.po_w == nullptr) || blocks < 1 || a.B > 65535 ||
      (long long)a.H * a.W > 0x7fffffffLL)
    return -1;
  if (ffw2 && (a.gate || a.n_x2 != 0 || a.F != 2 * CT_C || a.f_ln_w == nullptr ||
               a.f_b1 == nullptr || a.f_w2 == nullptr || a.f_b2 == nullptr ||
               a.f_scale == nullptr))
    return -1;
  if (ct_stages(a.CH, a.E, a.gate, a.po_w != nullptr ? a.n_x2 : 0, ffw2 ? a.F : 0) < 2)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffw2) return launch_ffn_c64<false, true>(a, blocks, s);
  return a.gate ? launch_ffn_c64<true, false>(a, blocks, s)
                : launch_ffn_c64<false, false>(a, blocks, s);
}
