// Fused conv-FFN half of a Turtle block, one pass over the map.
//
//   x'  = x + sum_j x2_j @ po_j (+ po_b)   (up to 5 maps x2_j, each with its
//         own matrix, per batch or shared; or one map x2 added as it is)
//   out = x' + scale * (pw2(act(dw3x3(pw1(LN x') + b1) + bd)) + b2)
//   (without wd: no dw3x3, the pointwise FFW of a block on its own)
//   act = gelu(a) * b on the two halves of the hidden axis (gate), or gelu
//   optionally followed by a pointwise FFW on y = out rounded to T:
//   out2 = y + scale2 * (pw5(gelu(pw4(LN2 y) + b4)) + b5)
//
// Replaces fused_block_ffn in turtlevsr_tpu/kernels/ffn.py: its dw branch
// (_dw_kernel / _dw_gate_cm_kernel) and, with wd absent, its no-dw branch
// (_pw_kernel), which here still computes pw1 on the halo it does not need.
// On an H100 the chain is bound by operations at the levels with C >= 128
// and by bytes at C = 64 (2*(C*CH + E*C) flop per pixel
// against 2-3 map reads and one write), so the design keeps every
// intermediate in shared memory and registers: a block owns an 8x8 tile,
// holds LN(x') of its 10x10 halo tile, and walks the hidden axis in chunks
// of 64 columns (pw1 on the halo tile -> dw -> act -> partial pw2 into
// register accumulators), so hidden widths of 2*1280 never exist anywhere.
// The three products (pw1, pw2, po) and the chained FFW run as mma.sync
// warp tiles on the bf16 tensor cores; the operands come straight from
// shared memory and from the weights in device memory (no TMA, no wgmma, no
// software pipeline yet: that is later work).
#include "common.cuh"

namespace turtle {

struct FfnArgs {
  const void *x, *po_w, *po_b, *ln_w, *ln_b, *w1, *b1, *wd, *bd, *w2, *b2, *scale;
  const void *f_ln_w, *f_ln_b, *f_w1, *f_b1, *f_w2, *f_b2, *f_scale;
  void* out;
  const void* x2[MAX_X2];  // map j of batch b starts at x2[j] + b * x2_bs[j] elements
  int x2_bs[MAX_X2];
  int B, H, W, C, CH, E, F, gate, po_batched, n_x2;
};

// NTW: 8-column output tiles per warp (C <= 64 NTW). The narrow levels
// (NTW <= 2) are held to 128 registers so that two blocks share an SM: they
// are bound by instruction issue and latency, and measured faster so (enc2's
// block 3.15 -> 1.9 ms on an H100) in spite of a few spilled registers.
// NX: the most x2 maps the instantiation takes (1, or MAX_X2 for the lists).
template <class T, int NTW, bool FFW2, int NX>
__global__ void __launch_bounds__(NT, (NTW <= 2 ? 2 : 1)) ffn_kernel(FfnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CR = 2 * NTW;
  const int C = a.C, CH = a.CH, E = a.E, H = a.H, W = a.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int XS = C + XPAD;
  const int tiles_x = (W + TS - 1) / TS;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;

  // shared memory: xn T[NPH*XS] | xres T[P*C] | hid f32[NPH*HS] | act T[P*AS]
  //                | (ffw2) gs T[P*(F+XPAD)]
  T* xn = reinterpret_cast<T*>(smem);
  T* xres = xn + NPH * XS;
  float* hid = reinterpret_cast<float*>(xres + P * C);
  T* act = reinterpret_cast<T*>(hid + NPH * HS);
  T* gs = act + P * AS;

  const size_t boff = (size_t)b * H * W * C;
  const T* x = static_cast<const T*>(a.x) + boff;
  // po_w holds one (C, C) matrix per map: (n_x2, B, C, C) or (n_x2, C, C)
  const T* x2s[NX];
  const T* pos[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const bool on = j < a.n_x2;
    x2s[j] = on ? static_cast<const T*>(a.x2[j]) + (size_t)b * a.x2_bs[j] : nullptr;
    pos[j] = (on && a.po_w)
                 ? static_cast<const T*>(a.po_w) +
                       ((size_t)j * (a.po_batched ? a.B : 1) + (a.po_batched ? b : 0)) * C * C
                 : nullptr;
  }
  // the running sum over several maps borrows the space of xres, hid and act
  ln_prologue<T, CR, NX>(x, x2s, pos, a.n_x2, static_cast<const T*>(a.po_b),
                         static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W,
                         C, y0, x0, xn, xres, reinterpret_cast<float*>(xres));

  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wd = static_cast<const T*>(a.wd);
  const T* bd = static_cast<const T*>(a.bd);
  const T* w2 = static_cast<const T*>(a.w2);

  // out[pixel][c] accumulators: column tiles 8 (warp + 8 j), four 16-pixel tiles
  float acc[NTW][MT_P][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mi = 0; mi < MT_P; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][mi][i] = 0.f;

  const int EA = a.gate ? SEG : HC;  // activation channels per chunk
  for (int e0 = 0; e0 < E; e0 += EA) {
    // pw1 on the halo tile: a gate chunk holds channels e0.. in its first
    // segment and their partners e0 + E.. in the second
    const int ne = min(EA, E - e0);
    const ChunkCols cols = a.gate ? ChunkCols{e0, ne, E + e0, ne}
                                  : ChunkCols{e0, min(ne, SEG), e0 + SEG, max(ne - SEG, 0)};
    pw1_chunk<T>(xn, w1, b1, H, W, C, CH, y0, x0, cols, hid);
    __syncthreads();
    // dw 3x3 + activation, rounded to T as the pw2 operand
    for (int item = tid; item < EA * TS; item += NT) {
      const int col = item % EA, px = item / EA;  // a thread walks down a tile column
      float va[TS], vb[TS];
      if (col < ne) {
        dw_column<T>(hid, wd, bd, CH, px, col, e0 + col, va);
        if (a.gate) dw_column<T>(hid, wd, bd, CH, px, col + SEG, E + e0 + col, vb);
      }
#pragma unroll
      for (int py = 0; py < TS; ++py) {
        float v = 0.f;
        if (col < ne) {
          v = gelu_exact(va[py]);
          if (a.gate) v *= vb[py];
        }
        act[(py * TS + px) * AS + col] = from_f<T>(v);
      }
    }
    __syncthreads();
    // partial pw2 on the 64 pixels: rows e0 .. e0 + ne of w2 (E, C)
    pixel_tile_product<T, NTW>(acc, act, AS, EA, w2 + (size_t)e0 * C, ne, C);
    // no barrier here: the next pw1 rewrites hid, last read before the
    // barrier above; the next dw rewrites act only after the barrier that
    // follows that pw1, which every warp reaches after this product
  }

  // epilogue: y = (acc + b2) * scale + x'. Nobody reads xn any more (the
  // last pw1 lies before two barriers), so its rows stage the output tile.
  const T* b2 = static_cast<const T*>(a.b2);
  const T* sc = static_cast<const T*>(a.scale);
  T* ybuf = xn;  // T[P][XS]
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (warp + NW * j) * 8 + 2 * t + (i & 1);
      if (c >= C) continue;
      const float bb = b2 ? to_f(b2[c]) : 0.f;
      const float ss = sc ? to_f(sc[c]) : 1.f;
#pragma unroll
      for (int mi = 0; mi < MT_P; ++mi) {
        const int pix = mi * 16 + g + 8 * (i >> 1);
        const float y = round_to<T>((acc[j][mi][i] + bb) * ss + to_f(xres[pix * C + c]));
        acc[j][mi][i] = y;
        ybuf[pix * XS + c] = from_f<T>(y);
      }
    }
  }
  __syncthreads();

  if constexpr (FFW2) {
    // chained pointwise FFW on y (already rounded to T):
    // out = y + scale2 * (pw5(gelu(pw4(LN2 y) + b4)) + b5)
    const int F = a.F, GS = F + XPAD;
    const T* f_w1 = static_cast<const T*>(a.f_w1);
    const T* f_b1 = static_cast<const T*>(a.f_b1);
    const T* f_w2 = static_cast<const T*>(a.f_w2);
    const T* f_b2 = static_cast<const T*>(a.f_b2);
    const T* f_sc = static_cast<const T*>(a.f_scale);
    float gw[CR], bt[CR];
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const int c = lane + 32 * j;
      gw[j] = c < C ? to_f(static_cast<const T*>(a.f_ln_w)[c]) : 0.f;
      bt[j] = (c < C && a.f_ln_b) ? to_f(static_cast<const T*>(a.f_ln_b)[c]) : 0.f;
    }
    for (int pix = warp; pix < P; pix += NW) {  // LN2 in place: y stays in acc
      float v[CR];
#pragma unroll
      for (int j = 0; j < CR; ++j)
        v[j] = lane + 32 * j < C ? to_f(ybuf[pix * XS + lane + 32 * j]) : 0.f;
      warp_layer_norm<CR>(v, lane, C, gw, bt, a.f_ln_b != nullptr);
#pragma unroll
      for (int j = 0; j < CR; ++j)
        if (lane + 32 * j < C) ybuf[pix * XS + lane + 32 * j] = from_f<T>(v[j]);
    }
    __syncthreads();
    {
      constexpr int NTF = 2 * NTW;  // F <= 2 C
      float h2[NTF][MT_P][4];
#pragma unroll
      for (int j = 0; j < NTF; ++j)
#pragma unroll
        for (int mi = 0; mi < MT_P; ++mi)
#pragma unroll
          for (int i = 0; i < 4; ++i) h2[j][mi][i] = 0.f;
      pixel_tile_product<T, NTF>(h2, ybuf, XS, C, f_w1, C, F);
#pragma unroll
      for (int j = 0; j < NTF; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = (warp + NW * j) * 8 + 2 * t + (i & 1);
          if (f >= F) continue;
          const float bb = to_f(f_b1[f]);
#pragma unroll
          for (int mi = 0; mi < MT_P; ++mi)
            gs[(mi * 16 + g + 8 * (i >> 1)) * GS + f] =
                from_f<T>(gelu_exact(h2[j][mi][i] + bb));
        }
    }
    __syncthreads();
    float o2[NTW][MT_P][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int mi = 0; mi < MT_P; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) o2[j][mi][i] = 0.f;
    pixel_tile_product<T, NTW>(o2, gs, GS, F, f_w2, F, C);
    // every warp has read LN2(y) before the barrier above: restage the output
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (warp + NW * j) * 8 + 2 * t + (i & 1);
        if (c >= C) continue;
        const float bb = to_f(f_b2[c]), ss = to_f(f_sc[c]);
#pragma unroll
        for (int mi = 0; mi < MT_P; ++mi)
          ybuf[(mi * 16 + g + 8 * (i >> 1)) * XS + c] =
              from_f<T>((o2[j][mi][i] + bb) * ss + acc[j][mi][i]);
      }
    __syncthreads();
  }

  // the staged tile goes out in 16-byte (bf16) pieces, pixel rows coalesced
  T* out = static_cast<T*>(a.out) + boff;
  const int c8n = C / 8;
  for (int idx = tid; idx < P * c8n; idx += NT) {
    const int pix = idx / c8n, c8 = (idx - pix * c8n) * 8;
    const int gy = y0 + pix / TS, gx = x0 + pix % TS;
    if (gy < H && gx < W) copy8(out + ((size_t)gy * W + gx) * C + c8, ybuf + pix * XS + c8);
  }
}

template <class T, int NTW, bool FFW2, int NX = 1>
static int launch_ffn(const FfnArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = ffn_kernel<T, NTW, FFW2, NX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// float (the comparison type) is built for C <= 128 only
template <class T>
static int dispatch_ffn(const FfnArgs& a, size_t smem, cudaStream_t stream) {
  constexpr bool wide = sizeof(T) == 2;
  if (a.C % 16 != 0) return -1;
  if (a.f_w1 != nullptr) {  // the chained FFW is built for the narrow levels only
    if (a.F > 2 * a.C || a.F % 16 != 0 || a.n_x2 > 1) return -1;
    if (a.C <= 64) return launch_ffn<T, 1, true>(a, smem, stream);
    if (a.C <= 128) return launch_ffn<T, 2, true>(a, smem, stream);
    return -1;
  }
  if (a.n_x2 > 1) {  // lists of maps: their own instantiations
    if (a.C <= 64) return launch_ffn<T, 1, false, MAX_X2>(a, smem, stream);
    if (a.C <= 128) return launch_ffn<T, 2, false, MAX_X2>(a, smem, stream);
    if constexpr (wide) {
      if (a.C <= 256) return launch_ffn<T, 4, false, MAX_X2>(a, smem, stream);
      if (a.C <= 512) return launch_ffn<T, 8, false, MAX_X2>(a, smem, stream);
    }
    return -1;
  }
  if (a.C <= 64) return launch_ffn<T, 1, false>(a, smem, stream);
  if (a.C <= 128) return launch_ffn<T, 2, false>(a, smem, stream);
  if constexpr (wide) {
    if (a.C <= 256) return launch_ffn<T, 4, false>(a, smem, stream);
    if (a.C <= 512) return launch_ffn<T, 8, false>(a, smem, stream);
  }
  return -1;
}

}  // namespace turtle

// ptrs: x, po_w, po_b, ln_w, ln_b, w1, b1, wd, bd, w2, b2, scale,
//       f_ln_w, f_ln_b, f_w1, f_b1, f_w2, f_b2, f_scale, out, x2_0 .. x2_4
//       (null = absent)
// ints: B, H, W, C, CH, E, F, gate, po_batched, n_x2, x2_bs_0 .. x2_bs_4
// is_bf16: element type of every tensor. Returns the CUDA error code
// (0 = launched), -1 for a width the kernel does not take.
extern "C" size_t turtle_ffn_smem(int C, int F, int has_ffw2, int is_bf16, int n_x2) {
  using namespace turtle;
  const size_t ts = is_bf16 ? 2 : 4;
  const size_t xn = (size_t)NPH * (C + XPAD) * ts;
  const size_t rest = ((size_t)P * C + (size_t)P * AS) * ts + (size_t)NPH * HS * 4 +
                      (has_ffw2 ? (size_t)P * (F + XPAD) * ts : 0);
  const size_t acc = n_x2 > 1 ? (size_t)NPH * C * 4 : 0;  // borrows `rest`
  return xn + (rest > acc ? rest : acc);
}

extern "C" int turtle_ffn_launch(void* const* ptrs, const int* ints, int is_bf16,
                                 void* stream) {
  using namespace turtle;
  FfnArgs a;
  a.x = ptrs[0]; a.po_w = ptrs[1]; a.po_b = ptrs[2];
  a.ln_w = ptrs[3]; a.ln_b = ptrs[4]; a.w1 = ptrs[5]; a.b1 = ptrs[6];
  a.wd = ptrs[7]; a.bd = ptrs[8]; a.w2 = ptrs[9]; a.b2 = ptrs[10]; a.scale = ptrs[11];
  a.f_ln_w = ptrs[12]; a.f_ln_b = ptrs[13]; a.f_w1 = ptrs[14]; a.f_b1 = ptrs[15];
  a.f_w2 = ptrs[16]; a.f_b2 = ptrs[17]; a.f_scale = ptrs[18]; a.out = ptrs[19];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.CH = ints[4];
  a.E = ints[5]; a.F = ints[6]; a.gate = ints[7]; a.po_batched = ints[8];
  a.n_x2 = ints[9];
  if (a.n_x2 < 0 || a.n_x2 > MAX_X2 || (a.n_x2 > 1 && a.po_w == nullptr)) return -1;
  for (int j = 0; j < MAX_X2; ++j) {
    a.x2[j] = j < a.n_x2 ? ptrs[20 + j] : nullptr;
    a.x2_bs[j] = ints[10 + j];
  }
  const size_t smem = turtle_ffn_smem(a.C, a.F, a.f_w1 != nullptr, is_bf16, a.n_x2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_ffn<__nv_bfloat16>(a, smem, s) : dispatch_ffn<float>(a, smem, s);
}
