// The Hopper body of the fused conv-FFN half (row 1) for its depthwise forms
// at C >= 128: bf16, a depthwise stage, E a multiple of 32, and one of
//
//   * at most one x2 map (with or without po, shared (C, C) or per batch
//     (B, C, C), with or without po_b), mode gate or gelu, C in {128, 256,
//     512};
//   * a list of 2 to MAX_X2 maps, each with its own po (the value maps of the
//     causal history model, a stacked entry read in place through its batch
//     stride), mode gate, C in {128, 256};
//   * the chained pointwise FFW (a ReducedAttn+FFW block in one pass), mode
//     gelu, no x2, C = 128 and F = 2 C.
//
// ffn.py's _ffn_plan sends every such call here, the depthwise forms at C =
// 64 to ffn_c64.cu and every other one (no dw, float32, other widths) to
// ffn.cu's mma.sync body. What it computes,
// and where it rounds, is in the note of ffn.cu: each x2_j @ po_j rounded to
// bf16, + po_b (map 0 only) rounded again, x' = x + those summed in fp32 in
// map order and rounded, LN(x') with fp32 statistics rounded, pw1 + b1, the
// nine taps in row-major order and + bd in fp32 (the hidden map zero outside
// the image after pw1 and its bias), gelu(a) * b rounded to bf16, pw2 + b2,
// * scale, + x' in fp32 and one rounding; with the chained FFW that is y,
// and out = y + scale2 * (pw5(gelu(pw4(LN2 y) + b4)) + b5) with LN2(y) and
// the activation rounded to bf16 and one rounding at the end.
//
// The chain is bound by operations at C >= 128 (about 17 C^2 flop a pixel
// against 6 C bytes). What held ffn.cu's body back was the weights: every
// 64-pixel block read all of w1, w2 and po from device memory per warp, a
// few k-steps ahead, with nothing in flight across its block barriers. Here
// a block still owns one 8 x 8 tile of outputs and LN(x') of its 10 x 10
// halo (the 100 halo rows run as two m64 tiles of wgmma, one per consumer
// warpgroup), but:
//
//   * po, w1 and w2 stream through a ring of 16 KB stages in shared memory,
//     in the 128-byte swizzled layout wgmma reads, filled by TMA from a copy
//     warpgroup on full / empty mbarriers: the loads run ahead of the
//     products, across the block barriers of the chunk loop, and no
//     consumer thread spends an instruction on them;
//   * the three products run as wgmma, A from registers by ldmatrix, B from
//     the ring. po: x2's halo tile, all of K in registers, 128 columns a
//     pass. pw1: a chunk of 64 activation columns (gate: the panels e0.. and
//     E + e0.. of w1; gelu: 128 columns) with N = 128 on the halo tile; the
//     dw taps from an fp32 chunk in shared memory. pw2: K = the chunk, into
//     register accumulators of the 64 pixels, warpgroup w owning columns
//     [w C / 2, (w + 1) C / 2). One wgmma group a ring stage, one group left
//     in flight, so the tensor cores run from pw2 into the next pw1;
//   * two block barriers per chunk of 64 activation columns (ffn.cu: per
//     32), none between the copies and the products; the copy warpgroup
//     gives its registers to the consumers (setmaxnreg).
//
// x' of the 64 interior pixels goes to the output map in the prologue and
// comes back from there (L2) in the epilogue, which overwrites it: shared
// memory holds the ring, the halo, the fp32 hidden chunk and the activation
// chunk only, and the two other forms live in those regions while they are
// idle, so every form of a width takes the same shared memory:
//
//   * lists: x' needs a sum in fp32 over the maps. A pass of 128 columns of
//     po keeps it in registers, from x on, and runs the maps in order: map
//     m's halo tile is staged in the hid chunk (free until pw1; 100 x C
//     bf16, 16-byte pieces swizzled by the row), taken with all of its K
//     into registers, and the next map's tile comes in by cp.async behind
//     map m's products; po_m streams through the ring like po. At C = 256
//     the tiles come in once a pass (two passes): registers hold one pass's
//     sum, not all of C;
//   * the chained FFW: after pw2 the two warpgroups hold half of y's columns
//     each, and LN2 needs a pixel's whole row, so y (rounded) meets in the
//     LN halo's space, LN2(y) overwrites it there, pw4 (N = F split between
//     the warpgroups) and pw5 (N = C, the columns of each warpgroup's y) run
//     as two M = 64 products, the activation in the hid chunk's space, f_w1
//     and f_w2 through the ring after the last chunk's w2.
//
// C = 64 has a body of its own, ffn_c64.cu: there the chain is bound by the
// dw taps, the hidden map's stores and the prologue, not by the products,
// and this body, with its 16 KB ring stages and its 100 halo rows padded to
// 128 a tile, was not faster than ffn.cu on an H100 (PERF.md, row 1).
#include "ffn_wg.cuh"

namespace turtle {

// C: the map's width (128, 256, 512); GATE: the mode; FORM: a WgForm. One
// 8 x 8 output tile a block, grid (tiles, B); the ring's loads and their
// order are wg_copy_tile's (ffn_wg.cuh).
template <int C, bool GATE, int FORM>
__global__ void __launch_bounds__(WG_NT, 1)
    ffn_wg_kernel(const __grid_constant__ FfnArgs a, const __grid_constant__ WgMaps maps) {
  using T = __nv_bfloat16;
  constexpr int AS = wg_aw(GATE) + XPAD, XS = C + XPAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int S = wg_stages(C, GATE);
  unsigned char* ring = smem;
  T* xn = reinterpret_cast<T*>(ring + (size_t)S * WG_STAGE);
  float* hid = reinterpret_cast<float*>(xn + NPH * XS);
  T* act = reinterpret_cast<T*>(hid + NPH * WG_HS);
  uint64_t* full = reinterpret_cast<uint64_t*>(act + P * AS);
  uint64_t* empty = full + S;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_COPY));
    if (tid == NT) wg_copy_tile<C, GATE, FORM>(a, maps, blockIdx.y, r);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_CONSUMER));
  wg_tile<C, GATE, FORM>(a, static_cast<const T*>(a.x), static_cast<T*>(a.out),
                         static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b),
                         static_cast<const T*>(a.wd), blockIdx.y, blockIdx.x, r, xn, hid, act);
}

template <int C, bool GATE, int FORM>
static int launch_ffn_wg(const FfnArgs& a, cudaStream_t stream) {
  WgMaps maps;
  const uint64_t c = a.C, ch = a.CH, e = a.E, f = a.F;
  // po: one (C, C) matrix a map, per batch entry or shared
  const uint64_t po_rows = (uint64_t)(FORM == WG_LIST ? a.n_x2 : 1) *
                           (a.po_batched ? (uint64_t)a.B : 1) * c;
  constexpr int R2 = wg_r2(C, GATE), FR1 = 8192 / (2 * C), FR2 = 8192 / C;
  if (!encode_bf16<2>(&maps.w1, a.w1, {ch, c}, {ch * 2}, {64, WG_KB},
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<2>(&maps.w2, a.w2, {c, e}, {c * 2}, {64, R2}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (a.po_w != nullptr && !encode_bf16<2>(&maps.po, a.po_w, {c, po_rows}, {c * 2},
                                             {64, WG_KB}, CU_TENSOR_MAP_SWIZZLE_128B)))
    return -2;
  if (FORM == WG_FFW2 &&
      (!encode_bf16<2>(&maps.fw1, a.f_w1, {f, c}, {f * 2}, {64, FR1},
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
       !encode_bf16<2>(&maps.fw2, a.f_w2, {c, f}, {c * 2}, {64, FR2},
                       CU_TENSOR_MAP_SWIZZLE_128B)))
    return -2;
  auto kern = ffn_wg_kernel<C, GATE, FORM>;
  const size_t smem = wg_smem(C, GATE);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS);
  if (tiles > 0x7fffffffLL || a.B > 65535) return -1;
  kern<<<dim3((unsigned)tiles, a.B), dim3(WG_NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

template <bool GATE>
static int dispatch_ffn_wg(const FfnArgs& a, cudaStream_t stream) {
  switch (a.C) {
    case 128: return launch_ffn_wg<128, GATE, WG_ONE>(a, stream);
    case 256: return launch_ffn_wg<256, GATE, WG_ONE>(a, stream);
    case 512: return launch_ffn_wg<512, GATE, WG_ONE>(a, stream);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_ffn_wg_smem(int C, int gate) { return turtle::wg_smem(C, gate); }

// ptrs and ints: those of turtle_ffn_launch (ffn.cu). Returns the CUDA error
// code (0 = launched), -1 for a call this body does not take, -2 when a
// tensor map is refused.
extern "C" int turtle_ffn_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
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
  if (a.n_x2 < 0 || a.n_x2 > MAX_X2) return -1;
  for (int j = 0; j < MAX_X2; ++j) {
    a.x2[j] = j < a.n_x2 ? ptrs[20 + j] : nullptr;
    a.x2_bs[j] = ints[10 + j];
  }
  if (!is_bf16 || a.wd == nullptr || a.ln_w == nullptr || a.E % 32 != 0 ||
      a.CH != (a.gate ? 2 * a.E : a.E) || (a.po_w != nullptr && a.n_x2 < 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.f_w1 != nullptr) {  // the chained FFW: gelu, no x2, C = 128, F = 2 C
    if (a.gate || a.n_x2 != 0 || a.C != 128 || a.F != 2 * a.C || a.f_ln_w == nullptr ||
        a.f_b1 == nullptr || a.f_w2 == nullptr || a.f_b2 == nullptr || a.f_scale == nullptr)
      return -1;
    return launch_ffn_wg<128, false, WG_FFW2>(a, s);
  }
  if (a.n_x2 > 1) {  // lists: gate, a po a map, C = 128 or 256
    if (!a.gate || a.po_w == nullptr) return -1;
    if (a.C == 128) return launch_ffn_wg<128, true, WG_LIST>(a, s);
    if (a.C == 256) return launch_ffn_wg<256, true, WG_LIST>(a, s);
    return -1;
  }
  return a.gate ? dispatch_ffn_wg<true>(a, s) : dispatch_ffn_wg<false>(a, s);
}
