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
#include "ffn_tile.cuh"

namespace turtle {

// The narrow levels (NTW <= 2) are held to 128 registers so that two blocks
// share an SM: they are bound by instruction issue and latency, and measured
// faster so (enc2's block 3.15 -> 1.9 ms on an H100) in spite of a few
// spilled registers.
template <class T, int NTW, bool FFW2, int NX>
__global__ void __launch_bounds__(NT, (NTW <= 2 ? 2 : 1)) ffn_kernel(FfnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ffn_tile<T, NTW, FFW2, NX>(a, blockIdx.y, blockIdx.x, smem);
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
  return turtle::ffn_tile_smem(C, F, has_ffw2, is_bf16, n_x2);
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
