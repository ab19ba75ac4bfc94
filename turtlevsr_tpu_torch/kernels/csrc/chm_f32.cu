// The float32 body of the causal history model's front (row 6), one pass
// over the current map x and the NF aligned frames x_sp:
//
//   q, k, v = dw3x3(pw1(LN x))          (the ChanAttn qkv weights)
//   kh_n, vh_n = dw3x3(pw1(x_sp[n]))    (the kv weights, shared by all
//                                        frames, NO LayerNorm)
//
// Written: v (B, H, W, C) and vh (B, NF, H, W, C); q, k and every kh_n
// leave as the per-head Grams q_h^T k_h and q_h^T kh_n,h over all pixels and
// the per-channel sums of q^2, k^2 and kh_n^2, in chm_stats.cu's partial row
// layout.
//
// Replaces fused_chm_stats in turtlevsr_tpu/kernels/ffn.py
// (_chm_stats_kernel) for float32 maps with 64 channels a head, C up to 512
// (every float32 call of the paths; kernels/ffn.py's _chm_plan,
// csrc/chm_stats.cu keeps the other head widths). Bound by operations on an
// H100 (2 C (3 + 2 NF) C flop a pixel for the pointwise products against NF
// + 1 maps read and written), so it is row 3's body (qkv_f32.cu) with the
// frames beside it:
//
//   1. h = LN(x) @ w_qkv          f32_tile.cuh's product over all pixels of
//      a batch entry, the LayerNorm as its prologue (the rows' statistics
//      first): h (B, H, W, 3C)
//   2. hh = x_sp @ w_kv           the same product over the B NF frames,
//      without LayerNorm: hh (B NF, H, W, 2C)
//   3. gram_f32.cuh's Gram pass over NF + 1 parts: part 0 takes q, k, v of
//      h (v written), part n + 1 q of h and kh_n, vh_n of frame n of hh
//      (vh_n written); each adds its Gram and sums of squares in registers
//      over a chunk of at most 8 of its tiles and writes its piece of one
//      partial row a chunk, summed by
//      turtle_reduce_rows (qkv_stats.cu) in a fixed order: no atomics, a
//      launch repeats bit for bit
//
// h and hh go through device memory once (the wrapper allocates them and
// the statistics, and passes them last): 8 bytes a hidden channel and pixel.
// Full fp32 FMA (no TF32); the sums run in another order than the plain
// version's and chm_stats.cu's.
#include "gram_f32.cuh"

// shared memory of the body's kernels: the products' (dynamic) for 3C and
// 2C output channels, the Gram pass's q and k tiles (static)
extern "C" size_t turtle_chm_f32_smem(int C) {
  using namespace turtle;
  const size_t qkv = f32_gemm_smem(f32_gemm_tn(3 * C)), kv = f32_gemm_smem(f32_gemm_tn(2 * C));
  const size_t m = qkv > kv ? qkv : kv;
  return m > f32_gram_smem() ? m : f32_gram_smem();
}

// ptrs: x (B, H, W, C), x_sp (B, NF, H, W, C), ln_w, ln_b, w_qkv (C, 3C),
//       wd_qkv (3, 3, 3C), w_kv (C, 2C), wd_kv (3, 3, 2C), v, vh, part
//       (B, G R, (NF + 1) heads 64^2 + (NF + 2) C) (csrc/chm_stats.cu's), then
//       the scratch: h (B H W 3C floats), hh (B NF H W 2C floats), the
//       LayerNorm's row statistics (B H W float2)
// ints: B, H, W, C, heads, NF, G, R (partial rows a block). Every tensor
// float32. Returns the CUDA
// error code of the first launch that failed (0 = all launched), -1 for a
// call the body does not take (64 channels a head, C up to 512).
extern "C" int turtle_chm_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], heads = ints[4], NF = ints[5],
            G = ints[6], R = ints[7];
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  float* hid = static_cast<float*>(ptrs[11]);
  float* hh = static_cast<float*>(ptrs[12]);
  float2* stats = static_cast<float2*>(ptrs[13]);
  if (is_bf16 || C % 16 || C != QG_CT * heads || C > FG_LN_MAX_K || NF < 1 || B < 1 ||
      (long long)B * NF > 65535 || (long long)B * (NF + 1) > 65535 || G < 1 || H < 1 ||
      W < 1 || (long long)H * W > 0x7fffffffLL || f(2) == nullptr || hid == nullptr ||
      hh == nullptr || stats == nullptr)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long HW = (long long)H * W;
  int rc;
  {  // 1. h = LN(x) @ w_qkv
    F32Gemm g{};
    g.a[0] = f(0); g.a_bs[0] = HW * C;
    g.n_a = 1; g.seg = C;
    g.ln_w = f(2); g.ln_b = f(3); g.stats = stats;
    g.w = f(4);
    g.out = hid; g.M = (int)HW; g.N = 3 * C; g.K = C;
    if ((rc = run_f32_gemm<true, false>(g, B, s)) != 0) return rc;
  }
  {  // 2. hh = x_sp @ w_kv, the B NF frames as batch entries
    F32Gemm g{};
    g.a[0] = f(1); g.a_bs[0] = HW * C;
    g.n_a = 1; g.seg = C;
    g.w = f(6);
    g.out = hh; g.M = (int)HW; g.N = 2 * C; g.K = C;
    if ((rc = run_f32_gemm<false, false>(g, B * NF, s)) != 0) return rc;
  }
  F32GramArgs a{};  // 3. the taps, v and vh, the Grams and sums
  a.h = hid; a.wd0 = f(5);
  a.hh = hh; a.wd1 = f(7);
  a.v = static_cast<float*>(ptrs[8]);
  a.vh = static_cast<float*>(ptrs[9]);
  a.part = static_cast<float*>(ptrs[10]);
  a.H = H; a.W = W; a.C = C; a.heads = heads; a.NP = NF + 1; a.R = R;
  return run_f32_gram(a, B, G, s);
}
