// The float32 body of the channel-attention front (row 3): from one read of
// x, LN and the three chains dw3x3(pw1(LN x) + b1) + bd for q, k, v; the v
// map is written, q and k leave as the per-head Gram q^T k over all pixels
// and the per-channel sums of q^2 and k^2.
//
// Replaces fused_qkv_stats in turtlevsr_tpu/kernels/ffn.py
// (_qkv_stats_kernel) for float32 maps with 64 channels a head, C up to 512
// (every float32 call of the paths; kernels/ffn.py's _qkv_plan, csrc/
// qkv_stats.cu keeps the other head widths). Bound by operations on an H100
// (2 C 3C flop a pixel for pw1 against one map read and a third of one
// written), so pw1 runs as f32_tile.cuh's product over all the pixels of a
// batch entry (the LayerNorm as its prologue, no halo recomputed) into a
// hidden map h (B, H, W, 3C) in device memory, written once and read once.
// The second kernel is gram_f32.cuh's Gram pass (one part: the current
// map): a persistent grid of G blocks a head and batch entry, the taps, v
// written, the Gram and norms in registers, one partial row a block, summed
// by turtle_reduce_rows (qkv_stats.cu) in a fixed order, so a result does
// not change from run to run. The products are fp32 FMA; the sums run in
// another order than qkv_stats.cu's and the plain version's.
#include "gram_f32.cuh"

// shared memory of the body's two kernels: the product's (dynamic) for 3C
// output channels, the Gram kernel's q and k tiles (static)
extern "C" size_t turtle_qkv_f32_smem(int C) {
  const size_t gemm = turtle::f32_gemm_smem(turtle::f32_gemm_tn(3 * C));
  const size_t gram = turtle::f32_gram_smem();
  return gemm > gram ? gemm : gram;
}

// ptrs: x, ln_w, ln_b, w1 (C, 3C), b1, wd (3, 3, 3C), bd, v, part
//       (B, G, heads 64^2 + 2C), then the scratch: h (B H W 3C floats), the
//       LayerNorm's row statistics (B H W float2)
// ints: B, H, W, C, heads, G. Every tensor float32. Returns the CUDA error
// code of the first launch that failed (0 = both launched), -1 for a call
// the body does not take (64 channels a head, C up to 512).
extern "C" int turtle_qkv_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], heads = ints[4], G = ints[5];
  if (is_bf16 || C % 16 || C != QG_CT * heads || C > FG_LN_MAX_K || B < 1 || B > 65535 ||
      G < 1 || H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL || ptrs[9] == nullptr ||
      ptrs[10] == nullptr)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long HW = (long long)H * W;
  float* hid = static_cast<float*>(ptrs[9]);
  {  // h = LN(x) @ w1 + b1
    F32Gemm g{};
    g.a[0] = static_cast<const float*>(ptrs[0]); g.a_bs[0] = HW * C;
    g.n_a = 1; g.seg = C;
    g.ln_w = static_cast<const float*>(ptrs[1]); g.ln_b = static_cast<const float*>(ptrs[2]);
    g.stats = static_cast<float2*>(ptrs[10]);
    g.w = static_cast<const float*>(ptrs[3]); g.bias = static_cast<const float*>(ptrs[4]);
    g.out = hid; g.M = (int)HW; g.N = 3 * C; g.K = C;
    const int rc = run_f32_gemm<true, false>(g, B, s);
    if (rc != 0) return rc;
  }
  F32GramArgs a{};
  a.h = hid;
  a.wd0 = static_cast<const float*>(ptrs[5]);
  a.bd0 = static_cast<const float*>(ptrs[6]);
  a.v = static_cast<float*>(ptrs[7]);
  a.part = static_cast<float*>(ptrs[8]);
  a.H = H; a.W = W; a.C = C; a.heads = heads; a.NP = 1; a.R = 1;
  return run_f32_gram(a, B, G, s);
}
