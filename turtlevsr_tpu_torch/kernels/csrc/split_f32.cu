// The float32 body of the split projection (row 4): N chains
// dw3x3(pw1(LN x) + b1) + bd from one read of x, each written as its own
// map (the latent FHR blocks' q, k, v; the SAB fronts' q, k).
//
// Replaces fused_ln_split_proj in turtlevsr_tpu/kernels/ffn.py
// (_multi_dw_kernel) for float32 maps with the LayerNorm, E = C a multiple
// of 16 from 64 to 512 and 1-4 maps (every float32 call of the paths;
// kernels/ffn.py's _split_plan, csrc/split_proj.cu keeps the other float32
// calls: no LayerNorm, E != C, narrower maps). Bound by operations on an
// H100 (2 C N E flop a pixel for pw1 against one map read and N written), so
// it runs as row 1's front half on f32_tile.cuh:
//
//   1. h = LN(x) @ w1 + b1     (each row's mean and deviation first, then
//      the product over all pixels of a batch entry with LN as its A
//      stages are staged: no halo, nothing of LN(x) stored); h (B, H, W, N E)
//      is one hidden map of the N chains side by side
//   2. out_n = dw3x3(h_n) + bd_n  (split_taps_kernel below: four channels
//      and four rows a thread, the taps and a sliding window in registers;
//      channel c of h goes to map c / E)
//
// The hidden map goes through device memory once (8 bytes a hidden channel
// and pixel: 80 / C of the product's operation bound on an H100). The
// wrapper allocates h and the statistics and passes them last. Float32
// throughout, fp32 FMA (no TF32); the sums run in another order than the
// plain version's and split_proj.cu's, so the results agree within the
// float32 limits, not bit for bit; no atomics, so a launch repeats bit for
// bit.
#include "f32_tile.cuh"

namespace turtle {

struct SplitOut {
  float* out[4];
};

// out[c / E][b][y][x][c % E] for c < CH = N E: grid (ceil(W / 16), ceil(H /
// 4), B * ceil(CH / 64)); a thread owns four channels of one column and four
// rows, the nine taps of its channels in registers
__global__ void __launch_bounds__(256) split_taps_kernel(const float* __restrict__ h,
                                                         const float* __restrict__ wd,
                                                         const float* __restrict__ bd,
                                                         const __grid_constant__ SplitOut o,
                                                         int H, int W, int E, int CH, int n_cg) {
  const int tid = threadIdx.x;
  const int cg = blockIdx.z % n_cg, b = blockIdx.z / n_cg;
  const int c = (cg * 16 + (tid & 15)) * 4;
  const int x = blockIdx.x * DW_TX + (tid >> 4);
  const int y0 = blockIdx.y * DW_RT;
  if (c >= CH || x >= W) return;
  const int n = c / E, ce = c - n * E;  // E % 4 == 0: the four stay in map n
  const float* hb = h + (long long)b * H * W * CH;
  float* ob = o.out[n] + (long long)b * H * W * E;
  float4 w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = ldg4(wd + i * CH + c);
  const float4 bias = bd != nullptr ? ldg4(bd + c) : zero4();
  dw_column4<DW_RT, false>(hb, H, W, CH, y0, x, c, [&](int i) { return w[i]; }, bias,
                           [&](int r, float4 v) {
                             if (y0 + r < H) st4(ob + ((long long)(y0 + r) * W + x) * E + ce, v);
                           });
}

}  // namespace turtle

// the shared memory of the body's product blocks (dynamic, under 48 KiB;
// the taps' kernel uses none) for N E hidden channels
extern "C" size_t turtle_split_f32_smem(int n) {
  return turtle::f32_gemm_smem(turtle::f32_gemm_tn(n));
}

// ptrs: x, ln_w, ln_b, w1 (C, N E), b1, wd (3, 3, N E), bd, out_0 .. out_3
//       (csrc/split_proj.cu's), then the scratch: h (B H W N E floats), the
//       LayerNorm's row statistics (B H W float2)
// ints: B, H, W, C, E, n_out (1..4). Every tensor float32. Returns the CUDA
// error code of the first launch that failed (0 = both launched), -1 for a
// call the body does not take.
extern "C" int turtle_split_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], E = ints[4], N = ints[5];
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  float* hid = static_cast<float*>(ptrs[11]);
  float2* stats = static_cast<float2*>(ptrs[12]);
  const int CH = N * E;
  if (is_bf16 || C % 16 || C < 64 || C > FG_LN_MAX_K || E != C || N < 1 || N > 4 ||
      f(1) == nullptr || hid == nullptr || stats == nullptr || B < 1 || B > 65535 || H < 1 ||
      W < 1 || (long long)H * W > 0x7fffffffLL || (H + DW_RT - 1) / DW_RT > 65535 ||
      (long long)B * ((CH + 63) / 64) > 65535)
    return -1;
  SplitOut o{};
  for (int n = 0; n < N; ++n) {
    o.out[n] = static_cast<float*>(ptrs[7 + n]);
    if (o.out[n] == nullptr) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long HW = (long long)H * W;
  int rc;

  // 1. h = LN(x) @ w1 + b1
  {
    F32Gemm g{};
    g.a[0] = f(0); g.a_bs[0] = HW * C;
    g.n_a = 1; g.seg = C;
    g.ln_w = f(1); g.ln_b = f(2); g.stats = stats;
    g.w = f(3); g.bias = f(4);
    g.out = hid; g.M = (int)HW; g.N = CH; g.K = C;
    if ((rc = run_f32_gemm<true, false>(g, B, s)) != 0) return rc;
  }

  // 2. out_n = dw3x3(h_n) + bd_n
  const int n_cg = (CH + 63) / 64;
  const dim3 grid((W + DW_TX - 1) / DW_TX, (H + DW_RT - 1) / DW_RT, B * n_cg);
  split_taps_kernel<<<grid, dim3(256), 0, s>>>(hid, f(5), f(6), o, H, W, E, CH, n_cg);
  return (int)cudaGetLastError();
}
