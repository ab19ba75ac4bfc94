// The float32 body of the fused conv-FFN half of a Turtle block (row 1):
//
//   x'  = x + sum_j x2_j @ po_j (+ po_b)   (up to 5 maps, each with its own
//         matrix, per batch or shared; or one map x2 added as it is)
//   out = x' + scale * (pw2(act(dw3x3(pw1(LN x') + b1) + bd)) + b2)
//   act = gelu(a) * b on the two halves of the hidden axis (gate), or gelu
//   optionally followed by a pointwise FFW on y = out:
//   out2 = y + scale2 * (pw5(gelu(pw4(LN2 y) + b4)) + b5)
//
// Replaces fused_block_ffn in turtlevsr_tpu/kernels/ffn.py (its dw branch,
// _dw_kernel / _dw_gate_cm_kernel) for float32 maps; kernels/ffn.py's
// _ffn_plan sends it every float32 call with a depthwise stage, C a multiple
// of 16 up to 512 and E a multiple of 4 (csrc/ffn.cu keeps the other float32
// calls: no depthwise stage, other hidden widths). Bound by operations on an
// H100 at every width of the paths (float32 FMA, 67 TFLOP/s): the design
// (f32_tile.cuh) runs each product as a register-blocked tile over all the
// pixels of a batch entry, with no halo to recompute, and passes the hidden
// map through device memory once:
//
//   1. x' = x + [x2_0 | x2_1 | ..] @ [po_0; po_1; ..] + po_b  (one product,
//      K = n_x2 C; only with po)
//   2. h  = LN(x') @ w1 + b1        (each row's mean and deviation first,
//      then LN as the product's A stages are staged; x' = x + x2 summed as
//      it is read where the map has no po)
//   3. a  = act(dw3x3(h) + bd)      (dw_act_kernel below: four channels and
//      four rows a thread, the taps and a sliding window in registers)
//   4. y  = x' + scale * (a @ w2 + b2)
//   5. with the chained FFW: g = gelu(LN2(y) @ f_w1 + f_b1), then
//      out = y + f_scale * (g @ f_w2 + f_b2)
//
// The wrapper allocates x', h, a (and y, g) and passes them last. Float32
// throughout: the sums run in another order than the plain version's (and
// than ffn.cu's), so the results agree within the float32 limits, not bit
// for bit.
#include "f32_tile.cuh"

namespace turtle {

// act[b][y][x][c..c+3] for c < E: grid (ceil(W / 16), ceil(H / 4), B *
// ceil(E / 64)); a thread owns four channels of one column and four rows,
// the nine taps of its channels in registers
__global__ void __launch_bounds__(256) dw_act_kernel(const float* __restrict__ h,
                                                     const float* __restrict__ wd,
                                                     const float* __restrict__ bd,
                                                     float* __restrict__ act, int H, int W,
                                                     int E, int CH, int gate, int n_eg) {
  const int tid = threadIdx.x;
  const int eg = blockIdx.z % n_eg, b = blockIdx.z / n_eg;
  const int c = (eg * 16 + (tid & 15)) * 4;
  const int x = blockIdx.x * DW_TX + (tid >> 4);
  const int y0 = blockIdx.y * DW_RT;
  if (c >= E || x >= W) return;
  const float* hb = h + (long long)b * H * W * CH;
  float* ab = act + (long long)b * H * W * E;
  float4 va[DW_RT];
  auto taps = [&](int ch, float4 (&w)[9]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = ldg4(wd + i * CH + ch);
    return bd != nullptr ? ldg4(bd + ch) : zero4();
  };
  float4 w[9];
  float4 bias = taps(c, w);
  dw_column4<DW_RT, false>(hb, H, W, CH, y0, x, c, [&](int i) { return w[i]; }, bias,
                    [&](int r, float4 v) { va[r] = v; });
  if (gate) {  // gelu(a) * b, b the partner channel E + c
    bias = taps(E + c, w);
    dw_column4<DW_RT, false>(hb, H, W, CH, y0, x, E + c, [&](int i) { return w[i]; }, bias,
                      [&](int r, float4 v) { va[r] = mul4(gelu4(va[r]), v); });
  } else {
#pragma unroll
    for (int r = 0; r < DW_RT; ++r) va[r] = gelu4(va[r]);
  }
#pragma unroll
  for (int r = 0; r < DW_RT; ++r)
    if (y0 + r < H) st4(ab + ((long long)(y0 + r) * W + x) * E + c, va[r]);
}

}  // namespace turtle

// the shared memory of the body's product blocks for outputs of n channels
// (dynamic, under 48 KiB; the taps' kernel uses none)
extern "C" size_t turtle_ffn_f32_smem(int n) {
  return turtle::f32_gemm_smem(turtle::f32_gemm_tn(n));
}

// ptrs: x, po_w, po_b, ln_w, ln_b, w1, b1, wd, bd, w2, b2, scale,
//       f_ln_w, f_ln_b, f_w1, f_b1, f_w2, f_b2, f_scale, out, x2_0 .. x2_4
//       (csrc/ffn.cu's), then the scratch: xp (x', B H W C floats; with po),
//       h (B H W CH), a (B H W E), y (B H W C) and g (B H W F) (with the
//       chained FFW), the LayerNorms' row statistics (B H W float2); po_w
//       is (n_x2, [B,] C, C) or one ([B,] C, C)
// ints: B, H, W, C, CH, E, F, gate, po_batched, n_x2, x2_bs_0 .. x2_bs_4
// Every tensor float32. Returns the CUDA error code of the first launch that
// failed (0 = all launched), -1 for a call the body does not take.
extern "C" int turtle_ffn_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], CH = ints[4], E = ints[5],
            F = ints[6], gate = ints[7], po_batched = ints[8], n_x2 = ints[9];
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  const float* x = f(0);
  const float* po = f(1);
  const float* f_w1 = f(14);
  float* out = static_cast<float*>(ptrs[19]);
  float* xp = static_cast<float*>(ptrs[25]);
  float* hid = static_cast<float*>(ptrs[26]);
  float* act = static_cast<float*>(ptrs[27]);
  float* y = static_cast<float*>(ptrs[28]);
  float* gs = static_cast<float*>(ptrs[29]);
  float2* stats = static_cast<float2*>(ptrs[30]);
  if (is_bf16 || C % 16 || C < 16 || C > FG_LN_MAX_K || E % 4 || E < 4 ||
      CH != (gate ? 2 * E : E) || f(7) == nullptr || n_x2 < 0 || n_x2 > MAX_X2 ||
      (n_x2 > 1 && po == nullptr) || (po != nullptr && (n_x2 < 1 || xp == nullptr)) ||
      hid == nullptr || act == nullptr || stats == nullptr || B < 1 || B > 65535 || H < 1 ||
      W < 1 ||
      (long long)H * W > 0x7fffffffLL || (H + DW_RT - 1) / DW_RT > 65535 ||
      (long long)B * ((E + 63) / 64) > 65535 ||
      (f_w1 != nullptr && (F % 16 || F < 16 || y == nullptr || gs == nullptr)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long HW = (long long)H * W, map_bs = HW * C;
  const int M = (int)HW;
  int rc;

  // 1. x' = x + sum_j x2_j @ po_j + po_b
  const float* xr = x;  // x' as the later steps read it
  const float* x2 = nullptr;  // a map added as it is (no po)
  long long x2_bs = 0;
  if (po != nullptr) {
    F32Gemm g{};
    for (int j = 0; j < n_x2; ++j) {
      g.a[j] = f(20 + j);
      g.a_bs[j] = ints[10 + j];
    }
    g.n_a = n_x2; g.seg = C;
    g.w = po; g.w_ms = (long long)(po_batched ? B : 1) * C * C;
    g.w_bs = po_batched ? (long long)C * C : 0;
    g.bias = f(2); g.resid = 1; g.r0 = x; g.r0_bs = map_bs;
    g.out = xp; g.M = M; g.N = C; g.K = n_x2 * C;
    if ((rc = run_f32_gemm<false, true>(g, B, s)) != 0) return rc;
    xr = xp;
  } else if (n_x2 == 1) {
    x2 = f(20);
    x2_bs = ints[10];
  }

  // 2. h = LN(x') @ w1 + b1
  {
    F32Gemm g{};
    g.a[0] = xr; g.a_bs[0] = map_bs;
    g.a[1] = x2; g.a_bs[1] = x2_bs;
    g.n_a = x2 != nullptr ? 2 : 1; g.seg = C;
    g.ln_w = f(3); g.ln_b = f(4); g.stats = stats;
    g.w = f(5); g.bias = f(6);
    g.out = hid; g.M = M; g.N = CH; g.K = C;
    if ((rc = run_f32_gemm<true, false>(g, B, s)) != 0) return rc;
  }

  // 3. a = act(dw3x3(h) + bd)
  {
    const int n_eg = (E + 63) / 64;
    const dim3 grid((W + DW_TX - 1) / DW_TX, (H + DW_RT - 1) / DW_RT, B * n_eg);
    dw_act_kernel<<<grid, dim3(256), 0, s>>>(hid, f(7), f(8), act, H, W, E, CH, gate, n_eg);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }

  // 4. y = x' + scale * (a @ w2 + b2)
  float* y_out = f_w1 != nullptr ? y : out;
  {
    F32Gemm g{};
    g.a[0] = act; g.a_bs[0] = HW * E; g.n_a = 1; g.seg = E;
    g.w = f(9); g.bias = f(10); g.scale = f(11);
    g.resid = 1; g.r0 = xr; g.r0_bs = map_bs; g.r1 = x2; g.r1_bs = x2_bs;
    g.out = y_out; g.M = M; g.N = C; g.K = E;
    if ((rc = run_f32_gemm<false, false>(g, B, s)) != 0) return rc;
  }
  if (f_w1 == nullptr) return 0;

  // 5. the chained FFW: g = gelu(LN2(y) @ f_w1 + f_b1); out = y + f_scale *
  //    (g @ f_w2 + f_b2)
  {
    F32Gemm g{};
    g.a[0] = y; g.a_bs[0] = map_bs; g.n_a = 1; g.seg = C;
    g.ln_w = f(12); g.ln_b = f(13); g.stats = stats;
    g.w = f_w1; g.bias = f(15); g.gelu = 1;
    g.out = gs; g.M = M; g.N = F; g.K = C;
    if ((rc = run_f32_gemm<true, false>(g, B, s)) != 0) return rc;
  }
  {
    F32Gemm g{};
    g.a[0] = gs; g.a_bs[0] = HW * F; g.n_a = 1; g.seg = F;
    g.w = f(16); g.bias = f(17); g.scale = f(18);
    g.resid = 1; g.r0 = y; g.r0_bs = map_bs;
    g.out = out; g.M = M; g.N = C; g.K = F;
    if ((rc = run_f32_gemm<false, false>(g, B, s)) != 0) return rc;
  }
  return 0;
}
