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
// The second kernel, qkv_gram_kernel, is a persistent grid of G blocks a
// head and batch entry: block (g, head, b) walks tiles g, g + G, .. of 4 x 16
// pixels of entry b; for each it takes the head's q, k and v by the taps of
// f32_tile.cuh (four channels and four rows a thread; the head's weights in
// shared memory, loaded once a block), writes v, keeps q and
// k of the tile in shared memory and adds the tile's 64 x 64 Gram (a 4 x 4
// block of it a thread, in registers across the block's tiles) and the 128
// norms. Each block writes its head's part of one partial row (row g of
// entry b, [gram (heads, 64, 64) | sum q^2 (C) | sum k^2 (C)]) once, at the
// end; turtle_reduce_rows (qkv_stats.cu) sums the G rows in a fixed order,
// so a result does not change from run to run. The products are fp32 FMA;
// the sums run in another order than qkv_stats.cu's and the plain version's.
#include "f32_tile.cuh"

namespace turtle {

constexpr int QG_CT = 64;              // channels a head
constexpr int QG_TH = 4, QG_TW = 16;   // a tile of 4 x 16 pixels
constexpr int QG_P = QG_TH * QG_TW;

struct QkvF32Args {
  const float *h, *wd, *bd;  // h (B, H, W, 3C), wd (3, 3, 3C), bd (3C) or null
  float* v;                  // (B, H, W, C)
  float* part;               // (B, G, heads 64^2 + 2C)
  int H, W, C, heads;
};

__global__ void __launch_bounds__(256, 2) qkv_gram_kernel(const __grid_constant__ QkvF32Args a) {
  __shared__ __align__(16) float qs[QG_P][QG_CT];
  __shared__ __align__(16) float ks[QG_P][QG_CT];
  __shared__ __align__(16) float taps[3][10][QG_CT];  // the head's q, k, v: 9 taps, bias
  const int tid = threadIdx.x;
  const int g = blockIdx.x, G = gridDim.x, hd = blockIdx.y, b = blockIdx.z;
  const int H = a.H, W = a.W, C = a.C, CH = 3 * C;
  for (int idx = tid; idx < 3 * 10 * (QG_CT / 4); idx += blockDim.x) {
    const int part = idx / (10 * (QG_CT / 4)), i = idx / (QG_CT / 4) % 10,
              c = 4 * (idx % (QG_CT / 4));
    const int ch = part * C + hd * QG_CT + c;
    st4(&taps[part][i][c], i < 9 ? ldg4(a.wd + i * CH + ch)
                                 : (a.bd != nullptr ? ldg4(a.bd + ch) : zero4()));
  }
  __syncthreads();
  const int tiles_x = (W + QG_TW - 1) / QG_TW;
  const int n_tiles = ((H + QG_TH - 1) / QG_TH) * tiles_x;
  const float* hb = a.h + (long long)b * H * W * CH;
  float* vb = a.v + (long long)b * H * W * C;
  const int c4 = tid & 15, px = tid >> 4;  // taps: channels 4 c4 .., tile column px
  const int gi = tid >> 4, gj = tid & 15;  // Gram: q channels 4 gi .., k channels 4 gj ..
  float gacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
  float nacc = 0.f;  // thread t < 128: sum q^2 (t < 64) or k^2 of channel t % 64

  for (int tile = g; tile < n_tiles; tile += G) {
    const int y0 = (tile / tiles_x) * QG_TH, x = (tile % tiles_x) * QG_TW + px;
#pragma unroll 1
    for (int part = 0; part < 3; ++part) {
      const int ch = part * C + hd * QG_CT + 4 * c4;
      float(*dst)[QG_CT] = part == 0 ? qs : ks;
      const float(*tp)[QG_CT] = taps[part];
      auto tap = [&](int i) { return *reinterpret_cast<const float4*>(&tp[i][4 * c4]); };
      auto emit = [&](int r, float4 v) {
        const bool in = y0 + r < H;
        if (part < 2)
          st4(&dst[r * QG_TW + px][4 * c4], in ? v : zero4());
        else if (in)
          st4(vb + ((long long)(y0 + r) * W + x) * C + hd * QG_CT + 4 * c4, v);
      };
      if (x < W) {
        dw_column4<QG_TH, true>(hb, H, W, CH, y0, x, ch, tap, tap(9), emit);
      } else if (part < 2) {  // pixels outside the map add nothing
#pragma unroll
        for (int r = 0; r < QG_TH; ++r) st4(&dst[r * QG_TW + px][4 * c4], zero4());
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int p = 0; p < QG_P; ++p) {
      const float4 q = *reinterpret_cast<const float4*>(&qs[p][4 * gi]);
      const float4 k = *reinterpret_cast<const float4*>(&ks[p][4 * gj]);
      const float qv[4] = {q.x, q.y, q.z, q.w}, kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(qv[i], kv[j], gacc[i][j]);
    }
    if (tid < 2 * QG_CT) {
      const float(*src)[QG_CT] = tid < QG_CT ? qs : ks;
      const int ci = tid % QG_CT;
      for (int p = 0; p < QG_P; ++p) nacc = fmaf(src[p][ci], src[p][ci], nacc);
    }
    __syncthreads();  // the next tile rewrites qs and ks
  }

  float* row = a.part + ((long long)b * G + g) * (a.heads * QG_CT * QG_CT + 2 * C);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(row + hd * QG_CT * QG_CT + (4 * gi + i) * QG_CT + 4 * gj,
        make_float4(gacc[i][0], gacc[i][1], gacc[i][2], gacc[i][3]));
  if (tid < 2 * QG_CT)
    row[a.heads * QG_CT * QG_CT + (tid / QG_CT) * C + hd * QG_CT + tid % QG_CT] = nacc;
}

}  // namespace turtle

// shared memory of the body's two kernels: the product's (dynamic) for 3C
// output channels, the Gram kernel's q and k tiles (static)
extern "C" size_t turtle_qkv_f32_smem(int C) {
  const size_t gemm = turtle::f32_gemm_smem(turtle::f32_gemm_tn(3 * C));
  const size_t gram = sizeof(float) * (2 * turtle::QG_P + 30) * turtle::QG_CT;
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
  QkvF32Args a;
  a.h = hid;
  a.wd = static_cast<const float*>(ptrs[5]);
  a.bd = static_cast<const float*>(ptrs[6]);
  a.v = static_cast<float*>(ptrs[7]);
  a.part = static_cast<float*>(ptrs[8]);
  a.H = H; a.W = W; a.C = C; a.heads = heads;
  qkv_gram_kernel<<<dim3(G, heads, B), dim3(256), 0, s>>>(a);
  return (int)cudaGetLastError();
}
