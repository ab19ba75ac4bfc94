// The float32 body of the dense 3x3 stride-1 pad-1 convolution (row 5) on an
// NHWC map, weight (3, 3, Cin, Cout), optional bias, optional channel
// LayerNorm in front (zero padding of LN(x): pixels outside the image stay
// zero after the normalisation).
//
// Replaces fused_conv3x3 in turtlevsr_tpu/kernels/ffn.py (_conv3_kernel) for
// float32 maps; kernels/ffn.py's _conv_plan sends it every float32 call
// (csrc/conv3x3.cu's float tile, which read its fragments element by element
// and ran the products through common.cuh's shuffled tile_mma, keeps none on
// the paths). On an H100 in float32 the wide convs are bound by operations
// (18 Cin Cout flop a pixel against 4 (Cin + Cout) bytes: up4_3 512->1024,
// up3_2, up2_1, the LayerNorm forms, down3_4 and down2_3), the ending conv
// 64->3 and the input conv 3->64 by bytes. Two bodies:
//
//   * the implicit GEMM (f32_tile.cuh's hooked product, ConvP below): per
//     batch entry M = H W output pixels, N = Cout, K = 9 Cin with k = tap Cin
//     + c, the weight as its (9 Cin, Cout) matrix. A thread keeps the pixel
//     index of the A rows it stages and a mask of the taps whose source lies
//     in the image; A[m][k] is pixel (y + dy - 1, x + dx - 1) of k's tap, an
//     offset of the launch's table from the row's pixel, zeros outside the
//     image (k's tap by a shift where Cin is a power of two); with the
//     LayerNorm each row's mean and deviation come from a statistics kernel
//     run first on x (f32_row_stats_kernel, one float2 a pixel in a scratch
//     the wrapper allocates) and the loader normalises the source pixel's
//     four channels as it stages them (no halo, no LN(x) in device memory).
//     Cin not a
//     multiple of 4 (the 3-channel input) gathers element by element, K padded
//     with zeros to the stage (27 -> 32). Cout not a multiple of 4 takes
//     element loads and stores at the column tail. The tile kind by Cout
//     (kernels/ffn.py _conv_f32_geometry chooses it): 128 x 128 outputs a
//     block above 64 channels (FP_WIDE; FP_RING at Cin >= 512 without the
//     LayerNorm), 128 x 64 up to 64 (FP_HALF_W), 256 x 32 up to 32
//     (FP_QUARTER: down1_2 64->32 would leave half of a 64-column tile
//     empty), 64 x 64 (FP_SMALL) where the grid would have fewer blocks than
//     half the SMs; bias in fp32 and one store.
//   * conv_narrow_kernel, Cout <= 4 without the LayerNorm, Cin a multiple of
//     4 (the ending conv 64->3, +bias): a 64-column tile would be 21x
//     empty, and the conv is bound by the map's bytes, so it aims at that
//     bound: a block of 32 x 32 output pixels stages the 34 x 34 input halo
//     16 channels at a time in shared memory by cp.async (zeros outside the
//     image), each thread owns four pixels of a column and every output
//     channel of them, the weights of three taps in registers while it walks
//     the input rows.
// Sums in fp32 FMA, full float32 (no TF32), in another order than the plain
// version's, so the results agree within the float32 limits.
#include "f32_tile.cuh"

namespace turtle {

struct ConvF32Args {
  const float* x;       // (B, H, W, Cin)
  const float* w;       // (9 Cin, Cout)
  const float* bias;    // (Cout) or null
  const float* ln_w;    // (Cin) or null: no LayerNorm
  const float* ln_b;    // (Cin) or null: bias-free LayerNorm
  const float2* stats;  // LayerNorm: (mean, 1 / deviation) of each pixel, (B, H W)
  float* out;           // (B, H, W, Cout)
  int H, W, Cin, Cout;
  int cin_shift;   // log2 Cin where Cin is a power of two, else -1
  int tap_px[9];   // the pixel offset of tap t = 3 dy + dx: (dy - 1) W + dx - 1
  int M, N, K;
};

struct ConvP {
  using Args = ConvF32Args;
  static constexpr unsigned KINDS =
      1u << FP_WIDE | 1u << FP_RING | 1u << FP_HALF_W | 1u << FP_QUARTER | 1u << FP_SMALL;
  struct Row {
    long long px;  // the output pixel's index in the batch, (n H + y) W + x
    int mask;      // bit t: tap t's source pixel lies in the image (0 for rows >= M)
  };
  static __device__ __forceinline__ Row row(const Args& a, int n, int m) {
    if (m >= a.M) return {0, 0};
    const int y = m / a.W, x = m - y * a.W;
    int mask = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
      mask |= (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) << t;
    }
    return {(long long)n * a.M + m, mask};
  }
  static __device__ __forceinline__ const float* any(const Args& a) { return a.x; }
  static __device__ __forceinline__ int tap(const Args& a, int k) {
    return a.cin_shift >= 0 ? k >> a.cin_shift : k / a.Cin;
  }
  // the source pixel of tap t for row r, -1 outside the image
  static __device__ __forceinline__ long long src(const Args& a, Row r, int t) {
    return (r.mask >> t) & 1 ? r.px + a.tap_px[t] : -1;
  }
  static __device__ __forceinline__ float4 load_a(const Args& a, int n, Row r, int k) {
    if (a.Cin % 4 == 0) {  // the four k of one tap
      if (k >= a.K) return zero4();
      const int t = tap(a, k), c = k - t * a.Cin;
      const long long p = src(a, r, t);
      if (p < 0) return zero4();
      float4 v = ldg4(a.x + p * a.Cin + c);
      if (a.ln_w != nullptr) {
        const float2 st = a.stats[p];
        const float4 g = ldg4(a.ln_w + c);
        if (a.ln_b != nullptr) {
          const float4 bt = ldg4(a.ln_b + c);
          v = make_float4((v.x - st.x) * st.y * g.x + bt.x, (v.y - st.x) * st.y * g.y + bt.y,
                          (v.z - st.x) * st.y * g.z + bt.z, (v.w - st.x) * st.y * g.w + bt.w);
        } else {
          v = make_float4(v.x * st.y * g.x, v.y * st.y * g.y, v.z * st.y * g.z, v.w * st.y * g.w);
        }
      }
      return v;
    }
    float e[4];  // gathered element by element (no LayerNorm here)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = 0.f;
      const int kk = k + i;
      if (kk < a.K) {
        const int t = kk / a.Cin, c = kk - t * a.Cin;
        const long long p = src(a, r, t);
        if (p >= 0) e[i] = __ldg(a.x + p * a.Cin + c);
      }
    }
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ const float* a_ptr(const Args& a, int n, Row r, int k,
                                                       int& valid) {
    valid = 0;
    if (k >= a.K) return nullptr;
    const int t = tap(a, k), c = k - t * a.Cin;
    const long long p = src(a, r, t);
    if (p < 0) return nullptr;
    valid = 4;
    return a.x + p * a.Cin + c;
  }
  static __device__ __forceinline__ float4 load_b(const Args& a, int n, int k, int c) {
    if (k >= a.K || c >= a.N) return zero4();
    const float* p = a.w + (long long)k * a.N + c;
    if (a.N % 4 == 0) return ldg4(p);
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = c + i < a.N ? __ldg(p + i) : 0.f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ const float* b_ptr(const Args& a, int n, int k, int c) {
    return k < a.K && c < a.N ? a.w + (long long)k * a.N + c : nullptr;
  }
  static __device__ __forceinline__ void store(const Args& a, int n, int m, int c, float4 v) {
    float* p = a.out + ((long long)n * a.M + m) * a.N + c;
    if (a.N % 4 == 0) {
      if (a.bias != nullptr) v = add4(v, ldg4(a.bias + c));
      st4(p, v);
      return;
    }
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < a.N) p[i] = e[i] + (a.bias != nullptr ? __ldg(a.bias + c + i) : 0.f);
  }
};

// the narrow body: 32 x 32 output pixels a block, 256 threads (32 columns x
// 8 groups of 4 rows), the input halo 16 channels at a time
constexpr int CN_T = 32, CN_RT = 4, CN_CC = 16;
constexpr int CN_H = CN_T + 2;           // halo side
constexpr int CN_PS = CN_CC + 4;         // pixel stride of the staged halo (floats)
constexpr int CN_SMEM = (CN_H * CN_H * CN_PS + 9 * CN_CC * 4) * 4;

__global__ void __launch_bounds__(256, 2) conv_narrow_kernel(const __grid_constant__ ConvF32Args a) {
  extern __shared__ __align__(16) float cn_smem[];
  float* xs = cn_smem;                         // [34][34][CN_PS]
  float* ws = cn_smem + CN_H * CN_H * CN_PS;   // [9][CN_CC][4]
  const int tid = threadIdx.x, n = blockIdx.z;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int x0 = blockIdx.x * CN_T, y0 = blockIdx.y * CN_T;
  const int tx = tid & 31, ty = tid >> 5;
  float acc[CN_RT][4];
#pragma unroll
  for (int r = 0; r < CN_RT; ++r)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[r][o] = 0.f;
  const float* xb = a.x + (long long)n * H * W * Cin;

  for (int c0 = 0; c0 < Cin; c0 += CN_CC) {
    // the chunk: the halo's 16 channels (zeros outside the image and past
    // Cin) by cp.async, the weights of its channels (zeros past Cin, Cout)
    for (int idx = tid; idx < CN_H * CN_H * (CN_CC / 4); idx += 256) {
      const int hp = idx / (CN_CC / 4), c4 = (idx - hp * (CN_CC / 4)) * 4;
      const int hy = hp / CN_H, hx = hp - hy * CN_H;
      const int yy = y0 + hy - 1, xx = x0 + hx - 1, c = c0 + c4;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cin;
      fp_cp16(xs + hp * CN_PS + c4, in ? xb + ((long long)yy * W + xx) * Cin + c : a.x,
              in ? 16 : 0);
    }
    fp_commit();
    for (int idx = tid; idx < 9 * CN_CC * 4; idx += 256) {
      const int o = idx & 3, c = (idx >> 2) % CN_CC, t = idx / (4 * CN_CC);
      ws[idx] = (c0 + c < Cin && o < Cout)
                    ? __ldg(a.w + ((long long)t * Cin + c0 + c) * Cout + o)
                    : 0.f;
    }
    fp_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int c4 = 0; c4 < CN_CC; c4 += 4) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float4 wt[3][4];  // taps (dy, dx) of channels c4 .. c4 + 3, four outputs each
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wt[dy][i] = *reinterpret_cast<const float4*>(ws + ((dy * 3 + dx) * CN_CC + c4 + i) * 4);
#pragma unroll
        for (int hr = 0; hr < CN_RT + 2; ++hr) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + ((ty * CN_RT + hr) * CN_H + tx + dx) * CN_PS + c4);
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int r = 0; r < CN_RT; ++r) {
            const int dy = hr - r;
            if (dy < 0 || dy > 2) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[r][0] = fmaf(e[i], wt[dy][i].x, acc[r][0]);
              acc[r][1] = fmaf(e[i], wt[dy][i].y, acc[r][1]);
              acc[r][2] = fmaf(e[i], wt[dy][i].z, acc[r][2]);
              acc[r][3] = fmaf(e[i], wt[dy][i].w, acc[r][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  const int x = x0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int r = 0; r < CN_RT; ++r) {
    const int y = y0 + ty * CN_RT + r;
    if (y >= H) continue;
    float* p = a.out + (((long long)n * H + y) * W + x) * Cout;
#pragma unroll
    for (int o = 0; o < 4; ++o)
      if (o < Cout) p[o] = acc[r][o] + (a.bias != nullptr ? __ldg(a.bias + o) : 0.f);
  }
}

}  // namespace turtle

// shared memory of a launch: body 0 (the narrow body), 1 (the product on
// tile kind `kind`); kernels/ffn.py's _conv_f32_geometry mirrors it
extern "C" size_t turtle_conv_f32_smem(int body, int kind) {
  using namespace turtle;
  if (body == 0) return CN_SMEM;
  return fp_smem(kind);
}

// ptrs: x, weight, bias, out, ln_w, ln_b, stats (the LayerNorm's scratch, B
// H W float2)
// ints: B, H, W, Cin, Cout, body (0 narrow, 1 product), kind (FpKind)
// Every tensor float32. Returns the CUDA error code of the first launch that
// failed (0 = all launched), -1 for a call the body does not take.
extern "C" int turtle_conv_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                      void* stream) {
  using namespace turtle;
  ConvF32Args a{};
  a.x = static_cast<const float*>(ptrs[0]);
  a.w = static_cast<const float*>(ptrs[1]);
  a.bias = static_cast<const float*>(ptrs[2]);
  a.out = static_cast<float*>(ptrs[3]);
  a.ln_w = static_cast<const float*>(ptrs[4]);
  a.ln_b = static_cast<const float*>(ptrs[5]);
  float2* stats = static_cast<float2*>(ptrs[6]);
  a.stats = stats;
  const int B = ints[0], body = ints[5], kind = ints[6];
  a.H = ints[1]; a.W = ints[2]; a.Cin = ints[3]; a.Cout = ints[4];
  const long long hw = (long long)a.H * a.W;
  if (is_bf16 || B < 1 || B > 65535 || a.H < 1 || a.W < 1 || hw > 0x7fffffffLL || a.Cin < 1 ||
      a.Cout < 1 || 9LL * a.Cin > 0x7fffffffLL ||
      (a.ln_w != nullptr && (a.Cin % 4 || a.Cin > FG_LN_MAX_K || stats == nullptr)) ||
      (a.ln_w == nullptr && a.ln_b != nullptr))
    return -1;
  a.M = (int)hw; a.N = a.Cout; a.K = 9 * a.Cin;
  a.cin_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if (a.Cin == 1 << sh) a.cin_shift = sh;
  for (int t = 0; t < 9; ++t) a.tap_px[t] = (t / 3 - 1) * a.W + t % 3 - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) {  // the narrow body
    if (a.Cout > 4 || a.Cin % 4 || a.ln_w != nullptr || (a.H + CN_T - 1) / CN_T > 65535) return -1;
    cudaError_t e = cudaFuncSetAttribute(conv_narrow_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CN_SMEM);
    if (e != cudaSuccess) return (int)e;
    conv_narrow_kernel<<<dim3((a.W + CN_T - 1) / CN_T, (a.H + CN_T - 1) / CN_T, B), dim3(256),
                         CN_SMEM, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (body != 1) return -1;
  // the cp.async ring copies A and B as they lie: no LayerNorm, four k of a
  // tap contiguous, B rows in 16-byte pieces
  if (kind == FP_RING && (a.ln_w != nullptr || a.Cin % 4 || a.Cout % 4)) return -1;
  if (a.ln_w != nullptr) {
    const int rc = run_row_stats(a.x, B, a.M, a.Cin, stats, s);
    if (rc != 0) return rc;
  }
  return run_fp<ConvP>(a, B, kind, s);
}
