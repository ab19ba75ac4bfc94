// The float32 building blocks of rows 1 and 3 on an H100 (ffn_f32.cu,
// qkv_f32.cu): a register-blocked product on the CUDA cores with the channel
// LayerNorm as its prologue, and the depthwise 3x3 taps of four channels down
// a column of pixels. Full fp32 FMA, no TF32, no shuffles.
//
// Why products and not one fused tile. In float32 the chains are bound by
// operations by a wide margin: at C = 256, E = 640 a pixel costs 2 (C * 2E +
// E * C + C * C) = 1.1 Mflop against a few kB, so the 67 TFLOP/s of the
// FP32 units are the limit and the kernel's share of them is what counts.
// The mma.sync-shaped tile of ffn_tile.cuh reached 8-17 % of that rate: it
// emulates the m16n8k16 fragment with four shuffles per four FMA, runs pw1 on
// a 10 x 10 halo for 64 outputs (1.56x the work) and, at C = 512, keeps the
// LN halo in device memory. Here each product is a plain tiled product over
// all pixels of a batch entry (M = H * W rows, no halo, no recomputation),
// and the hidden map between pw1 and the taps goes through device memory,
// written once and read once: 8 bytes a hidden channel and pixel, which on
// an H100 costs 80 / C of the chain's operation bound (31 % at C = 256, 16 %
// at 512, more at the narrow levels; PERF.md row 1).
//
// The product: C[M x N] = A[M x K] B[K x N], a block of 256 threads owns 128
// rows x BN = 16 TN columns (TN = 8: 128; TN = 4 for N <= 64), each thread 8
// rows x TN columns in registers (64 FMA for four 16-byte shared loads a k).
// K streams through shared memory in stages of 8, double-buffered: the next
// stage's global loads are in flight in registers while the current one is
// multiplied (K of the weights through a ring of two stages; A is
// transposed k-major on its way in, rows padded to 132 floats so that both
// the transposing stores and the float4 reads are free of bank conflicts;
// the weight stage is read as float4 by 16 threads a row, broadcast across
// the rest of the warp). Each output's sum runs over k in ascending order.
//
// LayerNorm without a halo: a first kernel takes each row's mean and
// reciprocal deviation (a warp a row, the row in registers, two passes as
// the plain version; two floats a pixel into a scratch), and the product
// normalises each A stage as it is staged (the statistics are not taken
// again in every column tile of the product). Nothing of LN(x) is stored
// anywhere.
#pragma once

#include "common.cuh"

namespace turtle {

constexpr int FG_NT = 256;           // threads of a product block
constexpr int FG_BM = 128;           // rows (pixels) of a block
constexpr int FG_BK = 8;             // K of a stage
constexpr int FG_AS = FG_BM + 4;     // row stride of the k-major A stage (floats)
constexpr int FG_LN_MAX_K = 512;     // the widest LayerNorm row (4 float4 a lane)

// One product of a batch entry, blockIdx.z = b:
//   A row p (k < K): LN forms: sum_j a[j][b][p][k] (n_a = 1 or 2 maps, K =
//     seg), normalised with ln_w (ln_b null: bias-free, the mean not
//     subtracted in the numerator); concat forms: a[j][b][p][k - j seg] for
//     j = k / seg (the x2 maps side by side, K = n_a seg)
//   B row k: w + j w_ms + b w_bs + (k - j seg) N (j = 0 but in concat forms)
//   out[b][p][n] = r0 + r1 + scale * (acc + bias)   (resid)
//                = gelu?(acc + bias)                 (otherwise)
// maps are NHWC: row p of batch entry b of a map at base + b * bs + p * width
struct F32Gemm {
  const float* a[MAX_X2];
  long long a_bs[MAX_X2];
  int n_a, seg;
  const float* ln_w;
  const float* ln_b;
  float2* stats;  // LN forms: (mean, 1 / deviation) of each row, (B, M)
  const float* w;
  long long w_ms, w_bs;
  const float* bias;
  const float* scale;
  const float* r0;
  const float* r1;
  long long r0_bs, r1_bs;
  int gelu, resid;
  float* out;
  int M, N, K;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}
__device__ __forceinline__ float4 gelu4(float4 a) {
  return make_float4(gelu_exact(a.x), gelu_exact(a.y), gelu_exact(a.z), gelu_exact(a.w));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// the static shared memory of a product block of TN columns a thread
__host__ __device__ constexpr size_t f32_gemm_smem(int tn) {
  return (size_t)(2 * FG_BK * FG_AS + 2 * FG_BK * 16 * tn) * 4;
}

// the LN forms' row statistics: stats[b][m] = (mean, 1 / sqrt(var + eps))
// of row m of sum_j a[j] (K <= 512: 4 float4 a lane), a warp a row; grid
// (ceil(M / 8), B)
__global__ void __launch_bounds__(FG_NT) f32_row_stats_kernel(const __grid_constant__ F32Gemm g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (FG_NT / 32) + warp, batch = blockIdx.y;
  const int K = g.K;
  if (m >= g.M) return;  // the whole warp
  float4 v[4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = (lane + 32 * i) * 4;
    v[i] = zero4();
    if (k < K) {
      v[i] = ldg4(g.a[0] + batch * g.a_bs[0] + (long long)m * g.seg + k);
      if (g.n_a > 1)
        v[i] = add4(v[i], ldg4(g.a[1] + batch * g.a_bs[1] + (long long)m * g.seg + k));
    }
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(s) / (float)K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if ((lane + 32 * i) * 4 < K) {
      const float dx = v[i].x - mean, dy = v[i].y - mean, dz = v[i].z - mean,
                  dw = v[i].w - mean;
      q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float var = warp_sum(q) / (float)K;
  if (lane == 0)
    g.stats[(long long)batch * g.M + m] = make_float2(mean, 1.0f / sqrtf(var + LN_EPS));
}

template <int TN, bool LN, bool CONCAT>
__global__ void __launch_bounds__(FG_NT, 2) f32_gemm_kernel(const __grid_constant__ F32Gemm g) {
  constexpr int BN = 16 * TN;
  constexpr int B_THREADS = FG_BK * BN / 4;  // threads that stage a weight float4
  __shared__ __align__(16) float As[2][FG_BK][FG_AS];
  __shared__ __align__(16) float Bs[2][FG_BK][BN];
  const int tid = threadIdx.x;
  const int batch = blockIdx.z;
  // the column tiles of a row block are neighbours in the launch order: the
  // block's A rows are read from device memory once, then from L2
  const int m0 = blockIdx.y * FG_BM, n0 = blockIdx.x * BN;
  const int M = g.M, N = g.N, K = g.K, seg = g.seg;

  // the A float4 this thread stages: row ar, k offset ak of the stage
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int am = m0 + ar;
  // the weight float4: stage row bk, column bn
  const int bk = tid / (BN / 4), bn = (tid % (BN / 4)) * 4;
  const bool b_on = tid < B_THREADS && n0 + bn < N;

  float mu = 0.f, rs = 0.f;
  if constexpr (LN) {
    if (am < M) {
      const float2 st = g.stats[(long long)batch * M + am];
      mu = st.x;
      rs = st.y;
    }
  }

  auto load_a = [&](int k0) -> float4 {
    const int k = k0 + ak;
    if (am >= M || k >= K) return zero4();
    if constexpr (CONCAT) {
      const int j = k / seg;
      return ldg4(g.a[j] + batch * g.a_bs[j] + (long long)am * seg + (k - j * seg));
    } else {
      float4 v = ldg4(g.a[0] + batch * g.a_bs[0] + (long long)am * seg + k);
      if (g.n_a > 1) v = add4(v, ldg4(g.a[1] + batch * g.a_bs[1] + (long long)am * seg + k));
      if constexpr (LN) {
        const float4 gw = ldg4(g.ln_w + k);
        if (g.ln_b != nullptr) {
          const float4 bt = ldg4(g.ln_b + k);
          v = make_float4((v.x - mu) * rs * gw.x + bt.x, (v.y - mu) * rs * gw.y + bt.y,
                          (v.z - mu) * rs * gw.z + bt.z, (v.w - mu) * rs * gw.w + bt.w);
        } else {
          v = make_float4(v.x * rs * gw.x, v.y * rs * gw.y, v.z * rs * gw.z, v.w * rs * gw.w);
        }
      }
      return v;
    }
  };
  auto load_b = [&](int k0) -> float4 {
    const int k = k0 + bk;
    if (!b_on || k >= K) return zero4();
    if constexpr (CONCAT) {
      const int j = k / seg;
      return ldg4(g.w + j * g.w_ms + batch * g.w_bs + (long long)(k - j * seg) * N + n0 + bn);
    } else {
      return ldg4(g.w + batch * g.w_bs + (long long)k * N + n0 + bn);
    }
  };
  auto stage = [&](int buf, float4 va, float4 vb) {
    As[buf][ak + 0][ar] = va.x;
    As[buf][ak + 1][ar] = va.y;
    As[buf][ak + 2][ar] = va.z;
    As[buf][ak + 3][ar] = va.w;
    if (tid < B_THREADS) st4(&Bs[buf][bk][bn], vb);
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + FG_BK - 1) / FG_BK;
  float4 ra = load_a(0), rb = load_b(0);
  stage(0, ra, rb);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) {  // the next stage's loads in flight during this one
      ra = load_a((t + 1) * FG_BK);
      rb = load_b((t + 1) * FG_BK);
    }
#pragma unroll
    for (int k = 0; k < FG_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the barrier that ended the
    // previous stage: refill it now, then one barrier a stage
    if (t + 1 < nk) stage(cur ^ 1, ra, rb);
    __syncthreads();
  }

  // epilogue: rows 4 ty .. and 64 + 4 ty .., columns 4 tx .. and 64 + 4 tx ..
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (g.bias != nullptr) v = add4(v, ldg4(g.bias + n));
      if (g.resid) {
        if (g.scale != nullptr) v = mul4(v, ldg4(g.scale + n));
        float4 r = ldg4(g.r0 + batch * g.r0_bs + (long long)m * N + n);
        if (g.r1 != nullptr) r = add4(r, ldg4(g.r1 + batch * g.r1_bs + (long long)m * N + n));
        v = add4(v, r);
      } else if (g.gelu) {
        v = gelu4(v);
      }
      st4(g.out + ((long long)batch * M + m) * N + n, v);
    }
  }
}

template <int TN, bool LN, bool CONCAT>
static int launch_f32_gemm(const F32Gemm& g, int B, cudaStream_t stream) {
  const dim3 grid((g.N + 16 * TN - 1) / (16 * TN), (g.M + FG_BM - 1) / FG_BM, B);
  f32_gemm_kernel<TN, LN, CONCAT><<<grid, dim3(FG_NT), 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// TN = 4 (64 columns a block) for outputs of at most 64 channels, else 8
__host__ __device__ constexpr int f32_gemm_tn(int n) { return n <= 64 ? 4 : 8; }

// one product: -1 for a shape the tile does not take (N, K, seg multiples of
// 4; the LayerNorm rows at most 512 wide; 1-2 summed maps, up to MAX_X2 side
// by side)
template <bool LN, bool CONCAT>
static int run_f32_gemm(const F32Gemm& g, int B, cudaStream_t stream) {
  if (g.M < 1 || g.N < 4 || g.K < 4 || g.N % 4 || g.K % 4 || g.seg % 4 || B < 1 ||
      B > 65535 || g.n_a < 1 || g.n_a > MAX_X2 || (g.M + FG_BM - 1) / FG_BM > 65535)
    return -1;
  if (CONCAT ? g.K != g.n_a * g.seg : (g.K != g.seg || g.n_a > 2)) return -1;
  if (LN && (g.K > FG_LN_MAX_K || g.ln_w == nullptr || g.stats == nullptr)) return -1;
  if (g.resid && g.r0 == nullptr) return -1;
  if (LN) {
    f32_row_stats_kernel<<<dim3((g.M + FG_NT / 32 - 1) / (FG_NT / 32), B), dim3(FG_NT), 0,
                           stream>>>(g);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return f32_gemm_tn(g.N) == 4 ? launch_f32_gemm<4, LN, CONCAT>(g, B, stream)
                               : launch_f32_gemm<8, LN, CONCAT>(g, B, stream);
}

// Depthwise 3x3 of four channels c .. c + 3 down column x, rows y0 .. y0 + RT
// - 1: emit(r, bias + sum over (ty, tx) in row-major order of h[y0 + r - 1 +
// ty][x - 1 + tx] tap(3 ty + tx)), the hidden map zero outside the image (h:
// this batch entry's (H, W, CH) map; tap(i): the four channels' weights of
// tap i of wd (3, 3, CH)). A sliding window of three rows of three pixels;
// ROLLED: the row loop is not unrolled (fewer loads in flight, fewer
// registers; emit then sees r as a variable).
template <int RT, bool ROLLED, class Tap, class Emit>
__device__ __forceinline__ void dw_column4(const float* __restrict__ h, int H, int W, int CH,
                                           int y0, int x, int c, Tap&& tap, float4 bias,
                                           Emit&& emit) {
  auto row = [&](int y, float4 (&r)[3]) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      const int xx = x - 1 + tx;
      r[tx] = (y >= 0 && y < H && xx >= 0 && xx < W)
                  ? ldg4(h + ((long long)y * W + xx) * CH + c)
                  : zero4();
    }
  };
  float4 win[3][3];
  row(y0 - 1, win[0]);
  row(y0, win[1]);
#pragma unroll(ROLLED ? 1 : RT)
  for (int r = 0; r < RT; ++r) {
    row(y0 + r + 1, win[2]);
    float4 a = zero4();
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) a = fma4(win[ty][tx], tap(ty * 3 + tx), a);
    emit(r, add4(a, bias));
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      win[0][tx] = win[1][tx];
      win[1][tx] = win[2][tx];
    }
  }
}

}  // namespace turtle
