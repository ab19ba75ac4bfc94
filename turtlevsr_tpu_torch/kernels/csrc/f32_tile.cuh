// The float32 building blocks of rows 1, 3, 5 and 11 on an H100 (ffn_f32.cu,
// qkv_f32.cu, conv_f32.cu, attn_v_f32.cu): a register-blocked product on the
// CUDA cores with loader hooks (rows 1 and 3: the channel LayerNorm as its
// prologue; row 5: the conv's shifted pixel rows; row 11: the ring views'
// values), and the depthwise 3x3 taps of four channels down a column of
// pixels. Full fp32 FMA, no TF32, no shuffles.
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
// The product (fp_product_kernel below): C[M x N] = A[M x K] B[K x N], a
// block of 256 threads owns 128 rows x 128 columns (64 for outputs of at
// most 64 channels), each thread 8 rows x 8 (or 4) columns in registers (64
// FMA for four 16-byte shared loads a k). K streams through shared memory in
// stages of 8, double-buffered: the next stage's global loads are in flight
// in registers while the current one is multiplied; A is transposed k-major
// on its way in, rows padded to 132 floats so that both the transposing
// stores and the float4 reads are free of bank conflicts. Each output's sum
// runs over k in ascending order.
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
constexpr int FG_BK = 8;             // K of a stage
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

// ---------------------------------------------------------------------------
// The product with loader hooks, fp_product_kernel<P, KIND>: C[M x N] = A[M x
// K] B[K x N] a batch entry (blockIdx.z = n), with A's rows, B's rows and the
// store given by a problem class P:
//   P::Args (a __grid_constant__) with int fields M, N, K
//   P::KINDS                               the tile kinds (bits of FpKind)
//                                          run_fp instantiates for P
//   P::Row P::row(a, n, m)                 what a thread keeps of A row m
//                                          (m >= M: a row of zeros)
//   float4 P::load_a(a, n, row, k)         A[m][k .. k+3], zeros outside
//   float4 P::load_b(a, n, k, c)           B[k][c .. c+3], zeros outside
//   void P::store(a, n, m, c, float4 v)    columns c .. c+3 of row m (c < N)
// and, for the cp.async ring (FP_RING), the addresses the copies read:
//   const float* P::a_ptr(a, n, row, k, valid)   the first of A[m][k .. k+3]
//                                          where they lie, contiguous;
//                                          `valid` of them (0: zeros)
//   const float* P::b_ptr(a, n, k, c)      the same 16-byte piece of B, null
//                                          for zeros
//   const float* P::any(a)                 a valid address for zero fills
// The problem classes: GemmP below (rows 1 and 3: the LayerNorm prologue or
// maps side by side, the residual or GELU epilogue), conv_f32.cu's ConvP
// (row 5: shifted, zero-padded pixel rows), attn_v_f32.cu's AvP (row 11: the
// ring views' values, the merge as the store).
//
// The tile FpTile<KIND>: 256 threads, each RM rows x TN columns of outputs in
// registers, BM = RM TY rows by BN = TN TX columns a block (TY = 256 / TX),
// two blocks an SM at up to 128 registers; K in stages of BK, A staged
// k-major in rows of BM + 4 floats (the transposing stores and the float4
// reads free of bank conflicts). The kinds are the configurations some call
// of the paths runs (kernels/ffn.py _FP_KINDS mirrors them); the others that
// were measured (PERF.md row 5) were no faster and are not built:
//   FP_WIDE     128 x 128, 8 x 8 a thread    rows 1 and 3 (N > 64), row 5
//                                            (Cout > 64), row 11
//   FP_RING     FP_WIDE in the warps' layout with stages of 16 through the
//               cp.async ring                row 5 at Cin >= 512 without the
//                                            LayerNorm (up4_3)
//   FP_HALF     128 x 64, 8 x 4 a thread     rows 1 and 3 (N <= 64)
//   FP_HALF_W   FP_HALF in the warps' layout with stages of 16
//                                            row 5 (Cout 33-64)
//   FP_QUARTER  256 x 32, 8 x 4 a thread, 8 threads across, the warps'
//               layout with stages of 16     row 5 (Cout <= 32)
//   FP_SMALL    64 x 64, 4 x 4 a thread, the warps' layout with stages of 16
//                                            row 5, grids that would have
//                                            fewer blocks than half the SMs
// The flags of a kind:
//   * FP_ASYNC: K through a ring of FP_STAGES stages filled by cp.async (A
//     transposed by 4-byte copies, B by 16-byte copies, zeros by the copies'
//     zero fill), one barrier a stage, nothing staged through registers;
//     else one stage prefetched into registers while the other is multiplied
//     (the loaders that transform, the LayerNorm, the gathered 3-channel
//     input, take this path);
//   * FP_WARP: each warp owns a block of 4 x 8 threads (32 x 32 or 32 x 64
//     outputs), so a k step's fragments are 4 distinct A pieces and 8
//     distinct B pieces a warp where the plain layout (16 threads across the
//     block's columns) reads 2 and 16;
//   * FP_BK16: stages of 16 k, half the barriers and stage switches a k.
// The column blocks of a row block are neighbours in the launch order: the
// block's A rows are read from device memory once, then from L2. Each
// output's sum runs over k in ascending order, full fp32 FMA, no TF32.
constexpr int FP_STAGES = 4;  // the cp.async ring's stages
enum FpFlag { FP_ASYNC = 1, FP_WARP = 2, FP_BK16 = 4 };
enum FpKind { FP_WIDE = 0, FP_RING = 1, FP_HALF = 2, FP_HALF_W = 3, FP_QUARTER = 4, FP_SMALL = 5 };
__host__ __device__ constexpr int fp_rm(int kind) { return kind == FP_SMALL ? 4 : 8; }
__host__ __device__ constexpr int fp_tn(int kind) { return kind <= FP_RING ? 8 : 4; }
__host__ __device__ constexpr int fp_tx(int kind) { return kind == FP_QUARTER ? 8 : 16; }
__host__ __device__ constexpr int fp_flags(int kind) {
  return kind == FP_WIDE || kind == FP_HALF ? 0
         : kind == FP_RING                  ? FP_ASYNC | FP_WARP | FP_BK16
                                            : FP_WARP | FP_BK16;
}

template <int KIND>
struct FpTile {
  static constexpr int NT = FG_NT, RM = fp_rm(KIND), TN = fp_tn(KIND), TX = fp_tx(KIND);
  static constexpr int TY = NT / TX, BM = RM * TY, BN = TN * TX;
  static constexpr bool ASYNC = (fp_flags(KIND) & FP_ASYNC) != 0;
  static constexpr bool WARP = (fp_flags(KIND) & FP_WARP) != 0;
  static constexpr int BK = (fp_flags(KIND) & FP_BK16) ? 16 : FG_BK;
  static constexpr int STAGES = ASYNC ? FP_STAGES : 2;
  static constexpr int AS = BM + 4;                    // k-major A row stride
  static constexpr int A_PER = BM * BK / 4 / NT;       // A pieces a thread stages
  static constexpr int B_SLOTS = BK * BN / 4;          // B pieces a stage
  static constexpr int B_PER = (B_SLOTS + NT - 1) / NT;
  static constexpr int SMEM = STAGES * BK * (AS + BN) * 4;
  // FP_WARP: a warp's tile of 4 x 8 threads, WR x WC warps a block
  static constexpr int WTR = 4 * RM, WTC = 8 * TN, WC = BN / WTC, WR = BM / WTR;
  static_assert(A_PER >= 1 && A_PER * 4 * NT == BM * BK, "A staging");
  static_assert(RM % 4 == 0 && TN % 4 == 0, "tile geometry");
  static_assert(!WARP || (WC >= 1 && WR * WC == NT / 32), "warp tiles");
};

// a kind's dynamic shared memory (ffn.py _fp_smem mirrors it)
__host__ __device__ constexpr int fp_smem(int kind) {
  return ((fp_flags(kind) & FP_ASYNC) ? FP_STAGES : 2) * ((fp_flags(kind) & FP_BK16) ? 16 : FG_BK) *
         (fp_rm(kind) * (FG_NT / fp_tx(kind)) + 4 + fp_tn(kind) * fp_tx(kind)) * 4;
}

// cp.async of 4 and 16 bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void fp_cp4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void fp_cp16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void fp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void fp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <class P, int KIND>
__global__ void __launch_bounds__(FG_NT, 2)
    fp_product_kernel(const __grid_constant__ typename P::Args a) {
  using T = FpTile<KIND>;
  constexpr int BK = T::BK;
  extern __shared__ __align__(16) float fp_smem_buf[];
  float* As = fp_smem_buf;                            // [STAGES][BK][AS]
  float* Bs = fp_smem_buf + T::STAGES * BK * T::AS;   // [STAGES][BK][BN]
  const int tid = threadIdx.x, n = blockIdx.z;
  const int M = a.M, N = a.N, K = a.K;
  const int ncb = (N + T::BN - 1) / T::BN;
  const int m0 = (blockIdx.x / ncb) * T::BM, n0 = (blockIdx.x % ncb) * T::BN;

  // what this thread stages: A piece j at row ar(j), k offset ak; B piece j
  // at stage row bk(j), column bn(j)
  constexpr int AQ = BK / 4;  // A pieces a row
  const int ak = (tid % AQ) * 4;
  auto ar = [&](int j) { return (tid + j * T::NT) / AQ; };
  typename P::Row rows[T::A_PER];
#pragma unroll
  for (int j = 0; j < T::A_PER; ++j) rows[j] = P::row(a, n, m0 + ar(j));
  auto bk = [&](int j) { return (tid + j * T::NT) / (T::BN / 4); };
  auto bn = [&](int j) { return ((tid + j * T::NT) % (T::BN / 4)) * 4; };
  auto b_on = [&](int j) { return tid + j * T::NT < T::B_SLOTS; };

  // this thread's outputs: rows r0 + h rstep + i, columns c0 + g cstep + j
  int r0, rstep, c0, cstep;
  if constexpr (T::WARP) {
    const int w = tid >> 5, lane = tid & 31;
    r0 = (w / T::WC) * T::WTR + (lane >> 3) * 4;
    c0 = (w % T::WC) * T::WTC + (lane & 7) * 4;
    rstep = 16;
    cstep = 32;
  } else {
    r0 = (tid / T::TX) * 4;
    c0 = (tid % T::TX) * 4;
    rstep = 4 * T::TY;
    cstep = 4 * T::TX;
  }
  float acc[T::RM][T::TN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  auto compute = [&](int s) {
    const float* as = As + s * BK * T::AS + r0;
    const float* bs = Bs + s * BK * T::BN + c0;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[T::RM], bv[T::TN];
#pragma unroll
      for (int h = 0; h < T::RM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * T::AS + h * rstep);
        av[4 * h] = v.x; av[4 * h + 1] = v.y; av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * T::BN + g * cstep);
        bv[4 * g] = v.x; bv[4 * g + 1] = v.y; bv[4 * g + 2] = v.z; bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::RM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  const int nk = (K + BK - 1) / BK;
  if constexpr (T::ASYNC) {
    const float* any = P::any(a);  // a valid address for the zero fills
    auto issue = [&](int t, int s) {
      const int k0 = t * BK;
      float* as = As + s * BK * T::AS;
#pragma unroll
      for (int j = 0; j < T::A_PER; ++j) {
        int valid;
        const float* src = P::a_ptr(a, n, rows[j], k0 + ak, valid);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fp_cp4(as + (ak + i) * T::AS + ar(j), i < valid ? src + i : any, i < valid ? 4 : 0);
      }
#pragma unroll
      for (int j = 0; j < T::B_PER; ++j) {
        if (!b_on(j)) continue;
        const float* src = P::b_ptr(a, n, k0 + bk(j), n0 + bn(j));
        fp_cp16(Bs + (s * BK + bk(j)) * T::BN + bn(j), src != nullptr ? src : any,
                src != nullptr ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) {
      if (s < nk) issue(s, s);
      fp_commit();
    }
    for (int t = 0; t < nk; ++t) {
      fp_wait<T::STAGES - 2>();
      __syncthreads();  // stage t has landed; stage t - 1's slot is free
      if (t + T::STAGES - 1 < nk) issue(t + T::STAGES - 1, (t + T::STAGES - 1) % T::STAGES);
      fp_commit();
      compute(t % T::STAGES);
    }
  } else {
    float4 ra[T::A_PER], rbv[T::B_PER];
    auto fetch = [&](int t) {
      const int k0 = t * BK;
#pragma unroll
      for (int j = 0; j < T::A_PER; ++j) ra[j] = P::load_a(a, n, rows[j], k0 + ak);
#pragma unroll
      for (int j = 0; j < T::B_PER; ++j)
        rbv[j] = b_on(j) ? P::load_b(a, n, k0 + bk(j), n0 + bn(j)) : zero4();
    };
    auto stage = [&](int s) {
      float* as = As + s * BK * T::AS;
#pragma unroll
      for (int j = 0; j < T::A_PER; ++j) {
        as[(ak + 0) * T::AS + ar(j)] = ra[j].x;
        as[(ak + 1) * T::AS + ar(j)] = ra[j].y;
        as[(ak + 2) * T::AS + ar(j)] = ra[j].z;
        as[(ak + 3) * T::AS + ar(j)] = ra[j].w;
      }
#pragma unroll
      for (int j = 0; j < T::B_PER; ++j)
        if (b_on(j)) st4(Bs + (s * BK + bk(j)) * T::BN + bn(j), rbv[j]);
    };
    fetch(0);
    stage(0);
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      const int cur = t & 1;
      if (t + 1 < nk) fetch(t + 1);  // the next stage's loads in flight during this one
      compute(cur);
      // the other buffer was last read before the barrier that ended the
      // previous stage: refill it now, then one barrier a stage
      if (t + 1 < nk) stage(cur ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < T::RM / 4; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + r0 + h * rstep + i;
      if (m >= M) continue;
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        const int c = n0 + c0 + g * cstep;
        if (c >= N) continue;
        P::store(a, n, m, c,
                 make_float4(acc[4 * h + i][4 * g], acc[4 * h + i][4 * g + 1],
                             acc[4 * h + i][4 * g + 2], acc[4 * h + i][4 * g + 3]));
      }
    }
}

// one product over B batch entries on tile kind KIND: -1 for a grid the card
// does not take or a kind P does not instantiate
template <class P, int KIND>
static int launch_fp(const typename P::Args& a, int B, cudaStream_t stream) {
  if constexpr (((P::KINDS >> KIND) & 1) == 0) {
    return -1;
  } else {
    using T = FpTile<KIND>;
    const long long blocks =
        (long long)((a.M + T::BM - 1) / T::BM) * ((a.N + T::BN - 1) / T::BN);
    if (a.M < 1 || a.N < 1 || a.K < 1 || blocks > 0x7fffffffLL || B < 1 || B > 65535)
      return -1;
    auto kern = fp_product_kernel<P, KIND>;
    if (T::SMEM > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<dim3((unsigned)blocks, 1, B), dim3(T::NT), T::SMEM, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

template <class P>
static int run_fp(const typename P::Args& a, int B, int kind, cudaStream_t s) {
  switch (kind) {
    case FP_WIDE: return launch_fp<P, FP_WIDE>(a, B, s);
    case FP_RING: return launch_fp<P, FP_RING>(a, B, s);
    case FP_HALF: return launch_fp<P, FP_HALF>(a, B, s);
    case FP_HALF_W: return launch_fp<P, FP_HALF_W>(a, B, s);
    case FP_QUARTER: return launch_fp<P, FP_QUARTER>(a, B, s);
    case FP_SMALL: return launch_fp<P, FP_SMALL>(a, B, s);
  }
  return -1;
}

// Rows 1 and 3's products (F32Gemm above) as a problem class: A row m of
// batch entry n with its LayerNorm statistics, B rows of the weights, the
// bias and the residual or GELU epilogue in one store.
template <bool LN, bool CONCAT>
struct GemmP {
  using Args = F32Gemm;
  static constexpr unsigned KINDS = 1u << FP_WIDE | 1u << FP_HALF;
  struct Row {
    int m;
    float mu, rs;  // LN forms: the row's mean and reciprocal deviation
  };
  static __device__ __forceinline__ Row row(const Args& g, int n, int m) {
    Row r{m, 0.f, 0.f};
    if constexpr (LN) {
      if (m < g.M) {
        const float2 st = g.stats[(long long)n * g.M + m];
        r.mu = st.x;
        r.rs = st.y;
      }
    }
    return r;
  }
  static __device__ __forceinline__ float4 load_a(const Args& g, int n, Row r, int k) {
    if (r.m >= g.M || k >= g.K) return zero4();
    const int seg = g.seg;
    if constexpr (CONCAT) {
      const int j = k / seg;
      return ldg4(g.a[j] + n * g.a_bs[j] + (long long)r.m * seg + (k - j * seg));
    } else {
      float4 v = ldg4(g.a[0] + n * g.a_bs[0] + (long long)r.m * seg + k);
      if (g.n_a > 1) v = add4(v, ldg4(g.a[1] + n * g.a_bs[1] + (long long)r.m * seg + k));
      if constexpr (LN) {
        const float4 gw = ldg4(g.ln_w + k);
        const float mu = r.mu, rs = r.rs;
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
  }
  static __device__ __forceinline__ float4 load_b(const Args& g, int n, int k, int c) {
    if (k >= g.K || c >= g.N) return zero4();
    if constexpr (CONCAT) {
      const int j = k / g.seg;
      return ldg4(g.w + j * g.w_ms + n * g.w_bs + (long long)(k - j * g.seg) * g.N + c);
    } else {
      return ldg4(g.w + n * g.w_bs + (long long)k * g.N + c);
    }
  }
  static __device__ __forceinline__ void store(const Args& g, int n, int m, int c, float4 v) {
    const int N = g.N;
    if (g.bias != nullptr) v = add4(v, ldg4(g.bias + c));
    if (g.resid) {
      if (g.scale != nullptr) v = mul4(v, ldg4(g.scale + c));
      float4 r = ldg4(g.r0 + n * g.r0_bs + (long long)m * N + c);
      if (g.r1 != nullptr) r = add4(r, ldg4(g.r1 + n * g.r1_bs + (long long)m * N + c));
      v = add4(v, r);
    } else if (g.gelu) {
      v = gelu4(v);
    }
    st4(g.out + ((long long)n * g.M + m) * N + c, v);
  }
};

// 128 x 64 blocks (TN = 4) for outputs of at most 64 channels, else 128 x 128
__host__ __device__ constexpr int f32_gemm_tn(int n) { return n <= 64 ? 4 : 8; }

// the dynamic shared memory of a product block of TN columns a thread
__host__ __device__ constexpr size_t f32_gemm_smem(int tn) {
  return (size_t)fp_smem(tn == 4 ? FP_HALF : FP_WIDE);
}

// one product: -1 for a shape the tile does not take (N, K, seg multiples of
// 4; the LayerNorm rows at most 512 wide; 1-2 summed maps, up to MAX_X2 side
// by side)
template <bool LN, bool CONCAT>
static int run_f32_gemm(const F32Gemm& g, int B, cudaStream_t stream) {
  if (g.M < 1 || g.N < 4 || g.K < 4 || g.N % 4 || g.K % 4 || g.seg % 4 || B < 1 ||
      B > 65535 || g.n_a < 1 || g.n_a > MAX_X2)
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
  return run_fp<GemmP<LN, CONCAT>>(g, B, f32_gemm_tn(g.N) == 4 ? FP_HALF : FP_WIDE, stream);
}

// the row statistics of an NHWC map x (B, M, C), C a multiple of 4 up to 512,
// into stats (B, M) (f32_row_stats_kernel)
static int run_row_stats(const float* x, int B, int M, int C, float2* stats, cudaStream_t s) {
  if (C % 4 || C > FG_LN_MAX_K || B > 65535 || stats == nullptr) return -1;
  F32Gemm g{};
  g.a[0] = x;
  g.a_bs[0] = (long long)M * C;
  g.n_a = 1;
  g.seg = C;
  g.K = C;
  g.M = M;
  g.stats = stats;
  f32_row_stats_kernel<<<dim3((M + FG_NT / 32 - 1) / (FG_NT / 32), B), dim3(FG_NT), 0, s>>>(g);
  return (int)cudaGetLastError();
}


// the taps' kernels (ffn_f32.cu's dw_act_kernel, split_f32.cu's
// split_taps_kernel): a thread four channels of one column and DW_RT rows,
// a block DW_TX columns by 16 threads (64 channels)
constexpr int DW_RT = 4;
constexpr int DW_TX = 16;

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
