// Dense 3x3 stride-1 pad-1 convolution on an NHWC map, weight
// (3, 3, Cin, Cout), optional bias: the input projection, the ending conv,
// the bodies of the down- and upsamplers and, with a LayerNorm in front, the
// composite v chain of the SAB front.
//
// Replaces fused_conv3x3 in turtlevsr_tpu/kernels/ffn.py (_conv3_kernel).
//
// The function is an implicit GEMM: M = output pixels, N = Cout, K = 9 taps
// x Cin, with the weight viewed as its (9 Cin, Cout) matrix (k = tap * Cin +
// c). On an H100 the wide convs (128->256, 256->512, 512->1024, LN + v at
// C = 256 and 128) are bound by operations (18 Cin Cout flop a pixel against
// 2 (Cin + Cout) bytes), 128->64 and 256->128 close to the balance point, the
// narrow ends (64->3, 64->32, 3->64, LN + v at C = 64) by bytes. What held
// the first designs back here was not the tensor cores' rate but how many
// bytes a block keeps in flight and how often all its warps wait for each
// other: a whole-Cin halo of an 8 x 16 tile at Cin = 512 (187 KB) leaves room
// for a shallow weight ring only, and a barrier every 32 rows of K idles the
// tensor cores. Three bodies, chosen by width in choose_plan:
//
//   * conv3x3_chunked_kernel (bf16, no LayerNorm, Cin a multiple of 16, Cout
//     a multiple of 8 above 32: every wide conv of the models, 128->64 and
//     256->128): wgmma. The halo comes through the ring with the weight, 16
//     input channels a stage, so a block owns 256 output pixels (two 8 x 16
//     sub-tiles, one per warpgroup) by 128 (or 64) channels whatever Cin, and
//     each weight crosses from L2 once per 256 pixels. A copy warp starts the
//     stages' TMA boxes (the halo as a 4-D box of x whose parts outside the
//     image arrive as zeros, the weight as 2-D boxes per tap and panel, in
//     the swizzled layout wgmma reads) on mbarriers; four stages of 48 KB,
//     no block-wide barrier in the loop; A from registers by ldmatrix from
//     the halo windows, a tap only shifts the rows.
//   * conv3x3_ln_kernel (bf16, LayerNorm in front, Cout a multiple of 8, Cin
//     up to 256: the composite v chain of the CHM blocks): wgmma. LN(x) needs
//     every channel of a pixel, so the halo stays whole in shared memory as
//     ln_prologue of common.cuh writes it (fp32 statistics, rounded to T,
//     zero rows outside the image: the border is zero padding of LN(x)), two
//     8 x 8 sub-tiles of an 8 x 16 tile; the weight streams through an
//     8-stage TMA ring of 32 rows of K on mbarriers.
//   * conv3x3_kernel (every other case): mma.sync m16n8k16 on the same halo
//     tile (cp.async, 16-byte pieces), the weight through a 4-stage cp.async
//     ring of 32 rows read by all warps with ldmatrix.trans, the result
//     staged and stored in 16-byte pieces. Narrow Cout takes large pixel
//     tiles whose warps split the pixels, not the channels: Cout <= 16 16 x 32
//     pixels by 16 channels (the halo costs 1.2x the input reads; Cout = 3 is
//     padded to 16, the N tile of one ldmatrix.x4.trans), Cout <= 32 16 x 16
//     by 32. Cin not a multiple of 16 (the 3-channel input): each pixel's
//     9 Cin neighbourhood values are gathered into shared memory, K padded to
//     a multiple of 32 (27 -> 32 at the input), and run through the same ring
//     and tensor-core products. Cout not a multiple of 8 takes 8 x 16 pixels
//     by 128 or 16 x 16 by 64; a halo that does not fit the 227 KB of a block
//     takes 8 x 16 by 64, or the gather. T = float (the type of the tight
//     on-card comparisons, not of serving) takes this body only, 8 x 8 pixels
//     by 64 channels, fragments read element by element and the products by
//     FMA (common.cuh's tile_mma), two stages.
// Every body sums in fp32, adds the bias in fp32 and rounds once to T.
#include <initializer_list>

#include "pipe.cuh"

namespace turtle {

struct ConvArgs {
  const void *x, *w, *bias, *ln_w, *ln_b;
  void* out;
  int B, H, W, Cin, Cout;
};

constexpr int CV_KC = 32;           // rows of K per ring stage
constexpr int CV_AS = CV_KC + XPAD;  // row stride of a gathered A stage

// TH x TW output pixels; WM x WN warps, each MI 16-row tiles by NJ 8-column
// tiles
template <int TH_, int TW_, int WM_, int WN_, int MI_, int NJ_>
struct ConvGeo {
  static constexpr int TH = TH_, TW = TW_, WM = WM_, WN = WN_, MI = MI_, NJ = NJ_;
  static constexpr int M = TH * TW;
  static constexpr int BN = WN * NJ * 8;
  static constexpr int BS = BN + XPAD;  // row stride of a weight stage and of the out tile
  static_assert(WM * MI * 16 == M && WM * WN == NW && NJ % 2 == 0, "tile geometry");
};

// halo pixels of the tile: a (TH + 2) x (TW + 2) window, or with the
// LayerNorm one 10 x 10 buffer per 8 x 8 sub-tile (ln_prologue's geometry)
template <class G, bool LN>
__host__ __device__ constexpr int halo_pixels() {
  return LN ? (G::TH / TS) * (G::TW / TS) * NPH : (G::TH + 2) * (G::TW + 2);
}

// element offset, in the halo tile, of the top-left tap of output pixel p
template <class G, bool LN>
__device__ __forceinline__ int halo_row(int p, int XS) {
  const int py = p / G::TW, px = p - py * G::TW;
  if constexpr (LN) {
    const int sub = (py / TS) * (G::TW / TS) + px / TS;
    return (sub * NPH + (py % TS) * PH + px % TS) * XS;
  } else {
    return (py * (G::TW + 2) + px) * XS;
  }
}

__device__ __forceinline__ void frag_a(AFrag<__nv_bfloat16>& a, const __nv_bfloat16* base,
                                       const int (&off)[2]) {
  ldsm_a(a, base + off[0]);
}
__device__ __forceinline__ void frag_a(AFrag<float>& a, const float* base, const int (&off)[2]) {
  load_a(a, base + off[0], base + off[1], 0);
}

// the offsets frag_a reads for 16-row tile mt, rows at row(p) elements
template <class T, class RowOf>
__device__ __forceinline__ void lane_rows(int (&off)[2], int mt, RowOf row) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    off[0] = row(mt * 16 + (lane & 15)) + (lane >> 4) * 8;
    off[1] = 0;
  } else {
    off[0] = row(mt * 16 + (lane >> 2));
    off[1] = row(mt * 16 + (lane >> 2) + 8);
  }
}

template <class T, class G, int CR, int STAGES, bool GATHER>
__host__ __device__ constexpr size_t conv_smem(int Cin) {
  constexpr bool LN = CR > 0;
  const size_t a = GATHER ? (size_t)STAGES * G::M * CV_AS
                          : (size_t)halo_pixels<G, LN>() * (Cin + XPAD);
  const size_t main = (a + (size_t)STAGES * CV_KC * G::BS) * sizeof(T);
  const size_t out = (size_t)G::M * G::BS * sizeof(T);
  return main > out ? main : out;
}

// CR: 0 without LayerNorm, else the channels per lane of its prologue;
// GATHER: A gathered per chunk (any Cin) instead of read from a halo tile
template <class T, class G, int CR, int STAGES, bool GATHER>
__global__ void __launch_bounds__(NT) conv3x3_kernel(const __grid_constant__ ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool LN = CR > 0;
  constexpr int M = G::M, BN = G::BN, BS = G::BS, MI = G::MI, NJ = G::NJ;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int HWS = LN ? PH : G::TW + 2;  // halo row stride in pixels
  static_assert(!(LN && GATHER), "the LayerNorm takes the halo tile");
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / G::WN, wn = warp - wm * G::WN;
  const int n_tiles = (Cout + BN - 1) / BN, tiles_x = (W + G::TW - 1) / G::TW;
  const int st = blockIdx.x / n_tiles, n0 = (blockIdx.x - st * n_tiles) * BN;
  const int y0 = (st / tiles_x) * G::TH, x0 = (st % tiles_x) * G::TW;
  const int b = blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * H * W * Cin;
  const T* w = static_cast<const T*>(a.w);
  const int K = 9 * Cin, XS = Cin + XPAD;
  const int n_chunks = (K + CV_KC - 1) / CV_KC;
  T* as = reinterpret_cast<T*>(smem);  // halo tile, or the gathered A ring
  T* ring = as + (GATHER ? STAGES * M * CV_AS : halo_pixels<G, LN>() * XS);
  const bool w_vec = (Cout * (int)sizeof(T)) % 16 == 0;

  // chunk ch of the weight (rows ch * 32.., columns n0..) into stage s and,
  // gathering, the pixels' neighbourhood values of the same rows of K
  auto load_chunk = [&](int ch, int s) {
    T* dst = ring + s * CV_KC * BS;
    const int k0 = ch * CV_KC;
    if (w_vec) {
      for (int idx = tid; idx < CV_KC * (BN / VE); idx += NT) {
        const int r = idx / (BN / VE), c = (idx - r * (BN / VE)) * VE;
        if (k0 + r < K && n0 + c < Cout)
          cp_async16(dst + r * BS + c, w + (size_t)(k0 + r) * Cout + n0 + c);
        else
          zero16(dst + r * BS + c);
      }
    } else {
      for (int idx = tid; idx < CV_KC * BN; idx += NT) {
        const int r = idx / BN, c = idx - r * BN;
        dst[r * BS + c] = (k0 + r < K && n0 + c < Cout) ? w[(size_t)(k0 + r) * Cout + n0 + c]
                                                        : from_f<T>(0.f);
      }
    }
    if constexpr (GATHER) {
      T* ad = as + s * M * CV_AS;
      for (int idx = tid; idx < M * CV_KC; idx += NT) {
        const int kk = idx / M, p = idx - kk * M;  // neighbouring threads: neighbouring pixels
        const int k = k0 + kk;
        T v = from_f<T>(0.f);
        if (k < K) {
          const int tap = k / Cin, c = k - tap * Cin;
          const int gy = y0 + p / G::TW + tap / 3 - 1, gx = x0 + p % G::TW + tap % 3 - 1;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = x[((size_t)gy * W + gx) * Cin + c];
        }
        ad[p * CV_AS + kk] = v;
      }
    }
  };

  // prologue: the halo tile and the first STAGES - 1 weight chunks in flight
  if constexpr (!LN && !GATHER) {
    const int v_n = Cin / VE;
    for (int idx = tid; idx < halo_pixels<G, false>() * v_n; idx += NT) {
      const int p = idx / v_n, c = (idx - p * v_n) * VE;
      const int gy = y0 - 1 + p / HWS, gx = x0 - 1 + p % HWS;
      T* d = as + p * XS + c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        cp_async16(d, x + ((size_t)gy * W + gx) * Cin + c);
      else
        zero16(d);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  if constexpr (LN) {
    // one 10 x 10 LayerNorm halo buffer per 8 x 8 sub-tile (ends in a barrier)
#pragma unroll 1
    for (int sub = 0; sub < (G::TH / TS) * (G::TW / TS); ++sub)
      ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W,
                         Cin, y0 + (sub / (G::TW / TS)) * TS, x0 + (sub % (G::TW / TS)) * TS,
                         as + sub * NPH * XS);
  }

  // this lane's A rows: halo rows of its pixels, or rows of the gathered stage
  int aoff[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if constexpr (GATHER)
      lane_rows<T>(aoff[mi], wm * MI + mi, [](int p) { return p * CV_AS; });
    else
      lane_rows<T>(aoff[mi], wm * MI + mi, [XS](int p) { return halo_row<G, LN>(p, XS); });
  }

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;

  int tap = 0, c = 0;  // of the k16 step about to run (tap path)
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();  // chunk ch (and with chunk 0 the halo) landed
    __syncthreads();              // ... for every thread; stage (ch - 1) % STAGES is free
    if (ch + STAGES - 1 < n_chunks) load_chunk(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);
    cp_async_commit();
    const T* bs = ring + (ch % STAGES) * CV_KC * BS;
    const T* abase = GATHER ? as + (ch % STAGES) * M * CV_AS : as;
#pragma unroll
    for (int kk = 0; kk < CV_KC; kk += 16) {
      if (ch * CV_KC + kk >= K) break;  // uniform
      int ak;
      if constexpr (GATHER) {
        ak = kk;
      } else {
        ak = ((tap / 3) * HWS + tap % 3) * XS + c;
        c += 16;
        if (c == Cin) { c = 0; ++tap; }
      }
      AFrag<T> af[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) frag_a(af[mi], abase + ak, aoff[mi]);
      BFrag<T> bf[NJ];
#pragma unroll
      for (int j = 0; j < NJ; j += 2) ldsm_b_pair(bf[j], bf[j + 1], bs, BS, kk, (wn * NJ + j) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j) tile_mma(acc[mi][j], af[mi], bf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the halo and the ring

  // stage the tile, bias added in fp32 and rounded once to T
  T* os = reinterpret_cast<T*>(smem);  // [M][BS]
  const T* bias = static_cast<const T*>(a.bias);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = (wn * NJ + j) * 8 + 2 * t;
    const float b0 = (bias && n0 + col < Cout) ? to_f(bias[n0 + col]) : 0.f;
    const float b1 = (bias && n0 + col + 1 < Cout) ? to_f(bias[n0 + col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* o = os + ((wm * MI + mi) * 16 + g + 8 * h) * BS + col;
        o[0] = from_f<T>(acc[mi][j][2 * h] + b0);
        o[1] = from_f<T>(acc[mi][j][2 * h + 1] + b1);
      }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (size_t)b * H * W * Cout;
  for (int idx = tid; idx < M * (BN / VE); idx += NT) {
    const int p = idx / (BN / VE), cc = (idx - p * (BN / VE)) * VE;
    const int gy = y0 + p / G::TW, gx = x0 + p % G::TW, n = n0 + cc;
    if (gy >= H || gx >= W || n >= Cout) continue;
    T* dst = out + ((size_t)gy * W + gx) * Cout + n;
    const T* src = os + p * BS + cc;
    if (w_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e)
        if (n + e < Cout) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// the tile of each case
// ---------------------------------------------------------------------------

using GeoWide = ConvGeo<8, 16, 4, 2, 2, 8>;   // 128 px x 128 ch
using GeoMid = ConvGeo<16, 16, 8, 1, 2, 8>;   // 256 px x 64 ch
using GeoSlim = ConvGeo<16, 16, 8, 1, 2, 4>;  // 256 px x 32 ch
using GeoThin = ConvGeo<16, 32, 8, 1, 4, 2>;  // 512 px x 16 ch
using GeoHalf = ConvGeo<8, 16, 8, 1, 1, 8>;   // 128 px x 64 ch: large Cin, narrow Cout
using GeoF32 = ConvGeo<8, 8, 4, 2, 1, 4>;     // float: 64 px x 64 ch

constexpr int STAGES_BF16 = 4, STAGES_F32 = 2;

struct ConvPlan {
  int (*launch)(const ConvArgs&, cudaStream_t);
  size_t smem;
};

template <class T, class G, int CR, int STAGES, bool GATHER>
static int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  auto kern = conv3x3_kernel<T, G, CR, STAGES, GATHER>;
  const size_t smem = conv_smem<T, G, CR, STAGES, GATHER>(a.Cin);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (a.Cout + G::BN - 1) / G::BN;
  const long long blocks = (long long)((a.H + G::TH - 1) / G::TH) *
                           ((a.W + G::TW - 1) / G::TW) * n_tiles;
  if (blocks > 0x7fffffffLL || a.B > 65535) return -1;
  kern<<<dim3((unsigned)blocks, a.B), dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T, class G, int CR, int STAGES, bool GATHER>
static ConvPlan plan_of(int Cin) {
  return {launch_conv<T, G, CR, STAGES, GATHER>, conv_smem<T, G, CR, STAGES, GATHER>(Cin)};
}

// ---------------------------------------------------------------------------
// wgmma (bf16): m64nBNk16 with A from registers (a warp's 16 pixels, one image
// row, by ldmatrix from a halo tile) and B from a weight ring through a
// matrix descriptor. The ring holds 16 or 32 rows of K a stage as 64-column
// panels, rows of 128 bytes, 16-byte pieces swizzled as piece ^ (row & 7)
// (the 128-byte swizzle of a 1024-byte aligned block; TMA writes it so), the
// MN-major layout wgmma reads with B transposed: the 8-row groups of K lie
// 1024 bytes apart (stride offset), the panels one panel apart (leading
// offset).
// ---------------------------------------------------------------------------

template <int BN> __device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                                           const AFrag<__nv_bfloat16>& a,
                                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const AFrag<__nv_bfloat16>& a,
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      " %36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      " %48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      " %60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const AFrag<__nv_bfloat16>& a,
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc), "r"(1));
}
constexpr uint32_t WG_SBO = 1024;
constexpr int WG_ALIGN = 1024;  // the swizzle's block: rings start at such a boundary

// the tensor maps of a launch: x as (B, H, W, Cin), boxes of 16 channels by
// 18 x 10 pixels; the weight as its (9 Cin, Cout) matrix, boxes of rows by
// 64 columns, swizzled
struct ConvMaps {
  CUtensorMap x, w;
};

// ---------------------------------------------------------------------------
// The convs with a LayerNorm in front (bf16, Cout a multiple of 8, Cin up to
// 256): LN(x) needs every channel of a pixel, so the halo tile stays whole in
// shared memory as ln_prologue writes it (two 8 x 8 sub-tiles of an 8 x 16
// tile, 10 x 10 halo buffers), and the weight streams through a ring of TMA
// stages: thread 0 starts each stage's boxes on a full
// barrier and refills a stage once both warpgroups have released it on its
// empty barrier, so no barrier of the whole block stands in the loop, and
// the first stages are in flight while the LayerNorm runs. A stage holds 64
// rows of K; the ring is as deep as two blocks an SM allow (C <= 128) or as
// the halo leaves room for (C = 256: 6 stages). Warpgroup w
// multiplies tile rows 4 w .. 4 w + 3 (m64nBNk16, BN = 128 for Cout > 64,
// else 64).
// ---------------------------------------------------------------------------

constexpr int LN_KC = 64;  // rows of K a stage
// ring depth by the LayerNorm's channels per lane (C <= 32 CR)
template <int CR> __host__ __device__ constexpr int ln_stages() { return CR <= 2 ? 4 : CR <= 4 ? 3 : 6; }

template <int BN, int CR>
__host__ __device__ constexpr size_t conv_ln_smem(int Cin) {
  return WG_ALIGN + (size_t)ln_stages<CR>() * LN_KC * BN * 2 +
         (size_t)halo_pixels<GeoWide, true>() * (Cin + XPAD) * 2 +
         2 * ln_stages<CR>() * sizeof(uint64_t);
}

// the B operand of 16 rows of K from p, panels panel_bytes apart
__device__ __forceinline__ uint64_t panel_desc(const void* p, int panel_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(panel_bytes >> 4) << 16) |
         ((uint64_t)(WG_SBO >> 4) << 32) | (1ull << 62);
}

template <int BN, int CR>
__global__ void __launch_bounds__(NT) conv3x3_ln_kernel(const __grid_constant__ ConvArgs a,
                                                        const __grid_constant__ ConvMaps maps) {
  using T = __nv_bfloat16;
  using G = GeoWide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  constexpr int M = G::M, BS = BN + XPAD, NA = BN / 2, LN_STAGES = ln_stages<CR>();
  constexpr int PANEL = LN_KC * 128;              // 64 rows of a 64-column panel
  constexpr int STAGE_BYTES = LN_KC * BN * 2;     // BN / 64 panels
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = warp & 3;
  const int n_tiles = (Cout + BN - 1) / BN, tiles_x = (W + G::TW - 1) / G::TW;
  const int st = blockIdx.x / n_tiles, n0 = (blockIdx.x - st * n_tiles) * BN;
  const int y0 = (st / tiles_x) * G::TH, x0 = (st % tiles_x) * G::TW;
  const int b = blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * H * W * Cin;
  const int K = 9 * Cin, XS = Cin + XPAD;
  const int n_chunks = (K + LN_KC - 1) / LN_KC;
  unsigned char* ring = smem;
  T* as = reinterpret_cast<T*>(smem + LN_STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(as + halo_pixels<G, true>() * XS);
  uint64_t* empty = full + LN_STAGES;

  auto fill = [&](int ch, int s) {
    mbar_expect_tx(&full[s], STAGE_BYTES);
#pragma unroll
    for (int pp = 0; pp < BN / 64; ++pp)
      tma_load_2d(ring + s * STAGE_BYTES + pp * PANEL, &maps.w, n0 + 64 * pp, ch * LN_KC,
                  &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < LN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < LN_STAGES && s < n_chunks; ++s) fill(s, s);
  }
  // one 10 x 10 LayerNorm halo buffer per 8 x 8 sub-tile (ends in a barrier,
  // which also publishes the barriers' initialisation)
#pragma unroll 1
  for (int sub = 0; sub < (G::TH / TS) * (G::TW / TS); ++sub)
    ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W,
                       Cin, y0 + (sub / (G::TW / TS)) * TS, x0 + (sub % (G::TW / TS)) * TS,
                       as + sub * NPH * XS);

  // warp w: tile rows 16 w .. 16 w + 15 (one image row); warpgroup w / 4 the
  // 64 rows of its product
  int aoff[2];
  lane_rows<T>(aoff, warp, [XS](int p) { return halo_row<G, true>(p, XS); });

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  int tap = 0, c = 0;
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch % LN_STAGES;
    mbar_wait(&full[s], (ch / LN_STAGES) & 1);
    const unsigned char* bs = ring + s * STAGE_BYTES;
    AFrag<T> af[LN_KC / 16];
    const int steps = min(LN_KC / 16, (K - ch * LN_KC) / 16);
#pragma unroll
    for (int k = 0; k < LN_KC / 16; ++k) {
      if (k < steps) {
        frag_a(af[k], as + ((tap / 3) * PH + tap % 3) * XS + c, aoff);
        c += 16;
        if (c == Cin) { c = 0; ++tap; }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < LN_KC / 16; ++k)
      if (k < steps) wgmma_rs<BN>(acc, af[k], panel_desc(bs + k * 16 * 128, PANEL));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0 && q == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && ch + LN_STAGES < n_chunks) {
      mbar_wait(&empty[s], (ch / LN_STAGES) & 1);
      fill(ch + LN_STAGES, s);
    }
    __syncwarp();
  }
  pin(acc);
  __syncthreads();  // every copy was awaited, every product is done

  T* os = reinterpret_cast<T*>(smem);  // [M][BS]
  const T* bias = static_cast<const T*>(a.bias);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = (bias && n0 + col < Cout) ? to_f(bias[n0 + col]) : 0.f;
    const float b1 = (bias && n0 + col + 1 < Cout) ? to_f(bias[n0 + col + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* o = os + (warp * 16 + g + 8 * h) * BS + col;
      o[0] = from_f<T>(acc[4 * j + 2 * h] + b0);
      o[1] = from_f<T>(acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (size_t)b * H * W * Cout;
  for (int idx = tid; idx < M * (BN / 8); idx += NT) {
    const int p = idx / (BN / 8), cc = (idx - p * (BN / 8)) * 8;
    const int gy = y0 + p / G::TW, gx = x0 + p % G::TW, n = n0 + cc;
    if (gy >= H || gx >= W || n >= Cout) continue;
    *reinterpret_cast<uint4*>(out + ((size_t)gy * W + gx) * Cout + n) =
        *reinterpret_cast<const uint4*>(os + p * BS + cc);
  }
}

template <int BN, int CR>
static int launch_conv_ln(const ConvArgs& a, cudaStream_t stream) {
  ConvMaps maps;
  const uint64_t cin = a.Cin, cout = a.Cout;
  if (!encode_bf16<2>(&maps.w, a.w, {cout, 9 * cin}, {cout * 2}, {64, LN_KC},
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  auto kern = conv3x3_ln_kernel<BN, CR>;
  const size_t smem = conv_ln_smem<BN, CR>(a.Cin);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.H + GeoWide::TH - 1) / GeoWide::TH) *
                           ((a.W + GeoWide::TW - 1) / GeoWide::TW) * ((a.Cout + BN - 1) / BN);
  if (blocks > 0x7fffffffLL || a.B > 65535) return -1;
  kern<<<dim3((unsigned)blocks, a.B), dim3(NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

template <int BN, int CR>
static ConvPlan ln_wgmma_plan(int Cin) {
  return {launch_conv_ln<BN, CR>, conv_ln_smem<BN, CR>(Cin)};
}

// ---------------------------------------------------------------------------
// The convs without a LayerNorm whose N tile is wide (bf16, Cin a multiple
// of 16, Cout a multiple of 8 above 32): the halo comes through the ring too,
// 16 input channels a stage, so that a block can own 256 output pixels and
// keep three stages of 48 KB in flight whatever Cin. A block takes two 8 x 16
// sub-tiles of the (batch, tile row, tile column) list, one per consumer
// warpgroup (neighbours in the list, so a 40 x 40 latent map wastes no more
// than its 8 x 16 grid), by BN = 128 (Cout > 64) or 64 output channels.
// Stage c holds, for channels 16 c .. 16 c + 15, the two 10 x 18 halo windows
// (rows of 32 bytes, read by ldmatrix) and the 9 x 16 rows of K of those
// channels (tap-major, 64-column panels in the swizzled layout of the wgmma
// ring above). A ninth warp only copies: one thread starts the stage's TMA
// boxes (a 4-D box of x per window, whose parts outside the image arrive as
// zeros, and a 2-D box of the weight per tap and panel) on a full barrier,
// and refills a stage once both warpgroups have released it on its empty
// barrier, so no barrier of the whole block stands in the loop. Each
// warpgroup runs 9 taps x 2 halves of m64nBNk16 products a stage, A from
// registers. Each weight crosses from L2 once per 256 pixels.
// ---------------------------------------------------------------------------

constexpr int CK_CC = 16;                     // input channels a stage
constexpr int CK_HW = 18, CK_HP = 10 * 18;    // halo window of an 8 x 16 sub-tile
constexpr int CK_WIN = CK_HP * CK_CC * 2;     // bytes of a window: 5760
constexpr int CK_SUB = 2;                     // sub-tiles a block, one per warpgroup
constexpr int CK_ROWS = 9 * CK_CC;            // rows of K a stage
constexpr int CK_HALO_BYTES = 12288;          // two windows, 128-byte aligned, then 1 KB
constexpr int CK_STAGES = 4;
constexpr int CK_NT = NT + 32;                // two consumer warpgroups and a copy warp

template <int BN>
__host__ __device__ constexpr int ck_stage_bytes() {
  return CK_HALO_BYTES + CK_ROWS * BN * 2;
}
template <int BN>
__host__ __device__ constexpr size_t conv_chunked_smem() {
  const size_t ring = (size_t)CK_STAGES * ck_stage_bytes<BN>();
  const size_t out = (size_t)CK_SUB * 128 * (BN + XPAD) * 2;
  return WG_ALIGN + (ring > out ? ring : out) + 2 * CK_STAGES * sizeof(uint64_t);
}

// the consumer warpgroups' own barrier (the copy warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(CK_NT)
    conv3x3_chunked_kernel(const __grid_constant__ ConvArgs a,
                           const __grid_constant__ ConvMaps maps) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  constexpr int STAGE = ck_stage_bytes<BN>(), BS = BN + XPAD, NA = BN / 2;
  constexpr size_t RING = (size_t)CK_STAGES * STAGE;
  constexpr size_t OUT = (size_t)CK_SUB * 128 * BS * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (RING > OUT ? RING : OUT));
  uint64_t* empty = full + CK_STAGES;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (Cout + BN - 1) / BN;
  const int tiles_x = (W + 15) / 16, tiles_y = (H + 7) / 8, per_map = tiles_x * tiles_y;
  const int n_sub = a.B * per_map;
  const int pair = blockIdx.x / n_tiles, n0 = (blockIdx.x - pair * n_tiles) * BN;
  // sub-tile s: map sb(s), top-left pixel (sy(s), sx(s)); sb = B: past the
  // end of the list, read as zeros (selects, not arrays: s is a run-time value)
  static_assert(CK_SUB == 2, "one sub-tile a warpgroup");
  const int i0 = pair * CK_SUB, i1 = i0 + 1;
  const int b0_ = i0 / per_map, r0 = i0 - b0_ * per_map;
  const int b1_ = i1 / per_map, r1 = i1 - b1_ * per_map;
  const int sb0 = i0 < n_sub ? b0_ : a.B, sb1 = i1 < n_sub ? b1_ : a.B;
  const int sy0 = (r0 / tiles_x) * 8, sx0 = (r0 % tiles_x) * 16;
  const int sy1 = (r1 / tiles_x) * 8, sx1 = (r1 % tiles_x) * 16;
  auto sb = [&](int s) { return s ? sb1 : sb0; };
  auto sy = [&](int s) { return s ? sy1 : sy0; };
  auto sx = [&](int s) { return s ? sx1 : sx0; };
  const int n_chunks = Cin / CK_CC;

  if (tid == 0) {
    for (int s = 0; s < CK_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {  // the copy warp
    if (lane == 0) {
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int s = ch % CK_STAGES;
        if (ch >= CK_STAGES) mbar_wait(&empty[s], (ch / CK_STAGES - 1) & 1);
        unsigned char* base = smem + s * STAGE;
        mbar_expect_tx(&full[s], CK_SUB * CK_WIN + CK_ROWS * BN * 2);
        for (int sub = 0; sub < CK_SUB; ++sub)
          tma_load_4d(base + sub * (CK_HALO_BYTES / 2), &maps.x, ch * CK_CC, sx(sub) - 1,
                      sy(sub) - 1, sb(sub), &full[s]);
        for (int tap = 0; tap < 9; ++tap)
          for (int pp = 0; pp < BN / 64; ++pp)
            tma_load_2d(base + CK_HALO_BYTES + pp * (CK_ROWS * 128) + tap * CK_CC * 128, &maps.w,
                        n0 + 64 * pp, tap * Cin + ch * CK_CC, &full[s]);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  // warp q of warpgroup wg: rows 4 h + q of sub-tile wg for the halves h =
  // 0, 1; ldmatrix row lane & 15 (a pixel), channels 8 (lane >> 4) ..
  const int a0 =
      wg * (CK_HALO_BYTES / 2) + (q * CK_HW + (lane & 15)) * (CK_CC * 2) + (lane >> 4) * 16;

  float acc[2][NA];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[h][i] = 0.f;

#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch % CK_STAGES;
    mbar_wait(&full[s], (ch / CK_STAGES) & 1);
    const unsigned char* base = smem + s * STAGE;
    const unsigned char* wd = base + CK_HALO_BYTES;
    AFrag<T> af[2][2];  // [tap parity][half]
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ty = tap / 3, tx = tap % 3, buf = tap & 1;
      if (tap >= 2) wgmma_wait<1>();  // tap - 2's products are done with af[buf]
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_a(af[buf][h], reinterpret_cast<const T*>(
                               base + a0 + ((4 * h + ty) * CK_HW + tx) * (CK_CC * 2)));
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_rs<BN>(acc[h], af[buf][h], panel_desc(wd + tap * CK_CC * 128, CK_ROWS * 128));
      wgmma_commit();
    }
    wgmma_wait<0>();
    if (lane == 0 && q == 0) mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) pin(acc[h]);
  consumers_sync();  // every copy was awaited, every product is done

  // stage the two sub-tiles' results, bias added in fp32, rounded once
  T* os = reinterpret_cast<T*>(smem);  // [2 * 128][BS]
  const T* bias = static_cast<const T*>(a.bias);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = (bias && n0 + col < Cout) ? to_f(bias[n0 + col]) : 0.f;
    const float b1 = (bias && n0 + col + 1 < Cout) ? to_f(bias[n0 + col + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        T* o = os + (wg * 128 + (4 * h + q) * 16 + g + 8 * e) * BS + col;
        o[0] = from_f<T>(acc[h][4 * j + 2 * e] + b0);
        o[1] = from_f<T>(acc[h][4 * j + 2 * e + 1] + b1);
      }
  }
  consumers_sync();
  T* out = static_cast<T*>(a.out);
  for (int idx = tid; idx < CK_SUB * 128 * (BN / 8); idx += NT) {
    const int p = idx / (BN / 8), cc = (idx - p * (BN / 8)) * 8, s = p >> 7, pp = p & 127;
    const int gy = sy(s) + (pp >> 4), gx = sx(s) + (pp & 15), n = n0 + cc;
    if (sb(s) >= a.B || gy >= H || gx >= W || n >= Cout) continue;
    *reinterpret_cast<uint4*>(out + (((size_t)sb(s) * H + gy) * W + gx) * Cout + n) =
        *reinterpret_cast<const uint4*>(os + p * BS + cc);
  }
}

template <int BN>
static int launch_conv_chunked(const ConvArgs& a, cudaStream_t stream) {
  ConvMaps maps;
  const uint64_t cin = a.Cin, cout = a.Cout, w = a.W, h = a.H;
  if (!encode_bf16<4>(&maps.x, a.x, {cin, w, h, (uint64_t)a.B},
                      {cin * 2, w * cin * 2, h * w * cin * 2}, {CK_CC, CK_HW, 10, 1},
                      CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_bf16<2>(&maps.w, a.w, {cout, 9 * cin}, {cout * 2}, {64, CK_CC},
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  auto kern = conv3x3_chunked_kernel<BN>;
  const size_t smem = conv_chunked_smem<BN>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long subs = (long long)a.B * ((a.H + 7) / 8) * ((a.W + 15) / 16);
  const long long blocks = (subs + CK_SUB - 1) / CK_SUB * ((a.Cout + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return -1;
  kern<<<dim3((unsigned)blocks), dim3(CK_NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

template <int BN>
static ConvPlan chunked_plan() {
  return {launch_conv_chunked<BN>, conv_chunked_smem<BN>()};
}

constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block can have on sm_90

// the first plan whose shared memory fits; launch null: the case is not taken
static ConvPlan first_fit(std::initializer_list<ConvPlan> plans) {
  for (const ConvPlan& p : plans)
    if (p.smem <= SMEM_MAX) return p;
  return {nullptr, 0};
}

template <class T, int CR>
static ConvPlan ln_plan(int Cin, int Cout) {
  if constexpr (sizeof(T) == 2) {
    constexpr int S = STAGES_BF16;
    if (Cout % 8 == 0)
      return first_fit({Cout > 64 ? ln_wgmma_plan<128, CR>(Cin) : ln_wgmma_plan<64, CR>(Cin),
                        plan_of<T, GeoHalf, CR, S, false>(Cin)});
    if (Cout > 64)
      return first_fit({plan_of<T, GeoWide, CR, S, false>(Cin),
                        plan_of<T, GeoHalf, CR, S, false>(Cin)});
    return first_fit({plan_of<T, GeoHalf, CR, S, false>(Cin)});
  } else {
    return first_fit({plan_of<T, GeoF32, CR, STAGES_F32, false>(Cin)});
  }
}

template <class T>
static ConvPlan choose_plan(int Cin, int Cout, bool ln) {
  if (ln) {
    if (Cin % 16 != 0) return {nullptr, 0};
    if (Cin <= 64) return ln_plan<T, 2>(Cin, Cout);
    if (Cin <= 128) return ln_plan<T, 4>(Cin, Cout);
    if constexpr (sizeof(T) == 2) {  // float (the comparison type): Cin <= 128 only
      if (Cin <= 256) return ln_plan<T, 8>(Cin, Cout);
      if (Cin <= 512) return ln_plan<T, 16>(Cin, Cout);
    }
    return {nullptr, 0};
  }
  if constexpr (sizeof(T) == 2) {
    constexpr int S = STAGES_BF16;
    const ConvPlan gather = plan_of<T, GeoMid, 0, S, true>(Cin);
    if (Cin % 16 != 0) return gather;
    if (Cout > 32 && Cout % 8 == 0)
      return Cout > 64 ? chunked_plan<128>() : chunked_plan<64>();
    if (Cout > 64)
      return first_fit({plan_of<T, GeoWide, 0, S, false>(Cin), gather});
    if (Cout > 32)
      return first_fit({plan_of<T, GeoMid, 0, S, false>(Cin),
                        plan_of<T, GeoHalf, 0, S, false>(Cin), gather});
    if (Cout > 16)
      return first_fit({plan_of<T, GeoSlim, 0, S, false>(Cin),
                        plan_of<T, GeoHalf, 0, S, false>(Cin), gather});
    return first_fit({plan_of<T, GeoThin, 0, S, false>(Cin), plan_of<T, GeoSlim, 0, S, false>(Cin),
                      plan_of<T, GeoHalf, 0, S, false>(Cin), gather});
  } else {
    const ConvPlan gather = plan_of<T, GeoF32, 0, STAGES_F32, true>(Cin);
    if (Cin % 16 != 0) return gather;
    return first_fit({plan_of<T, GeoF32, 0, STAGES_F32, false>(Cin), gather});
  }
}

}  // namespace turtle

// the most shared memory a launch at this Cin takes, over every Cout and
// with or without the LayerNorm
extern "C" size_t turtle_conv3x3_smem(int Cin, int is_bf16) {
  using namespace turtle;
  size_t most = 0;
  for (int cout : {8, 24, 48, 128})
    for (int ln = 0; ln < 2; ++ln) {
      if (ln && Cin % 16 != 0) continue;
      const ConvPlan p = is_bf16 ? choose_plan<__nv_bfloat16>(Cin, cout, ln)
                                 : choose_plan<float>(Cin, cout, ln);
      if (p.launch != nullptr && p.smem > most) most = p.smem;
    }
  return most;
}

// ptrs: x, weight (3, 3, Cin, Cout), bias, out, ln_w, ln_b; ints: B, H, W, Cin, Cout
extern "C" int turtle_conv3x3_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  ConvArgs a;
  a.x = ptrs[0]; a.w = ptrs[1]; a.bias = ptrs[2]; a.out = ptrs[3];
  a.ln_w = ptrs[4]; a.ln_b = ptrs[5];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.Cin = ints[3]; a.Cout = ints[4];
  if (a.ln_w == nullptr && a.ln_b != nullptr) return -1;
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.Cin < 1 || a.Cout < 1) return -1;
  const bool ln = a.ln_w != nullptr;
  const ConvPlan p = is_bf16 ? choose_plan<__nv_bfloat16>(a.Cin, a.Cout, ln)
                             : choose_plan<float>(a.Cin, a.Cout, ln);
  if (p.launch == nullptr) return -1;
  return p.launch(a, static_cast<cudaStream_t>(stream));
}
