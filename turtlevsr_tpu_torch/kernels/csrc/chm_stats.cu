// Front of the causal history model's routing, one pass over the current
// map x and the NF aligned frames x_sp:
//
//   q, k, v = dw3x3(pw1(LN x))          (the ChanAttn qkv weights)
//   kh_n, vh_n = dw3x3(pw1(x_sp[n]))    (the kv weights, shared by all
//                                        frames, NO LayerNorm)
//
// Written: the maps v (B, H, W, C) and vh (B, NF, H, W, C). q, k and every
// kh_n stay in shared memory and leave the block as fp32 statistics (after
// rounding to T, as a written map would hold them): the per-head Grams
// q_h^T k_h and q_h^T kh_n,h over the tile's pixels and the per-channel sums
// of q^2, k^2 and kh_n^2. No biases (the configurations with biases take the
// unfused route).
//
// Replaces fused_chm_stats in turtlevsr_tpu/kernels/ffn.py
// (_chm_stats_kernel). As in qkv_stats.cu every block writes one row of
// partials
//   [g (heads, ctok, ctok) | gh (NF, heads, ctok, ctok) | sum q^2 (C) |
//    sum k^2 (C) | sum kh_n^2 (NF, C)]
// and turtle_reduce_rows sums the rows in a fixed order: bitwise repeatable,
// no atomics. Only the per-head diagonal blocks of the (C, C) Grams are
// computed. The block keeps its q tile (64 pixels x C, fp32) while it walks
// the frames. On an H100 the chains are bound by operations
// (2*C*(3 + 2 NF)*C flop per pixel against NF + 1 maps read and written);
// they run as mma.sync warp tiles (common.cuh), the 64-pixel-deep Grams as
// FMA on 4x4 register tiles. float32 up to C = 512, the LN halo in device
// memory at C = 512 (common.cuh; ffn.py's _chm_f32_plan mirrors the
// dispatch below).
#include "common.cuh"

namespace turtle {

struct ChmArgs {
  const void *x, *xsp, *ln_w, *ln_b, *w_qkv, *wd_qkv, *w_kv, *wd_kv;
  void *v, *vh;
  float* part;  // (B, n_tiles, width)
  int B, H, W, C, heads, NF;
};

// dst[pixel * dstride + col] = dw3x3(pw1(xn))[channel cbase + col] rounded to
// T, col < n <= 64, for the tile's 64 pixels (zero outside the image)
template <class T>
__device__ void chain_to_shared(const T* xn, const T* w1, const T* wd, int H, int W, int C,
                                int CH, int y0, int x0, int cbase, int n, float* hid,
                                float* dst, int dstride) {
  const ChunkCols cols = {cbase, min(n, SEG), cbase + SEG, max(n - SEG, 0)};
  pw1_chunk<T>(xn, w1, nullptr, H, W, C, CH, y0, x0, cols, hid);
  __syncthreads();
  for (int item = threadIdx.x; item < HC * TS; item += NT) {
    const int col = item % HC, px = item / HC;
    if (col >= n) continue;
    float v[TS];
    dw_column<T>(hid, wd, nullptr, CH, px, col, cbase + col, v);
#pragma unroll
    for (int py = 0; py < TS; ++py) {
      const bool inside = y0 + py < H && x0 + px < W;
      dst[(py * TS + px) * dstride + col] = inside ? round_to<T>(v[py]) : 0.f;
    }
  }
  __syncthreads();
}

// out[i * n + j] = sum over the 64 pixels of qa[p * qs + i] * kb[p * ks + j],
// i, j < n <= 64: thread (ti, tj) of a 16 x 16 grid owns a 4 x 4 block
__device__ void tile_gram(const float* qa, int qs, const float* kb, int ks, int n,
                          float* out) {
  const int i0 = (threadIdx.x >> 4) * 4, j0 = (threadIdx.x & 15) * 4;
  if (i0 >= n || j0 >= n) return;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  const bool vec = (n & 3) == 0 && (qs & 3) == 0 && (ks & 3) == 0;
  for (int p = 0; p < P; ++p) {
    float qv[4], kv[4];
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(qa + p * qs + i0);
      const float4 b = *reinterpret_cast<const float4*>(kb + p * ks + j0);
      qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
      kv[0] = b.x; kv[1] = b.y; kv[2] = b.z; kv[3] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = i0 + u < n ? qa[p * qs + i0 + u] : 0.f;
        kv[u] = j0 + u < n ? kb[p * ks + j0 + u] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += qv[u] * kv[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (i0 + u < n && j0 + v < n) out[(i0 + u) * n + j0 + v] = acc[u][v];
}

// out[i] = sum over the 64 pixels of src[p * stride + i]^2, i < n
__device__ void tile_sumsq(const float* src, int stride, int n, float* out) {
  for (int i = threadIdx.x; i < n; i += NT) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += src[p * stride + i] * src[p * stride + i];
    out[i] = s;
  }
}

// XN_DEV: the halo of x and of each frame in this block's slice of xn_dev
// (common.cuh), the shared memory starts at hid
template <class T, int CR, bool XN_DEV = false>
__global__ void __launch_bounds__(NT) chm_stats_kernel(ChmArgs a, T* xn_dev) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, H = a.H, W = a.W, heads = a.heads, NF = a.NF;
  const int ctok = C / heads, g2 = ctok * ctok;
  const int tiles_x = (W + TS - 1) / TS;
  const int n_tiles = gridDim.x;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;

  // shared memory: xn T[NPH*(C+XPAD)] | hid f32[NPH*HS] | qs f32[P*C] |
  //                ks f32[P*ctok]; XN_DEV: xn in device memory
  T* xn;
  float* hid;
  if constexpr (XN_DEV) {
    xn = xn_dev + ((size_t)b * n_tiles + blockIdx.x) * NPH * (C + XPAD);
    hid = reinterpret_cast<float*>(smem);
  } else {
    xn = reinterpret_cast<T*>(smem);
    hid = reinterpret_cast<float*>(xn + NPH * (C + XPAD));
  }
  float* qs = hid + NPH * HS;
  float* ks = qs + P * C;

  const size_t map = (size_t)H * W * C;
  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const T* w_qkv = static_cast<const T*>(a.w_qkv);
  const T* wd_qkv = static_cast<const T*>(a.wd_qkv);
  const T* w_kv = static_cast<const T*>(a.w_kv);
  const T* wd_kv = static_cast<const T*>(a.wd_kv);

  const int width = (NF + 1) * heads * g2 + (NF + 2) * C;
  float* row = a.part + ((size_t)b * n_tiles + blockIdx.x) * width;
  float* g_row = row;
  float* gh_row = row + heads * g2;
  float* s_row = row + (NF + 1) * heads * g2;  // [q | k | kh_0 .. kh_NF-1], C each

  // the current frame: q, k per head, then v
  ln_prologue<T, CR>(static_cast<const T*>(a.x) + (size_t)b * map, ln_w, ln_b, H, W, C, y0, x0,
                     xn);
  for (int h = 0; h < heads; ++h) {
    chain_to_shared<T>(xn, w_qkv, wd_qkv, H, W, C, 3 * C, y0, x0, h * ctok, ctok, hid,
                       qs + h * ctok, C);
    chain_to_shared<T>(xn, w_qkv, wd_qkv, H, W, C, 3 * C, y0, x0, C + h * ctok, ctok, hid, ks,
                       ctok);
    tile_gram(qs + h * ctok, C, ks, ctok, ctok, g_row + h * g2);
    tile_sumsq(qs + h * ctok, C, ctok, s_row + h * ctok);
    tile_sumsq(ks, ctok, ctok, s_row + C + h * ctok);
    __syncthreads();  // ks is rewritten by the next head
  }
  T* v = static_cast<T*>(a.v) + (size_t)b * map;
  for (int cb = 0; cb < C; cb += HC)
    linear_chunk_to_global<T>(xn, w_qkv, nullptr, wd_qkv, nullptr, H, W, C, 3 * C, y0, x0,
                              2 * C + cb, min(HC, C - cb), hid, v, C, cb);

  // the aligned frames, through the shared kv weights, without LayerNorm
  for (int n = 0; n < NF; ++n) {
    const size_t foff = ((size_t)b * NF + n) * map;
    ln_prologue<T, CR>(static_cast<const T*>(a.xsp) + foff, nullptr, nullptr, H, W, C, y0, x0,
                       xn);
    for (int h = 0; h < heads; ++h) {
      chain_to_shared<T>(xn, w_kv, wd_kv, H, W, C, 2 * C, y0, x0, h * ctok, ctok, hid, ks,
                         ctok);
      tile_gram(qs + h * ctok, C, ks, ctok, ctok, gh_row + ((size_t)n * heads + h) * g2);
      tile_sumsq(ks, ctok, ctok, s_row + (2 + n) * C + h * ctok);
      __syncthreads();
    }
    T* vh = static_cast<T*>(a.vh) + foff;
    for (int cb = 0; cb < C; cb += HC)
      linear_chunk_to_global<T>(xn, w_kv, nullptr, wd_kv, nullptr, H, W, C, 2 * C, y0, x0,
                                C + cb, min(HC, C - cb), hid, vh, C, cb);
  }
}

template <class T, int CR, bool XN_DEV = false>
static int launch_chm(const ChmArgs& a, size_t smem, cudaStream_t stream,
                      void* xn_dev = nullptr) {
  if (XN_DEV && xn_dev == nullptr) return -1;
  auto kern = chm_stats_kernel<T, CR, XN_DEV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a, static_cast<T*>(xn_dev));
  return (int)cudaGetLastError();
}

// both types up to C = 512; float at C > 256 with the halo in device memory
template <class T>
static int dispatch_chm(const ChmArgs& a, void* xn_dev, size_t smem, cudaStream_t stream) {
  if (a.C % 16 != 0) return -1;
  if (a.C <= 64) return launch_chm<T, 2>(a, smem, stream);
  if (a.C <= 128) return launch_chm<T, 4>(a, smem, stream);
  if (a.C <= 256) return launch_chm<T, 8>(a, smem, stream);
  if (a.C <= 512) {
    if constexpr (sizeof(T) == 2) return launch_chm<T, 16>(a, smem, stream);
    else return launch_chm<T, 16, true>(a, smem, stream, xn_dev);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_chm_stats_smem(int C, int heads, int is_bf16) {
  using namespace turtle;
  return (halo_in_device_memory(C, is_bf16) ? 0
                                            : (size_t)NPH * (C + XPAD) * (is_bf16 ? 2 : 4)) +
         (size_t)NPH * HS * 4 + (size_t)P * (C + C / heads) * 4;
}

// ptrs: x (B, H, W, C), x_sp (B, NF, H, W, C), ln_w, ln_b, w_qkv (C, 3C),
//       wd_qkv (3, 3, 3C), w_kv (C, 2C), wd_kv (3, 3, 2C), v, vh, part, then
//       (read only where the halo lives in device memory: float32 at C >
//       256) xn_dev, B * n_tiles * 100 * (C + 8) floats
// ints: B, H, W, C, heads, NF. part is fp32
// (B, n_tiles, (NF + 1) * heads * ctok^2 + (NF + 2) * C).
extern "C" int turtle_chm_stats_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  ChmArgs a;
  a.x = ptrs[0]; a.xsp = ptrs[1]; a.ln_w = ptrs[2]; a.ln_b = ptrs[3]; a.w_qkv = ptrs[4];
  a.wd_qkv = ptrs[5]; a.w_kv = ptrs[6]; a.wd_kv = ptrs[7]; a.v = ptrs[8]; a.vh = ptrs[9];
  a.part = static_cast<float*>(ptrs[10]);
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.heads = ints[4];
  a.NF = ints[5];
  if (a.heads < 1 || a.C % a.heads != 0 || a.C / a.heads > 64 || a.NF < 1) return -1;
  const size_t smem = turtle_chm_stats_smem(a.C, a.heads, is_bf16);
  void* xn_dev = halo_in_device_memory(a.C, is_bf16) ? ptrs[11] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_chm<__nv_bfloat16>(a, nullptr, smem, s)
                 : dispatch_chm<float>(a, xn_dev, smem, s);
}
