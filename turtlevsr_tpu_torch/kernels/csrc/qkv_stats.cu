// Channel-attention front: from one read of x, LN and the three chains
// dw3x3(pw1(LN x)) for q, k, v. Only the v map is written; q and k stay in
// shared memory and leave the block as the per-head Gram q^T k over the
// tile's pixels and the per-channel sums of q^2 and k^2 (q, k rounded to T
// first, as a written map would hold them).
//
// Replaces fused_qkv_stats in turtlevsr_tpu/kernels/ffn.py
// (_qkv_stats_kernel). That kernel carries the Gram across sequential grid
// steps; blocks here run in no order, so each block writes one row of
// partials [gram (heads, ctok, ctok) | sum q^2 (C) | sum k^2 (C)] and
// turtle_reduce_rows sums the rows in a fixed order in two passes: the
// result does not change from run to run. Only the per-head diagonal blocks
// of the Gram are computed (the attention reads nothing else). The chain is
// bound by operations (2*C*3C flop per pixel against one map read and one
// third of a map written); the chains run as mma.sync warp tiles as in ffn.cu,
// the tile's small Gram (64 pixels deep) as FMA.
#include "common.cuh"

namespace turtle {

struct QkvArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *wd, *bd;
  void* v;
  float* part;  // (B, n_tiles, width)
  int B, H, W, C, heads;
};

template <class T, int CR>
__global__ void __launch_bounds__(NT) qkv_stats_kernel(QkvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, CH = 3 * a.C, H = a.H, W = a.W, heads = a.heads;
  const int ctok = C / heads;
  const int tid = threadIdx.x;
  const int tiles_x = (W + TS - 1) / TS;
  const int n_tiles = gridDim.x;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;

  // shared memory: xn T[NPH*(C+XPAD)] | hid f32[NPH*HS] | qs, ks f32[P*ctok]
  T* xn = reinterpret_cast<T*>(smem);
  float* hid = reinterpret_cast<float*>(xn + NPH * (C + XPAD));
  float* qs = hid + NPH * HS;
  float* ks = qs + P * ctok;

  const size_t boff = (size_t)b * H * W * C;
  const T* x = static_cast<const T*>(a.x) + boff;
  ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W, C,
                     y0, x0, xn);

  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wd = static_cast<const T*>(a.wd);
  const T* bd = static_cast<const T*>(a.bd);
  const int width = heads * ctok * ctok + 2 * C;
  float* row = a.part + ((size_t)b * n_tiles + blockIdx.x) * width;

  for (int h = 0; h < heads; ++h) {
    for (int part = 0; part < 2; ++part) {
      float* dst = part == 0 ? qs : ks;
      // one chunk holds the head's ctok <= 64 channels of q (or k)
      const int cbase = part * C + h * ctok;
      const ChunkCols cols = {cbase, min(ctok, SEG), cbase + SEG, max(ctok - SEG, 0)};
      pw1_chunk<T>(xn, w1, b1, H, W, C, CH, y0, x0, cols, hid);
      __syncthreads();
      for (int item = tid; item < HC * TS; item += NT) {
        const int col = item % HC, px = item / HC;
        if (col >= ctok) continue;
        float v[TS];
        dw_column<T>(hid, wd, bd, CH, px, col, cbase + col, v);
#pragma unroll
        for (int py = 0; py < TS; ++py) {
          const bool inside = y0 + py < H && x0 + px < W;
          dst[(py * TS + px) * ctok + col] = inside ? round_to<T>(v[py]) : 0.f;
        }
      }
      __syncthreads();
    }
    for (int idx = tid; idx < ctok * ctok; idx += NT) {
      const int i = idx / ctok, j = idx % ctok;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += qs[p * ctok + i] * ks[p * ctok + j];
      row[h * ctok * ctok + idx] = s;
    }
    for (int idx = tid; idx < 2 * ctok; idx += NT) {
      const int part = idx / ctok, i = idx % ctok;
      const float* src = part == 0 ? qs : ks;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += src[p * ctok + i] * src[p * ctok + i];
      row[heads * ctok * ctok + part * C + h * ctok + i] = s;
    }
    __syncthreads();
  }

  T* v = static_cast<T*>(a.v) + boff;
  for (int cb = 0; cb < C; cb += HC)
    linear_chunk_to_global<T>(xn, w1, b1, wd, bd, H, W, C, CH, y0, x0, 2 * C + cb,
                              min(HC, C - cb), hid, v, C, cb);
}

// dst[b][g][i] = sum over rows r in group g of src[b][r][i], rows taken in
// order; groups of `per` rows. grid (ceil(width/256), n_groups, B).
__global__ void reduce_rows_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                   int n_rows, int per, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  const int g = blockIdx.y, n_groups = gridDim.y, b = blockIdx.z;
  const int r0 = g * per, r1 = min(n_rows, r0 + per);
  const float* s = src + ((size_t)b * n_rows + r0) * width + i;
  float acc = 0.f;
  for (int r = r0; r < r1; ++r, s += width) acc += *s;
  dst[((size_t)b * n_groups + g) * width + i] = acc;
}

template <class T, int CR>
static int launch_qkv(const QkvArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = qkv_stats_kernel<T, CR>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int dispatch_qkv(const QkvArgs& a, size_t smem, cudaStream_t stream) {
  if (a.C % 16 != 0) return -1;
  if (a.C <= 64) return launch_qkv<T, 2>(a, smem, stream);
  if (a.C <= 128) return launch_qkv<T, 4>(a, smem, stream);
  if constexpr (sizeof(T) == 2) {  // float (the comparison type): C <= 128 only
    if (a.C <= 256) return launch_qkv<T, 8>(a, smem, stream);
    if (a.C <= 512) return launch_qkv<T, 16>(a, smem, stream);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_qkv_stats_smem(int C, int heads, int is_bf16) {
  using namespace turtle;
  return (size_t)NPH * (C + XPAD) * (is_bf16 ? 2 : 4) + (size_t)NPH * HS * 4 +
         (size_t)2 * P * (C / heads) * 4;
}

// ptrs: x, ln_w, ln_b, w1 (C, 3C), b1, wd (3, 3, 3C), bd, v, part
// ints: B, H, W, C, heads. part is fp32 (B, n_tiles, heads*ctok^2 + 2C).
extern "C" int turtle_qkv_stats_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  QkvArgs a;
  a.x = ptrs[0]; a.ln_w = ptrs[1]; a.ln_b = ptrs[2]; a.w1 = ptrs[3]; a.b1 = ptrs[4];
  a.wd = ptrs[5]; a.bd = ptrs[6]; a.v = ptrs[7]; a.part = static_cast<float*>(ptrs[8]);
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.heads = ints[4];
  if (a.C % a.heads != 0 || a.C / a.heads > 64) return -1;
  const size_t smem = turtle_qkv_stats_smem(a.C, a.heads, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_qkv<__nv_bfloat16>(a, smem, s) : dispatch_qkv<float>(a, smem, s);
}

// one pass of the fixed-order sum: src (B, n_rows, width) -> dst (B, n_groups, width)
extern "C" int turtle_reduce_rows(const float* src, float* dst, int B, int n_rows, int per,
                                  int width, void* stream) {
  using namespace turtle;
  const int n_groups = (n_rows + per - 1) / per;
  const dim3 grid((width + 255) / 256, n_groups, B);
  reduce_rows_kernel<<<grid, dim3(256), 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, n_rows, per, width);
  return (int)cudaGetLastError();
}
