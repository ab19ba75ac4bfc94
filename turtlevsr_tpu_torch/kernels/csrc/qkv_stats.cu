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
// the tile's small Gram (64 pixels deep) as FMA. float32 up to C = 512, the
// LN halo in device memory at C = 512 (common.cuh; ffn.py's _qkv_f32_plan
// mirrors the dispatch below).
#include "qkv_tile.cuh"

namespace turtle {

// __grid_constant__: the tile code takes the arguments by reference; without
// it the compiler copies them to local memory first, which cost the wide
// levels 8-22 % of their time on an H100.
// XN_DEV: the LN halo in this block's slice of xn_dev (float32 at C = 512)
template <class T, int CR, bool XN_DEV>
__global__ void __launch_bounds__(NT) qkv_stats_kernel(const __grid_constant__ QkvArgs a,
                                                       T* xn_dev) {
  extern __shared__ __align__(16) unsigned char smem[];
  qkv_tile<T, CR, XN_DEV>(a, blockIdx.y, blockIdx.x, gridDim.x, smem, xn_dev);
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

template <class T, int CR, bool XN_DEV = false>
static int launch_qkv(const QkvArgs& a, size_t smem, cudaStream_t stream,
                      void* xn_dev = nullptr) {
  if (XN_DEV && xn_dev == nullptr) return -1;
  auto kern = qkv_stats_kernel<T, CR, XN_DEV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a, static_cast<T*>(xn_dev));
  return (int)cudaGetLastError();
}

// both types up to C = 512; float at C > 256 with the halo in device memory
template <class T>
static int dispatch_qkv(const QkvArgs& a, void* xn_dev, size_t smem, cudaStream_t stream) {
  if (a.C % 16 != 0) return -1;
  if (a.C <= 64) return launch_qkv<T, 2>(a, smem, stream);
  if (a.C <= 128) return launch_qkv<T, 4>(a, smem, stream);
  if (a.C <= 256) return launch_qkv<T, 8>(a, smem, stream);
  if (a.C <= 512) {
    if constexpr (sizeof(T) == 2) return launch_qkv<T, 16>(a, smem, stream);
    else return launch_qkv<T, 16, true>(a, smem, stream, xn_dev);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_qkv_stats_smem(int C, int heads, int is_bf16) {
  return turtle::qkv_tile_smem(C, heads, is_bf16, turtle::halo_in_device_memory(C, is_bf16));
}

// ptrs: x, ln_w, ln_b, w1 (C, 3C), b1, wd (3, 3, 3C), bd, v, part, then
//       (read only where the halo lives in device memory: float32 at C > 256)
//       xn_dev, B * n_tiles * 100 * (C + 8) floats
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
  void* xn_dev = halo_in_device_memory(a.C, is_bf16) ? ptrs[9] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_qkv<__nv_bfloat16>(a, nullptr, smem, s)
                 : dispatch_qkv<float>(a, xn_dev, smem, s);
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
