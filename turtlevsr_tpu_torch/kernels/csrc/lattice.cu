// The SAB lattice permutation between a map and its window tokens, both ways.
//
//   split: map (N, H, W, C) -> tokens (N, hh*ww, ws*ws*C), hh = H/ws, ww = W/ws
//          token (i, j), feature (a, b, c)  <-  pixel (a*hh + i, b*ww + j, c)
//   merge: the inverse
//
// Replaces lattice_split_op / lattice_merge_op of
// turtlevsr_tpu/kernels/lattice.py (_split_kernel, _merge_kernel). Pure
// copies, bound by bytes (every element read once and written once). The
// work is the map's 16-byte vectors of one image, walked in order: block
// (x, n) takes U * 256 consecutive vectors of image n, a thread every 256th
// of them. Each thread issues its U loads before any store, so a block keeps
// U * 4 KB in flight, and the grid has a block for every 32 KB of the map
// whatever its window or its token grid. On the map side a warp's vectors are
// contiguous; on the token side they are runs of one pixel's C channels. The
// map index is split into (pixel row, column, channel vector) and the
// lattice coordinates by four 32-bit divisions a vector. Every access is a
// 16-byte vector, so C * sizeof(T) must be a multiple of 16 (any C that is a
// multiple of 8).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace turtle {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // vectors a thread keeps in flight

// the token-side index of map vector m of one image (vectors); wd = ww * ws
// map pixels a row
__device__ __forceinline__ uint32_t token_index(uint32_t m, uint32_t cv, uint32_t wd,
                                                uint32_t hh, uint32_t ww, uint32_t ws) {
  const uint32_t pix = m / cv, c = m % cv;
  const uint32_t y = pix / wd, x = pix % wd;
  const uint32_t a = y / hh, i = y % hh;
  const uint32_t b = x / ww, j = x % ww;
  return ((i * ww + j) * ws * ws + a * ws + b) * cv + c;
}

template <bool MERGE>
__global__ void __launch_bounds__(kThreads) lattice_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, uint32_t per_image, uint32_t cv,
    uint32_t wd, uint32_t hh, uint32_t ww, uint32_t ws) {
  const size_t image = (size_t)blockIdx.y * per_image;
  src += image;
  dst += image;
  const uint32_t first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  uint4 v[kUnroll];
  uint32_t t[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const uint32_t m = first + k * kThreads;
    if (m < per_image) {
      t[k] = token_index(m, cv, wd, hh, ww, ws);
      v[k] = src[MERGE ? t[k] : m];
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const uint32_t m = first + k * kThreads;
    if (m < per_image) dst[MERGE ? m : t[k]] = v[k];
  }
}

}  // namespace turtle

// src, dst: 16-byte aligned; n images, token grid hh x ww, window ws, cv
// 16-byte vectors per pixel. merge != 0: tokens -> map, else map -> tokens.
// Returns the CUDA error code (0 = launched), -1 for a shape not taken (an
// image of about 2^32 vectors or more, which no 80 GB card holds twice, or
// more than 65535 images).
extern "C" int turtle_lattice_launch(const void* src, void* dst, int n, int hh, int ww, int ws,
                                     int cv, int merge, void* stream) {
  using namespace turtle;
  if (n < 1 || hh < 1 || ww < 1 || ws < 1 || cv < 1 || n > 65535) return -1;
  const uint64_t per_image = (uint64_t)hh * ws * ww * ws * cv;
  const uint32_t chunk = kThreads * kUnroll;
  if (per_image > UINT32_MAX - chunk) return -1;  // a block's last index in 32 bits
  const dim3 grid((uint32_t)((per_image + chunk - 1) / chunk), n);
  const uint32_t wd = (uint32_t)ww * ws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (merge)
    lattice_kernel<true><<<grid, dim3(kThreads), 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), (uint32_t)per_image, cv, wd,
        hh, ww, ws);
  else
    lattice_kernel<false><<<grid, dim3(kThreads), 0, s>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), (uint32_t)per_image, cv, wd,
        hh, ww, ws);
  return (int)cudaGetLastError();
}
