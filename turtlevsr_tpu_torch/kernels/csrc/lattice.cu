// The SAB lattice permutation between a map and its window tokens, both ways.
//
//   split: map (N, H, W, C) -> tokens (N, hh*ww, ws*ws*C), hh = H/ws, ww = W/ws
//          token (i, j), feature (a, b, c)  <-  pixel (a*hh + i, b*ww + j, c)
//   merge: the inverse
//
// Replaces lattice_split_op / lattice_merge_op of
// turtlevsr_tpu/kernels/lattice.py (_split_kernel, _merge_kernel). Pure
// copies, bound by bytes (every element read once and written once). One
// block per (i, a, n) moves the ws runs of ww*C elements that share a map
// row: on the map side a run is contiguous, on the token side it is ww
// pieces of C elements, ws*ws*C apart. Every access is a 16-byte vector, so
// C * sizeof(T) must be a multiple of 16 (any C that is a multiple of 8).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace turtle {

// V: 16-byte vectors; cv = vectors per pixel (C * sizeof(T) / 16)
template <bool MERGE>
__global__ void __launch_bounds__(256) lattice_kernel(const uint4* __restrict__ src,
                                                      uint4* __restrict__ dst, int hh, int ww,
                                                      int ws, int cv) {
  const int i = blockIdx.x, a = blockIdx.y, n = blockIdx.z;
  const size_t W = (size_t)ws * ww;
  // map row a*hh + i of image n; token row i of image n, feature slot a
  const size_t map_row = (((size_t)n * ws + a) * hh + i) * W * cv;
  const size_t tok_row = ((size_t)n * hh + i) * ww * ((size_t)ws * ws * cv) +
                         (size_t)a * ws * cv;
  const int per_b = ww * cv, total = ws * per_b;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int b = idx / per_b, r = idx - b * per_b;
    const int j = r / cv, c = r - j * cv;
    const size_t m = map_row + (size_t)idx;  // (b*ww + j) * cv + c
    const size_t t = tok_row + (size_t)j * ((size_t)ws * ws * cv) + (size_t)b * cv + c;
    if (MERGE) dst[m] = src[t];
    else dst[t] = src[m];
  }
}

}  // namespace turtle

// src, dst: 16-byte aligned; n images, token grid hh x ww, window ws, cv
// 16-byte vectors per pixel. merge != 0: tokens -> map, else map -> tokens.
// Returns the CUDA error code (0 = launched), -1 for a shape not taken.
extern "C" int turtle_lattice_launch(const void* src, void* dst, int n, int hh, int ww, int ws,
                                     int cv, int merge, void* stream) {
  using namespace turtle;
  if (n < 1 || hh < 1 || ww < 1 || ws < 1 || cv < 1 || ws > 65535 || n > 65535) return -1;
  const dim3 grid(hh, ws, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (merge)
    lattice_kernel<true><<<grid, dim3(256), 0, s>>>(static_cast<const uint4*>(src),
                                                    static_cast<uint4*>(dst), hh, ww, ws, cv);
  else
    lattice_kernel<false><<<grid, dim3(256), 0, s>>>(static_cast<const uint4*>(src),
                                                     static_cast<uint4*>(dst), hh, ww, ws, cv);
  return (int)cudaGetLastError();
}
