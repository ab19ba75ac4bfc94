// N chains dw3x3(pw1(LN x)) from one read of x, each written as its own map
// (the q, k, v maps of the latent FHR blocks, the q, k maps of the SAB front).
// Without ln_w the chains run on x itself.
//
// Replaces fused_ln_split_proj in turtlevsr_tpu/kernels/ffn.py
// (_multi_dw_kernel). Bound by operations on an H100 (2*C*N*E flop per pixel
// against one map read and N written); LN(x) of the halo tile is computed
// once per block and every chain walks it in chunks of 64 hidden columns
// (mma.sync warp tiles, see common.cuh). float32 up to C = 512, the LN halo
// in device memory at C = 512 (common.cuh; ffn.py's _split_f32_plan mirrors
// the dispatch below).
#include "common.cuh"

namespace turtle {

struct SplitArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *wd, *bd;
  void* out[4];
  int B, H, W, C, E, n_out;
};

// XN_DEV: the LN halo in this block's slice of xn_dev (common.cuh), the
// shared memory holds hid only
template <class T, int CR, bool XN_DEV = false>
__global__ void __launch_bounds__(NT) split_proj_kernel(SplitArgs a, T* xn_dev) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, E = a.E, CH = a.E * a.n_out, H = a.H, W = a.W;
  const int tiles_x = (W + TS - 1) / TS;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;
  T* xn;
  float* hid;
  if constexpr (XN_DEV) {
    xn = xn_dev + ((size_t)b * gridDim.x + blockIdx.x) * NPH * (C + XPAD);
    hid = reinterpret_cast<float*>(smem);
  } else {
    xn = reinterpret_cast<T*>(smem);
    hid = reinterpret_cast<float*>(xn + NPH * (C + XPAD));
  }
  const T* x = static_cast<const T*>(a.x) + (size_t)b * H * W * C;
  ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W, C,
                     y0, x0, xn);
  for (int n = 0; n < a.n_out; ++n) {
    T* out = static_cast<T*>(a.out[n]) + (size_t)b * H * W * E;
    for (int cb = 0; cb < E; cb += HC)
      linear_chunk_to_global<T>(xn, static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
                                static_cast<const T*>(a.wd), static_cast<const T*>(a.bd), H, W,
                                C, CH, y0, x0, n * E + cb, min(HC, E - cb), hid, out, E, cb);
  }
}

template <class T, int CR, bool XN_DEV = false>
static int launch_split(const SplitArgs& a, size_t smem, cudaStream_t stream,
                        void* xn_dev = nullptr) {
  if (XN_DEV && xn_dev == nullptr) return -1;
  auto kern = split_proj_kernel<T, CR, XN_DEV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a, static_cast<T*>(xn_dev));
  return (int)cudaGetLastError();
}

// both types up to C = 512; float at C > 256 with the halo in device memory
template <class T>
static int dispatch_split(const SplitArgs& a, void* xn_dev, size_t smem, cudaStream_t stream) {
  if (a.C % 16 != 0) return -1;
  if (a.C <= 64) return launch_split<T, 2>(a, smem, stream);
  if (a.C <= 128) return launch_split<T, 4>(a, smem, stream);
  if (a.C <= 256) return launch_split<T, 8>(a, smem, stream);
  if (a.C <= 512) {
    if constexpr (sizeof(T) == 2) return launch_split<T, 16>(a, smem, stream);
    else return launch_split<T, 16, true>(a, smem, stream, xn_dev);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_split_proj_smem(int C, int is_bf16) {
  using namespace turtle;
  return (halo_in_device_memory(C, is_bf16) ? 0
                                            : (size_t)NPH * (C + XPAD) * (is_bf16 ? 2 : 4)) +
         (size_t)NPH * HS * 4;
}

// ptrs: x, ln_w, ln_b, w1 (C, N*E), b1, wd (3, 3, N*E), bd, out_0 .. out_3,
//       then (read only where the halo lives in device memory: float32 at
//       C > 256) xn_dev, B * n_tiles * 100 * (C + 8) floats
// ints: B, H, W, C, E, n_out (<= 4)
extern "C" int turtle_split_proj_launch(void* const* ptrs, const int* ints, int is_bf16,
                                        void* stream) {
  using namespace turtle;
  SplitArgs a;
  a.x = ptrs[0]; a.ln_w = ptrs[1]; a.ln_b = ptrs[2]; a.w1 = ptrs[3]; a.b1 = ptrs[4];
  a.wd = ptrs[5]; a.bd = ptrs[6];
  for (int i = 0; i < 4; ++i) a.out[i] = ptrs[7 + i];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.E = ints[4]; a.n_out = ints[5];
  if (a.n_out < 1 || a.n_out > 4) return -1;
  const size_t smem = turtle_split_proj_smem(a.C, is_bf16);
  void* xn_dev = halo_in_device_memory(a.C, is_bf16) ? ptrs[11] : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_split<__nv_bfloat16>(a, nullptr, smem, s)
                 : dispatch_split<float>(a, xn_dev, smem, s);
}
