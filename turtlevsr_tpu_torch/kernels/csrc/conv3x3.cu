// Dense 3x3 stride-1 pad-1 convolution on an NHWC map, weight
// (3, 3, Cin, Cout), optional bias: the input projection, the ending conv and
// the bodies of the down- and upsamplers.
//
// Replaces fused_conv3x3 in turtlevsr_tpu/kernels/ffn.py (_conv3_kernel).
// With ln_w the conv runs on LN(x): channel LayerNorm of the halo tile as it
// lands in shared memory (fp32 statistics, rounded to T, zero rows outside
// the image: the border is zero padding of LN(x)); the composite v chain of
// the SAB front takes this path.
// On an H100 the wide convs (128->256 .. 512->1024) are bound by operations
// (18*Cin*Cout flop per pixel), the 3->64 and 64->3 ends by bytes. A block
// holds its 10x10 halo tile of the input in shared memory once and walks
// Cout in passes of 128 channels; each warp owns 16 of them and runs the
// nine taps as mma.sync warp tiles over Cin (a tap only shifts the rows of
// A inside the halo tile). Cin that is not a multiple of 16 (the 3-channel
// input) takes a scalar FMA path: warp = tile row, lane = output channels,
// no 16-byte loads there.
#include "common.cuh"

namespace turtle {

struct ConvArgs {
  const void *x, *w, *bias, *ln_w, *ln_b;
  void* out;
  int B, H, W, Cin, Cout;
};

constexpr int COR = 4;  // output channels per lane and pass

// CR: 0 without LayerNorm, else the channels per lane of its prologue
// (Cin <= 32 CR, Cin a multiple of 16)
template <class T, int CR>
__global__ void __launch_bounds__(NT) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + TS - 1) / TS;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TS, x0 = (blockIdx.x % tiles_x) * TS;
  const bool tiled = Cin % 16 == 0;
  const int XS = tiled ? Cin + XPAD : Cin;
  T* xs = reinterpret_cast<T*>(smem);  // T[NPH * XS], zero outside the image
  const T* x = static_cast<const T*>(a.x) + (size_t)b * H * W * Cin;
  if constexpr (CR > 0) {
    ln_prologue<T, CR>(x, static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b), H, W,
                       Cin, y0, x0, xs);
  } else if (tiled) {
    const int c8n = Cin / 8;
    for (int idx = tid; idx < NPH * c8n; idx += NT) {
      const int p = idx / c8n, c8 = (idx - p * c8n) * 8;
      if (halo_inside(p, H, W, y0, x0))
        copy8(xs + p * XS + c8, x + halo_offset(p, W, Cin, y0, x0) + c8);
      else
        zero8(xs + p * XS + c8);
    }
  } else {
    for (int idx = tid; idx < NPH * Cin; idx += NT) {
      const int p = idx / Cin, c = idx - p * Cin;
      xs[idx] = halo_inside(p, H, W, y0, x0) ? x[halo_offset(p, W, Cin, y0, x0) + c]
                                             : from_f<T>(0.f);
    }
  }
  __syncthreads();

  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out) + (size_t)b * H * W * Cout;

  if (tiled) {
    // 16-pixel tile mi = tile rows 2 mi (lane rows g) and 2 mi + 1 (g + 8)
    const int g = lane >> 2, t = lane & 3;
    for (int co0 = warp * 16; co0 < Cout; co0 += NW * 16) {
      float acc[MT_P][2][4];
#pragma unroll
      for (int mi = 0; mi < MT_P; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int ty = tap / 3, tx = tap % 3;
        const T* wt = w + (size_t)tap * Cin * Cout;
        for (int k0 = 0; k0 < Cin; k0 += 16) {
          BFrag<T> bf[2];
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int n = co0 + 8 * nj + g;
            load_b(bf[nj], wt, (size_t)Cout, k0, Cin, n < Cout ? n : -1);
          }
#pragma unroll
          for (int mi = 0; mi < MT_P; ++mi) {
            const T* lo = xs + ((2 * mi + ty) * PH + g + tx) * XS;
            AFrag<T> af;
            load_a(af, lo, lo + PH * XS, k0);
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) tile_mma(acc[mi][nj], af, bf[nj]);
          }
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = co0 + 8 * nj + 2 * t + (i & 1);
          if (co >= Cout) continue;
          const float bb = bias ? to_f(bias[co]) : 0.f;
#pragma unroll
          for (int mi = 0; mi < MT_P; ++mi) {
            const int gy = y0 + 2 * mi + (i >> 1), gx = x0 + g;
            if (gy < H && gx < W)
              out[((size_t)gy * W + gx) * Cout + co] = from_f<T>(acc[mi][nj][i] + bb);
          }
        }
    }
    return;
  }

  const int gy = y0 + warp;
  for (int co0 = 0; co0 < Cout; co0 += 32 * COR) {
    float acc[TS][COR];
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int j = 0; j < COR; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int ty = tap / 3, tx = tap % 3;
      const T* xrow = xs + ((warp + ty) * PH + tx) * Cin;  // pixel i is at + i * Cin
      const T* wt = w + (size_t)tap * Cin * Cout;
      for (int k = 0; k < Cin; ++k) {
        float wv[COR];
#pragma unroll
        for (int j = 0; j < COR; ++j) {
          const int co = co0 + lane + 32 * j;
          wv[j] = co < Cout ? to_f(wt[(size_t)k * Cout + co]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TS; ++i) {
          const float xv = to_f(xrow[i * Cin + k]);
#pragma unroll
          for (int j = 0; j < COR; ++j) acc[i][j] += xv * wv[j];
        }
      }
    }
    if (gy < H) {
#pragma unroll
      for (int j = 0; j < COR; ++j) {
        const int co = co0 + lane + 32 * j;
        if (co >= Cout) continue;
        const float bb = bias ? to_f(bias[co]) : 0.f;
#pragma unroll
        for (int i = 0; i < TS; ++i)
          if (x0 + i < W)
            out[((size_t)gy * W + x0 + i) * Cout + co] = from_f<T>(acc[i][j] + bb);
      }
    }
  }
}

template <class T, int CR>
static int launch_conv(const ConvArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = conv3x3_kernel<T, CR>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS), a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int dispatch_conv(const ConvArgs& a, size_t smem, cudaStream_t stream) {
  if (a.ln_w == nullptr) return a.ln_b ? -1 : launch_conv<T, 0>(a, smem, stream);
  if (a.Cin % 16 != 0) return -1;
  if (a.Cin <= 64) return launch_conv<T, 2>(a, smem, stream);
  if (a.Cin <= 128) return launch_conv<T, 4>(a, smem, stream);
  if constexpr (sizeof(T) == 2) {  // float (the comparison type): Cin <= 128 only
    if (a.Cin <= 256) return launch_conv<T, 8>(a, smem, stream);
    if (a.Cin <= 512) return launch_conv<T, 16>(a, smem, stream);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_conv3x3_smem(int Cin, int is_bf16) {
  using namespace turtle;
  // rounded up to 16 bytes; the scalar path has no alignment needs
  const int xs = Cin % 16 == 0 ? Cin + XPAD : Cin;
  return ((size_t)NPH * xs * (is_bf16 ? 2 : 4) + 15) / 16 * 16;
}

// ptrs: x, weight (3, 3, Cin, Cout), bias, out, ln_w, ln_b; ints: B, H, W, Cin, Cout
extern "C" int turtle_conv3x3_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  ConvArgs a;
  a.x = ptrs[0]; a.w = ptrs[1]; a.bias = ptrs[2]; a.out = ptrs[3];
  a.ln_w = ptrs[4]; a.ln_b = ptrs[5];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.Cin = ints[3]; a.Cout = ints[4];
  const size_t smem = turtle_conv3x3_smem(a.Cin, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_conv<__nv_bfloat16>(a, smem, s) : dispatch_conv<float>(a, smem, s);
}
