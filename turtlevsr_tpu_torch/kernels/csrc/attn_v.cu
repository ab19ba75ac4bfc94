// Attention @ values of the StateAlignBlock with the window layout folded
// into the store: out[n] = a[n] @ v[n] for a (BN, HW, HW) probabilities and
// v (BN, HW, D) lattice-layout window values, D = S * c (S = ws^2 slots of c
// channels, feature order (p1, p2, c)). One kernel, two epilogues:
//
//   slots  out (BN, S, HW, c):    out[n][s][q][cc] = (a @ v)[n][q][s * c + cc]
//   merge  out (BN, H, W, c):     element (q = (i, j), d = (p1, p2, cc)) lands
//          at map position (p1 * hh + i, p2 * ww + j, cc): the product and the
//          lattice un-split in one pass, the token tensor never exists
//
// Replaces sab_attn_v_slots (_av_kernel / _av_pair_kernel) and
// sab_attn_v_merge in turtlevsr_tpu/kernels/sab.py. The TPU kernel tiles the
// D axis by slot so that its output layout makes the merge a coarse
// transpose; here a block owns 64 query rows by 128 columns of D, walks the
// keys in chunks of 64 through shared memory and multiplies with mma.sync
// (bf16 tensor cores, fp32 sums, one rounding to the map's type). The result
// tile is staged in shared memory and leaves in 16-byte pieces, each piece
// inside one slot (c is a multiple of 8), so the merge costs no extra pass.
// The work is bound by operations (2 HW^2 D flop per entry against
// HW (HW + 2 D) elements moved). The values of each entry n = b * NF + i
// are read where they lie: v is given as NF tensors with their own batch
// strides (the ring positions of the cache and the current frame's values),
// no stacked copy is made. The validity of a frame is already in a.
#include "common.cuh"

namespace turtle {

constexpr int AV_BM = 64;    // query rows per block
constexpr int AV_BN = 128;   // columns of D per block
constexpr int AV_KC = 64;    // keys per chunk
constexpr int AV_AS = AV_KC + XPAD;  // row stride of the a tile
constexpr int AV_VS = AV_BN + XPAD;  // row stride of the v tile and the out tile
constexpr int AV_MAX_V = 5;  // value tensors per launch (ring positions + 1)

struct AvArgs {
  const void* a;           // entry n starts at a + n * a_bs elements
  const void* v[AV_MAX_V]; // entry n = b * NF + i starts at v[i] + b * v_bs[i]
  void* out;               // contiguous
  int a_bs, v_bs[AV_MAX_V];
  int BN, NF, HW, D, c, merge, ws, hh, ww;
};

// two adjacent 8-column tiles of B (16 k x 8 n each) from a row-major
// [k][n] tile in shared memory
__device__ __forceinline__ void load_b_pair(BFrag<__nv_bfloat16> (&b)[2],
                                            const __nv_bfloat16* vs, int kk, int n0) {
  // ldmatrix .trans hands lane 4 g + t the elements [k = 2t, 2t + 1][n = g] of
  // each 8x8 matrix: the B fragment of mma.sync. Lanes 0-7 address rows kk..
  // of tile n0, 8-15 rows kk + 8.., 16-31 the same for tile n0 + 8.
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = vs + (kk + (lane & 15)) * AV_VS + n0 + (lane >> 4) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0].r[0]), "=r"(b[0].r[1]), "=r"(b[1].r[0]), "=r"(b[1].r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void load_b_pair(BFrag<float> (&b)[2], const float* vs, int kk,
                                            int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[j].v[i] = vs[(kk + 2 * t + (i & 1) + 8 * (i >> 1)) * AV_VS + n0 + 8 * j + g];
}

template <class T>
__global__ void __launch_bounds__(NT) attn_v_kernel(AvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);   // [AV_BM][AV_AS]
  T* vs = as + AV_BM * AV_AS;           // [AV_KC][AV_VS], later the out tile [AV_BM][AV_VS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps: 16 rows x 64 columns each
  const int HW = p.HW, D = p.D;
  const int n = blockIdx.z, q0 = blockIdx.y * AV_BM, d0 = blockIdx.x * AV_BN;
  const int bb = n / p.NF, fi = n - bb * p.NF;
  const T* a = static_cast<const T*>(p.a) + (size_t)n * p.a_bs;
  const T* v = static_cast<const T*>(p.v[0]);
  int v_bs = p.v_bs[0];
#pragma unroll
  for (int i = 1; i < AV_MAX_V; ++i)
    if (fi == i) { v = static_cast<const T*>(p.v[i]); v_bs = p.v_bs[i]; }
  v += (size_t)bb * v_bs;
  // rows of a start at 16-byte boundaries when HW elements fill 16-byte pieces
  const bool a_vec = (HW * sizeof(T)) % 16 == 0;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < HW; k0 += AV_KC) {
    // a tile: rows q0.., keys k0..; zero outside
    for (int idx = tid; idx < AV_BM * (AV_KC / 8); idx += NT) {
      const int r = idx / (AV_KC / 8), k8 = (idx % (AV_KC / 8)) * 8;
      T* dst = as + r * AV_AS + k8;
      const int q = q0 + r, k = k0 + k8;
      if (q < HW && k + 8 <= HW && a_vec) {
        copy8(dst, a + (size_t)q * HW + k);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = (q < HW && k + i < HW) ? a[(size_t)q * HW + k + i] : from_f<T>(0.f);
      }
    }
    // v tile: keys k0.., columns d0..; zero outside (D is a multiple of 8)
    for (int idx = tid; idx < AV_KC * (AV_BN / 8); idx += NT) {
      const int r = idx / (AV_BN / 8), c8 = (idx % (AV_BN / 8)) * 8;
      T* dst = vs + r * AV_VS + c8;
      if (k0 + r < HW && d0 + c8 < D) copy8(dst, v + (size_t)(k0 + r) * D + d0 + c8);
      else zero8(dst);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AV_KC; kk += 16) {
      AFrag<T> af;
      load_a(af, as + (wm * 16 + g) * AV_AS, as + (wm * 16 + g + 8) * AV_AS, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        BFrag<T> bf[2];
        load_b_pair(bf, vs, kk, wn * 64 + j * 16);
        tile_mma(acc[2 * j], af, bf[0]);
        tile_mma(acc[2 * j + 1], af, bf[1]);
      }
    }
    __syncthreads();
  }

  // stage the tile, rounded once to T
  T* os = vs;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      os[(wm * 16 + g + 8 * (i >> 1)) * AV_VS + wn * 64 + j * 8 + 2 * t + (i & 1)] =
          from_f<T>(acc[j][i]);
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  const int c = p.c, S = D / c;
  for (int idx = tid; idx < AV_BM * (AV_BN / 8); idx += NT) {
    const int r = idx / (AV_BN / 8), c8 = (idx % (AV_BN / 8)) * 8;
    const int q = q0 + r, d = d0 + c8;
    if (q >= HW || d >= D) continue;
    const int s = d / c, cc = d - s * c;
    size_t off;
    if (p.merge) {
      const int p1 = s / p.ws, p2 = s - p1 * p.ws, i = q / p.ww, j = q - i * p.ww;
      off = (((size_t)n * (p.ws * p.hh) + p1 * p.hh + i) * (p.ws * p.ww) + p2 * p.ww + j) * c + cc;
    } else {
      off = (((size_t)n * S + s) * HW + q) * c + cc;
    }
    copy8(out + off, os + r * AV_VS + c8);
  }
}

template <class T>
static int launch_attn_v(const AvArgs& p, cudaStream_t stream) {
  const size_t smem = (size_t)(AV_BM * AV_AS + AV_BM * AV_VS) * sizeof(T);
  auto kern = attn_v_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.D + AV_BN - 1) / AV_BN, (p.HW + AV_BM - 1) / AV_BM, p.BN);
  kern<<<grid, dim3(NT), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace turtle

// ptrs: a, out, v_0 .. v_4 (null = absent)
// ints: BN, NF, HW, D, c, merge, ws, hh, ww, a_bs, v_bs_0 .. v_bs_4 (strides
// in elements). Entry n = b * NF + i of a and out goes with v_i[b]. Returns
// the CUDA error code (0 = launched), -1 for a shape the kernel does not take.
extern "C" int turtle_attn_v_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
  static_assert(AV_KC == AV_BM, "the out tile reuses the v tile's rows");
  AvArgs p;
  p.a = ptrs[0]; p.out = ptrs[1];
  p.BN = ints[0]; p.NF = ints[1]; p.HW = ints[2]; p.D = ints[3]; p.c = ints[4];
  p.merge = ints[5]; p.ws = ints[6]; p.hh = ints[7]; p.ww = ints[8]; p.a_bs = ints[9];
  if (p.NF < 1 || p.NF > AV_MAX_V || p.BN % p.NF != 0 || p.BN > 65535) return -1;
  if (p.c < 8 || p.c % 8 != 0 || p.D % p.c != 0 || p.HW < 1) return -1;
  if (p.merge && (p.hh * p.ww != p.HW || p.ws * p.ws * p.c != p.D)) return -1;
  for (int i = 0; i < AV_MAX_V; ++i) {
    p.v[i] = i < p.NF ? ptrs[2 + i] : nullptr;
    p.v_bs[i] = ints[10 + i];
    if (i < p.NF && p.v[i] == nullptr) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_attn_v<__nv_bfloat16>(p, s) : launch_attn_v<float>(p, s);
}
