// A run of N cacheless Channel + gated-FFN blocks over one map in ONE launch.
// Per block of the run:
//
//   q, k, v = dw3x3(pw1(LN1 x))                      (the three chains)
//   attn_h  = softmax(temp_h * (q_h^T k_h) / (|q_h| |k_h|^T))   per head, over
//             all pixels of a batch entry
//   po'     = blockdiag(attn)^T W_po                 (B, C, C)
//   x'      = x + v @ po'
//   x_next  = x' + pw2(gelu(a) * b),  a | b = dw3x3(pw1(LN2 x'))
//
// Replaces fused_channel_gffw_run in turtlevsr_tpu/kernels/level.py
// (_chan_gffw_run_kernel), which keeps the map in the TPU's VMEM and walks
// it strip by strip on one core. Here the Gram of a block is a sum over the
// whole map and the FFN reads a one-pixel halo of its own input, so the
// blocks of one launch need barriers over the grid: the kernel is launched
// cooperatively (every thread block co-resident, grid sized by the
// occupancy) and goes through four phases per block of the run, separated by
// grid.sync():
//   (a) tiles: LN1 and the q/k/v chains, the v map to scratch, the tile's
//       partial Gram and sums of squares to its row of `part` (qkv_tile.cuh,
//       the device code of qkv_stats.cu);
//   (b1) the rows of a batch entry are summed in the fixed order of
//       turtle_reduce_rows (groups of rows, then the groups);
//   (b2) per (batch entry, head): norms, the softmax rounded to T, po' by
//       FMA, rounded to T;
//   (c) tiles: the gate FFN with pair and po' (ffn_tile.cuh, the device code
//       of ffn.cu) from one map buffer into the other; the two swap per block
//       and the last block writes the result.
// It rounds where the split kernels round (the v map, the softmax, po', every
// block's output), so a run equals N qkv_stats + ffn launches up to the
// exp/divide of the softmax. At the sizes of tiled inference the maps stay in
// the 50 MB L2 between the phases; device memory sees the weights and the
// partial rows. Bound by operations like the kernels it is made of.
//
// float32 at C = 512: the LN halo of both tile phases lives in a
// device-memory scratch of one slice a tile (common.cuh
// halo_in_device_memory), indexed by (b * n_tiles + tile) in both; phase (a)
// and phase (c) are apart by grid.sync(), so one scratch serves both.
#include <cooperative_groups.h>

#include <cfloat>
#include <cmath>

#include "ffn_tile.cuh"
#include "qkv_tile.cuh"

namespace cg = cooperative_groups;

namespace turtle {

constexpr int MAX_RUN = 10;        // blocks of a run per launch (the arguments fit 4 KB)
constexpr int REDUCE_GROUPS = 64;  // as _REDUCE_GROUPS of kernels/ffn.py

// The arguments of every phase are laid out by the host, one QkvArgs and one
// FfnArgs per block of the run, and the kernel takes them as a
// __grid_constant__ parameter: the tile code reads its pointers and sizes
// from the parameter space where it needs them, as the one-tile-per-block
// kernels do, instead of carrying them in registers through a kernel that
// has none to spare.
struct LevelArgs {
  float* part;  // (B, n_tiles, width) partial rows
  float* tot;   // (B, width) their sums
  void* po;     // (B, C, C) po' of the current block
  void* xn_dev; // (B * n_tiles, 100, C + 8) the LN halo where it lives in device memory
  const void* temp[MAX_RUN];  // (heads) temperatures, of T
  const void* wpo[MAX_RUN];   // (C, C) project_out matrices, of T
  int B, H, W, C, heads, n_blocks;
  QkvArgs qkv[MAX_RUN];  // phase (a): x = the block's input map, v, part
  FfnArgs ffn[MAX_RUN];  // phase (c): x, x2[0] = v, po_w = po, out
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// XN_DEV: both tile phases keep the LN halo in a.xn_dev (float32 at C = 512)
template <class T, int NTW, bool XN_DEV>
__global__ void __launch_bounds__(NT, (NTW <= 2 ? 2 : 1))
level_kernel(const __grid_constant__ LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, heads = a.heads, ctok = C / heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = ((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS);
  const int n_items = a.B * n_tiles;
  const int n_g = heads * ctok * ctok, width = n_g + 2 * C;
  const int per = n_tiles > REDUCE_GROUPS ? (n_tiles + REDUCE_GROUPS - 1) / REDUCE_GROUPS
                                          : n_tiles;
  const int n_zc = (C + 63) / 64;  // po' is formed in chunks of 64 columns
  T* xn_dev = static_cast<T*>(a.xn_dev);

  for (int bi = 0; bi < a.n_blocks; ++bi) {
    // (a) chains and partial statistics
    for (int it = blockIdx.x; it < n_items; it += gridDim.x)
      qkv_tile<T, 2 * NTW, XN_DEV>(a.qkv[bi], it / n_tiles, it % n_tiles, n_tiles, smem,
                                   xn_dev);
    grid.sync();

    // (b1) fixed-order sums of the partial rows
    for (int i = blockIdx.x * NT + tid; i < a.B * width; i += gridDim.x * NT) {
      const int b = i / width, col = i - b * width;
      const float* s = a.part + (size_t)b * n_tiles * width + col;
      float total = 0.f;
      for (int r0 = 0; r0 < n_tiles; r0 += per) {
        const int r1 = min(n_tiles, r0 + per);
        float acc = 0.f;
        for (int r = r0; r < r1; ++r) acc += s[(size_t)r * width];
        total += acc;
      }
      a.tot[i] = total;
    }
    grid.sync();

    // (b2) softmax and po' = blockdiag(attn)^T W_po
    {
      float* attn = reinterpret_cast<float*>(smem);  // [c][d] of one head
      float* nq = attn + ctok * ctok;
      float* nk = nq + ctok;
      const T* wpo = static_cast<const T*>(a.wpo[bi]);
      for (int it = blockIdx.x; it < a.B * heads * n_zc; it += gridDim.x) {
        const int zc = it % n_zc, h = (it / n_zc) % heads, b = it / (n_zc * heads);
        const float* tot = a.tot + (size_t)b * width;
        const float temp = to_f(static_cast<const T*>(a.temp[bi])[h]);
        for (int i = tid; i < 2 * ctok; i += NT) {
          const int which = i / ctok, cc = i - which * ctok;
          const float nrm = fmaxf(sqrtf(tot[n_g + which * C + h * ctok + cc]), 1e-12f);
          (which == 0 ? nq : nk)[cc] = nrm;
        }
        __syncthreads();
        for (int c = warp; c < ctok; c += NW) {  // a row of the head per warp
          float s[2], m = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = lane + 32 * j;
            s[j] = -INFINITY;
            if (d < ctok) {
              s[j] = tot[h * ctok * ctok + c * ctok + d] / (nq[c] * nk[d]) * temp;
              m = fmaxf(m, s[j]);
            }
          }
          m = warp_max(m);
          if (!isfinite(m)) m = 0.f;
          float e[2], sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            e[j] = lane + 32 * j < ctok ? expf(s[j] - m) : 0.f;
            sum += e[j];
          }
          sum = fmaxf(warp_sum(sum), FLT_MIN);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (lane + 32 * j < ctok) attn[c * ctok + lane + 32 * j] = round_to<T>(e[j] / sum);
        }
        __syncthreads();
        // po'[(h, d)][z] = sum_c attn[c][d] W_po[(h, c)][z]
        T* po = static_cast<T*>(a.po) + (size_t)b * C * C;
        const int z0 = zc * 64, nz = min(64, C - z0);
        for (int idx = tid; idx < ctok * nz; idx += NT) {
          const int d = idx / nz, z = z0 + idx - d * nz;
          float acc = 0.f;
          for (int c = 0; c < ctok; ++c)
            acc += attn[c * ctok + d] * to_f(wpo[(size_t)(h * ctok + c) * C + z]);
          po[(size_t)(h * ctok + d) * C + z] = from_f<T>(acc);
        }
        __syncthreads();
      }
    }
    grid.sync();

    // (c) the gate FFN with pair and po'
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      ffn_tile<T, NTW, false, 1, XN_DEV>(a.ffn[bi], it / n_tiles, it % n_tiles, smem, xn_dev);
      __syncthreads();  // the tile's output left shared memory
    }
    if (bi + 1 < a.n_blocks) grid.sync();  // the next block reads its input with halos
  }
}

// shared memory of a launch (xn_dev: the LN halo in device memory)
__host__ __device__ inline size_t level_smem(int C, int heads, int is_bf16, int xn_dev = 0) {
  const int ctok = C / heads;
  size_t s = qkv_tile_smem(C, heads, is_bf16, xn_dev);
  const size_t f = ffn_tile_smem(C, 0, 0, is_bf16, 1, xn_dev);
  const size_t b2 = (size_t)(ctok * ctok + 2 * ctok) * 4;
  if (f > s) s = f;
  return b2 > s ? b2 : s;
}

// The grid is sized by the occupancy, so that it is co-resident; a launch the
// runtime refuses all the same comes back as its error code.
template <class T, int NTW, bool XN_DEV = false>
static int launch_level(const LevelArgs& a, size_t smem, cudaStream_t stream) {
  if (XN_DEV && a.xn_dev == nullptr) return -1;
  auto kern = level_kernel<T, NTW, XN_DEV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -2;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -3;
  int blocks = sms * per_sm;
  const int n_items = a.B * ((a.H + TS - 1) / TS) * ((a.W + TS - 1) / TS);
  if (blocks > n_items) blocks = n_items;
  void* params[] = {const_cast<LevelArgs*>(&a)};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(blocks), dim3(NT), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// both types up to C = 512; float at C > 256 with the LN halo of both tile
// phases in device memory (kernels/level.py _level_f32_plan mirrors it)
template <class T>
static int dispatch_level(const LevelArgs& a, size_t smem, cudaStream_t stream) {
  if (a.C % 16 != 0) return -1;
  if (a.C <= 64) return launch_level<T, 1>(a, smem, stream);
  if (a.C <= 128) return launch_level<T, 2>(a, smem, stream);
  if (a.C <= 256) return launch_level<T, 4>(a, smem, stream);
  if (a.C <= 512) {
    if constexpr (sizeof(T) == 2) return launch_level<T, 8>(a, smem, stream);
    else return launch_level<T, 8, true>(a, smem, stream);
  }
  return -1;
}

}  // namespace turtle

extern "C" size_t turtle_level_smem(int C, int heads, int is_bf16) {
  return turtle::level_smem(C, heads, is_bf16, turtle::halo_in_device_memory(C, is_bf16));
}

// ptrs: x, out, tmp, v, part, tot, po, then 11 per block of the run (MAX_RUN
//       blocks, null past the run):
//       ln1_w, ln1_b, w_qkv (C, 3C), wd_qkv (3, 3, 3C), temp (heads), wpo (C, C),
//       ln2_w, ln2_b, w1 (C, CH), wd (3, 3, CH), w2 (E, C)   (ln*_b may be null),
//       then (read only where the halo lives in device memory: float32 at
//       C > 256) xn_dev, B * n_tiles * 100 * (C + 8) floats
// ints: B, H, W, C, CH, E, heads, n_blocks
// Returns the CUDA error code (0 = launched), -1 for a shape the kernel does
// not take, -2 for a device without cooperative launch, -3 when not even one
// block fits an SM.
extern "C" int turtle_level_launch(void* const* ptrs, const int* ints, int is_bf16,
                                   void* stream) {
  using namespace turtle;
  static_assert(sizeof(LevelArgs) <= 4096, "kernel arguments are limited to 4 KB");
  const void* x = ptrs[0];
  void *out = ptrs[1], *tmp = ptrs[2], *v = ptrs[3];
  LevelArgs a = {};
  a.part = static_cast<float*>(ptrs[4]); a.tot = static_cast<float*>(ptrs[5]); a.po = ptrs[6];
  a.xn_dev = halo_in_device_memory(ints[3], is_bf16) ? ptrs[7 + 11 * MAX_RUN] : nullptr;
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3];
  const int CH = ints[4], E = ints[5];
  a.heads = ints[6]; a.n_blocks = ints[7];
  if (a.n_blocks < 1 || a.n_blocks > MAX_RUN) return -1;
  if (a.heads < 1 || a.C % a.heads != 0 || a.C / a.heads > 64 || CH != 2 * E) return -1;
  if ((long long)a.H * a.W * a.C >= (1ll << 31)) return -1;
  for (int i = 0; i < a.n_blocks; ++i) {
    void* const* p = ptrs + 7 + 11 * i;
    // the two map buffers swap per block; block i writes `out` when an even
    // number of blocks follows it, so the last one does
    const void* src = i == 0 ? x : (((a.n_blocks - i) & 1) ? tmp : out);
    void* dst = ((a.n_blocks - 1 - i) & 1) ? tmp : out;
    QkvArgs& q = a.qkv[i];
    q.x = src; q.ln_w = p[0]; q.ln_b = p[1]; q.w1 = p[2]; q.wd = p[3];
    q.v = v; q.part = a.part;
    q.B = a.B; q.H = a.H; q.W = a.W; q.C = a.C; q.heads = a.heads;
    a.temp[i] = p[4]; a.wpo[i] = p[5];
    FfnArgs& f = a.ffn[i];
    f.x = src; f.po_w = a.po; f.ln_w = p[6]; f.ln_b = p[7]; f.w1 = p[8]; f.wd = p[9];
    f.w2 = p[10]; f.out = dst; f.x2[0] = v; f.x2_bs[0] = a.H * a.W * a.C;
    f.B = a.B; f.H = a.H; f.W = a.W; f.C = a.C; f.CH = CH; f.E = E;
    f.gate = 1; f.po_batched = 1; f.n_x2 = 1;
  }
  const size_t smem = turtle_level_smem(a.C, a.heads, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_level<__nv_bfloat16>(a, smem, s)
                 : dispatch_level<float>(a, smem, s);
}
