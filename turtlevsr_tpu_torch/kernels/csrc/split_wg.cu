// The Hopper body of the split projection (row 4): N chains dw3x3(pw1(LN x))
// from one read of x, each written as its own map, for bf16 maps with
// LayerNorm, no b1 or bd, E = C in {128, 256, 512} and N * E a multiple of
// 128 (the latent FHR blocks' q, k, v at C = 512, the SAB q, k at C = 256
// and 128). kernels/ffn.py's _split_plan sends those calls here and every
// other one (C = 64, where split_proj.cu was faster on an H100: the LN pass
// and the taps on the CUDA cores outweigh a K = 64 product; float32,
// biases, no LayerNorm, E != C) to split_proj.cu. It
// rounds where split_proj.cu does: LN(x) to bf16, pw1 and the nine taps in
// row-major order in fp32, the map once.
//
// Replaces fused_ln_split_proj in turtlevsr_tpu/kernels/ffn.py
// (_multi_dw_kernel). Bound by operations at C >= 256 (2 C x N E flop a
// pixel against one map read and N written), by bytes at C = 128. What held
// split_proj.cu back is what held the statistics' mma.sync bodies back
// (stats_wg.cuh): every 8 x 8 tile read w1 from device memory per warp with
// nothing in flight across its block barriers. This body is stats_wg.cuh's
// machinery without the Grams:
//
//   * a persistent grid: block g walks a static, contiguous range of the
//     flattened (batch entry, tile) sequence, so the copy warpgroup loads the
//     next tile's weights while the consumers run the current tile's taps;
//   * w1 streams through a ring of 16 KB stages (two 64-column panels of 64
//     rows of K, the 128-byte swizzle wgmma reads), filled by TMA from a copy
//     warpgroup that hands its registers to the consumers (setmaxnreg);
//   * a tile is N E / 128 passes, each one pw1 product of N = 128 on the
//     10 x 10 halo (two m64 wgmma tiles, one a consumer warpgroup, A from
//     registers by ldmatrix), the fp32 chunk in shared memory, then the nine
//     taps on the CUDA cores straight into the maps: a pass's 128 columns lie
//     in one chain;
//   * at C <= 256 the next tile's halo of x comes into shared memory by
//     cp.async while the current tile's passes run, so the LN pass waits on
//     no load from device memory (at C = 128 the LN pass was a third of a
//     tile's time); at C = 512 there is no room for it.
#include "stats_wg.cuh"

namespace turtle {

struct SplitWgArgs {
  const void *x, *ln_w, *ln_b, *wd;
  void* out[4];
  int B, H, W, E, NE;  // NE = n_out * E, a multiple of 128
};

// the next tile's halo of x is staged at these widths
__host__ __device__ constexpr bool spw_staged(int C) { return C <= 256; }

// bytes of the parts after the ring (the fp32 hidden chunk, the LN halo, the
// staged halo of x); the ring takes as many stages as fit
__host__ __device__ inline size_t spw_rest(int C) {
  return (size_t)NPH * SW_HS * 4 + (size_t)NPH * (C + XPAD) * 2 +
         (spw_staged(C) ? (size_t)NPH * C * 2 : 0);
}

__host__ __device__ inline int spw_stages(int C) {
  const size_t room = SW_SMEM_MAX - WG_ALIGN - spw_rest(C);
  const int s = (int)(room / (SW_STAGE + 2 * sizeof(uint64_t)));
  return s < SW_MAX_STAGES ? s : SW_MAX_STAGES;
}
__host__ __device__ inline size_t spw_smem(int C) {
  const int s = spw_stages(C);
  return WG_ALIGN + (size_t)s * SW_STAGE + spw_rest(C) + 2 * s * sizeof(uint64_t);
}

// the raw halo of a tile into xs (100 rows of C), by cp.async behind the
// consumers' backs; the LN pass never reads the rows outside the image
template <int C>
__device__ __forceinline__ void spw_stage(const __nv_bfloat16* __restrict__ x, int H, int W,
                                          int y0, int x0, __nv_bfloat16* xs) {
  constexpr int C8 = C / 8;
  for (int idx = threadIdx.x; idx < NPH * C8; idx += NT) {
    const int p = idx / C8, c8 = (idx - p * C8) * 8;
    if (halo_inside(p, H, W, y0, x0))
      cp_async16(xs + p * C + c8, x + halo_offset(p, W, C, y0, x0) + c8);
  }
  cp_async_commit();
}
// C: the map's width. grid: one block an SM at most (the plan's count)
template <int C>
__global__ void __launch_bounds__(SW_NT, 1)
    split_wg_kernel(const __grid_constant__ SplitWgArgs a, const __grid_constant__ CUtensorMap w1) {
  using T = __nv_bfloat16;
  constexpr int XS = C + XPAD, NS = C / SW_KB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int S = spw_stages(C);
  unsigned char* ring = smem;
  float* hid = reinterpret_cast<float*>(ring + (size_t)S * SW_STAGE);
  T* xn = reinterpret_cast<T*>(hid + NPH * SW_HS);
  T* xs = xn + NPH * XS;  // the staged halo (spw_staged(C))
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + (spw_staged(C) ? NPH * C : 0));
  uint64_t* empty = full + S;

  const int H = a.H, W = a.W, E = a.E, NE = a.NE;
  const int tiles_x = (W + TS - 1) / TS, nt = tiles_x * ((H + TS - 1) / TS);
  const long long total = (long long)a.B * nt;
  const long long it0 = sw_item0(blockIdx.x, total), it1 = sw_item0(blockIdx.x + 1, total);
  const int n_pass = NE / 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NW) {  // the copy warpgroup: thread NT starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_COPY));
    if (tid == NT) {
      int li = 0;
      for (long long it = it0; it < it1; ++it)
        for (int p = 0; p < n_pass; ++p)
          for (int kb = 0; kb < NS; ++kb) {
            const int s = li % S;
            if (li >= S) mbar_wait(&empty[s], (li / S - 1) & 1);
            mbar_expect_tx(&full[s], 2 * SW_PANEL);
            ++li;
            unsigned char* dst = ring + (size_t)s * SW_STAGE;
            tma_load_2d(dst, &w1, 128 * p, kb * SW_KB, &full[s]);
            tma_load_2d(dst + SW_PANEL, &w1, 128 * p + 64, kb * SW_KB, &full[s]);
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_CONSUMER));

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  int li = 0, rel = 0;
  auto take = [&]() {
    const int s = li % S;
    mbar_wait(&full[s], (li / S) & 1);
    ++li;
    return ring + (size_t)s * SW_STAGE;
  };
  auto release_upto = [&](int n) {
    for (; rel < n; ++rel)
      if (lane == 0 && q == 0) mbar_arrive(&empty[rel % S]);
  };

  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const T* wd = static_cast<const T*>(a.wd);
  // warpgroup wg multiplies halo rows 64 wg .. 64 wg + 63 (rows past the
  // 100th read row 0 and are dropped); ldmatrix row lane & 15 of warp q
  const int hrow = 64 * wg + 16 * q + (lane & 15);
  const T* arow = xn + (hrow < NPH ? hrow : 0) * XS + (lane >> 4) * 8;
  bool hrow_ok[2];
  int hrow_at[2], hrow_swz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * q + g + 8 * h;
    hrow_ok[h] = row < NPH;
    hrow_at[h] = row * SW_HS;
    hrow_swz[h] = (row & 3) << 3;
  }
  // this thread's column of the taps (the same for its four tile columns)
  const int col = tid & 127;
  const T* x = static_cast<const T*>(a.x);
  const size_t map = (size_t)H * W * C;
  auto stage = [&](long long it) {  // the halo of item it into xs
    const int b = (int)(it / nt), tile = (int)(it - (long long)b * nt);
    spw_stage<C>(x + (size_t)b * map, H, W, (tile / tiles_x) * TS, (tile % tiles_x) * TS, xs);
  };
  if (spw_staged(C)) stage(it0);

  for (long long it = it0; it < it1; ++it) {
    const int b = (int)(it / nt), tile = (int)(it - (long long)b * nt);
    const int y0 = (tile / tiles_x) * TS, x0 = (tile % tiles_x) * TS;
    bool hrow_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hrow_in[h] = hrow_ok[h] && halo_inside(64 * wg + 16 * q + g + 8 * h, H, W, y0, x0);
    if constexpr (spw_staged(C)) {
      cp_async_wait<0>();
      consumers_sync();  // every thread's part of the halo has landed
      sw_ln_pass<C, true>(xs, ln_w, ln_b, H, W, y0, x0, xn);
      if (it + 1 < it1) stage(it + 1);  // xs is free: the LN pass ends in a barrier
    } else {
      sw_ln_pass<C>(x + (size_t)b * map, ln_w, ln_b, H, W, y0, x0, xn);
    }

#pragma unroll 1
    for (int p = 0; p < n_pass; ++p) {
      // pw1 on the halo tile: 128 hidden columns, K = C in stages of 64 rows
      float h1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) h1[i] = 0.f;
      AFrag<T> af[2][SW_KB / 16];
#pragma unroll
      for (int kb = 0; kb < NS; ++kb) {
        const unsigned char* bs = take();
#pragma unroll
        for (int k = 0; k < SW_KB / 16; ++k) ldsm_a(af[kb & 1][k], arow + kb * SW_KB + k * 16);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < SW_KB / 16; ++k)
          wgmma_rs<128>(h1, af[kb & 1][k], sw_stage_desc(bs, 0, k));
        wgmma_commit();
        wgmma_wait<1>();  // the group before is done
        release_upto(li - 1);
      }
      wgmma_wait<0>();
      pin(h1);
      release_upto(li);
      // the column's nine taps: their loads run behind the stores and the
      // barrier
      const int ch = 128 * p + col;
      float wt[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) wt[i] = to_f(wd[i * NE + ch]);
      // zero outside the image: the hidden map is zero-padded after pw1
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!hrow_ok[h]) continue;
          *reinterpret_cast<float2*>(hid + hrow_at[h] + (c ^ hrow_swz[h])) =
              make_float2(hrow_in[h] ? h1[4 * j + 2 * h] : 0.f,
                          hrow_in[h] ? h1[4 * j + 2 * h + 1] : 0.f);
        }
      }
      consumers_sync();
      // the taps, rounded once into chain ch / E at channel ch % E
      T* mp = static_cast<T*>(a.out[ch / E]) + (size_t)b * H * W * E + ch % E;
      for (int px = tid >> 7; px < TS; px += NT / 128) {
        if (x0 + px >= W) continue;
        float v[TS];
        sw_dw_column(hid, wt, px, col, v);
#pragma unroll
        for (int py = 0; py < TS; ++py)
          if (y0 + py < H) mp[((size_t)(y0 + py) * W + x0 + px) * E] = from_f<T>(v[py]);
      }
      consumers_sync();  // the chunk is read before the next pass stores into it
    }
  }
}

template <int C>
static int launch_split_wg(const SplitWgArgs& a, const void* w1, int grid, cudaStream_t stream) {
  CUtensorMap map;
  const uint64_t c = C, ne = a.NE;
  if (!encode_bf16<2>(&map, w1, {ne, c}, {ne * 2}, {64, SW_KB}, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  auto kern = split_wg_kernel<C>;
  const size_t smem = spw_smem(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(grid), dim3(SW_NT), smem, stream>>>(a, map);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_split_wg_smem(int C) { return turtle::spw_smem(C); }

// ptrs: x, ln_w, ln_b, w1 (C, N*E), wd (3, 3, N*E), out_0 .. out_3
// ints: B, H, W, C, E, n_out, grid. Returns the CUDA error code (0 =
// launched), -1 for a call this body does not take, -2 when the tensor map
// is refused.
extern "C" int turtle_split_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                      void* stream) {
  using namespace turtle;
  SplitWgArgs a = {};
  a.x = ptrs[0]; a.ln_w = ptrs[1]; a.ln_b = ptrs[2]; a.wd = ptrs[4];
  for (int i = 0; i < 4; ++i) a.out[i] = ptrs[5 + i];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.E = ints[4];
  const int C = ints[3], n_out = ints[5], grid = ints[6];
  a.NE = n_out * a.E;
  if (!is_bf16 || a.ln_w == nullptr || a.E != C || n_out < 1 || n_out > 4 || a.NE % 128 != 0 ||
      grid < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch_split_wg<128>(a, ptrs[3], grid, s);
    case 256: return launch_split_wg<256>(a, ptrs[3], grid, s);
    case 512: return launch_split_wg<512>(a, ptrs[3], grid, s);
  }
  return -1;
}
