// Row 14's Hopper body: a run of N cacheless Channel + gated-FFN blocks over
// one map in ONE cooperative launch, for bf16 maps with C in {128, 256, 512},
// 64 channels a head, E a multiple of 32 and no conv biases. Per block:
//
//   q, k, v = dw3x3(pw1(LN1 x)),  attn_h = softmax(temp_h q_h^T k_h / norms)
//   x' = x + v @ (blockdiag(attn)^T W_po),  x_next = x' + gate-FFN(LN2 x')
//
// Replaces fused_channel_gffw_run in turtlevsr_tpu/kernels/level.py
// (_chan_gffw_run_kernel). kernels/level.py's _level_plan sends those runs
// here and every other one (float32, other widths and head sizes) to
// level.cu, whose phases run the mma.sync tile code of rows 1 and 3.
//
// A run is the split route's 2 N launches in one: the statistics body of
// rows 3 and 6 (stats_wg.cuh) and row 1's body (ffn_wg.cuh) run one after
// the other by one persistent grid of one block an SM (384 threads: two
// consumer warpgroups and a copy warpgroup, setmaxnreg as in both bodies),
// with grid barriers between the phases of each block:
//   (a) statistics over the block's static range sw_item0(g, T) ..
//       sw_item0(g + 1, T) of the T (batch entry, tile) items: the partition
//       qkv_wg.cu gets at the same grid, so the partial rows, their owners and
//       the order of every sum are the split route's; v to its map;
//   (b1) the R rows of each entry summed in the fixed order of
//       turtle_reduce_rows, then zeroed for the next block;
//   (b2) per (entry, head, 64 columns of po'): the norms, the softmax
//       rounded to bf16, po' by FMA in the order of c, rounded (level.cu's
//       arithmetic);
//   (c) the gate FFN with x2 = v and the entry's po' over items g, g + G, ..
//       from one map buffer into the other; the last block writes `out`.
// So the run is the split route bit for bit, up to the exp and the divide
// of the softmax and the order of po''s sums (equal on every case measured,
// PERF.md row 14). Bound by operations like the two bodies (about 2 (4 C^2 +
// 3 C E) flop a pixel and block against one map read and one written). What
// it saves is the split route's launch gaps, its row reductions and its
// host-side softmax; what it costs is the FFN phase, 1.2-1.3x the FFN body
// in its own kernel (PERF.md, row 14: the phases left out in turn).
//
// What the design has to handle:
//   * one register allocation for two bodies: each body runs at the 168
//     registers of a 384-thread block, ffn_wg.cu's at C = 256 without a byte
//     to spare. Inlined into the loop over the run's blocks, the two bodies,
//     the loop's state and the block's pointers spilled 320 to 904 bytes a
//     thread and ran 1.24-1.34x the split route. So the consumers' phases are
//     functions that are not inlined, each with an allocation of its own, and
//     the launch's arguments but the tensor maps sit in constant memory
//     (lv_args), which the functions read as the bodies' own kernels read
//     their parameters: as operands, without registers;
//   * the rings across phases: each body streams its weights through a ring
//     of 16 KB stages in the 128-byte swizzle, as many stages as in its own
//     kernel, over one region of shared memory that holds either ring with
//     its tiles, each ring with its own full / empty mbarriers. Each ring's
//     load index and parities go on from the run's block to the next
//     (WgRing), so no phase drains a ring or initialises barriers again; a
//     phase has taken and handed back every stage it loaded before the grid
//     barrier that ends it, so the two never hold the region at once. The
//     hidden chunk and the LN halo, laid out alike by both bodies, follow the
//     region;
//   * the copy warpgroup reaches every grid barrier: its 128 threads run the
//     phase loop beside the consumers, thread NT starts the loads of (a) and
//     (c), and the warp reconverges before each barrier;
//   * po' crosses proxies: (b2) writes it with generic stores and (c) reads it
//     by TMA, so a fence.proxy.async.global follows the stores and comes again
//     in the copy thread after the barrier. The maps and v are read by generic
//     loads in both bodies (x by plain loads, not through the read-only cache:
//     other blocks of this launch wrote it) and need no such fence;
//   * the 4 KB limit on kernel parameters: ten blocks' tensor maps do not fit
//     it, so the wrapper stacks the run's weights once a call, (N, C, 3C),
//     (N, C, 2E) and (N, E, C) with one 3-D tensor map each (the JAX kernel
//     stacks its weights along the same first axis), the small ones as (N,
//     ...) tensors read at block bi;
//   * a refused launch raises: a refused tensor map, a device without
//     cooperative launch or fewer than one block an SM come back as their
//     codes and the wrapper raises; nothing gives way to level.cu.
#include <cooperative_groups.h>

#include <cfloat>
#include <cmath>

#include "ffn_wg.cuh"
#include "stats_wg.cuh"

namespace cg = cooperative_groups;

namespace turtle {

constexpr int LV_REDUCE_GROUPS = 64;  // _REDUCE_GROUPS of kernels/ffn.py
constexpr int LV_MAX_RUN = 10;        // blocks of a run a launch (MAX_RUN of kernels/level.py)

// block i of the run: its input and output maps and its weights, each a
// block of the stacked tensors (ln*_b may be null)
struct LvBlock {
  const void* x;
  void* y;
  const void *ln1_w, *ln1_b, *wd_qkv, *temp, *wpo, *ln2_w, *ln2_b, *wd;
};

struct LvArgs {
  // the statistics phase: v, part (B, R, width) zero at the launch, B, H, W,
  // R; the map and the weights are the block's
  StatsWgArgs st;
  // the FFN phase: x2[0] = v, po_w = po' (B, C, C), w1, w2, the sizes; the
  // maps and the LN and depthwise weights are the block's
  FfnArgs ffn;
  LvBlock blk[LV_MAX_RUN];
  float* tot;  // (B, width): the sums of the partial rows
  int n_blocks, nt, items;  // the tiles of a map, of the batch
};

__device__ __forceinline__ float lv_warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// generic-proxy stores to global memory ordered before the async proxy's
// (TMA's) reads, and the other way round
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Shared memory: a region that holds either phase's ring and tiles, then the
// fp32 hidden chunk and the LN halo (both bodies lay them out alike), then
// the two rings' mbarriers. In the statistics phase the region is that
// body's ring of lv_stages_s stages and its q and k tiles; in the FFN phase
// it is that body's ring of lv_stages_f stages and its activation chunk. So
// each phase streams its weights through as many stages as its own kernel
// (with the statistics body's three stages at C = 512 the FFN phase ran 6 %
// slower than with its own four: PERF.md, row 14).
__host__ __device__ inline int lv_stages_s(int C) { return sw_stages(C, false); }
__host__ __device__ inline int lv_stages_f(int C) { return wg_stages(C, true); }
__host__ __device__ inline size_t lv_region(int C) {
  const size_t s = (size_t)lv_stages_s(C) * SW_STAGE + 2 * SW_TILE;
  const size_t f = (size_t)lv_stages_f(C) * WG_STAGE + (size_t)P * (wg_aw(true) + XPAD) * 2;
  return s > f ? s : f;
}
__host__ __device__ inline size_t lv_smem(int C) {
  return WG_ALIGN + lv_region(C) + (size_t)NPH * SW_HS * 4 + (size_t)NPH * (C + XPAD) * 2 +
         2 * sizeof(uint64_t) * (lv_stages_s(C) + lv_stages_f(C));
}

// What a phase derives from the aligned base s of shared memory: its ring,
// with the counters it carries from the last block, and its tiles
template <int C>
__device__ __forceinline__ uint64_t* lv_bars(unsigned char* s) {
  return reinterpret_cast<uint64_t*>(s + lv_region(C) + (size_t)NPH * SW_HS * 4 +
                                     (size_t)NPH * (C + XPAD) * 2);
}
template <int C>
__device__ __forceinline__ WgRing lv_ring_s(unsigned char* s, int li, int rel) {
  uint64_t* b = lv_bars<C>(s);
  return {s, b, b + lv_stages_s(C), lv_stages_s(C), li, rel};
}
template <int C>
__device__ __forceinline__ WgRing lv_ring_f(unsigned char* s, int li, int rel) {
  uint64_t* b = lv_bars<C>(s) + 2 * lv_stages_s(C);
  return {s, b, b + lv_stages_f(C), lv_stages_f(C), li, rel};
}
template <int C>
__device__ __forceinline__ float* lv_hid(unsigned char* s) {
  return reinterpret_cast<float*>(s + lv_region(C));
}
template <int C>
__device__ __forceinline__ __nv_bfloat16* lv_xn(unsigned char* s) {
  return reinterpret_cast<__nv_bfloat16*>(lv_hid<C>(s) + NPH * SW_HS);
}
template <int C>  // the statistics' q tile, its k tile after it
__device__ __forceinline__ __nv_bfloat16* lv_qt(unsigned char* s) {
  return reinterpret_cast<__nv_bfloat16*>(s + (size_t)lv_stages_s(C) * SW_STAGE);
}
template <int C>  // the FFN's activation chunk
__device__ __forceinline__ __nv_bfloat16* lv_act(unsigned char* s) {
  return reinterpret_cast<__nv_bfloat16*>(s + (size_t)lv_stages_f(C) * WG_STAGE);
}

// The launch's arguments but the tensor maps, in constant memory: the
// phase functions read them as the bodies' own kernels read their
// parameters, as operands from a constant bank, without registers. Written
// on the launch's stream before the launch, so one launch at a time reads
// them (the port runs row 14 on one stream).
__constant__ LvArgs lv_args;

// the kernel's dynamic shared memory, its base aligned for the swizzle: the
// phase functions derive their regions from the symbol, as the bodies' own
// kernels do
extern __shared__ __align__(16) unsigned char lv_smem_raw[];
__device__ __forceinline__ unsigned char* lv_base() { return align_smem<WG_ALIGN>(lv_smem_raw); }

// The phases of the consumers as functions that are not inlined (see the
// note). Each takes the block of the run, (a) and (c) their ring's counters,
// which they return.
//
// LV_PHASES: the phases a build runs, bits (a) 1, (b) 2, (c) 4. The port's
// builds run all three; chip_smoke.py --phase level-phases builds the
// others to time each phase by leaving it out (their outputs are wrong).
#ifndef LV_PHASES
#define LV_PHASES 7
#endif

// (a) the chains, v, this block's partial rows
template <int C>
__device__ __noinline__ int2 lv_statistics(int bi, int li, int rel) {
  using T = __nv_bfloat16;
  unsigned char* s = lv_base();
  const LvBlock& k = lv_args.blk[bi];
  WgRing r = lv_ring_s<C>(s, li, rel);
  sw_consume<C, false>(lv_args.st, static_cast<const T*>(k.x), static_cast<const T*>(k.ln1_w),
                       static_cast<const T*>(k.ln1_b), static_cast<const T*>(k.wd_qkv),
                       sw_item0(blockIdx.x, lv_args.items), sw_item0(blockIdx.x + 1, lv_args.items),
                       r, lv_qt<C>(s), lv_qt<C>(s) + P * 64, lv_hid<C>(s), lv_xn<C>(s));
  return make_int2(r.li, r.rel);
}

// (b1) the partial rows of every batch entry summed into tot in the fixed
// order of turtle_reduce_rows as kernels/ffn.py's _reduce_rows runs it
// (groups of ceil(R / 64) rows, then the groups; R <= 64: one group), a
// column a thread over the whole grid; the rows zeroed for the next block.
template <int C>
__device__ __noinline__ void lv_rows() {
  constexpr int HEADS = C / 64, WIDTH = HEADS * 64 * 64 + 2 * C;
  const LvArgs& a = lv_args;
  const int R = a.st.R;
  const int per = R > LV_REDUCE_GROUPS ? (R + LV_REDUCE_GROUPS - 1) / LV_REDUCE_GROUPS : R;
  for (int i = blockIdx.x * NT + threadIdx.x; i < a.st.B * WIDTH; i += gridDim.x * NT) {
    const int b = i / WIDTH, col = i - b * WIDTH;
    float* s = a.st.part + (size_t)b * R * WIDTH + col;
    float sum = 0.f;
    for (int r0 = 0; r0 < R; r0 += per) {
      const int r1 = min(R, r0 + per);
      float acc = 0.f;
      for (int rr = r0; rr < r1; ++rr) acc += s[(size_t)rr * WIDTH];
      sum += acc;
    }
    a.tot[i] = sum;
    for (int rr = 0; rr < R; ++rr) s[(size_t)rr * WIDTH] = 0.f;
  }
}

// (b2) per (batch entry, head, 64 columns of po'): the norms, the softmax
// rounded to bf16, po' = blockdiag(attn)^T W_po, each output a sum over c in
// order, rounded to bf16. A thread takes one column z and 16 rows of the 64,
// so that it reads each W_po element once.
template <int C>
__device__ __noinline__ void lv_po(int bi) {
  using T = __nv_bfloat16;
  constexpr int HEADS = C / 64, G2 = 64 * 64, WIDTH = HEADS * G2 + 2 * C;
  const LvArgs& a = lv_args;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* attn = lv_hid<C>(lv_base());  // [c][d] of one head
  float* nq = attn + G2;
  float* nk = nq + 64;
  const T* temp = static_cast<const T*>(a.blk[bi].temp);
  const T* wpo = static_cast<const T*>(a.blk[bi].wpo);
  T* po = static_cast<T*>(const_cast<void*>(a.ffn.po_w));
  for (int it = blockIdx.x; it < a.st.B * HEADS * HEADS; it += gridDim.x) {
    const int zc = it % HEADS, h = (it / HEADS) % HEADS, b = it / (HEADS * HEADS);
    const float* tot = a.tot + (size_t)b * WIDTH;
    for (int i = tid; i < 128; i += NT)
      (i < 64 ? nq : nk)[i & 63] =
          fmaxf(sqrtf(tot[HEADS * G2 + (i < 64 ? 0 : C) + h * 64 + (i & 63)]), 1e-12f);
    consumers_sync();
    const float tp = to_f(temp[h]);
    for (int c = warp; c < 64; c += NW) {  // a row of the head a warp
      float sc[2], m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = lane + 32 * j;
        sc[j] = tot[h * G2 + c * 64 + d] / (nq[c] * nk[d]) * tp;
        m = fmaxf(m, sc[j]);
      }
      m = lv_warp_max(m);
      if (!isfinite(m)) m = 0.f;
      float e[2], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        e[j] = expf(sc[j] - m);
        sum += e[j];
      }
      sum = fmaxf(warp_sum(sum), FLT_MIN);
#pragma unroll
      for (int j = 0; j < 2; ++j) attn[c * 64 + lane + 32 * j] = round_to<T>(e[j] / sum);
    }
    consumers_sync();
    // po'[(h, d)][z] = sum_c attn[c][d] W_po[(h, c)][z]
    const int z = zc * 64 + (tid & 63), d0 = tid >> 6;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int c = 0; c < 64; ++c) {
      const float w = to_f(wpo[(size_t)(h * 64 + c) * C + z]);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += attn[c * 64 + d0 + 4 * j] * w;
    }
    T* pob = po + (size_t)b * C * C + (size_t)h * 64 * C + z;
#pragma unroll
    for (int j = 0; j < 16; ++j) pob[(size_t)(d0 + 4 * j) * C] = from_f<T>(acc[j]);
    consumers_sync();
  }
  fence_proxy_async_global();  // po' is read by TMA in (c)
}

// (c) the gate FFN with x2 = v and po' over the tiles g, g + G, ..
template <int C>
__device__ __noinline__ int2 lv_ffn(int bi, int li, int rel) {
  using T = __nv_bfloat16;
  unsigned char* s = lv_base();
  const LvBlock& k = lv_args.blk[bi];
  WgRing r = lv_ring_f<C>(s, li, rel);
#pragma unroll 1
  for (int it = blockIdx.x; it < lv_args.items; it += gridDim.x) {
    const int b = it / lv_args.nt, tile = it - b * lv_args.nt;
    wg_tile<C, true, WG_ONE, false>(lv_args.ffn, static_cast<const T*>(k.x), static_cast<T*>(k.y),
                                    static_cast<const T*>(k.ln2_w),
                                    static_cast<const T*>(k.ln2_b), static_cast<const T*>(k.wd),
                                    b, tile, r, lv_xn<C>(s), lv_hid<C>(s), lv_act<C>(s));
    consumers_sync();  // every warp is done with the tile's shared memory
  }
  return make_int2(r.li, r.rel);
}

// C: the map's width. grid: one block an SM at most (the plan's count, which
// is qkv_wg.cu's for the same map), all resident (a cooperative launch).
// The parameters are the tensor maps; the rest is lv_args.
template <int C>
__global__ void __launch_bounds__(SW_NT, 1)
    level_wg_kernel(const __grid_constant__ StatsWgMaps sm, const __grid_constant__ WgMaps fm) {
  const LvArgs& a = lv_args;
  unsigned char* smem = lv_base();
  const int tid = threadIdx.x, warp = tid >> 5;

  if (tid == 0) {  // the two rings' full and empty barriers
    WgRing rs = lv_ring_s<C>(smem, 0, 0), rf = lv_ring_f<C>(smem, 0, 0);
    for (int s = 0; s < rs.S; ++s) {
      mbar_init(&rs.full[s], 1);
      mbar_init(&rs.empty[s], 2);  // one arrival a consumer warpgroup
    }
    for (int s = 0; s < rf.S; ++s) {
      mbar_init(&rf.full[s], 1);
      mbar_init(&rf.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NW) {  // the copy warpgroup: thread NT starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_COPY));
    // each ring's loads counted from the run's first block to its last
    WgRing rs = lv_ring_s<C>(smem, 0, 0), rf = lv_ring_f<C>(smem, 0, 0);
    const long long it0 = sw_item0(blockIdx.x, a.items), it1 = sw_item0(blockIdx.x + 1, a.items);
    for (int bi = 0; bi < a.n_blocks; ++bi) {
      if (tid == NT && (LV_PHASES & 1)) sw_copy_walk<C, false, true>(sm, it0, it1, 0, rs, bi);
      __syncwarp();
      cg::this_grid().sync();  // (a) done
      cg::this_grid().sync();  // (b1) done
      cg::this_grid().sync();  // (b2) done: po' written
      if (tid == NT && (LV_PHASES & 4)) {
        fence_proxy_async_global();
        for (int it = blockIdx.x; it < a.items; it += gridDim.x)
          wg_copy_tile<C, true, WG_ONE, true>(a.ffn, fm, it / a.nt, rf, bi);
      }
      __syncwarp();
      if (bi + 1 < a.n_blocks) cg::this_grid().sync();  // (c) done
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SW_REGS_CONSUMER));

  int2 at_s = make_int2(0, 0), at_f = make_int2(0, 0);  // the rings' (li, rel)
#pragma unroll 1
  for (int bi = 0; bi < a.n_blocks; ++bi) {
    if (LV_PHASES & 1) at_s = lv_statistics<C>(bi, at_s.x, at_s.y);
    cg::this_grid().sync();
    if (LV_PHASES & 2) lv_rows<C>();
    cg::this_grid().sync();
    if (LV_PHASES & 2) lv_po<C>(bi);
    cg::this_grid().sync();
    if (LV_PHASES & 4) at_f = lv_ffn<C>(bi, at_f.x, at_f.y);
    // the next block reads this one's map with halos
    if (bi + 1 < a.n_blocks) cg::this_grid().sync();
  }
}

template <int C>
static int launch_level_wg(const LvArgs& a, const void* w_qkv, const void* w1, const void* w2,
                           int grid, cudaStream_t stream) {
  const uint64_t c = C, e = a.ffn.E, ch = 2 * e, nb = a.n_blocks, bc = (uint64_t)a.st.B * C;
  constexpr int R2 = wg_r2(C, true);
  StatsWgMaps sm = {};
  WgMaps fm = {};
  if (!encode_bf16<3>(&sm.w_qkv, w_qkv, {3 * c, c, nb}, {3 * c * 2, c * 3 * c * 2},
                      {64, SW_KB, 1}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<3>(&fm.w1, w1, {ch, c, nb}, {ch * 2, c * ch * 2}, {64, WG_KB, 1},
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<3>(&fm.w2, w2, {c, e, nb}, {c * 2, e * c * 2}, {64, R2, 1},
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<2>(&fm.po, a.ffn.po_w, {c, bc}, {c * 2}, {64, WG_KB},
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  auto kern = level_wg_kernel<C>;
  const size_t smem = lv_smem(C);
  if (smem > SW_SMEM_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -4;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SW_NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || grid > sms * per_sm) return -3;
  if ((err = cudaMemcpyToSymbolAsync(lv_args, &a, sizeof(LvArgs), 0, cudaMemcpyHostToDevice,
                                     stream)) != cudaSuccess)
    return (int)err;
  void* params[] = {&sm, &fm};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(SW_NT), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_level_wg_smem(int C) { return turtle::lv_smem(C); }

// ptrs: x, out, tmp, v, part, tot, po, then the run's stacked weights:
//       ln1_w (N, C), ln1_b (N, C) or null, w_qkv (N, C, 3C), wd_qkv (N, 3, 3,
//       3C), temp (N, heads), wpo (N, C, C), ln2_w (N, C), ln2_b (N, C) or
//       null, w1 (N, C, 2E), wd (N, 3, 3, 2E), w2 (N, E, C)
// ints: B, H, W, C, E, heads, N, R, grid. part is fp32 (B, R, heads * 64^2 +
// 2C), zero; the launch leaves it zero; tot is fp32 (B, heads * 64^2 + 2C).
// R: the rows of a batch entry, grid: the blocks (kernels/ffn.py's
// _sw_geometry for the map). Returns the CUDA error code (0 = launched), -1
// for a call this body does not take, -2 when a tensor map is refused, -3
// when not one block fits an SM (or the grid is larger than the card holds
// at once), -4 without cooperative launch.
extern "C" int turtle_level_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                      void* stream) {
  using namespace turtle;
  static_assert(sizeof(StatsWgMaps) + sizeof(WgMaps) <= 4096,
                "the kernel's parameters fit the 4 KB limit of every CUDA toolkit");
  LvArgs a = {};
  a.st.v = ptrs[3]; a.st.part = static_cast<float*>(ptrs[4]); a.tot = static_cast<float*>(ptrs[5]);
  const int B = ints[0], H = ints[1], W = ints[2], C = ints[3], E = ints[4], heads = ints[5];
  const int n = ints[6], R = ints[7], grid = ints[8];
  if (!is_bf16 || heads * 64 != C || E < 32 || E % 32 != 0 || n < 1 || n > LV_MAX_RUN ||
      R < 1 || R > LV_REDUCE_GROUPS * LV_REDUCE_GROUPS || grid < 1 || ptrs[7] == nullptr ||
      ptrs[13] == nullptr || (long long)H * W * C >= (1ll << 31))
    return -1;
  a.n_blocks = n;
  // block i's part of a stacked weight of `per` elements a block
  auto at = [&](int k, int i, size_t per) -> const void* {
    return ptrs[k] == nullptr ? nullptr
                              : static_cast<const __nv_bfloat16*>(ptrs[k]) + (size_t)i * per;
  };
  for (int i = 0; i < n; ++i) {
    LvBlock& k = a.blk[i];
    // the map buffers swap per block; block i writes `out` when an even
    // number of blocks follows it, so the last one does
    k.x = i == 0 ? ptrs[0] : (((n - i) & 1) ? ptrs[2] : ptrs[1]);
    k.y = ((n - 1 - i) & 1) ? ptrs[2] : ptrs[1];
    k.ln1_w = at(7, i, C); k.ln1_b = at(8, i, C); k.wd_qkv = at(10, i, 27 * (size_t)C);
    k.temp = at(11, i, heads); k.wpo = at(12, i, (size_t)C * C); k.ln2_w = at(13, i, C);
    k.ln2_b = at(14, i, C); k.wd = at(16, i, 18 * (size_t)E);
  }
  a.st.B = B; a.st.H = H; a.st.W = W; a.st.NF = 0; a.st.R = R;
  a.nt = ((H + TS - 1) / TS) * ((W + TS - 1) / TS);
  if ((long long)B * a.nt >= (1ll << 31)) return -1;
  a.items = B * a.nt;
  FfnArgs& f = a.ffn;
  f.po_w = ptrs[6]; f.w1 = ptrs[15]; f.w2 = ptrs[17];
  f.x2[0] = ptrs[3]; f.x2_bs[0] = H * W * C; f.n_x2 = 1;
  f.B = B; f.H = H; f.W = W; f.C = C; f.CH = 2 * E; f.E = E;
  f.gate = 1; f.po_batched = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch_level_wg<128>(a, ptrs[9], ptrs[15], ptrs[17], grid, s);
    case 256: return launch_level_wg<256>(a, ptrs[9], ptrs[15], ptrs[17], grid, s);
    case 512: return launch_level_wg<512>(a, ptrs[9], ptrs[15], ptrs[17], grid, s);
  }
  return -1;
}
