// The Hopper body of the split projection (row 4) at C = 64: N chains
// dw3x3(pw1(LN x)) from one read of x, each written as its own map, for bf16
// maps with LayerNorm (ln_b optional), no b1 or bd, E = C = 64, N = 1-4
// (dec1's SAB q, k: N = 2). kernels/ffn.py's _split_plan sends those calls
// here, E = C = 128-512 to split_wg.cu, every other one to split_proj.cu. It
// rounds where split_proj.cu does: LN(x) to bf16, pw1 and the nine taps in
// row-major order in fp32 (the hidden map zero outside the image), the map
// once.
//
// Replaces fused_ln_split_proj in turtlevsr_tpu/kernels/ffn.py
// (_multi_dw_kernel) for these calls. Bound by bytes on an H100 (2 x 64 x 64
// N + 18 x 64 N flop a pixel against one map read and N written, 128 (1 +
// N) bytes). split_proj.cu ran it at 8x that bound (an 8 x 8 tile a block,
// w1 read from L2 warp by warp, a 10 x 10 halo for 64 outputs), and
// split_wg.cu's 8 x 8 tiles, built for C >= 128, were slower still. This is
// the front half of row 1's C = 64 body (ffn_c64.cu) without pw2 or its
// epilogue, on the same code (c64_tile.cuh):
//
//   * a persistent grid of one block an SM walks a contiguous range of the
//     (batch entry, tile) items; w1 (64 x 64 N, a panel a chain) and wd stay
//     in shared memory from the block's start, in the 128-byte swizzle
//     wgmma reads;
//   * an output tile is 16 rows x 8 columns; its 18 x 10 halo tile comes in
//     by TMA into a ring of slots, one tile ahead of the arithmetic;
//   * LN on the halo, then chain by chain pw1 on wgmma (three m64 tiles, one
//     a warpgroup) into an fp32 chunk of 64 hidden columns, and the nine taps
//     on the CUDA cores straight into the chain's map. The chunk is double
//     buffered: one block barrier a chain.
#include "c64_tile.cuh"

namespace turtle {

constexpr int SC_MAX_OUT = 4;

struct SplitC64Args {
  const void *ln_w, *ln_b, *w1, *wd;
  void* out[SC_MAX_OUT];
  int B, H, W, n_out;
};

// bytes of the parts after the ring: the LN halo (a slot's bytes), w1 (64 x
// 64 N), two fp32 hidden chunks, wd (9 x 64 N); the ring takes as many slots
// as fit
__host__ __device__ inline size_t sc_rest(int n_out) {
  return (size_t)CT_SLOT + (size_t)n_out * CT_PANEL + (size_t)2 * CT_NPH * CT_HS * 4 +
         (size_t)18 * CT_C * n_out;
}
__host__ __device__ inline int sc_stages(int n_out) {
  const int s = (int)((CT_SMEM_MAX - WG_ALIGN - sc_rest(n_out)) / (CT_SLOT + sizeof(uint64_t)));
  return s < CT_MAX_STAGES ? s : CT_MAX_STAGES;
}
__host__ __device__ inline size_t sc_smem(int n_out) {
  const int s = sc_stages(n_out);
  return WG_ALIGN + (size_t)s * CT_SLOT + sc_rest(n_out) + s * sizeof(uint64_t);
}

// Load li (item it0 + li's halo tile) goes to slot li % S; thread 0 starts
// load li + S after the barrier that follows the LN pass of load li.
__global__ void __launch_bounds__(CT_NT, 1)
    split_c64_kernel(const __grid_constant__ SplitC64Args a, const __grid_constant__ CUtensorMap xmap) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int H = a.H, W = a.W, N = a.n_out, CH = N * CT_C;
  const int S = sc_stages(N);
  unsigned char* stg = smem;
  unsigned char* xn = stg + (size_t)S * CT_SLOT;
  unsigned char* w1s = xn + CT_SLOT;
  float* hid = reinterpret_cast<float*>(w1s + N * CT_PANEL);
  T* wds = reinterpret_cast<T*>(hid + 2 * CT_NPH * CT_HS);
  uint64_t* full = reinterpret_cast<uint64_t*>(wds + 9 * CH);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q = warp & 3;
  const int tiles_x = (W + CT_TW - 1) / CT_TW, nt = tiles_x * ((H + CT_TH - 1) / CT_TH);
  const long long total = (long long)a.B * nt;
  const long long it0 = total * blockIdx.x / gridDim.x;
  const long long it1 = total * (blockIdx.x + 1) / gridDim.x;
  const int n_loads = (int)(it1 - it0);
  const CtRing ring{stg, full, S};
  auto issue = [&](int li) {  // thread 0
    const CtTile tl = ct_tile(it0 + li, tiles_x, nt);
    ring.load(li, &xmap, tl.b, tl.y0, tl.x0);
  };

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0)
    for (int li = 0; li < S && li < n_loads; ++li) issue(li);

  // the weights, once a block: w1 a panel a chain, wd as it is
  const T* w1 = static_cast<const T*>(a.w1);
  for (int n = 0; n < N; ++n)
    ct_panel(w1s + n * CT_PANEL, w1, CH, CT_C, [&](int j) { return n * CT_C + 8 * j; });
  {
    const uint4* src = static_cast<const uint4*>(a.wd);
    for (int idx = tid; idx < 9 * CH / 8; idx += CT_NT)
      reinterpret_cast<uint4*>(wds)[idx] = __ldg(src + idx);
  }
  fence_proxy_async();
  __syncthreads();

  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  float gw[8], bt[8];
  {
    const int l = lane & 7;
    load8(ln_w + 8 * l, gw);
#pragma unroll
    for (int i = 0; i < 8; ++i) bt[i] = 0.f;
    if (ln_b != nullptr) load8(ln_b + 8 * l, bt);
  }
  // warpgroup wg multiplies halo rows 64 wg .. 64 wg + 63; rows past the
  // 180th read row 0 and are dropped. ldmatrix row lane & 15 of warp q; this
  // thread's accumulator rows hrow[h]
  const int arow = 64 * wg + 16 * q + (lane & 15) < CT_NPH ? 64 * wg + 16 * q + (lane & 15) : 0;
  int hrow[2];
  bool hrow_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    hrow[h] = 64 * wg + 16 * q + g + 8 * h;
    hrow_ok[h] = hrow[h] < CT_NPH;
  }

  int li = 0, chunk = 0;
#pragma unroll 1
  for (long long it = it0; it < it1; ++it, ++li) {
    const CtTile tl = ct_tile(it, tiles_x, nt);
    const int b = tl.b, y0 = tl.y0, x0 = tl.x0;
    bool hin[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 - 1 + hrow[h] / CT_HW, gx = x0 - 1 + hrow[h] % CT_HW;
      hin[h] = hrow_ok[h] && gy >= 0 && gy < H && gx >= 0 && gx < W;
    }
    // LN(x) of the halo tile into xn; its slot goes back
    ct_ln_pass(ring.wait(li), xn, gw, bt, ln_b != nullptr, H, W, y0, x0);
    __syncthreads();
    if (tid == 0 && li + S < n_loads) issue(li + S);

#pragma unroll 1
    for (int n = 0; n < N; ++n, ++chunk) {
      // pw1 of chain n on the halo tile: w1's panel n, K = 64. Its chunk is
      // the other one than the chain's before, whose taps may still run
      float* hb = hid + (chunk & 1) * (CT_NPH * CT_HS);
      AFrag<T> a1[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_a(a1[kk], reinterpret_cast<const T*>(xn + sw128(arow, 2 * kk + (lane >> 4))));
      float h1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h1[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(h1, a1[kk], panel_desc(w1s + n * CT_PANEL + kk * 2048, CT_PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      pin(h1);
      // the hidden map, zero outside the image
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!hrow_ok[h]) continue;
          *reinterpret_cast<float2*>(hb + ct_hid(hrow[h], col)) =
              make_float2(hin[h] ? h1[4 * j + 2 * h] : 0.f, hin[h] ? h1[4 * j + 2 * h + 1] : 0.f);
        }
      }
      __syncthreads();
      // the taps: output rows 0-5, 6-10, 11-15 a warpgroup, rounded once
      // into map n
      T* out = static_cast<T*>(a.out[n]) + (size_t)b * H * W * CT_C;
      auto to_map = [&](int row, int px, int k, const float (&o)[4]) {
        const int gy = y0 + row, gx = x0 + px;
        if (gy >= H || gx >= W) return;
        __nv_bfloat162 v2[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                __floats2bfloat162_rn(o[2], o[3])};
        *reinterpret_cast<uint2*>(out + ((size_t)gy * W + gx) * CT_C + 4 * k) =
            *reinterpret_cast<const uint2*>(v2);
      };
      if (wg == 0)
        ct_taps<false, 6>(hb, wds, nullptr, CH, CT_C, n * CT_C, 0, tid & 127, to_map);
      else
        ct_taps<false, 5>(hb, wds, nullptr, CH, CT_C, n * CT_C, wg == 1 ? 6 : 11, tid & 127,
                          to_map);
    }
  }
}

static int launch_split_c64(const SplitC64Args& a, const void* x, int blocks,
                            cudaStream_t stream) {
  CUtensorMap xmap;
  if (!ct_encode_halo(&xmap, x, a.B, a.H, a.W, (uint64_t)a.H * a.W * CT_C)) return -2;
  const size_t smem = sc_smem(a.n_out);
  cudaError_t err = cudaFuncSetAttribute(split_c64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_c64_kernel<<<dim3(blocks), dim3(CT_NT), smem, stream>>>(a, xmap);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_split_c64_smem(int n_out) { return turtle::sc_smem(n_out); }

// ptrs: x, ln_w, ln_b, w1 (64, N*64), wd (3, 3, N*64), out_0 .. out_3
// ints: B, H, W, C, E, n_out, grid. Returns the CUDA error code (0 =
// launched), -1 for a call this body does not take, -2 when the tensor map
// is refused.
extern "C" int turtle_split_c64_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  SplitC64Args a = {};
  a.ln_w = ptrs[1]; a.ln_b = ptrs[2]; a.w1 = ptrs[3]; a.wd = ptrs[4];
  for (int i = 0; i < SC_MAX_OUT; ++i) a.out[i] = ptrs[5 + i];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.n_out = ints[5];
  const int C = ints[3], E = ints[4], grid = ints[6];
  if (!is_bf16 || a.ln_w == nullptr || C != CT_C || E != CT_C || a.n_out < 1 ||
      a.n_out > SC_MAX_OUT || grid < 1 || (long long)a.H * a.W > 0x7fffffffLL)
    return -1;
  return launch_split_c64(a, ptrs[0], grid, static_cast<cudaStream_t>(stream));
}
