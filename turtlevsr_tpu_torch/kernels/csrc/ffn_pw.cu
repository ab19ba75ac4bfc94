// The Hopper body of the conv-FFN half without a depthwise stage (row 2):
// the pointwise FFW of a block as a pass of its own,
//
//   x'  = x + x2 @ po (+ po_b)   (at most one map x2 with its po, shared
//         (C, C) or per batch (B, C, C))
//   out = x' + scale * (pw2(gelu(pw1(LN x') + b1)) + b2)
//
// for bf16 maps, mode gelu, F = E = 2 C, C = 128 or 256 (gopro_enc3_ffw's
// enc3 Channel+FFW blocks: C = 256, x2 the channel attention's v map, po its
// per-batch matrix). Replaces fused_block_ffn's no-dw branch in
// turtlevsr_tpu/kernels/ffn.py (_pw_kernel) for these calls; ffn.py's
// _ffn_plan sends them here and keeps ffn.cu's mma.sync body for the rest
// (float32, other widths and forms). It rounds where ffn.cu does: x2 @ po
// to bf16, + po_b rounded again, x' rounded, LN(x') with fp32 statistics
// rounded, pw1 + b1 in fp32, the activation rounded, pw2 + b2, * scale, +
// x' in fp32 and one rounding.
//
// Bound by operations on an H100 (2 (C^2 + 2 C F) flop a pixel with po,
// 655 k at C = 256, against 6 C bytes). ffn.cu ran this purely pointwise
// chain on its 8 x 8 tile body at 30x that bound: a 10 x 10 LN halo no
// depthwise stage needs, the weights read warp by warp from L2 with
// nothing in flight across its barriers. Here, a body of its own that keeps
// ffn_wg.cu's ring (a form of ffn_wg.cu would keep its 384-thread block,
// its halo and its activation chunk in shared memory, none of which this
// chain needs):
//
//   * a persistent grid of one block an SM walks a contiguous range of the
//     (batch entry, tile) items; a tile is 128 consecutive pixels of an
//     entry's flattened map, 64 to each consumer warpgroup (one m64 wgmma
//     tile), its x and x2 brought in by TMA 3-D boxes (64 channels x 128
//     pixels, zeros past the entry's last pixel, the 128-byte swizzle);
//   * po, w1 and w2 stream through ffn_wg.cu's ring of 16 KB TMA stages,
//     one thread refilling a stage as soon as both warpgroups handed it back,
//     across the tile boundaries (the next tile's x2 comes in behind the last
//     pw1, its x behind the epilogue). ptxas serialises some of the products
//     (C7520) for that thread's waits between them; refilling only where no
//     product was in flight kept the warning and ran 16 % slower on an H100;
//   * po and pw1 take their A operand from shared memory by descriptor (x2,
//     then LN(x') in x2's place), so the registers hold pw2's accumulators
//     (64 pixels x C a warpgroup) and one chunk of 64 hidden columns: pw1's
//     accumulators, + b1, gelu, rounded, become pw2's A fragments in
//     registers (the chained FFW's pw4 -> pw5 of ffn_wg.cu); one wgmma group
//     a ring stage, one left in flight;
//   * no copy warps: with a copy warp beside the two warpgroups (288
//     threads) ptxas held a thread to 168 registers, as for 384, and spilled
//     pw2's 128 accumulators at C = 256 (768 bytes, the products serialised,
//     C7520); 256 threads leave it 255.
#include "ffn_tile.cuh"
#include "pipe.cuh"

namespace turtle {

constexpr int PW_TP = 128;           // pixels a tile
constexpr int PW_STAGE = 16384;      // bytes of a ring stage
constexpr int PW_MAX_STAGES = 8;
constexpr int PW_AW = 64;            // hidden columns a chunk
constexpr int PW_PANEL = PW_TP * 128;  // a tile's 64 channels: 128 rows of 128 bytes
constexpr size_t PW_SMEM_MAX = 232448;

// shared memory: x (then x'), x2 (then LN(x')), the ring, its full and empty
// mbarriers, four more (x full, x empty, x2 full, x2 empty)
__host__ __device__ inline int pw_stages(int C) {
  const size_t rest = (size_t)2 * PW_TP * C * 2 + 4 * sizeof(uint64_t);
  const int s = (int)((PW_SMEM_MAX - WG_ALIGN - rest) / (PW_STAGE + 2 * sizeof(uint64_t)));
  return s < PW_MAX_STAGES ? s : PW_MAX_STAGES;
}
__host__ __device__ inline size_t pw_smem(int C) {
  const int s = pw_stages(C);
  return WG_ALIGN + (size_t)2 * PW_TP * C * 2 + (size_t)s * PW_STAGE +
         (2 * s + 4) * sizeof(uint64_t);
}

struct PwMaps {
  CUtensorMap x, x2;   // (C, H W, B), a 64-channel panel of a tile a box; x2 unset without it
  CUtensorMap po;      // (C, rows), 64 x 64 boxes; unset without po
  CUtensorMap w1, w2;  // (E, C) boxes 64 x 128, (C, E) boxes 64 x 8192 / C
};

// d (m64nN) += a b over 16 k: a 64 rows K-major by its descriptor (a tile's
// rows in the 128-byte swizzle), b MN-major from the ring (panel_desc)
template <int N> __device__ __forceinline__ void wgmma_ss_kn(float (&d)[N / 2], uint64_t da,
                                                             uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss_kn<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
template <>
__device__ __forceinline__ void wgmma_ss_kn<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      " %36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      " %48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      " %60,%61,%62,%63}, %64, %65, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// the K-major descriptor of 16 k of a tile's 64 rows from row r0 (a multiple
// of 8), k-step kk: panel kk / 4, 32 bytes a k-step within its rows
__device__ __forceinline__ uint64_t pw_tile_desc(const unsigned char* tile, int r0, int kk) {
  const uint64_t addr = smem_u32(tile + (kk >> 2) * PW_PANEL + r0 * 128 + (kk & 3) * 32);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of (pixel r, channel c) in a tile (c even: a bf16 pair)
__device__ __forceinline__ int pw_at(int r, int c) {
  return (c >> 6) * PW_PANEL + sw128(r, (c & 63) >> 3) + 2 * (c & 7);
}

// C: the map's width (128 or 256). The ring's loads, in the order the
// consumers take them, item by item: with po, C / 128 passes of 128 columns
// of po, C / 64 stages of 64 rows a pass; then chunk by chunk C / 128
// stages of 128 rows of w1's 64 columns and 64 / R2 stages of R2 rows of w2
// (all C columns). Thread 0 starts ring load j + S once both warpgroups
// handed load j back; the next item's x2 once both read LN(x') for the last
// time, its x once both passed the epilogue.
template <int C>
__global__ void __launch_bounds__(NT, 1)
    ffn_pw_kernel(const __grid_constant__ FfnArgs a, const __grid_constant__ PwMaps maps) {
  using T = __nv_bfloat16;
  constexpr int TB = PW_TP * C * 2;     // bytes of a tile
  constexpr int NPW = 128;              // po columns a pass
  constexpr int KB1 = 128, NS1 = C / KB1;  // rows of K of a w1 stage, stages a chunk
  constexpr int R2 = 8192 / C, NS2 = PW_AW / R2;  // rows of w2 a stage, stages a chunk
  constexpr int NJ2 = C / 128;          // pw2 products of N = 128
  constexpr int GL = C / 8, PP = 32 / GL;  // LN: lanes a pixel, pixels a warp
  static_assert(NS1 >= 1 && NS2 >= 1 && GL <= 32, "C = 128 or 256");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int S = pw_stages(C);
  unsigned char* xs = smem;                 // x, then x'
  unsigned char* ys = smem + TB;            // x2, then LN(x')
  unsigned char* ring = smem + 2 * TB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)S * PW_STAGE);
  uint64_t* empty = full + S;
  uint64_t* x_full = empty + S;
  uint64_t* x_empty = x_full + 1;
  uint64_t* y_full = x_full + 2;
  uint64_t* y_empty = x_full + 3;

  const int HW = a.H * a.W, n_chunks = a.E / PW_AW;
  const int tpe = (HW + PW_TP - 1) / PW_TP;  // tiles an entry
  const long long total = (long long)a.B * tpe;
  const long long it0 = total * blockIdx.x / gridDim.x;
  const long long it1 = total * (blockIdx.x + 1) / gridDim.x;
  const bool has_po = a.po_w != nullptr;  // and with it the map x2
  const int n_po = has_po ? (C / NPW) * (C / 64) : 0;  // ring loads of po an item
  const int L = n_po + n_chunks * (NS1 + NS2);         // ring loads an item
  const int n_loads = (int)(it1 - it0) * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // thread 0: ring load j (item it0 + j / L)
  auto issue = [&](int j) {
    const long long it = it0 + j / L;
    const int b = (int)(it / tpe);
    int k = j % L;
    unsigned char* st = ring + (size_t)(j % S) * PW_STAGE;
    uint64_t* bar = &full[j % S];
    mbar_expect_tx(bar, PW_STAGE);
    if (k < n_po) {  // po of this entry: rows b C .. of (B, C, C), or 0 ..
      const int np = k / (C / 64), kb = k % (C / 64);
      const int row0 = a.po_batched ? b * C : 0;
      for (int p = 0; p < NPW / 64; ++p)
        tma_load_2d(st + p * 8192, &maps.po, np * NPW + 64 * p, row0 + 64 * kb, bar);
      return;
    }
    k -= n_po;
    const int ck = k / (NS1 + NS2), i = k % (NS1 + NS2);
    if (i < NS1) {
      tma_load_2d(st, &maps.w1, ck * PW_AW, i * KB1, bar);
    } else {
      for (int p = 0; p < C / 64; ++p)
        tma_load_2d(st + p * R2 * 128, &maps.w2, 64 * p, ck * PW_AW + (i - NS1) * R2, bar);
    }
  };
  // thread 0: the tile of item it of the map m into dst
  auto load_tile = [&](unsigned char* dst, const CUtensorMap* m, uint64_t* bar, long long it) {
    const int b = (int)(it / tpe), p0 = (int)(it - (long long)b * tpe) * PW_TP;
    mbar_expect_tx(bar, TB);
    for (int p = 0; p < C / 64; ++p) tma_load_3d(dst + p * PW_PANEL, m, 64 * p, p0, b, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a warpgroup
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, NT);  // every thread
    mbar_init(y_full, 1);
    mbar_init(y_empty, NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (has_po) load_tile(ys, &maps.x2, y_full, it0);
    load_tile(xs, &maps.x, x_full, it0);
    for (int j = 0; j < S && j < n_loads; ++j) issue(j);
  }

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  // the ring as the threads see it: li the next load, rel the next to hand
  // back (one arrival a warpgroup); thread 0 refills a slot once both
  // warpgroups handed it back
  int li = 0, rel = 0;
  auto take = [&]() {
    const int s = li % S;
    mbar_wait(&full[s], (li / S) & 1);
    ++li;
    return ring + (size_t)s * PW_STAGE;
  };
  auto release_upto = [&](int n) {
    for (; rel < n; ++rel) {
      if ((tid & 127) == 0) mbar_arrive(&empty[rel % S]);
      if (tid == 0 && rel + S < n_loads) {
        mbar_wait(&empty[rel % S], (rel / S) & 1);
        issue(rel + S);
      }
    }
  };

  const T* po_b = static_cast<const T*>(a.po_b);
  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);
  const T* sc = static_cast<const T*>(a.scale);
  // this warpgroup's 64 rows of a tile, this thread's two accumulator rows
  const int r0 = 64 * wg;
  int prow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) prow[h] = r0 + 16 * (warp & 3) + g + 8 * h;
  // LN: lane l of a pixel's GL lanes holds channels 8 l ..
  const int ll = lane % GL;
  float gw[8], bt[8];
  load8(ln_w + 8 * ll, gw);
#pragma unroll
  for (int i = 0; i < 8; ++i) bt[i] = 0.f;
  if (ln_b != nullptr) load8(ln_b + 8 * ll, bt);

  int k = 0;
#pragma unroll 1
  for (long long it = it0; it < it1; ++it, ++k) {
    const int b = (int)(it / tpe), p0 = (int)(it - (long long)b * tpe) * PW_TP;
    const int n_valid = HW - p0 < PW_TP ? HW - p0 : PW_TP;
    __syncthreads();  // every reader of the previous tile's x' and LN(x') is done
    if (has_po) {
      mbar_wait(y_full, k & 1);
      // x' = x + x2 @ po in passes of 128 columns: A is x2's tile by
      // descriptor, B this pass's C / 64 stages of 64 rows of po
#pragma unroll 1
      for (int np = 0; np < C / NPW; ++np) {
        float pa[NPW / 2];
#pragma unroll
        for (int i = 0; i < NPW / 2; ++i) pa[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < C / 64; ++kb) {
          const unsigned char* bs = take();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_kn<NPW>(pa, pw_tile_desc(ys, r0, 4 * kb + kk),
                             panel_desc(bs + kk * 16 * 128, 64 * 128));
          wgmma_commit();
          if (kb > 0) {
            wgmma_wait<1>();
            release_upto(li - 1);
          }
        }
        wgmma_wait<0>();
        pin(pa);
        release_upto(li);
        if (np == 0) mbar_wait(x_full, k & 1);
        // each product rounded, + po_b rounded again, x' = x + that rounded,
        // in place of x
#pragma unroll
        for (int j = 0; j < NPW / 8; ++j) {
          const int col = np * NPW + 8 * j + 2 * t;
          float2 pb = make_float2(0.f, 0.f);
          if (po_b != nullptr)
            pb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po_b + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xs + pw_at(prow[h], col));
            const float2 xx = __bfloat1622float2(*px);
            float a0 = round_to<T>(pa[4 * j + 2 * h]), a1 = round_to<T>(pa[4 * j + 2 * h + 1]);
            if (po_b != nullptr) {
              a0 = round_to<T>(a0 + pb.x);
              a1 = round_to<T>(a1 + pb.y);
            }
            *px = __floats2bfloat162_rn(xx.x + a0, xx.y + a1);
          }
        }
      }
    } else {
      mbar_wait(x_full, k & 1);
    }
    __syncthreads();  // x' whole; with po every warpgroup's reads of x2 done
    // LN(x') rounded into x2's place
#pragma unroll 1
    for (int pix = warp * PP + lane / GL; pix < PW_TP; pix += NW * PP) {
      const int off = pw_at(pix, 8 * ll);
      float v[8];
      load8(reinterpret_cast<const T*>(xs + off), v);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
#pragma unroll
      for (int m = 1; m < GL; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      const float mu = s / (float)C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) q += (v[i] - mu) * (v[i] - mu);
#pragma unroll
      for (int m = 1; m < GL; m <<= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
      const float inv = 1.0f / sqrtf(q / (float)C + LN_EPS);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = ln_b != nullptr ? (v[i] - mu) * inv * gw[i] + bt[i] : v[i] * inv * gw[i];
      store8(reinterpret_cast<T*>(ys + off), v);
    }
    fence_proxy_async();  // LN(x') is read by wgmma
    __syncthreads();

    float acc[NJ2][64];
#pragma unroll
    for (int n = 0; n < NJ2; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
#pragma unroll 1
    for (int ck = 0; ck < n_chunks; ++ck) {
      // pw1: 64 hidden columns, K = C in stages of 128 rows
      float h1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h1[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < NS1; ++kb) {
        const unsigned char* bs = take();
#pragma unroll
        for (int kk = 0; kk < KB1 / 16; ++kk)
          wgmma_ss_kn<64>(h1, pw_tile_desc(ys, r0, kb * (KB1 / 16) + kk),
                          panel_desc(bs + kk * 16 * 128, KB1 * 128));
        wgmma_commit();
        wgmma_wait<1>();  // the group before (the last pw2 stage, or pw1's) is done
        release_upto(li - 1);
      }
      wgmma_wait<0>();
      pin(h1);
      release_upto(li);
      // LN(x') is read for the last time: the next item's x2 may come in
      if (has_po && ck + 1 == n_chunks) {
        mbar_arrive(y_empty);
        if (tid == 0 && it + 1 < it1) {
          mbar_wait(y_empty, k & 1);
          load_tile(ys, &maps.x2, y_full, it + 1);
        }
      }
      // + b1, gelu, rounded: pw2's A operand, straight from the accumulators
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = ck * PW_AW + 8 * j + 2 * t;
        const float2 bias =
            b1 != nullptr ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col))
                          : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          h1[4 * j + 2 * h] = gelu_exact(h1[4 * j + 2 * h] + bias.x);
          h1[4 * j + 2 * h + 1] = gelu_exact(h1[4 * j + 2 * h + 1] + bias.y);
        }
      }
      AFrag<T> a2[PW_AW / 16];
#pragma unroll
      for (int kk = 0; kk < PW_AW / 16; ++kk) a2[kk] = acc_afrag<64>(h1, kk);
      // pw2: rows ck * 64 .. of w2 in NS2 stages of R2 rows; the last group
      // stays in flight into the next chunk's pw1
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NS2; ++i) {
        const unsigned char* bs = take();
#pragma unroll
        for (int kk = 0; kk < R2 / 16; ++kk)
#pragma unroll
          for (int n = 0; n < NJ2; ++n)
            wgmma_rs<128>(acc[n], a2[i * (R2 / 16) + kk],
                          panel_desc(bs + 2 * n * R2 * 128 + kk * 16 * 128, R2 * 128));
        wgmma_commit();
        wgmma_wait<1>();
        release_upto(li - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NJ2; ++n) pin(acc[n]);
    release_upto(li);

    // epilogue: y = (acc + b2) * scale + x', one rounding, straight to the map
    T* out = static_cast<T*>(a.out) + ((size_t)b * HW + p0) * C;
#pragma unroll
    for (int n = 0; n < NJ2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * n + 8 * j + 2 * t;
        const float2 bb =
            b2 != nullptr ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col))
                          : make_float2(0.f, 0.f);
        const float2 ss =
            sc != nullptr ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + col))
                          : make_float2(1.f, 1.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (prow[h] >= n_valid) continue;
          const float2 xx = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + pw_at(prow[h], col)));
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)prow[h] * C + col) =
              __floats2bfloat162_rn((acc[n][4 * j + 2 * h] + bb.x) * ss.x + xx.x,
                                    (acc[n][4 * j + 2 * h + 1] + bb.y) * ss.y + xx.y);
        }
      }
    fence_proxy_async();  // x' was written here: order it before the next TMA load
    mbar_arrive(x_empty);  // x' is read: the next item's x may come in
    if (tid == 0 && it + 1 < it1) {
      mbar_wait(x_empty, k & 1);
      load_tile(xs, &maps.x, x_full, it + 1);
    }
  }
}

template <int C>
static int launch_ffn_pw(const FfnArgs& a, int blocks, cudaStream_t stream) {
  PwMaps maps;
  const uint64_t c = C, hw = (uint64_t)a.H * a.W, e = a.E;
  constexpr uint32_t R2 = 8192 / C;
  auto tile_map = [&](CUtensorMap* m, const void* base, uint64_t batch_stride) {
    return encode_bf16<3>(m, base, {c, hw, (uint64_t)a.B}, {c * 2, batch_stride * 2},
                          {64, PW_TP, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const uint64_t po_rows = (a.po_batched ? (uint64_t)a.B : 1) * c;
  if (!tile_map(&maps.x, a.x, hw * c) ||
      (a.n_x2 > 0 && !tile_map(&maps.x2, a.x2[0], (uint64_t)a.x2_bs[0])) ||
      (a.po_w != nullptr && !encode_bf16<2>(&maps.po, a.po_w, {c, po_rows}, {c * 2}, {64, 64},
                                             CU_TENSOR_MAP_SWIZZLE_128B)) ||
      !encode_bf16<2>(&maps.w1, a.w1, {e, c}, {e * 2}, {64, 128}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<2>(&maps.w2, a.w2, {c, e}, {c * 2}, {64, R2}, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  auto kern = ffn_pw_kernel<C>;
  const size_t smem = pw_smem(C);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks), dim3(NT), smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_ffn_pw_smem(int C) { return turtle::pw_smem(C); }

// ptrs: those of turtle_ffn_launch (ffn.cu); ints: those of it, then the
// persistent grid's blocks. Returns the CUDA error code (0 = launched), -1
// for a call this body does not take, -2 when a tensor map is refused.
extern "C" int turtle_ffn_pw_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
  FfnArgs a = {};
  a.x = ptrs[0]; a.po_w = ptrs[1]; a.po_b = ptrs[2];
  a.ln_w = ptrs[3]; a.ln_b = ptrs[4]; a.w1 = ptrs[5]; a.b1 = ptrs[6];
  a.wd = ptrs[7]; a.bd = ptrs[8]; a.w2 = ptrs[9]; a.b2 = ptrs[10]; a.scale = ptrs[11];
  a.f_w1 = ptrs[14]; a.out = ptrs[19];
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.C = ints[3]; a.CH = ints[4];
  a.E = ints[5]; a.F = ints[6]; a.gate = ints[7]; a.po_batched = ints[8];
  a.n_x2 = ints[9];
  const int blocks = ints[15];
  if (a.n_x2 < 0 || a.n_x2 > 1) return -1;
  a.x2[0] = a.n_x2 > 0 ? ptrs[20] : nullptr;
  a.x2_bs[0] = ints[10];
  if (!is_bf16 || a.wd != nullptr || a.f_w1 != nullptr || a.gate || a.ln_w == nullptr ||
      a.E != 2 * a.C || a.CH != a.E || (a.po_w != nullptr) != (a.n_x2 == 1) || blocks < 1 ||
      (long long)a.H * a.W > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.C == 128) return launch_ffn_pw<128>(a, blocks, s);
  if (a.C == 256) return launch_ffn_pw<256>(a, blocks, s);
  return -1;
}
