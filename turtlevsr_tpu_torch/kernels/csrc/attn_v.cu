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
// sab_attn_v_merge in turtlevsr_tpu/kernels/sab.py.
//
// What bounds it on an H100: each entry reads a (HW^2) and v (HW D) and
// writes HW D elements, and does 2 HW^2 D flop. At the 15-tile shapes (HW =
// 400) that is 412 MB against 78.6 GFLOP at dec3: bound by bytes (0.123 ms)
// with the operations close behind (0.080 ms); at the whole frame (HW =
// 3680) the operations bound it (0.449 ms against 0.104). The design aims at
// the bytes bound of the tiled case and at the operations bound of the whole
// frame, so it keeps the tensor cores fed from copies that run behind them:
//   * a block owns BM query rows by 256 columns of D and walks the keys in
//     chunks of 64 through a ring of 4 shared-memory stages; thread 0 starts
//     each stage's TMA boxes (four 64-column panels of v, the BM x 64 tile
//     of a; parts outside the maps arrive as zeros) on a full mbarrier and
//     refills a stage once both warpgroups have released it on its empty
//     mbarrier, so the copies of the next chunks run behind the products and
//     no barrier of the whole block stands in the loop; the products of a
//     chunk stay in flight while the next chunk's begin (wgmma, bf16,
//     fp32 sums, one rounding to T);
//   * the product runs transposed (out^T = v^T a^T): D is wgmma's 64-row
//     side, so BM, its N side, can be chosen from HW among 80, 64 and 48 rows
//     (the tile that leaves the fewest empty rows; 80 divides both 400 and
//     3680), and both operands are read from the ring as they are stored (v
//     [key][d], the MN-major layout read transposed; a [q][key], K-major), in
//     the 128-byte swizzle TMA writes;
//   * the blocks of one column slab of one entry are launched side by side
//     (query block fastest), so v comes from device memory once and from L2
//     HW / BM times, and a (a few hundred KB an entry) stays in L2 while
//     every slab of its entry passes;
//   * the result tile is staged in shared memory and leaves in 16-byte
//     pieces, each piece inside one slot (c is a multiple of 8), so the
//     merge costs no extra pass; a thread keeps one column piece, whose slot
//     and window place it works out once.
// The values of each entry n = b * NF + i are read where they lie: v is given
// as NF tensors with their own batch strides (the ring positions of the cache
// and the current frame's values), one tensor map each; no stacked copy is
// made. The validity of a frame is already in a. A tensor map's strides must
// be multiples of 16 bytes, so bf16 maps whose HW is not a multiple of 8, and
// T = float (float32 serving and the tight on-card comparisons), take
// a simpler body: mma.sync tiles of the same product (every warp all BM rows,
// 32 or 16 columns of its own), a cp.async ring of 32-key chunks (4 stages of
// 256 columns in bf16, 3 of 128 in float; fragments read element by element
// and products by FMA in float).
#include "pipe.cuh"

namespace turtle {

constexpr int AV_KC = 32;            // keys per chunk
constexpr int AV_AS = AV_KC + XPAD;  // row stride of an a stage
constexpr int AV_MAX_V = 5;          // value tensors per launch (ring positions + 1)

struct AvArgs {
  const void* a;           // entry n starts at a + n * a_bs elements
  const void* v[AV_MAX_V]; // entry n = b * NF + i starts at v[i] + b * v_bs[i]
  void* out;               // contiguous
  int a_bs, v_bs[AV_MAX_V];
  int BN, NF, HW, D, c, merge, ws, hh, ww;
};

template <class T> struct AvTile;
template <> struct AvTile<__nv_bfloat16> { static constexpr int BD = 256, STAGES = 4; };
template <> struct AvTile<float> { static constexpr int BD = 128, STAGES = 3; };

// the result tile os ([BM][vs], rows q0.., columns d0..) to its place:
// 16-byte pieces, each inside one slot. A thread keeps one column piece (its
// slot and place in the window are fixed) and walks the rows.
template <class T>
__device__ __forceinline__ void av_store(const AvArgs& p, const T* os, int vs, int BM, int BD,
                                         int q0, int d0, int n) {
  T* out = static_cast<T*>(p.out);
  const int HW = p.HW, D = p.D, c = p.c, S = D / c;
  const int pieces = BD / 8, c8 = (threadIdx.x % pieces) * 8, d = d0 + c8;
  if (d >= D) return;
  const int s = d / c, cc = d - s * c, p1 = s / p.ws, p2 = s - p1 * p.ws;
  for (int r = threadIdx.x / pieces; r < BM && q0 + r < HW; r += NT / pieces) {
    const int q = q0 + r;
    size_t off;
    if (p.merge) {
      const int i = q / p.ww, j = q - i * p.ww;
      off = (((size_t)n * (p.ws * p.hh) + p1 * p.hh + i) * (p.ws * p.ww) + p2 * p.ww + j) * c + cc;
    } else {
      off = (((size_t)n * S + s) * HW + q) * c + cc;
    }
    copy8(out + off, os + r * vs + c8);
  }
}

template <class T, int BM>
__host__ __device__ constexpr size_t av_smem() {
  constexpr int BD = AvTile<T>::BD, VS = BD + XPAD;
  const size_t ring = (size_t)AvTile<T>::STAGES * (BM * AV_AS + AV_KC * VS);
  const size_t out = (size_t)BM * VS;
  return (ring > out ? ring : out) * sizeof(T);
}

template <class T, int BM>
__global__ void __launch_bounds__(NT) attn_v_kernel(const __grid_constant__ AvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BD = AvTile<T>::BD, STAGES = AvTile<T>::STAGES;
  constexpr int VS = BD + XPAD;        // row stride of a v stage and of the out tile
  constexpr int MI = BM / 16;          // 16-row tiles, every warp all of them
  constexpr int NJ = BD / NW / 8;      // 8-column tiles of a warp
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte piece
  constexpr int STAGE = BM * AV_AS + AV_KC * VS;
  static_assert(BM % 16 == 0 && NJ % 2 == 0, "tile geometry");
  T* ring = reinterpret_cast<T*>(smem);  // stage s: a [BM][AV_AS], then v [AV_KC][VS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int HW = p.HW, D = p.D;
  const int q0 = blockIdx.x * BM, d0 = blockIdx.y * BD, n = blockIdx.z;
  const int bb = n / p.NF, fi = n - bb * p.NF;
  const T* a = static_cast<const T*>(p.a) + (size_t)n * p.a_bs;
  const T* v = static_cast<const T*>(p.v[0]);
  int v_bs = p.v_bs[0];
#pragma unroll
  for (int i = 1; i < AV_MAX_V; ++i)
    if (fi == i) { v = static_cast<const T*>(p.v[i]); v_bs = p.v_bs[i]; }
  v += (size_t)bb * v_bs;
  // rows of a start at 16-byte boundaries when HW elements fill 16-byte pieces
  const bool a_vec = (HW * (int)sizeof(T)) % 16 == 0;
  const int n_chunks = (HW + AV_KC - 1) / AV_KC;

  auto load_chunk = [&](int ch, int s) {
    T* as = ring + s * STAGE;
    T* vs = as + BM * AV_AS;
    const int k0 = ch * AV_KC;
    // a: rows q0.., keys k0..; zero outside
    for (int idx = tid; idx < BM * (AV_KC / VE); idx += NT) {
      const int r = idx / (AV_KC / VE), kv = (idx - r * (AV_KC / VE)) * VE;
      T* dst = as + r * AV_AS + kv;
      const int q = q0 + r, k = k0 + kv;
      if (q < HW && k + VE <= HW && a_vec) {
        cp_async16(dst, a + (size_t)q * HW + k);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i)
          dst[i] = (q < HW && k + i < HW) ? a[(size_t)q * HW + k + i] : from_f<T>(0.f);
      }
    }
    // v: keys k0.., columns d0..; zero outside (D is a multiple of 8)
    for (int idx = tid; idx < AV_KC * (BD / VE); idx += NT) {
      const int r = idx / (BD / VE), cv = (idx - r * (BD / VE)) * VE;
      T* dst = vs + r * VS + cv;
      if (k0 + r < HW && d0 + cv < D) cp_async16(dst, v + (size_t)(k0 + r) * D + d0 + cv);
      else zero16(dst);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  // this lane's rows of a: ldmatrix addresses (bf16) or rows g, g + 8 (float)
  int aoff[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if constexpr (sizeof(T) == 2) {
      aoff[mi][0] = (mi * 16 + (lane & 15)) * AV_AS + (lane >> 4) * 8;
      aoff[mi][1] = 0;
    } else {
      aoff[mi][0] = (mi * 16 + g) * AV_AS;
      aoff[mi][1] = (mi * 16 + g + 8) * AV_AS;
    }
  }

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;

#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();  // chunk ch landed
    __syncthreads();              // ... for every thread; stage (ch - 1) % STAGES is free
    if (ch + STAGES - 1 < n_chunks) load_chunk(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);
    cp_async_commit();
    const T* as = ring + (ch % STAGES) * STAGE;
    const T* vs = as + BM * AV_AS;
#pragma unroll
    for (int kk = 0; kk < AV_KC; kk += 16) {
      AFrag<T> af[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if constexpr (sizeof(T) == 2)
          ldsm_a(af[mi], as + aoff[mi][0] + kk);
        else
          load_a(af[mi], as + aoff[mi][0], as + aoff[mi][1], kk);
      }
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        BFrag<T> bf[2];
        ldsm_b_pair(bf[0], bf[1], vs, VS, kk, (warp * NJ + j) * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          tile_mma(acc[mi][j], af[mi], bf[0]);
          tile_mma(acc[mi][j + 1], af[mi], bf[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // stage the tile, rounded once to T
  T* os = ring;  // [BM][VS]
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        os[(mi * 16 + g + 8 * (i >> 1)) * VS + (warp * NJ + j) * 8 + 2 * t + (i & 1)] =
            from_f<T>(acc[mi][j][i]);
  __syncthreads();

  av_store(p, os, VS, BM, BD, q0, d0, n);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma. The product is computed transposed, out^T = v^T a^T, so that
// the 64-row side of wgmma runs along D (256 columns a block, 64 a panel)
// and the query rows are its N side, which takes any multiple of 8: 80, 64
// or 48 rows as above. Both operands come from the ring through matrix
// descriptors: v as stored ([key][d], d contiguous: the MN-major layout,
// read transposed) and a as stored ([q][key], keys contiguous: K-major),
// each in 128-byte rows with 16-byte pieces swizzled as piece ^ (row & 7).
// Chunks of 64 keys; warpgroup w multiplies panels 2 w and 2 w + 1; the
// products of a chunk stay in flight while the next chunk's begin.
// ---------------------------------------------------------------------------

template <int N> __device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                                          uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      " %36,%37,%38,%39}, %40, %41, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}, %24, %25, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

constexpr int AW_KC = 64, AW_BD = 256, AW_STAGES = 4, AW_ALIGN = 1024;
constexpr int AW_V_BYTES = AW_KC * AW_BD * 2;  // four panels of 64 keys x 128 bytes

// the tensor maps of a launch: a as (BN, HW q, HW keys), each v_i as
// (B, HW keys, D); boxes of 64 elements (128 bytes, swizzled) innermost
struct AvMaps {
  CUtensorMap a;
  CUtensorMap v[AV_MAX_V];
};

template <int BM>
__host__ __device__ constexpr size_t av_wgmma_smem() {
  const size_t ring = (size_t)AW_STAGES * (AW_V_BYTES + BM * 128);
  const size_t out = (size_t)BM * (AW_BD + XPAD) * 2;
  return AW_ALIGN + (ring > out ? ring : out) + 2 * AW_STAGES * sizeof(uint64_t);
}

template <int BM>
__global__ void __launch_bounds__(NT) attn_v_wgmma_kernel(const __grid_constant__ AvArgs p,
                                                          const __grid_constant__ AvMaps maps) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<AW_ALIGN>(smem_raw);
  constexpr int STAGE = AW_V_BYTES + BM * 128, NA = BM / 2, VS = AW_BD + XPAD;
  constexpr size_t RING = (size_t)AW_STAGES * STAGE;
  constexpr size_t OUT = (size_t)BM * VS * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (RING > OUT ? RING : OUT));
  uint64_t* empty = full + AW_STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, q4 = warp & 3;
  const int HW = p.HW;
  const int q0 = blockIdx.x * BM, d0 = blockIdx.y * AW_BD, n = blockIdx.z;
  const int bb = n / p.NF, fi = n - bb * p.NF;
  const CUtensorMap* vmap = &maps.v[0];
#pragma unroll
  for (int i = 1; i < AV_MAX_V; ++i)
    if (fi == i) vmap = &maps.v[i];
  const int n_chunks = (HW + AW_KC - 1) / AW_KC;

  // chunk ch into stage s: four 64-column panels of v, then the a tile
  auto fill = [&](int ch, int s) {
    unsigned char* vs = smem + s * STAGE;
    mbar_expect_tx(&full[s], STAGE);
#pragma unroll
    for (int pp = 0; pp < AW_BD / 64; ++pp)
      tma_load_3d(vs + pp * (AW_KC * 128), vmap, d0 + 64 * pp, ch * AW_KC, bb, &full[s]);
    tma_load_3d(vs + AW_V_BYTES, &maps.a, ch * AW_KC, q0, n, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < AW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < AW_STAGES && s < n_chunks; ++s) fill(s, s);

  float acc[2][NA];
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[pp][i] = 0.f;

#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch % AW_STAGES;
    mbar_wait(&full[s], (ch / AW_STAGES) & 1);
    const unsigned char* vs = smem + s * STAGE;
    const unsigned char* as = vs + AW_V_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < AW_KC / 16; ++ks)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
        wgmma_ss<BM>(acc[pp], sw128_desc(vs + (2 * wg + pp) * (AW_KC * 128) + ks * 16 * 128,
                                         AW_KC * 128),
                     sw128_desc(as + ks * 32, 16));
    wgmma_commit();
    wgmma_wait<1>();  // the products of chunk ch - 1 are done: its stage is free
    if (ch >= 1) {
      const int sp = (ch - 1) % AW_STAGES;
      if (lane == 0 && q4 == 0) mbar_arrive(&empty[sp]);
      if (tid == 0 && ch - 1 + AW_STAGES < n_chunks) {
        mbar_wait(&empty[sp], ((ch - 1) / AW_STAGES) & 1);
        fill(ch - 1 + AW_STAGES, sp);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) pin(acc[pp]);
  __syncthreads();  // every copy was awaited, every product is done

  // stage the tile as [q][d], rounded once to T: accumulator row m is column
  // d0 + 64 (2 wg + pp) + m, column j of it query q0 + j
  T* os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (2 * wg + pp) * 64 + 16 * q4 + g + 8 * (i >> 1), qq = 8 * j + 2 * t + (i & 1);
        os[qq * VS + m] = from_f<T>(acc[pp][4 * j + i]);
      }
  __syncthreads();
  av_store(p, os, VS, BM, AW_BD, q0, d0, n);
}

template <int BM>
static int launch_attn_v_wgmma(const AvArgs& p, cudaStream_t stream) {
  AvMaps maps;
  const uint64_t hw = p.HW, d = p.D;
  if (!encode_bf16<3>(&maps.a, p.a, {hw, hw, (uint64_t)p.BN}, {hw * 2, (uint64_t)p.a_bs * 2},
                      {64, BM, 1}, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const uint64_t B = p.BN / p.NF;
  for (int i = 0; i < AV_MAX_V; ++i) {
    const int j = i < p.NF ? i : 0;  // unused maps repeat the first
    if (!encode_bf16<3>(&maps.v[i], p.v[j], {d, hw, B}, {d * 2, (uint64_t)p.v_bs[j] * 2},
                        {64, AW_KC, 1}, CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
  }
  const size_t smem = av_wgmma_smem<BM>();
  auto kern = attn_v_wgmma_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.HW + BM - 1) / BM, (p.D + AW_BD - 1) / AW_BD, p.BN);
  if (grid.y > 65535) return -1;
  kern<<<grid, dim3(NT), smem, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

template <class T, int BM>
static int launch_attn_v(const AvArgs& p, cudaStream_t stream) {
  const size_t smem = av_smem<T, BM>();
  auto kern = attn_v_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.HW + BM - 1) / BM, (p.D + AvTile<T>::BD - 1) / AvTile<T>::BD, p.BN);
  if (grid.y > 65535) return -1;
  kern<<<grid, dim3(NT), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the query-row tile that leaves the fewest empty rows in the last block
// (ties: the taller tile)
template <class T>
static int dispatch_attn_v(const AvArgs& p, cudaStream_t stream) {
  const int pad80 = (80 - p.HW % 80) % 80, pad64 = (64 - p.HW % 64) % 64,
            pad48 = (48 - p.HW % 48) % 48;
  const int bm = (pad80 <= pad64 && pad80 <= pad48) ? 80 : pad64 <= pad48 ? 64 : 48;
  // bf16 with rows of a on the 16-byte grid (a tensor map's strides must be
  // multiples of 16 bytes): the wgmma body; else the mma.sync one
  if (sizeof(T) == 2 && p.HW % 8 == 0) {
    if (bm == 80) return launch_attn_v_wgmma<80>(p, stream);
    if (bm == 64) return launch_attn_v_wgmma<64>(p, stream);
    return launch_attn_v_wgmma<48>(p, stream);
  }
  if (bm == 80) return launch_attn_v<T, 80>(p, stream);
  if (bm == 64) return launch_attn_v<T, 64>(p, stream);
  return launch_attn_v<T, 48>(p, stream);
}

}  // namespace turtle

// ptrs: a, out, v_0 .. v_4 (null = absent)
// ints: BN, NF, HW, D, c, merge, ws, hh, ww, a_bs, v_bs_0 .. v_bs_4 (strides
// in elements). Entry n = b * NF + i of a and out goes with v_i[b]. Returns
// the CUDA error code (0 = launched), -1 for a shape the kernel does not take.
extern "C" int turtle_attn_v_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
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
  return is_bf16 ? dispatch_attn_v<__nv_bfloat16>(p, s) : dispatch_attn_v<float>(p, s);
}
