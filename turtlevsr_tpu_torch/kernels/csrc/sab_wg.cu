// The Hopper body of the StateAlignBlock's attention probabilities (row 7),
// bf16, D a multiple of 64 up to 512, the local window's radius at most 4:
//
//   s    = round_to_bf16((q . k^T) * temperature)     per cached frame
//   keep = the k_top largest entries of each row (ties: first occurrence)
//   comb = s * keep + s * local       local: L1 distance <= n_local between
//                                     query and key on the (hq, wq) grid
//   out  = softmax over the nonzero entries of comb, zero elsewhere,
//          times the frame's validity
//
// q (B, HW, D), k (B, NF, HW, D) as the ring stores it, out (B, NF, HW, HW).
// kernels/sab.py's _sab_plan sends every such call here; float32 and the
// other shapes stay on sab.cu's sab_probs_kernel, whose note gives the
// function. Replaces sab_fused_attn_probs in turtlevsr_tpu/kernels/sab.py
// (_scores_kernel).
//
// Bound by operations at D = 512 and 256 (2 HW^2 D flop a frame against HW^2
// outputs written) and by bytes at D = 128. What held sab.cu back: a block of
// 16 query rows read every key of its frame from device memory (HW / 16
// passes over k) into mma.sync tiles, kept the dense row of HW scores in
// shared memory, and one warp walked each row four times. Here:
//
//   * a block owns 128 query rows of one (batch, frame), 64 a consumer
//     warpgroup; its q tile comes in once by TMA (D / 64 boxes of 128 rows x
//     128 bytes, the 128-byte swizzle), and the frame's keys stream through a
//     ring of 16 KB stages (128 keys x 64 d) filled by TMA from a copy warp:
//     each block reads k once;
//   * the scores of a key tile come from wgmma m64n128k16 with both operands
//     K-major in shared memory, into fp32 registers; each is scaled by the
//     temperature and rounded to bf16 as sab.cu rounds it;
//   * in the epilogue of each key tile every thread updates a running top-5
//     of (value, index) for each of its two rows over the columns it holds
//     (the tiles and a thread's columns come in ascending index order, and a
//     later equal value never displaces an earlier one: first occurrence on
//     ties), stores the scores that fall in a row's local window into a
//     shared table of (2 * 4 + 1)^2 slots a row, indexed by (dy, dx), and
//     writes zeros over the tile's columns of its warp's 16 rows (16-byte
//     stores when HW is a multiple of 8): the dense row's bytes leave behind
//     the products;
//   * after the last tile the four threads that share a row merge their
//     top-5 lists (value descending, index ascending), and the nonzero
//     entries of comb are the union of the chosen and the local window (an
//     entry in both counts 2s): at most k_top + 41 values, from which the
//     softmax is taken and written over the zeros.
//
// Row 12 (sab.cu's sparse_softmax_kernel) stays bit for bit this body on
// exact scores: the finishing step repeats sparse_softmax_row's fp32 order.
// There the lane l of a warp sums the exponentials of the entries j = l
// (mod 32) in ascending j, and a __shfl_xor tree from 16 down to 1 adds the
// lanes; here thread t of a row's quad keeps those eight lane sums of the
// entries j = t (mod 4), adds them as the tree's first three steps do, and
// its last two steps are the same shuffles within the quad (fp32 addition
// is commutative, so each step gives the same bits). The maximum, expf, the
// FLT_MIN floor and the value expf(c - max) / sum * fvalid are the same
// expressions; the entries whose comb is zero add nothing in either.
#include <cfloat>
#include <climits>

#include "pipe.cuh"

namespace turtle {

constexpr int SB_ROWS = 128;            // query rows of a block
constexpr int SB_KEYS = 128;            // keys of a key tile (wgmma N)
constexpr int SB_BOX = 128 * 128;       // bytes of a TMA box: 128 rows x 64 d
constexpr int SB_NL = 4;                // the largest local radius this body takes
constexpr int SB_SIDE = 2 * SB_NL + 1;  // the window's slots a row: SB_SIDE^2
constexpr int SB_SLOTS = SB_SIDE * SB_SIDE;
constexpr int SB_KTOP = 5;
constexpr int SB_CAND = 8;              // a thread's buffer of top-5 candidates
constexpr int SB_MAX_STAGES = 8;
constexpr int SB_NT = NT + 32;          // two consumer warpgroups and a copy warp
constexpr size_t SB_SMEM_MAX = 232448;

struct SabWgArgs {
  const float *temp, *fvalid;  // device: one temperature, NF validities (or null)
  void* out;
  int B, NF, HW, D, wq, k_top, n_local;
};

// bytes of the parts beside the ring: the q tile, the window slots and the
// candidate buffers; the ring takes as many 16 KB stages as fit
__host__ __device__ inline size_t sb_rest(int D) {
  return (size_t)(D / 64) * SB_BOX + (size_t)SB_ROWS * SB_SLOTS * 2 + (size_t)SB_CAND * NT * 4;
}
__host__ __device__ inline int sb_stages(int D) {
  const size_t room = SB_SMEM_MAX - WG_ALIGN - sb_rest(D) - sizeof(uint64_t);
  const int s = (int)(room / (SB_BOX + 2 * sizeof(uint64_t)));
  return s < SB_MAX_STAGES ? s : SB_MAX_STAGES;
}
__host__ __device__ inline size_t sb_smem(int D) {
  const int s = sb_stages(D);
  return WG_ALIGN + (size_t)s * SB_BOX + sb_rest(D) + (2 * s + 1) * sizeof(uint64_t);
}

// a K-major operand of 16 k in the 128-byte swizzle: rows of 128 bytes (64
// bf16 of k), 8-row groups 1024 bytes apart; p points at the first row's k0
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (m64n128, fp32) += a b^T over 16 k: a 64 rows, b 128 rows, both K-major
__device__ __forceinline__ void wgmma_ss128_kk(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      " %12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      " %24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      " %36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      " %48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      " %60,%61,%62,%63}, %64, %65, 1, 1, 1, 0, 0;\n"
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

// the running top-5 (value descending, index ascending) after the n
// candidates of key tile j0 in the thread's buffer, in their order: a later
// equal value never displaces an earlier one
__device__ __forceinline__ void sb_insert(float (&tv)[SB_KTOP], int (&ti)[SB_KTOP],
                                          const uint32_t* cand, int n, int j0) {
  for (int i = 0; i < n; ++i) {
    const uint32_t w = cand[i * NT + threadIdx.x];
    const float v = __uint_as_float(w & 0xffff0000u);
    if (!(v > tv[SB_KTOP - 1])) continue;
    tv[SB_KTOP - 1] = v;
    ti[SB_KTOP - 1] = j0 + (int)(w & 0xffffu);
#pragma unroll
    for (int m = SB_KTOP - 1; m > 0; --m)
      if (tv[m] > tv[m - 1]) {
        const float fv_ = tv[m]; tv[m] = tv[m - 1]; tv[m - 1] = fv_;
        const int iv_ = ti[m]; ti[m] = ti[m - 1]; ti[m - 1] = iv_;
      }
  }
}

// the key's row on the token grid: (j + 0.5) / wq in fp32 lies at least
// 0.5 / wq from an integer and is off by less than that below 2^22 keys
__device__ __forceinline__ int sb_key_row(int j, float rwq) {
  return __float2int_rz(((float)j + 0.5f) * rwq);
}

__global__ void __launch_bounds__(SB_NT, 1)
    sab_wg_kernel(const __grid_constant__ SabWgArgs a, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem<WG_ALIGN>(smem_raw);
  const int HW = a.HW, D = a.D, ND = D / 64, wq = a.wq, hq = HW / wq, NL = a.n_local;
  const int S = sb_stages(D);
  unsigned char* qs = smem;
  unsigned char* ring = qs + (size_t)ND * SB_BOX;
  T* slots = reinterpret_cast<T*>(ring + (size_t)S * SB_BOX);  // [SB_ROWS][SB_SLOTS]
  uint32_t* cand = reinterpret_cast<uint32_t*>(slots + SB_ROWS * SB_SLOTS);  // [SB_CAND][NT]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(cand + SB_CAND * NT);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  const int r0 = blockIdx.x * SB_ROWS, n = blockIdx.y, b = blockIdx.z;
  const int n_kt = (HW + SB_KEYS - 1) / SB_KEYS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < SB_ROWS * SB_SLOTS / 2; i += SB_NT)
    reinterpret_cast<uint32_t*>(slots)[i] = 0u;  // slots off the grid stay zero
  __syncthreads();

  if (warp == NW) {  // the copy warp: lane 0 starts every load
    if (lane == 0) {
      mbar_expect_tx(qbar, ND * SB_BOX);
      for (int d = 0; d < ND; ++d)
        tma_load_2d(qs + (size_t)d * SB_BOX, &qmap, 64 * d, b * HW + r0, qbar);
      const int krow = (b * a.NF + n) * HW;
      int li = 0;
      for (int kt = 0; kt < n_kt; ++kt)
        for (int d = 0; d < ND; ++d) {
          const int s = li % S;
          if (li >= S) mbar_wait(&empty[s], (li / S - 1) & 1);
          mbar_expect_tx(&full[s], SB_BOX);
          ++li;
          tma_load_2d(ring + (size_t)s * SB_BOX, &kmap, 64 * d, krow + kt * SB_KEYS, &full[s]);
        }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, qw = warp & 3;
  int li = 0, rel = 0;
  auto take = [&]() {
    const int s = li % S;
    mbar_wait(&full[s], (li / S) & 1);
    ++li;
    return ring + (size_t)s * SB_BOX;
  };
  auto release_upto = [&](int m) {
    for (; rel < m; ++rel)
      if (lane == 0 && qw == 0) mbar_arrive(&empty[rel % S]);
  };

  const float temp = *a.temp, fv = a.fvalid != nullptr ? a.fvalid[n] : 1.f;
  const float rwq = 1.0f / (float)wq;
  // this thread's two rows: block row lr, query qi at (qy, qx) on the grid
  int lr[2], qi[2], qy[2], qx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = 64 * wg + 16 * qw + g + 8 * h;
    qi[h] = r0 + lr[h];
    qy[h] = qi[h] / wq;
    qx[h] = qi[h] - qy[h] * wq;
  }
  const int reach = NL * wq + NL;  // a row's window lies within qi +- reach
  float tv[2][SB_KTOP];
  int ti[2][SB_KTOP];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < SB_KTOP; ++m) { tv[h][m] = -INFINITY; ti[h][m] = INT_MAX; }

  // the rows of this warp in the output: 16 from block row 64 wg + 16 qw
  T* out = static_cast<T*>(a.out) + ((size_t)(b * a.NF + n) * HW + r0) * HW;
  const int wrow0 = 64 * wg + 16 * qw;
  const bool wide = HW % 8 == 0;  // every row starts on a 16-byte boundary

  const unsigned char* qa = qs + wg * 64 * 128;  // this warpgroup's 64 rows of each box
  // a warpgroup past the last query only takes and hands back the stages;
  // a quad past it skips its rows' work (the quad's own shuffles)
  const bool wg_rows = r0 + 64 * wg < HW;
  const unsigned qmask = 0xfu << (lane & ~3);
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) live[h] = qi[h] < HW;
  mbar_wait(qbar, 0);
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int d = 0; d < ND; ++d) {
      const unsigned char* bs = take();
      if (wg_rows) {
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss128_kk(acc, kmajor_desc(qa + (size_t)d * SB_BOX + 32 * k),
                         kmajor_desc(bs + 32 * k));
        wgmma_commit();
        wgmma_wait<1>();
      }
      release_upto(li - 1);
    }
    wgmma_wait<0>();
    pin(acc);
    release_upto(li);

    // the epilogue: element i of acc is row g + 8 ((i >> 1) & 1) of the
    // warp's 16, column 8 (i >> 2) + 2 t + (i & 1) of the tile. acc becomes
    // the unrounded scaled score x; a rounded score above th has x > th
    const int j0 = kt * SB_KEYS;
    float xm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < SB_KEYS / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = j0 + 8 * jj + 2 * t + e < HW;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = acc[4 * jj + 2 * h + e];
          x *= temp;
          xm[h] = fmaxf(xm[h], valid ? x : -INFINITY);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the row's fifth value is at least the best of the quad's fifth
      // values, and every key before this tile precedes the tile's: a key of
      // the tile at or below th is never among the row's five
      if (!live[h]) continue;  // quad-uniform
      float th = tv[h][SB_KTOP - 1];
      th = fmaxf(th, __shfl_xor_sync(qmask, th, 1));
      th = fmaxf(th, __shfl_xor_sync(qmask, th, 2));
      if (!(xm[h] > th)) continue;
      // the keys above th of each run of SB_CAND of the thread's columns, as
      // (bf16 score, column) into its buffer in column order, then
      // inserted: the insertion's code runs as often as the most keys a lane
      // of the warp has, not once a key
#pragma unroll
      for (int r8 = 0; r8 < SB_KEYS / 4 / SB_CAND; ++r8) {
        int n = 0;
#pragma unroll
        for (int jj = r8 * SB_CAND / 2; jj < (r8 + 1) * SB_CAND / 2; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jj + 2 * t + e;
            const float x = acc[4 * jj + 2 * h + e];
            if (j0 + c >= HW || !(x > th)) continue;
            cand[n * NT + tid] =
                ((uint32_t)__bfloat16_as_ushort(from_f<T>(x)) << 16) | (uint32_t)c;
            ++n;
          }
        sb_insert(tv[h], ti[h], cand, n, j0);
      }
    }
    // the scores in a row's local window, into its slots: only the keys
    // within qi +- reach can be there
    bool near[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      near[h] = live[h] && j0 <= qi[h] + reach && j0 + SB_KEYS > qi[h] - reach;
    if (near[0] || near[1]) {
#pragma unroll
      for (int jj = 0; jj < SB_KEYS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * jj + 2 * t + e;
          bool band[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            band[h] = j < HW && (unsigned)(j - qi[h] + reach) <= (unsigned)(2 * reach);
          if (!band[0] && !band[1]) continue;
          const int ky = sb_key_row(j, rwq), kx = j - ky * wq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dy = ky - qy[h], dx = kx - qx[h];
            if (band[h] && abs(dy) + abs(dx) <= NL)
              slots[lr[h] * SB_SLOTS + (dy + SB_NL) * SB_SIDE + dx + SB_NL] =
                  from_f<T>(acc[4 * jj + 2 * h + e]);
          }
        }
    }
    // zeros over this tile's columns of the warp's 16 rows
    const int cols = min(SB_KEYS, HW - j0);
    if (wide) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = lane + 32 * i, row = c >> 4, c8 = (c & 15) * 8;
        if (r0 + wrow0 + row < HW && c8 < cols)
          *reinterpret_cast<uint4*>(out + (size_t)(wrow0 + row) * HW + j0 + c8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int c = lane; c < 16 * SB_KEYS; c += 32) {
        const int row = c / SB_KEYS, cc = c % SB_KEYS;
        if (r0 + wrow0 + row < HW && cc < cols)
          out[(size_t)(wrow0 + row) * HW + j0 + cc] = from_f<T>(0.f);
      }
    }
  }
  __syncwarp();  // the window slots and the zeros of the warp's rows

  // k_top rounds over each quad for both its rows: the best head, first
  // occurrence on ties; every lane of the quad ends with the chosen keys
  const int k_top = min(min(a.k_top, SB_KTOP), HW);
  float cv[2][SB_KTOP];
  int ci[2][SB_KTOP];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r) {
      ci[h][r] = -1;
      cv[h][r] = 0.f;
      if (live[h] && r < k_top) {
        float bv = tv[h][0];
        int bi = ti[h][0];
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          const float ov = __shfl_xor_sync(qmask, bv, m);
          const int oi = __shfl_xor_sync(qmask, bi, m);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        cv[h][r] = bv;
        ci[h][r] = bi;
        if (ti[h][0] == bi) {  // the winner's lane drops its head
#pragma unroll
          for (int m = 0; m < SB_KTOP - 1; ++m) { tv[h][m] = tv[h][m + 1]; ti[h][m] = ti[h][m + 1]; }
          tv[h][SB_KTOP - 1] = -INFINITY;
          ti[h][SB_KTOP - 1] = INT_MAX;
        }
      }
    }

  // a chosen key in the window counts twice: its slot becomes 2 s (exact in
  // bf16), written by one lane of the quad
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r) {
      const int j = ci[h][r];
      if ((r & 3) != t || j < 0 || j >= HW) continue;
      const int ky = sb_key_row(j, rwq), dy = ky - qy[h], dx = j - ky * wq - qx[h];
      if (abs(dy) + abs(dx) <= NL)
        slots[lr[h] * SB_SLOTS + (dy + SB_NL) * SB_SIDE + dx + SB_NL] = from_f<T>(2.f * cv[h][r]);
    }
  __syncwarp();

  // The softmax of each of the thread's two rows: thread t of the quad
  // takes the entries j = t (mod 4), the window's keys (at most three of
  // each grid row qy + dy, a segment of at most 9) and the chosen keys
  // outside the window, and keeps the eight lane sums of sparse_softmax_row
  // that are its (lane t + 4 u takes j = t + 4 u mod 32) in ascending j.
  constexpr int NWK = SB_SIDE * 3;  // the thread's window keys of a row, at most
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int row = h ? lr[1] : lr[0], qrow = r0 + row;
    if (qrow >= HW) continue;  // quad-uniform
    const int ry = h ? qy[1] : qy[0], rx = h ? qx[1] : qx[0];
    int cj[SB_KTOP];
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r) cj[r] = h ? ci[1][r] : ci[0][r];
    // the chosen keys outside the window that are this thread's, in
    // ascending j (none: INT_MAX); comb there is s
    int xj[SB_KTOP];
    float xc[SB_KTOP];
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r) {
      const int j = cj[r];
      const float v = h ? cv[1][r] : cv[0][r];
      bool ext = j >= 0 && j < HW && (j & 3) == t;
      if (ext) {
        const int ky = sb_key_row(j, rwq);
        ext = abs(ky - ry) + abs(j - ky * wq - rx) > NL;
      }
      xj[r] = ext ? j : INT_MAX;
      xc[r] = v * 1.f + v * 0.f;
    }
#pragma unroll
    for (int i = 0; i < SB_KTOP - 1; ++i)
#pragma unroll
      for (int m = 0; m + 1 < SB_KTOP - i; ++m)
        if (xj[m] > xj[m + 1]) {
          const int j_ = xj[m]; xj[m] = xj[m + 1]; xj[m + 1] = j_;
          const float c_ = xc[m]; xc[m] = xc[m + 1]; xc[m + 1] = c_;
        }
    // the window's keys that are this thread's, in ascending j (none: -1),
    // and their comb
    int wj[NWK];
    float wc[NWK];
#pragma unroll
    for (int i = 0; i < SB_SIDE; ++i) {
      const int dy = i - SB_NL, ky = ry + dy, rad = NL - abs(dy);
      const int lo = max(rx - rad, 0), hi = min(rx + rad, wq - 1), base = ky * wq;
      const int kx0 = lo + ((t - base - lo) & 3);
      const bool grid_row = rad >= 0 && ky >= 0 && ky < hq;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int kx = kx0 + 4 * m, j = base + kx;
        const bool on = grid_row && kx <= hi;
        wj[3 * i + m] = on ? j : -1;
        // comb: s, or 2 s for a chosen key (its slot holds that)
        wc[3 * i + m] = on ? to_f(slots[row * SB_SLOTS + i * SB_SIDE + kx - rx + SB_NL]) : 0.f;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NWK; ++i)
      if (wc[i] != 0.f) mx = fmaxf(mx, wc[i]);
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r)
      if (xj[r] != INT_MAX && xc[r] != 0.f) mx = fmaxf(mx, xc[r]);
    mx = fmaxf(mx, __shfl_xor_sync(qmask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(qmask, mx, 2));
    if (!(mx > -INFINITY)) mx = 0.f;  // a row with nothing left: zeros, not NaN
    // the lane sums: the chosen keys merged in front of each window key (yj:
    // those not yet added, shifted as they go)
    float ls[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) ls[u] = 0.f;
    auto add = [&](int j, float ex) {
      const int u = (j >> 2) & 7;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        if (w == u) ls[w] += ex;
    };
    int yj[SB_KTOP];
    float yc[SB_KTOP];
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r) { yj[r] = xj[r]; yc[r] = xc[r]; }
    auto add_chosen_below = [&](int bound) {
      while (yj[0] < bound) {
        if (yc[0] != 0.f) add(yj[0], expf(yc[0] - mx));
#pragma unroll
        for (int m = 0; m < SB_KTOP - 1; ++m) { yj[m] = yj[m + 1]; yc[m] = yc[m + 1]; }
        yj[SB_KTOP - 1] = INT_MAX;
      }
    };
    // each window key's exponential, kept for its store (wc: 0 elsewhere)
#pragma unroll
    for (int i = 0; i < NWK; ++i) {
      if (wj[i] < 0) continue;
      add_chosen_below(wj[i]);
      if (wc[i] != 0.f) {
        wc[i] = expf(wc[i] - mx);
        add(wj[i], wc[i]);
      }
    }
    add_chosen_below(INT_MAX);
    // warp_sum's steps 16, 8, 4 over those lanes, then 2 and 1 in the quad
#pragma unroll
    for (int u = 0; u < 4; ++u) ls[u] += ls[u + 4];
#pragma unroll
    for (int u = 0; u < 2; ++u) ls[u] += ls[u + 2];
    float sum = ls[0] + ls[1];
    sum += __shfl_xor_sync(qmask, sum, 2);
    sum += __shfl_xor_sync(qmask, sum, 1);
    sum = fmaxf(sum, FLT_MIN);
    T* orow = out + (size_t)row * HW;
#pragma unroll
    for (int i = 0; i < NWK; ++i)
      if (wj[i] >= 0 && wc[i] != 0.f) orow[wj[i]] = from_f<T>(wc[i] / sum * fv);
#pragma unroll
    for (int r = 0; r < SB_KTOP; ++r)
      if (xj[r] != INT_MAX && xc[r] != 0.f) orow[xj[r]] = from_f<T>(expf(xc[r] - mx) / sum * fv);
  }
}

static int launch_sab_wg(const SabWgArgs& a, const void* q, const void* k, cudaStream_t stream) {
  CUtensorMap qmap, kmap;
  const uint64_t d = a.D, rows_q = (uint64_t)a.B * a.HW, rows_k = rows_q * a.NF;
  if (!encode_bf16<2>(&qmap, q, {d, rows_q}, {d * 2}, {64, SB_ROWS},
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16<2>(&kmap, k, {d, rows_k}, {d * 2}, {64, SB_KEYS},
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const size_t smem = sb_smem(a.D);
  cudaError_t err = cudaFuncSetAttribute(sab_wg_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.HW + SB_ROWS - 1) / SB_ROWS, a.NF, a.B);
  sab_wg_kernel<<<grid, dim3(SB_NT), smem, stream>>>(a, qmap, kmap);
  return (int)cudaGetLastError();
}

}  // namespace turtle

extern "C" size_t turtle_sab_wg_smem(int D) { return turtle::sb_smem(D); }

// ptrs: q (B, HW, D), k (B, NF, HW, D), temp (1 float), fvalid (NF floats or
// null), out (B, NF, HW, HW); ints: B, NF, HW, D, wq, k_top, n_local.
// Returns the CUDA error code (0 = launched), -1 for a call this body does
// not take, -2 when a tensor map is refused.
extern "C" int turtle_sab_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
  SabWgArgs a;
  a.temp = static_cast<const float*>(ptrs[2]);
  a.fvalid = static_cast<const float*>(ptrs[3]);
  a.out = ptrs[4];
  a.B = ints[0]; a.NF = ints[1]; a.HW = ints[2]; a.D = ints[3]; a.wq = ints[4];
  a.k_top = ints[5]; a.n_local = ints[6];
  if (!is_bf16 || a.D % 64 != 0 || a.D < 64 || a.D > 512 || a.wq < 1 || a.HW < 1 ||
      a.HW % a.wq != 0 || a.HW > (1 << 20) || a.k_top < 1 || a.k_top > SB_KTOP ||
      a.n_local < 0 || a.n_local > SB_NL || a.NF < 1 || a.NF > 65535 || a.B < 1 ||
      a.B > 65535 || (long long)a.B * a.NF * a.HW >= (1ll << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_sab_wg(a, ptrs[0], ptrs[1], s);
}
