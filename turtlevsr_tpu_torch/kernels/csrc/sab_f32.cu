// The float32 body of the StateAlignBlock's attention probabilities (row 7)
// for rows of any length: its shared memory is the same at every key count.
//
//   s    = (q . k^T) * temperature                    per cached frame
//   keep = the k_top largest entries of each row (ties: first occurrence)
//   comb = s * keep + s * local       local: L1 distance <= n_local between
//                                     query and key on the (hq, wq) grid
//   out  = softmax over the nonzero entries of comb, zero elsewhere,
//          times the frame's validity
//
// q (B, HW, D), k (B, NF, HW, D) as the ring stores it, out (B, NF, HW, HW),
// all float32; D a multiple of 16, a local radius of at most 4.
// kernels/sab.py's _sab_plan sends the float32 calls here whose row buffer
// does not fit sab.cu's block (sab.cu keeps each query row's HW scores in
// shared memory: at the 8160 keys of a padded 1920x1080 frame eight float32
// rows need 295,680 bytes, more than a block has), and those whose grid has
// at least one block an SM, where this body measured faster (a padded 720p
// frame, 15 tiles of 320). Replaces sab_fused_attn_probs in
// turtlevsr_tpu/kernels/sab.py (_scores_kernel).
//
// Bound by operations at every width of the paths: 2 HW^2 D flop a frame
// in float32 FMA (no tensor cores: TF32 would keep ten bits of the
// mantissa) against HW^2 outputs written. The design:
//
//   * a block owns 64 query rows of one (batch, frame) and walks the
//     frame's keys in blocks of 128; each key block's scores come from
//     chunks of 16 d of q and k staged in shared memory (d-major, read as
//     float4: every thread computes a 4 x 8 tile of scores in registers,
//     fp32 FMA in ascending d, the order of sab.cu's float tile, so the
//     scores are sab.cu's bit for bit), the next chunk's loads in flight
//     in registers while the current one is multiplied;
//   * after the last chunk of a key block its 64 x 128 scores go to a shared
//     tile; the four threads of a row scan it, each over the keys j = t
//     (mod 4), keeping a running top-5 of (value, index) (a later equal
//     value never displaces an earlier one: first occurrence on ties),
//     storing the scores that fall in the row's local window into a table of
//     (2 * 4 + 1)^2 slots a row, indexed by (dy, dx), and the block writes
//     zeros over the key block's columns of its rows (16-byte stores when
//     HW is a multiple of 4);
//   * after the last key block the quad of a row merges its four lists
//     (value descending, index ascending) and takes the softmax over the
//     union of the chosen and the window (an entry in both counts 2 s): at
//     most k_top + 41 values, written over the zeros. The finishing step is
//     sab_wg.cu's: thread t of the quad keeps the eight lane sums of
//     sparse_softmax_row (sab.cu) that are its own and adds them in that
//     function's tree order, so the output is sab.cu's bit for bit.
//
// Shared memory: the q and key chunks, the score tile and the window slots,
// 67,328 bytes whatever HW (sf_smem); two blocks an SM.
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace turtle {

constexpr int SF_ROWS = 64;             // query rows of a block
constexpr int SF_KEYS = 128;            // keys of a key block
constexpr int SF_DC = 16;               // d of a chunk
constexpr int SF_QS = SF_ROWS + 4;      // row stride (floats) of the d-major q chunk
constexpr int SF_KS = SF_KEYS + 4;      // of the d-major key chunk
constexpr int SF_SS = SF_KEYS + 4;      // of the score tile
constexpr int SF_NL = 4;                // the largest local radius this body takes
constexpr int SF_SIDE = 2 * SF_NL + 1;  // the window's slots a row: SF_SIDE^2
constexpr int SF_SLOTS = SF_SIDE * SF_SIDE;
constexpr int SF_KTOP = 5;
constexpr int SF_MAX_KEYS = 1 << 24;    // 64 rows of HW floats stay int offsets

struct SabF32Args {
  const float *q, *k, *temp, *fvalid;  // device: one temperature, NF validities (or null)
  float* out;
  int B, NF, HW, D, wq, k_top, n_local;
};

__host__ __device__ inline size_t sf_smem() {
  return (size_t)(SF_DC * SF_QS + SF_DC * SF_KS + SF_ROWS * SF_SS + SF_ROWS * SF_SLOTS) * 4;
}

__global__ void __launch_bounds__(NT, 2) sab_f32_kernel(const SabF32Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [SF_DC][SF_QS]
  float* ks = qs + SF_DC * SF_QS;                  // [SF_DC][SF_KS]
  float* sc = ks + SF_DC * SF_KS;                  // [SF_ROWS][SF_SS]
  float* slots = sc + SF_ROWS * SF_SS;             // [SF_ROWS][SF_SLOTS]
  const int HW = a.HW, D = a.D, wq = a.wq, hq = HW / wq, NL = a.n_local;
  const int r0 = blockIdx.x * SF_ROWS, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;  // the score tile: keys 4 tx (+ 64), rows 4 ty
  const int n_kb = (HW + SF_KEYS - 1) / SF_KEYS, n_dc = D / SF_DC;
  const float* q = a.q + ((size_t)b * HW + r0) * D;
  const float* k = a.k + ((size_t)b * a.NF + n) * HW * D;

  for (int i = tid; i < SF_ROWS * SF_SLOTS; i += NT) slots[i] = 0.f;  // off the grid: zero

  // the chunk loads: a float4 of q (row tid / 4) and two of k (keys tid / 4
  // and 64 + tid / 4), d 4 (tid % 4) .. + 3 of the chunk; zeros past HW
  const int lrow = tid >> 2, ld4 = (tid & 3) * 4;
  float4 pq, pk[2];
  auto load = [&](int kb, int dc) {
    const int d0 = dc * SF_DC + ld4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    pq = r0 + lrow < HW ? *reinterpret_cast<const float4*>(q + (size_t)lrow * D + d0) : z;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int key = kb * SF_KEYS + lrow + 64 * p;
      pk[p] = key < HW ? *reinterpret_cast<const float4*>(k + (size_t)key * D + d0) : z;
    }
  };
  auto stage = [&]() {
    qs[(ld4 + 0) * SF_QS + lrow] = pq.x;
    qs[(ld4 + 1) * SF_QS + lrow] = pq.y;
    qs[(ld4 + 2) * SF_QS + lrow] = pq.z;
    qs[(ld4 + 3) * SF_QS + lrow] = pq.w;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = lrow + 64 * p;
      ks[(ld4 + 0) * SF_KS + c] = pk[p].x;
      ks[(ld4 + 1) * SF_KS + c] = pk[p].y;
      ks[(ld4 + 2) * SF_KS + c] = pk[p].z;
      ks[(ld4 + 3) * SF_KS + c] = pk[p].w;
    }
  };

  // the scan's row: block row tid / 4, keys j = t (mod 4) of each key block
  const int row = tid >> 2, t = tid & 3;
  const int qi = r0 + row, qy = qi / wq, qx = qi - qy * wq;
  const bool live = qi < HW;  // quad-uniform
  const int reach = NL * wq + NL;  // the row's window lies within qi +- reach
  const float temp = *a.temp;
  float tv[SF_KTOP];
  int ti[SF_KTOP];
#pragma unroll
  for (int m = 0; m < SF_KTOP; ++m) { tv[m] = -INFINITY; ti[m] = INT_MAX; }
  float* out = a.out + ((size_t)(b * a.NF + n) * HW + r0) * HW;
  const bool wide = HW % 4 == 0;  // every row starts on a 16-byte boundary

  load(0, 0);
#pragma unroll 1
  for (int kb = 0; kb < n_kb; ++kb) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // the chunk before is read by every thread
      stage();
      __syncthreads();
      if (dc + 1 < n_dc) load(kb, dc + 1);
      else if (kb + 1 < n_kb) load(kb + 1, 0);
#pragma unroll
      for (int d = 0; d < SF_DC; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + d * SF_QS + 4 * ty);
        const float4 k0 = *reinterpret_cast<const float4*>(ks + d * SF_KS + 4 * tx);
        const float4 k1 = *reinterpret_cast<const float4*>(ks + d * SF_KS + 64 + 4 * tx);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
        const float kr[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qr[i], kr[j], acc[i][j]);
      }
    }
    // the key block's scores into the tile (the scan of the block before is
    // done: every thread passed this block's chunk barriers since)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* srow = sc + (4 * ty + i) * SF_SS;
      *reinterpret_cast<float4*>(srow + 4 * tx) =
          make_float4(acc[i][0] * temp, acc[i][1] * temp, acc[i][2] * temp, acc[i][3] * temp);
      *reinterpret_cast<float4*>(srow + 64 + 4 * tx) =
          make_float4(acc[i][4] * temp, acc[i][5] * temp, acc[i][6] * temp, acc[i][7] * temp);
    }
    __syncthreads();

    const int j0 = kb * SF_KEYS, cols = min(SF_KEYS, HW - j0);
    if (live) {
      const float* srow = sc + row * SF_SS;
      for (int c = t; c < cols; c += 4) {
        const float v = srow[c];
        if (!(v > tv[SF_KTOP - 1])) continue;
        tv[SF_KTOP - 1] = v;
        ti[SF_KTOP - 1] = j0 + c;
#pragma unroll
        for (int m = SF_KTOP - 1; m > 0; --m)
          if (tv[m] > tv[m - 1]) {
            const float fv_ = tv[m]; tv[m] = tv[m - 1]; tv[m - 1] = fv_;
            const int iv_ = ti[m]; ti[m] = ti[m - 1]; ti[m - 1] = iv_;
          }
      }
      // the scores in the row's local window, into its slots: only the
      // keys within qi +- reach can be there
      if (j0 <= qi + reach && j0 + cols > qi - reach) {
        for (int c = t; c < cols; c += 4) {
          const int j = j0 + c;
          if (abs(j - qi) > reach) continue;
          const int ky = j / wq, dy = ky - qy, dx = j - ky * wq - qx;
          if (abs(dy) + abs(dx) <= NL)
            slots[row * SF_SLOTS + (dy + SF_NL) * SF_SIDE + dx + SF_NL] = srow[c];
        }
      }
    }
    // zeros over the key block's columns of the block's rows
    if (wide) {
      for (int i = tid; i < SF_ROWS * (SF_KEYS / 4); i += NT) {
        const int zr = i / (SF_KEYS / 4), c4 = (i % (SF_KEYS / 4)) * 4;
        if (r0 + zr < HW && c4 < cols)
          *reinterpret_cast<float4*>(out + (size_t)zr * HW + j0 + c4) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < SF_ROWS * SF_KEYS; i += NT) {
        const int zr = i / SF_KEYS, c = i % SF_KEYS;
        if (r0 + zr < HW && c < cols) out[(size_t)zr * HW + j0 + c] = 0.f;
      }
    }
  }
  __syncthreads();  // the window slots and the zeros of every row
  if (!live) return;  // quad-uniform; no barrier follows

  // k_top rounds over the quad: the best head, first occurrence on ties;
  // every lane of the quad ends with the chosen keys
  const unsigned qmask = 0xfu << (lane & ~3);
  const int k_top = min(min(a.k_top, SF_KTOP), HW);
  float cv[SF_KTOP];
  int ci[SF_KTOP];
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r) {
    ci[r] = -1;
    cv[r] = 0.f;
    if (r < k_top) {
      float bv = tv[0];
      int bi = ti[0];
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        const float ov = __shfl_xor_sync(qmask, bv, m);
        const int oi = __shfl_xor_sync(qmask, bi, m);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      cv[r] = bv;
      ci[r] = bi;
      if (ti[0] == bi) {  // the winner's lane drops its head
#pragma unroll
        for (int m = 0; m < SF_KTOP - 1; ++m) { tv[m] = tv[m + 1]; ti[m] = ti[m + 1]; }
        tv[SF_KTOP - 1] = -INFINITY;
        ti[SF_KTOP - 1] = INT_MAX;
      }
    }
  }

  // a chosen key in the window counts twice: its slot becomes 2 s, written
  // by one lane of the quad
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r) {
    const int j = ci[r];
    if ((r & 3) != t || j < 0 || j >= HW) continue;
    const int ky = j / wq, dy = ky - qy, dx = j - ky * wq - qx;
    if (abs(dy) + abs(dx) <= NL)
      slots[row * SF_SLOTS + (dy + SF_NL) * SF_SIDE + dx + SF_NL] = 2.f * cv[r];
  }
  __syncwarp(qmask);

  // the softmax of the row: thread t takes the entries j = t (mod 4), the
  // window's keys (at most three of each grid row qy + dy, a segment of at
  // most 9) and the chosen keys outside the window, and keeps the eight
  // lane sums of sparse_softmax_row that are its (lane t + 4 u takes
  // j = t + 4 u mod 32) in ascending j
  constexpr int NWK = SF_SIDE * 3;  // the thread's window keys, at most
  int xj[SF_KTOP];  // the chosen keys outside the window that are this
  float xc[SF_KTOP];  // thread's, in ascending j (none: INT_MAX); comb: s
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r) {
    const int j = ci[r];
    bool ext = j >= 0 && j < HW && (j & 3) == t;
    if (ext) {
      const int ky = j / wq;
      ext = abs(ky - qy) + abs(j - ky * wq - qx) > NL;
    }
    xj[r] = ext ? j : INT_MAX;
    xc[r] = cv[r] * 1.f + cv[r] * 0.f;
  }
#pragma unroll
  for (int i = 0; i < SF_KTOP - 1; ++i)
#pragma unroll
    for (int m = 0; m + 1 < SF_KTOP - i; ++m)
      if (xj[m] > xj[m + 1]) {
        const int j_ = xj[m]; xj[m] = xj[m + 1]; xj[m + 1] = j_;
        const float c_ = xc[m]; xc[m] = xc[m + 1]; xc[m + 1] = c_;
      }
  // the window's keys that are this thread's, in ascending j (none: -1),
  // and their comb (s, or 2 s for a chosen key: its slot holds that)
  int wj[NWK];
  float wc[NWK];
#pragma unroll
  for (int i = 0; i < SF_SIDE; ++i) {
    const int dy = i - SF_NL, ky = qy + dy, rad = NL - abs(dy);
    const int lo = max(qx - rad, 0), hi = min(qx + rad, wq - 1), base = ky * wq;
    const int kx0 = lo + ((t - base - lo) & 3);
    const bool grid_row = rad >= 0 && ky >= 0 && ky < hq;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int kx = kx0 + 4 * m, j = base + kx;
      const bool on = grid_row && kx <= hi;
      wj[3 * i + m] = on ? j : -1;
      wc[3 * i + m] = on ? slots[row * SF_SLOTS + i * SF_SIDE + kx - qx + SF_NL] : 0.f;
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < NWK; ++i)
    if (wc[i] != 0.f) mx = fmaxf(mx, wc[i]);
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r)
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
  int yj[SF_KTOP];
  float yc[SF_KTOP];
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r) { yj[r] = xj[r]; yc[r] = xc[r]; }
  auto add_chosen_below = [&](int bound) {
    while (yj[0] < bound) {
      if (yc[0] != 0.f) add(yj[0], expf(yc[0] - mx));
#pragma unroll
      for (int m = 0; m < SF_KTOP - 1; ++m) { yj[m] = yj[m + 1]; yc[m] = yc[m + 1]; }
      yj[SF_KTOP - 1] = INT_MAX;
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
  const float fv = a.fvalid != nullptr ? a.fvalid[n] : 1.f;
  float* orow = out + (size_t)row * HW;
#pragma unroll
  for (int i = 0; i < NWK; ++i)
    if (wj[i] >= 0 && wc[i] != 0.f) orow[wj[i]] = wc[i] / sum * fv;
#pragma unroll
  for (int r = 0; r < SF_KTOP; ++r)
    if (xj[r] != INT_MAX && xc[r] != 0.f) orow[xj[r]] = expf(xc[r] - mx) / sum * fv;
}

}  // namespace turtle

extern "C" size_t turtle_sab_f32_smem() { return turtle::sf_smem(); }

// ptrs: q (B, HW, D), k (B, NF, HW, D), temp (1 float), fvalid (NF floats or
// null), out (B, NF, HW, HW), all float32; ints: B, NF, HW, D, wq, k_top,
// n_local. Returns the CUDA error code (0 = launched), -1 for a call this
// body does not take.
extern "C" int turtle_sab_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                     void* stream) {
  using namespace turtle;
  SabF32Args a;
  a.q = static_cast<const float*>(ptrs[0]);
  a.k = static_cast<const float*>(ptrs[1]);
  a.temp = static_cast<const float*>(ptrs[2]);
  a.fvalid = static_cast<const float*>(ptrs[3]);
  a.out = static_cast<float*>(ptrs[4]);
  a.B = ints[0]; a.NF = ints[1]; a.HW = ints[2]; a.D = ints[3]; a.wq = ints[4];
  a.k_top = ints[5]; a.n_local = ints[6];
  if (is_bf16 || a.D % SF_DC != 0 || a.D < SF_DC || a.wq < 1 || a.HW < 1 ||
      a.HW % a.wq != 0 || a.HW > SF_MAX_KEYS || a.k_top < 1 || a.k_top > SF_KTOP ||
      a.n_local < 0 || a.n_local > SF_NL || a.NF < 1 || a.NF > 65535 || a.B < 1 ||
      a.B > 65535)
    return -1;
  const size_t smem = sf_smem();
  cudaError_t err = cudaFuncSetAttribute(sab_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.HW + SF_ROWS - 1) / SF_ROWS, a.NF, a.B);
  sab_f32_kernel<<<grid, dim3(NT), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
