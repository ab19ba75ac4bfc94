// Attention probabilities of the StateAlignBlock (t1), two kernels that share
// one row body (sparse_softmax_row):
//
//   s    = round_to_T((q . k^T) * temperature)        per cached frame
//   keep = the k_top largest entries of each row (ties: first occurrence)
//   comb = s * keep + s * local       local: L1 distance <= n_local between
//                                     query and key on the (hq, wq) grid
//   out  = softmax over the nonzero entries of comb, zero elsewhere,
//          times the frame's validity
//
// sab_probs_kernel (row 7): q (B, HW, D), k (B, NF, HW, D) as the ring
// stores it, out (B, NF, HW, HW). Replaces sab_fused_attn_probs in
// turtlevsr_tpu/kernels/sab.py (_scores_kernel). On an H100 the work is
// bound by operations at D = 512 and 256 (2*HW*HW*D flop per frame against
// HW*HW written) and by bytes at D = 128. One block owns R = 16 (or 8) query
// rows and all HW keys of one (batch, frame): the scores run as mma.sync
// warp tiles (A = the q rows in shared memory, B = key rows read from device
// memory, 16 bytes a lane: the k axis is walked in a permuted order that
// both operands share), are rounded to T and kept as a row buffer in shared
// memory, so the score tensor never exists in device memory. The local mask
// comes from the indices.
//
// sparse_softmax_kernel (row 12): the same rows on given scores (BN, Q, K)
// and a given (Q, K) mask, no temperature, no validity. Replaces
// sab_sparse_softmax in turtlevsr_tpu/kernels/sab.py (_kernel). Bound by
// bytes (scores and mask read once, the probabilities written once): the
// rows are staged through shared memory and read from there four times.
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace turtle {

constexpr int KTOP_MAX = 5;
constexpr int QROWS = 16;  // rows of the q tile (one mma A tile)

struct SabArgs {
  const void *q, *k;
  const float *temp, *fvalid;  // device: one temperature, NF validities (or null)
  void* out;
  int B, NF, HW, D, wq, k_top, n_local, R, SS;
};

// d += A(16 x D) . key^T for the 8 keys of this lane group; alo, ahi: rows g
// and g + 8 of the q tile (shared), kr: this lane's key row (null: zeros)
__device__ __forceinline__ void sab_dot(float (&d)[4], const __nv_bfloat16* alo,
                                        const __nv_bfloat16* ahi,
                                        const __nv_bfloat16* __restrict__ kr, int D) {
  const int t = threadIdx.x & 3;
  int k0 = 0;
  // 32 k at a time: lane t takes k0 + 8 t .. + 7 of both operands in one
  // 16-byte load and feeds two MMAs (k in a permuted order, the same for A
  // and B, which leaves the dot product unchanged)
  for (; k0 + 32 <= D; k0 += 32) {
    const uint4 va = *reinterpret_cast<const uint4*>(alo + k0 + 8 * t);
    const uint4 vb = *reinterpret_cast<const uint4*>(ahi + k0 + 8 * t);
    uint4 vk = {0u, 0u, 0u, 0u};
    if (kr != nullptr) vk = *reinterpret_cast<const uint4*>(kr + k0 + 8 * t);
    AFrag<__nv_bfloat16> a1, a2;
    BFrag<__nv_bfloat16> b1, b2;
    a1.r[0] = va.x; a1.r[1] = vb.x; a1.r[2] = va.y; a1.r[3] = vb.y;
    b1.r[0] = vk.x; b1.r[1] = vk.y;
    a2.r[0] = va.z; a2.r[1] = vb.z; a2.r[2] = va.w; a2.r[3] = vb.w;
    b2.r[0] = vk.z; b2.r[1] = vk.w;
    tile_mma(d, a1, b1);
    tile_mma(d, a2, b2);
  }
  if (k0 < D) {  // D = 16 (mod 32): one step in the plain order
    AFrag<__nv_bfloat16> af;
    BFrag<__nv_bfloat16> bf;
    load_a(af, alo, ahi, k0);
    bf.r[0] = kr ? *reinterpret_cast<const uint32_t*>(kr + k0 + 2 * t) : 0u;
    bf.r[1] = kr ? *reinterpret_cast<const uint32_t*>(kr + k0 + 2 * t + 8) : 0u;
    tile_mma(d, af, bf);
  }
}
__device__ __forceinline__ void sab_dot(float (&d)[4], const float* alo, const float* ahi,
                                        const float* __restrict__ kr, int D) {
  const int t = threadIdx.x & 3;
  for (int k0 = 0; k0 < D; k0 += 16) {
    AFrag<float> af;
    BFrag<float> bf;
    load_a(af, alo, ahi, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bf.v[i] = kr ? kr[k0 + 2 * t + (i & 1) + 8 * (i >> 1)] : 0.f;
    tile_mma(d, af, bf);
  }
}

// The sparse softmax of one row of nk scores s (shared memory) by one warp:
// keep = the k_top largest (ties: first occurrence; fewer keys: all of them),
// comb = s * keep + s * local, out = softmax over the nonzero entries of comb,
// zero elsewhere (a row with nothing left gives zeros), times fv. local: the
// given mask row (GIVEN_MASK, global memory) or L1 distance <= n_local of key
// j from the query (qy, qx) on the grid of width wq. One scan keeps a sorted
// top-k list per lane, k_top rounds of a warp reduction on (value, lowest
// index) merge them, three more scans give the maximum, the sum and the row.
template <class T, bool GIVEN_MASK>
__device__ __forceinline__ void sparse_softmax_row(const T* s, int nk, int k_top_req, int qy,
                                                   int qx, int wq, int n_local,
                                                   const T* __restrict__ mrow, float fv,
                                                   T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k_top = min(min(k_top_req, KTOP_MAX), nk);
  const float NEG = -INFINITY;
  float tv[KTOP_MAX];
  int ti[KTOP_MAX];
#pragma unroll
  for (int m = 0; m < KTOP_MAX; ++m) { tv[m] = NEG; ti[m] = INT_MAX; }
  for (int j = lane; j < nk; j += 32) {
    const float v = to_f(s[j]);
    if (v > tv[KTOP_MAX - 1]) {  // a later equal value never displaces an earlier one
      tv[KTOP_MAX - 1] = v; ti[KTOP_MAX - 1] = j;
#pragma unroll
      for (int m = KTOP_MAX - 1; m > 0; --m)
        if (tv[m] > tv[m - 1]) {
          const float fv_ = tv[m]; tv[m] = tv[m - 1]; tv[m - 1] = fv_;
          const int iv_ = ti[m]; ti[m] = ti[m - 1]; ti[m - 1] = iv_;
        }
    }
  }
  // k_top rounds: the best head over the warp, first occurrence on ties
  int chosen[KTOP_MAX];
#pragma unroll
  for (int r = 0; r < KTOP_MAX; ++r) {
    chosen[r] = -1;
    if (r < k_top) {
      float bv = tv[0];
      int bi = ti[0];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      chosen[r] = bi;
      if (ti[0] == bi) {  // the winner's lane drops its head
#pragma unroll
        for (int m = 0; m < KTOP_MAX - 1; ++m) { tv[m] = tv[m + 1]; ti[m] = ti[m + 1]; }
        tv[KTOP_MAX - 1] = NEG; ti[KTOP_MAX - 1] = INT_MAX;
      }
    }
  }
  // comb of column j at grid position (jy, jx)
  auto comb_at = [&](int j, int jy, int jx) -> float {
    const float v = to_f(s[j]);
    float keep = 0.f;
#pragma unroll
    for (int r = 0; r < KTOP_MAX; ++r) keep += (j == chosen[r]) ? 1.f : 0.f;
    float local;
    if constexpr (GIVEN_MASK) local = to_f(mrow[j]);
    else local = (abs(jy - qy) + abs(jx - qx) <= n_local) ? 1.f : 0.f;
    return v * keep + v * local;
  };
  // lane's first key on the grid, and the step of 32 keys along it
  int jy0 = 0, jx0 = 0;
  if constexpr (!GIVEN_MASK) { jy0 = lane / wq; jx0 = lane - jy0 * wq; }
  auto advance = [&](int& jy, int& jx) {
    if constexpr (!GIVEN_MASK) {
      jx += 32;
      while (jx >= wq) { jx -= wq; ++jy; }
    }
  };
  float mx = NEG;
  for (int j = lane, jy = jy0, jx = jx0; j < nk; j += 32) {
    const float c = comb_at(j, jy, jx);
    if (c != 0.f) mx = fmaxf(mx, c);
    advance(jy, jx);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
  if (!(mx > NEG)) mx = 0.f;  // a row with nothing left: zeros, not NaN
  float sum = 0.f;
  for (int j = lane, jy = jy0, jx = jx0; j < nk; j += 32) {
    const float c = comb_at(j, jy, jx);
    if (c != 0.f) sum += expf(c - mx);
    advance(jy, jx);
  }
  sum = fmaxf(warp_sum(sum), FLT_MIN);
  for (int j = lane, jy = jy0, jx = jx0; j < nk; j += 32) {
    const float c = comb_at(j, jy, jx);
    out[j] = from_f<T>(c != 0.f ? expf(c - mx) / sum * fv : 0.f);
    advance(jy, jx);
  }
}

template <class T>
__global__ void __launch_bounds__(NT) sab_probs_kernel(SabArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = a.HW, D = a.D, R = a.R, SS = a.SS, wq = a.wq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * R, n = blockIdx.y, b = blockIdx.z;
  const int QS = D + XPAD;
  T* qs = reinterpret_cast<T*>(smem);  // T[QROWS][QS], zero rows past R or HW
  T* sb = qs + QROWS * QS;             // T[R][SS]: the rounded scores
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * HW + r0) * D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.NF + n) * HW * D;

  const int d8n = D / 8;
  for (int idx = tid; idx < QROWS * d8n; idx += NT) {
    const int row = idx / d8n, c8 = (idx - row * d8n) * 8;
    if (row < R && r0 + row < HW) copy8(qs + row * QS + c8, q + (size_t)row * D + c8);
    else zero8(qs + row * QS + c8);
  }
  __syncthreads();

  const float temp = *a.temp;
  const int n_tiles = (HW + 7) / 8;
  const T* alo = qs + g * QS;
  const T* ahi = qs + (g + 8) * QS;
  for (int nt = warp; nt < n_tiles; nt += NW) {
    const int key = nt * 8 + g;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    sab_dot(d, alo, ahi, key < HW ? k + (size_t)key * D : nullptr, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i >> 1), col = nt * 8 + 2 * t + (i & 1);
      if (row < R && col < HW) sb[row * SS + col] = from_f<T>(d[i] * temp);
    }
  }
  __syncthreads();

  const float fv = a.fvalid ? a.fvalid[n] : 1.f;
  for (int row = warp; row < R; row += NW) {
    const int qi = r0 + row;
    if (qi >= HW) break;  // warp-uniform
    T* out = static_cast<T*>(a.out) + (((size_t)b * a.NF + n) * HW + qi) * HW;
    sparse_softmax_row<T, false>(sb + row * SS, HW, a.k_top, qi / wq, qi % wq, wq, a.n_local,
                                 nullptr, fv, out);
  }
}

template <class T>
static int launch_sab(const SabArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = sab_probs_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.HW + a.R - 1) / a.R, a.NF, a.B);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Row 12: the same rows on given scores (BN, Q, K) and a given local mask
// (Q, K) of the scores' type. A block owns R rows of one entry: they are
// staged into shared memory in one coalesced pass, then each warp takes
// rows as sab_probs_kernel does.
struct SparseArgs {
  const void *scores, *mask;
  void* out;
  int BN, Q, K, k_top, R, SS;
};

template <class T>
__global__ void __launch_bounds__(NT) sparse_softmax_kernel(SparseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sb = reinterpret_cast<T*>(smem);  // T[R][SS]
  const int Q = a.Q, K = a.K, R = a.R, SS = a.SS;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * R, bn = blockIdx.y;
  const int rows = min(R, Q - r0);
  const T* src = static_cast<const T*>(a.scores) + ((size_t)bn * Q + r0) * K;
  for (int idx = threadIdx.x; idx < rows * K; idx += NT) {
    const int row = idx / K;
    sb[row * SS + idx - row * K] = src[idx];
  }
  __syncthreads();
  const T* mask = static_cast<const T*>(a.mask);
  for (int row = warp; row < rows; row += NW) {
    const int qi = r0 + row;
    T* out = static_cast<T*>(a.out) + ((size_t)bn * Q + qi) * K;
    sparse_softmax_row<T, true>(sb + row * SS, K, a.k_top, 0, 0, 1, 0, mask + (size_t)qi * K,
                                1.f, out);
  }
}

template <class T>
static int launch_sparse(const SparseArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = sparse_softmax_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Q + a.R - 1) / a.R, a.BN);
  kern<<<grid, dim3(NT), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// row stride of the score buffer: HW rounded up to 64, plus 8: the eight
// rows a warp tile writes at once then fall on different banks
static int sab_row_stride(int HW) { return (HW + 63) / 64 * 64 + 8; }

}  // namespace turtle

// shared memory of a block that owns R query rows
extern "C" size_t turtle_sab_smem(int HW, int D, int R, int is_bf16) {
  using namespace turtle;
  return ((size_t)QROWS * (D + XPAD) + (size_t)R * sab_row_stride(HW)) * (is_bf16 ? 2 : 4);
}

// ptrs: q (B, HW, D), k (B, NF, HW, D), temp (1 float), fvalid (NF floats or
// null), out (B, NF, HW, HW); ints: B, NF, HW, D, wq, k_top, n_local, R.
// Returns the CUDA error code (0 = launched), -1 for a shape not taken.
extern "C" int turtle_sab_launch(void* const* ptrs, const int* ints, int is_bf16,
                                 void* stream) {
  using namespace turtle;
  SabArgs a;
  a.q = ptrs[0]; a.k = ptrs[1]; a.temp = static_cast<const float*>(ptrs[2]);
  a.fvalid = static_cast<const float*>(ptrs[3]); a.out = ptrs[4];
  a.B = ints[0]; a.NF = ints[1]; a.HW = ints[2]; a.D = ints[3]; a.wq = ints[4];
  a.k_top = ints[5]; a.n_local = ints[6]; a.R = ints[7];
  a.SS = sab_row_stride(a.HW);
  if (a.D % 16 != 0 || a.D < 16 || (a.R != 8 && a.R != 16) || a.wq < 1 || a.HW < 1 ||
      a.k_top < 1 || a.k_top > KTOP_MAX || a.NF > 65535 || a.B > 65535)
    return -1;
  const size_t smem = turtle_sab_smem(a.HW, a.D, a.R, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sab<__nv_bfloat16>(a, smem, s) : launch_sab<float>(a, smem, s);
}

// shared memory of a row-12 block that owns R rows of K scores
extern "C" size_t turtle_sparse_softmax_smem(int K, int R, int is_bf16) {
  using namespace turtle;
  return (size_t)R * sab_row_stride(K) * (is_bf16 ? 2 : 4);
}

// ptrs: scores (BN, Q, K), mask (Q, K), out (BN, Q, K); ints: BN, Q, K,
// k_top, R. Returns the CUDA error code (0 = launched), -1 for a shape not
// taken.
extern "C" int turtle_sparse_softmax_launch(void* const* ptrs, const int* ints, int is_bf16,
                                            void* stream) {
  using namespace turtle;
  SparseArgs a;
  a.scores = ptrs[0]; a.mask = ptrs[1]; a.out = ptrs[2];
  a.BN = ints[0]; a.Q = ints[1]; a.K = ints[2]; a.k_top = ints[3]; a.R = ints[4];
  a.SS = sab_row_stride(a.K);
  if (a.BN < 1 || a.BN > 65535 || a.Q < 1 || a.K < 1 || a.R < 1 || a.R > 64 || a.k_top < 1 ||
      a.k_top > KTOP_MAX)
    return -1;
  const size_t smem = turtle_sparse_softmax_smem(a.K, a.R, is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sparse<__nv_bfloat16>(a, smem, s) : launch_sparse<float>(a, smem, s);
}
