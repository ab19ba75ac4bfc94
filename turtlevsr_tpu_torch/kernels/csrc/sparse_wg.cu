// The sparse softmax on given scores (row 12 of the port's kernel table) as
// one streaming pass, bf16:
//
//   keep = the k_top largest entries of each row (ties: first occurrence;
//          fewer keys: all of them)
//   comb = s * keep + s * mask            mask: the given (Q, K) local mask
//   out  = softmax over the nonzero entries of comb, zero elsewhere
//
// Replaces sab_sparse_softmax in turtlevsr_tpu/kernels/sab.py (_kernel) for
// bf16 scores whose rows are whole 16-byte pieces (K % 8 == 0) and fit the
// block's shared memory; kernels/sab.py's _sparse_plan sends them here and
// the rest (float32, other K) to sab.cu's sparse_softmax_kernel.
//
// The work is bound by bytes: each score row read once, each mask row read
// once, each output row written once. sab.cu's body staged a block's rows
// with 2-byte loads, evaluated the whole chain (the five top-k tests, the
// mask) at every key in each of its four walks, and read the mask from
// device memory once per entry. Here a block owns one query row and up to
// four entries of it, one a warp: the mask row comes in once (16-byte
// cp.async pieces) and serves the four; each warp's score row comes in the
// same way. A block holds about 10 K bytes, so that five share an SM (a
// block walking a range of rows with the next row in flight, three an SM,
// measured slower on an H100: PERF.md, row 12). Then a warp on its row:
//
//   A. in 16-byte pieces, each lane 8 consecutive keys: the lane's sorted
//      top-k list; the lists' merge gives the row's top k;
//   B. in 16-byte pieces: c = s * mask (s + s * mask at a kept key), the
//      largest nonzero c, and a bit a key, c != 0 (about 46 of 3680 keys
//      of a window row);
//   C. lane l over its keys l, l + 32, .. in order, as sab.cu's and row 7's
//      sums run: exp(c - max) at each set bit, summed (the bits read four
//      32-bit words at a time, c recomputed where a bit is set);
//   D. exp(c - max) / sum at the set bits, zero elsewhere, rounded, 16 bytes
//      a lane straight to the output.
//
// Only the sum's order fixes the bits; the top k and the maximum do not
// depend on which lane takes which key, and a bf16 product is exact in fp32
// (so s * 1 + s * mask is s + c whatever the compiler contracts). So the
// output is bit for bit sab.cu's, and row 7's on exact scores. The grid
// runs the query rows of one group of entries next to each other. (Folding
// B into A, and writing D as zeros and then the set bits in C's walk,
// measured slower on an H100: PERF.md, row 12.)
#include <cfloat>
#include <climits>

#include "pipe.cuh"

namespace turtle {

constexpr int SPW_WARPS = 4;               // entries a block, one a warp
constexpr int SPW_NT = 32 * SPW_WARPS;
constexpr int SPW_KTOP = 5;                // KTOP_MAX of sab.cu
constexpr size_t SPW_SMEM_MAX = 232448;

struct SpwArgs {
  const __nv_bfloat16 *scores, *mask;
  __nv_bfloat16* out;
  int BN, Q, K, k_top;
};

// bytes of a row of K bf16, and of its bits (32-bit words, four at a time
// so that the next warp's row starts on a 16-byte boundary)
__host__ __device__ inline size_t spw_row_bytes(int K) { return (size_t)K * 2; }
__host__ __device__ inline size_t spw_bit_bytes(int K) { return (size_t)(K + 127) / 128 * 16; }
// the mask row, then a warp's score row and bits
__host__ __device__ inline size_t spw_smem(int K) {
  return spw_row_bytes(K) + SPW_WARPS * (spw_row_bytes(K) + spw_bit_bytes(K));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&o)[8]) {
  o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xffff0000u);
  o[4] = __uint_as_float(v.z << 16); o[5] = __uint_as_float(v.z & 0xffff0000u);
  o[6] = __uint_as_float(v.w << 16); o[7] = __uint_as_float(v.w & 0xffff0000u);
}

// The sparse softmax of one row: s and m (shared memory) the scores and the
// mask, bits (shared memory) the row's nonzero bits, out the output row
// (device memory)
__device__ __forceinline__ void spw_row(const __nv_bfloat16* s, const __nv_bfloat16* m,
                                        uint32_t* bits, int nk, int k_top_req,
                                        __nv_bfloat16* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k_top = min(min(k_top_req, SPW_KTOP), nk);
  const int n8 = nk / 8, nw = (nk + 31) / 32;
  const float NEG = -INFINITY;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(bits);
  // A: the lane's top-k list over its keys in increasing order (a later
  // equal value never displaces an earlier one)
  float tv[SPW_KTOP];
  int ti[SPW_KTOP];
#pragma unroll
  for (int i = 0; i < SPW_KTOP; ++i) { tv[i] = NEG; ti[i] = INT_MAX; }
  for (int p = lane; p < n8; p += 32) {
    float v[8];
    unpack8(reinterpret_cast<const uint4*>(s)[p], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (v[e] > tv[SPW_KTOP - 1]) {
        tv[SPW_KTOP - 1] = v[e]; ti[SPW_KTOP - 1] = 8 * p + e;
#pragma unroll
        for (int i = SPW_KTOP - 1; i > 0; --i)
          if (tv[i] > tv[i - 1]) {
            const float fv_ = tv[i]; tv[i] = tv[i - 1]; tv[i - 1] = fv_;
            const int iv_ = ti[i]; ti[i] = ti[i - 1]; ti[i - 1] = iv_;
          }
      }
    }
  }
  // k_top rounds: the best head over the warp, first occurrence on ties;
  // every lane keeps the kept keys (-1: none)
  int kept[SPW_KTOP];
#pragma unroll
  for (int r = 0; r < SPW_KTOP; ++r) {
    kept[r] = -1;
    if (r < k_top) {
      float bv = tv[0];
      int bi = ti[0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      kept[r] = bi;
      if (ti[0] == bi) {  // the winner's lane drops its head
#pragma unroll
        for (int i = 0; i < SPW_KTOP - 1; ++i) { tv[i] = tv[i + 1]; ti[i] = ti[i + 1]; }
        tv[SPW_KTOP - 1] = NEG; ti[SPW_KTOP - 1] = INT_MAX;
      }
    }
  }
  auto is_kept = [&](int j) {
    bool k = false;
#pragma unroll
    for (int r = 0; r < SPW_KTOP; ++r) k |= j == kept[r];
    return k;
  };
  auto kept_in = [&](int p) {  // a kept key among keys 8 p .. 8 p + 7
    bool k = false;
#pragma unroll
    for (int r = 0; r < SPW_KTOP; ++r) k |= (kept[r] >> 3) == p;
    return k;
  };
  // c of key j (s * keep + s * mask with keep 1 at a kept key, 0 elsewhere)
  auto comb = [&](int j) {
    const float v = to_f(s[j]), w = to_f(m[j]);
    if (is_kept(j)) {
      const float keep = 1.f;
      return v * keep + v * w;
    }
    return v * w;
  };
  // B: the largest nonzero c and the row's bits
  float mx = NEG;
  for (int p = lane; p < n8; p += 32) {
    float v[8], w[8];
    unpack8(reinterpret_cast<const uint4*>(s)[p], v);
    unpack8(reinterpret_cast<const uint4*>(m)[p], w);
    float c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = v[e] * w[e];
    if (kept_in(p)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) c[e] = comb(8 * p + e);
    }
    uint32_t nz = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c[e] != 0.f) {
        mx = fmaxf(mx, c[e]);
        nz |= 1u << e;
      }
    bytes[p] = (unsigned char)nz;
  }
  for (int p = n8 + lane; p < nw * 4; p += 32) bytes[p] = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (!(mx > NEG)) mx = 0.f;  // a row with nothing left: zeros, not NaN
  __syncwarp();
  // C: lane l over keys l, l + 32, ..: the sum in sab.cu's order, the bits
  // four words at a time
  float sum = 0.f;
  for (int w4 = 0; w4 < nw; w4 += 4) {
    const uint4 b4 = *reinterpret_cast<const uint4*>(bits + w4);
    const uint32_t bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (w4 + e < nw && ((bw[e] >> lane) & 1u)) sum += expf(comb(32 * (w4 + e) + lane) - mx);
  }
  sum = fmaxf(warp_sum(sum), FLT_MIN);
  // D: the probabilities, 8 keys a lane
  for (int p = lane; p < n8; p += 32) {
    const uint32_t nz = bytes[p];
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
    if (nz != 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if ((nz >> e) & 1u) o[e] = expf(comb(8 * p + e) - mx) / sum * 1.f;
    }
    reinterpret_cast<uint4*>(out)[p] =
        make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]), pack_bf16x2(o[4], o[5]),
                   pack_bf16x2(o[6], o[7]));
  }
}

// grid (Q, entry groups): block (x, y) owns query row x of entries 4 y ..
// 4 y + 3, one a warp
__global__ void __launch_bounds__(SPW_NT) sparse_wg_kernel(const __grid_constant__ SpwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x, n = blockIdx.y * SPW_WARPS + warp;
  __nv_bfloat16* mrow = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* mine = smem + spw_row_bytes(K) + warp * (spw_row_bytes(K) + spw_bit_bytes(K));
  __nv_bfloat16* srow = reinterpret_cast<__nv_bfloat16*>(mine);
  uint32_t* bits = reinterpret_cast<uint32_t*>(mine + spw_row_bytes(K));
  const __nv_bfloat16* mg = a.mask + (size_t)qi * K;
  for (int i = threadIdx.x; i < K / 8; i += SPW_NT) cp_async16(mrow + 8 * i, mg + 8 * i);
  const size_t roff = ((size_t)n * a.Q + qi) * K;
  if (n < a.BN)
    for (int i = lane; i < K / 8; i += 32) cp_async16(srow + 8 * i, a.scores + roff + 8 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (n >= a.BN) return;  // warp-uniform, after the block's only barrier
  spw_row(srow, mrow, bits, K, a.k_top, a.out + roff);
}

}  // namespace turtle

extern "C" size_t turtle_sparse_wg_smem(int K) { return turtle::spw_smem(K); }

// ptrs: scores (BN, Q, K), mask (Q, K), out (BN, Q, K); ints: BN, Q, K,
// k_top. Returns the CUDA error code (0 = launched), -1 for a shape not
// taken.
extern "C" int turtle_sparse_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                       void* stream) {
  using namespace turtle;
  SpwArgs a;
  a.scores = static_cast<const __nv_bfloat16*>(ptrs[0]);
  a.mask = static_cast<const __nv_bfloat16*>(ptrs[1]);
  a.out = static_cast<__nv_bfloat16*>(ptrs[2]);
  a.BN = ints[0]; a.Q = ints[1]; a.K = ints[2]; a.k_top = ints[3];
  if (!is_bf16 || a.BN < 1 || a.Q < 1 || a.K < 8 || a.K % 8 != 0 ||
      a.k_top < 1 || a.k_top > SPW_KTOP || spw_smem(a.K) > SPW_SMEM_MAX)
    return -1;
  const long long row_blocks = a.Q;
  const long long groups = (a.BN + SPW_WARPS - 1) / SPW_WARPS;
  if (row_blocks > 0x7fffffffLL || groups > 65535) return -1;
  const size_t smem = spw_smem(a.K);
  cudaError_t err = cudaFuncSetAttribute(sparse_wg_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
// the largest shared-memory share of the SM, so that as many blocks as fit
  // run at once
  err = cudaFuncSetAttribute(sparse_wg_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  sparse_wg_kernel<<<dim3((unsigned)row_blocks, (unsigned)groups), dim3(SPW_NT), smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
