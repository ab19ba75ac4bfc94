// Copies into shared memory that run behind the arithmetic (cp.async rings)
// and warp-tile fragments read from shared memory with ldmatrix: the device
// helpers of the 3x3 conv (conv3x3.cu) and of attention @ values
// (attn_v.cu). Fragment layouts are those of common.cuh (mma.sync
// m16n8k16); the float versions read the same fragments element by element
// (float is the type of the tight on-card comparisons, not of serving).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace turtle {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// p moved up to the next multiple of A bytes of the shared window (the
// swizzled layouts repeat every 1024 bytes and must start on such a boundary)
template <int A> __device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((A - (smem_u32(p) & (A - 1))) & (A - 1));
}

// 16 bytes from global to shared memory, behind the issuing thread's back;
// completion is awaited with cp_async_wait after cp_async_commit
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// A fragment (16 rows x 16 k) of a row-major tile. bf16: one ldmatrix.x4,
// for which lane l passes the address of row (l & 15) at k + 8 (l >> 4):
// matrices 0-3 are (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
// 8-15), the registers r[0..3] of AFrag. `mine` is that address, so the
// caller computes one address per lane whatever the rows' spacing.
__device__ __forceinline__ void ldsm_a(AFrag<__nv_bfloat16>& a, const __nv_bfloat16* mine) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(smem_u32(mine))
               : "memory");
}

// Two adjacent 8-column B tiles (16 k x 8 n each) of a row-major [k][n]
// tile of row stride ld: ldmatrix.x4.trans hands lane 4 g + t the elements
// [k = 2t, 2t + 1][n = g] of each 8x8 matrix, the B fragment of mma.sync.
// Lanes 0-7 address rows k0.. of columns n0.., 8-15 rows k0 + 8.., 16-31 the
// same for columns n0 + 8.
__device__ __forceinline__ void ldsm_b_pair(BFrag<__nv_bfloat16>& b0, BFrag<__nv_bfloat16>& b1,
                                            const __nv_bfloat16* tile, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_b_pair(BFrag<float>& b0, BFrag<float>& b1, const float* tile,
                                            int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = tile + (k0 + 2 * t + (i & 1) + 8 * (i >> 1)) * ld + n0 + g;
    b0.v[i] = row[0];
    b1.v[i] = row[8];
  }
}

// wgmma bookkeeping (sm_90a): a fence before products whose registers other
// instructions wrote, a commit closing a group of products, a wait until at
// most N groups are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators stay where the asynchronous products write them
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers in shared memory and the TMA copy that completes on them
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// the box at (c0, c1, ..) of a tensor map into shared memory (TMA), its
// bytes counted on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}


// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the library links no CUDA library but the runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a bf16 map of R dims (dims[0] innermost; strides in bytes of dims 1 ..),
// boxes of box[0 .. R), zeros outside the tensor
template <int R>
static bool encode_bf16(CUtensorMap* m, const void* base, const uint64_t (&dims)[R],
                        const uint64_t (&strides)[R - 1], const uint32_t (&box)[R],
                        CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[R], st[R - 1];
  cuuint32_t b[R], e[R];
  for (int i = 0; i < R; ++i) { d[i] = dims[i]; b[i] = box[i]; e[i] = 1; }
  for (int i = 0; i + 1 < R; ++i) st[i] = strides[i];
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), d, st, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace turtle
