// The float32 body of attention @ values with the window layout folded into
// the store (rows 11 and 10): out[n] = a[n] @ v[n] for a (BN, HW, HW)
// probabilities and v (BN, HW, D) lattice-layout window values, D = S * c (S
// = ws^2 slots of c channels, feature order (p1, p2, c)), with csrc/attn_v.cu's
// two epilogues:
//
//   merge  out (BN, H, W, c): element (q = (i, j), d = (p1, p2, cc)) lands at
//          map position (p1 * hh + i, p2 * ww + j, cc); the token tensor never
//          exists
//   slots  out (BN, S, HW, c): out[n][s][q][cc] = (a @ v)[n][q][s * c + cc]
//
// Replaces sab_attn_v_merge (turtlevsr_tpu/kernels/sab.py:282, which reaches
// the pallas_call at :223 / :253) and sab_attn_v_slots for float32 maps;
// kernels/sab.py's _attn_v_plan sends it every float32 call (csrc/attn_v.cu's
// float tile, mma.sync fragments read element by element with the products
// by FMA, keeps none on the paths). In float32 the whole frame is bound by
// operations (2 HW^2 D flop against (HW^2 + 2 HW D) 4 bytes an entry: at
// dec3's 3680 keys 6.6 ms of FMA against 0.3 ms of bytes), so the product is
// f32_tile.cuh's hooked product with M = HW queries, N = D, K = HW keys,
// summed in ascending key order, dense (the zeros of the top-5 probabilities
// are multiplied as the JAX kernel and torch.matmul do). The values of entry
// n = b * NF + i are read where they lie, v[i] + b * v_bs[i], from up to
// AV_MAX_V = 5 ring views with their own batch strides: no stacked copy. A
// thread's four consecutive columns lie in one slot (c is a multiple of 8), so
// the result leaves in 16-byte pieces straight to its place in the map.
#include "f32_tile.cuh"

namespace turtle {

constexpr int AVF_MAX_V = 5;  // value tensors a launch (ring positions + 1)

struct AvF32Args {
  const float* a;                // entry n at a + n * HW * HW
  const float* v[AVF_MAX_V];     // entry n = b * NF + i at v[i] + b * v_bs[i]
  long long v_bs[AVF_MAX_V];
  float* out;
  int NF, HW, D, c, merge, ws, hh, ww, a_vec;
  int M, N, K;
};

struct AvP {
  using Args = AvF32Args;
  static constexpr unsigned KINDS = 1u << FP_WIDE;  // 128 x 128: D >= 128 on the paths
  struct Row {
    const float* p;  // query row q of entry n's probabilities, null for q >= HW
  };
  static __device__ __forceinline__ Row row(const Args& a, int n, int m) {
    return {m < a.M ? a.a + ((long long)n * a.HW + m) * a.HW : nullptr};
  }
  static __device__ __forceinline__ float4 load_a(const Args& a, int n, Row r, int k) {
    if (r.p == nullptr || k >= a.K) return zero4();
    if (a.a_vec && k + 3 < a.K) return ldg4(r.p + k);  // rows at 16-byte boundaries
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = k + i < a.K ? __ldg(r.p + k + i) : 0.f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
  static __device__ __forceinline__ const float* values(const Args& a, int n) {
    const int b = n / a.NF, i = n - b * a.NF;
    return a.v[i] + b * a.v_bs[i];
  }
  static __device__ __forceinline__ float4 load_b(const Args& a, int n, int k, int c) {
    if (k >= a.K || c >= a.N) return zero4();
    return ldg4(values(a, n) + (long long)k * a.D + c);
  }
  static __device__ __forceinline__ void store(const Args& a, int n, int m, int d, float4 v) {
    const int s = d / a.c, cc = d - s * a.c;
    long long off;
    if (a.merge) {
      const int p1 = s / a.ws, p2 = s - p1 * a.ws, i = m / a.ww, j = m - i * a.ww;
      off = (((long long)n * (a.ws * a.hh) + p1 * a.hh + i) * (a.ws * a.ww) + p2 * a.ww + j) *
                a.c + cc;
    } else {
      off = (((long long)n * (a.D / a.c) + s) * a.HW + m) * a.c + cc;
    }
    st4(a.out + off, v);
  }
};

}  // namespace turtle

// shared memory of a launch (the FP_WIDE tile); kernels/sab.py's
// _attn_v_f32_geometry mirrors it
extern "C" size_t turtle_attn_v_f32_smem() {
  using namespace turtle;
  return fp_smem(FP_WIDE);
}

// ptrs: a, out, v_0 .. v_4 (csrc/attn_v.cu's)
// ints: BN, NF, HW, D, c, merge, ws, hh, ww, a_bs (HW^2), v_bs_0 .. v_bs_4
//       (csrc/attn_v.cu's)
// Every tensor float32. Returns the CUDA error code of the launch (0 =
// launched), -1 for a call the body does not take.
extern "C" int turtle_attn_v_f32_launch(void* const* ptrs, const int* ints, int is_bf16,
                                        void* stream) {
  using namespace turtle;
  AvF32Args p{};
  p.a = static_cast<const float*>(ptrs[0]);
  p.out = static_cast<float*>(ptrs[1]);
  const int BN = ints[0];
  p.NF = ints[1]; p.HW = ints[2]; p.D = ints[3]; p.c = ints[4]; p.merge = ints[5];
  p.ws = ints[6]; p.hh = ints[7]; p.ww = ints[8];
  if (is_bf16 || p.NF < 1 || p.NF > AVF_MAX_V || BN < 1 || BN % p.NF != 0 || BN > 65535 ||
      p.HW < 1 || p.c < 8 || p.c % 8 != 0 || p.D % p.c != 0 || ints[9] != p.HW * p.HW)
    return -1;
  if (p.merge && (p.hh * p.ww != p.HW || p.ws * p.ws * p.c != p.D)) return -1;
  for (int i = 0; i < AVF_MAX_V; ++i) {
    p.v[i] = i < p.NF ? static_cast<const float*>(ptrs[2 + i]) : nullptr;
    p.v_bs[i] = ints[10 + i];
    if (i < p.NF && p.v[i] == nullptr) return -1;
  }
  p.a_vec = p.HW % 4 == 0;
  p.M = p.HW; p.N = p.D; p.K = p.HW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_fp<AvP>(p, BN, FP_WIDE, s);
}
