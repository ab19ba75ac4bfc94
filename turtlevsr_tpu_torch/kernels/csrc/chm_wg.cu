// The Hopper body of the causal history model's statistics (row 6): row 3's
// chain on the current map through w_qkv (q of every head kept in shared
// memory as bf16 tiles), then for each of the NF aligned frames, without
// LayerNorm, kh and vh through w_kv: the Grams q_h^T kh_n,h, the sums of
// kh_n^2 and the vh maps. bf16, C in {64, 128, 256}, ctok = 64, no biases;
// kernels/ffn.py's _chm_plan sends every other call to chm_stats.cu. The
// design, and where it rounds, is in the note of stats_wg.cuh.
//
// Replaces fused_chm_stats in turtlevsr_tpu/kernels/ffn.py (_chm_stats_kernel).
#include "stats_wg.cuh"

extern "C" size_t turtle_chm_wg_smem(int C) { return turtle::sw_smem(C, true); }

// ptrs: x (B, H, W, C), x_sp (B, NF, H, W, C), ln_w, ln_b, w_qkv (C, 3C),
//       wd_qkv (3, 3, 3C), w_kv (C, 2C), wd_kv (3, 3, 2C), v, vh, part
// ints: B, H, W, C, heads, NF, R, grid. part is fp32 (B, R,
// (NF + 1) * heads * 64^2 + (NF + 2) * C), zero. Returns as
// turtle_qkv_wg_launch.
extern "C" int turtle_chm_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
  StatsWgArgs a = {};
  a.x = ptrs[0]; a.xsp = ptrs[1]; a.ln_w = ptrs[2]; a.ln_b = ptrs[3];
  a.wd_qkv = ptrs[5]; a.wd_kv = ptrs[7]; a.v = ptrs[8]; a.vh = ptrs[9];
  a.part = static_cast<float*>(ptrs[10]);
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.NF = ints[5]; a.R = ints[6];
  const int C = ints[3], heads = ints[4], grid = ints[7];
  if (!is_bf16 || a.ln_w == nullptr || heads * 64 != C || a.NF < 1 || grid < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch_stats_wg<64, true>(a, ptrs[4], ptrs[6], grid, s);
    case 128: return launch_stats_wg<128, true>(a, ptrs[4], ptrs[6], grid, s);
    case 256: return launch_stats_wg<256, true>(a, ptrs[4], ptrs[6], grid, s);
  }
  return -1;
}
