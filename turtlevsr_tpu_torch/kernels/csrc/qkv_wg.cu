// The Hopper body of the channel-attention statistics (row 3): LN, the q/k/v
// chains, the v map, the per-head Gram q_h^T k_h and the sums of q^2 and k^2,
// for bf16 maps with C in {64, 128, 256, 512}, ctok = 64 and no biases (the
// shipped form). kernels/ffn.py's _qkv_plan sends those calls here
// and every other one (float32, biases, other head widths) to qkv_stats.cu.
// The design, and where it rounds, is in the note of stats_wg.cuh.
//
// Replaces fused_qkv_stats in turtlevsr_tpu/kernels/ffn.py
// (_qkv_stats_kernel). Row 14 (level.cu) keeps qkv_tile.cuh's tile code.
#include "stats_wg.cuh"

extern "C" size_t turtle_qkv_wg_smem(int C) { return turtle::sw_smem(C, false); }

// ptrs: x, ln_w, ln_b, w1 (C, 3C), wd (3, 3, 3C), v, part
// ints: B, H, W, C, heads, R, grid. part is fp32 (B, R, heads*64^2 + 2C),
// zero; R: the rows of a batch entry (the blocks whose range meets it).
// Returns the CUDA error code (0 = launched), -1 for a call this body does
// not take, -2 when a tensor map is refused.
extern "C" int turtle_qkv_wg_launch(void* const* ptrs, const int* ints, int is_bf16,
                                    void* stream) {
  using namespace turtle;
  StatsWgArgs a = {};
  a.x = ptrs[0]; a.ln_w = ptrs[1]; a.ln_b = ptrs[2]; a.wd_qkv = ptrs[4];
  a.v = ptrs[5]; a.part = static_cast<float*>(ptrs[6]);
  a.B = ints[0]; a.H = ints[1]; a.W = ints[2]; a.R = ints[5];
  const int C = ints[3], heads = ints[4], grid = ints[6];
  if (!is_bf16 || a.ln_w == nullptr || heads * 64 != C || grid < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return launch_stats_wg<64, false>(a, ptrs[3], nullptr, grid, s);
    case 128: return launch_stats_wg<128, false>(a, ptrs[3], nullptr, grid, s);
    case 256: return launch_stats_wg<256, false>(a, ptrs[3], nullptr, grid, s);
    case 512: return launch_stats_wg<512, false>(a, ptrs[3], nullptr, grid, s);
  }
  return -1;
}
