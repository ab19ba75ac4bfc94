"""The hand-written CUDA kernels of the port, their wrappers and their plain
versions: ``ffn`` (the conv-FFN chains and the attention statistics),
``sab`` (the alignment attention's probabilities and their product with the
values), ``lattice`` (the window permutation), ``level`` (a run of channel
blocks in one launch), ``chain2`` (two chained depthwise stages in one
launch). Nothing is built when the package is imported."""

from __future__ import annotations


def _counted() -> dict:
    from turtlevsr_tpu_torch.kernels import chain2, ffn, lattice, level, sab

    return {"ffn": ffn.fused_block_ffn, "qkv_stats": ffn.fused_qkv_stats,
            "split_proj": ffn.fused_ln_split_proj,
            "conv3x3": ffn.fused_conv3x3, "chm_stats": ffn.fused_chm_stats,
            "sab": sab.sab_attn_probs, "lattice_merge": lattice.lattice_merge,
            "lattice_split": lattice.lattice_split,
            "attn_v_slots": sab.sab_attn_v_slots,
            "attn_v_merge": sab.sab_attn_v_merge,
            "level_run": level.fused_channel_gffw_run,
            "two_stage": chain2.fused_two_stage,
            "sab_sparse_softmax": sab.sab_sparse_softmax}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`;
    ``ffn_no_dw`` are those of ``ffn`` without a depthwise stage,
    ``ffn_wg``, ``qkv_wg``, ``split_wg``, ``chm_wg`` and ``sab_wg`` those
    of ``ffn``, ``qkv_stats``, ``split_proj``, ``chm_stats`` and ``sab`` on
    their wgmma bodies, ``level_wg`` those of ``level_run`` on
    csrc/level_wg.cu, ``ffn_c64`` and ``split_c64`` those of ``ffn`` and
    ``split_proj`` on their C = 64 bodies, ``ffn_pw`` those of ``ffn_no_dw``
    on the body of csrc/ffn_pw.cu, ``two_stage_wg`` and ``sparse_wg`` those
    of ``two_stage`` and ``sab_sparse_softmax`` on csrc/chain2_wg.cu and
    csrc/sparse_wg.cu, ``sab_f32`` those of ``sab`` on the float32 body of
    csrc/sab_f32.cu, ``ffn_f32`` and ``qkv_f32`` those of ``ffn`` and
    ``qkv_stats`` on the float32 bodies of csrc/ffn_f32.cu and
    csrc/qkv_f32.cu, ``conv3x3_f32`` those of ``conv3x3`` on the float32
    body of csrc/conv_f32.cu, ``attn_v_f32`` those of ``attn_v_merge`` and
    ``attn_v_slots`` on the float32 body of csrc/attn_v_f32.cu,
    ``split_f32`` and ``chm_f32`` those of ``split_proj`` and ``chm_stats``
    on the float32 bodies of csrc/split_f32.cu and csrc/chm_f32.cu."""
    fns = _counted()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts["ffn_no_dw"] = fns["ffn"].launches_no_dw
    counts["ffn_c64"] = fns["ffn"].launches_c64
    counts["ffn_pw"] = fns["ffn"].launches_pw
    counts["split_c64"] = fns["split_proj"].launches_c64
    counts["two_stage_wg"] = fns["two_stage"].launches_wg
    counts["sparse_wg"] = fns["sab_sparse_softmax"].launches_wg
    counts["sab_f32"] = fns["sab"].launches_f32
    counts["ffn_f32"] = fns["ffn"].launches_f32
    counts["qkv_f32"] = fns["qkv_stats"].launches_f32
    counts["conv3x3_f32"] = fns["conv3x3"].launches_f32
    counts["attn_v_f32"] = (fns["attn_v_merge"].launches_f32
                            + fns["attn_v_slots"].launches_f32)
    counts["split_f32"] = fns["split_proj"].launches_f32
    counts["chm_f32"] = fns["chm_stats"].launches_f32
    for name in _WG_BODIES:
        counts[name.split("_")[0] + "_wg"] = fns[name].launches_wg
    return counts


# the wrappers with a second, wgmma body
_WG_BODIES = ("ffn", "qkv_stats", "split_proj", "chm_stats", "sab",
              "level_run")


def reset_launch_counts() -> None:
    fns = _counted()
    for fn in fns.values():
        fn.launches = 0
    fns["ffn"].launches_no_dw = 0
    fns["ffn"].launches_c64 = 0
    fns["ffn"].launches_pw = 0
    fns["split_proj"].launches_c64 = 0
    fns["two_stage"].launches_wg = 0
    fns["sab_sparse_softmax"].launches_wg = 0
    fns["sab"].launches_f32 = 0
    fns["ffn"].launches_f32 = 0
    fns["qkv_stats"].launches_f32 = 0
    for name in ("conv3x3", "attn_v_merge", "attn_v_slots", "split_proj",
                 "chm_stats"):
        fns[name].launches_f32 = 0
    for name in _WG_BODIES:
        fns[name].launches_wg = 0
