"""The hand-written CUDA kernels of the port, their wrappers and their plain
versions: ``ffn`` (the conv-FFN chains and the attention statistics),
``sab`` (the alignment attention's probabilities and their product with the
values), ``lattice`` (the window permutation), ``level`` (a run of channel
blocks in one launch). Nothing is built when the package is imported."""

from __future__ import annotations


def _counted() -> dict:
    from turtlevsr_tpu_torch.kernels import ffn, lattice, level, sab

    return {"ffn": ffn.fused_block_ffn, "qkv_stats": ffn.fused_qkv_stats,
            "split_proj": ffn.fused_ln_split_proj,
            "conv3x3": ffn.fused_conv3x3, "chm_stats": ffn.fused_chm_stats,
            "sab": sab.sab_attn_probs, "lattice_merge": lattice.lattice_merge,
            "lattice_split": lattice.lattice_split,
            "attn_v_slots": sab.sab_attn_v_slots,
            "attn_v_merge": sab.sab_attn_v_merge,
            "level_run": level.fused_channel_gffw_run}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`;
    ``ffn_no_dw`` are those of ``ffn`` without a depthwise stage."""
    counts = {name: fn.launches for name, fn in _counted().items()}
    counts["ffn_no_dw"] = _counted()["ffn"].launches_no_dw
    return counts


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
    _counted()["ffn"].launches_no_dw = 0
