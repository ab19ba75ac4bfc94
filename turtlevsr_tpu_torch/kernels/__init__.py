"""The hand-written CUDA kernels of the port, their wrappers and their plain
versions: ``ffn`` (the conv-FFN chains and the attention statistics),
``sab`` (the alignment attention's probabilities), ``lattice`` (the window
permutation). Nothing is built when the package is imported."""

from __future__ import annotations


def _counted() -> dict:
    from turtlevsr_tpu_torch.kernels import ffn, lattice, sab

    return {"ffn": ffn.fused_block_ffn, "qkv_stats": ffn.fused_qkv_stats,
            "split_proj": ffn.fused_ln_split_proj,
            "conv3x3": ffn.fused_conv3x3, "chm_stats": ffn.fused_chm_stats,
            "sab": sab.sab_attn_probs, "lattice_merge": lattice.lattice_merge,
            "lattice_split": lattice.lattice_split}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _counted().items()}


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
