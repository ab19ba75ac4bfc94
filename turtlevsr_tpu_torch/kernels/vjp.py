"""Gradients of the kernels: one ``torch.autograd.Function`` per kernel that
training runs through, as the JAX package's ``kernels/vjp.py`` has one
``custom_vjp`` per Pallas kernel.

Forward calls the kernel's wrapper (the CUDA kernel on the card, the plain
version on a CPU tensor) and saves its inputs only. Backward re-runs the
plain version on detached copies of those inputs under autograd and returns
``torch.autograd.grad`` of it: the plain versions repeat the kernels'
arithmetic (kernels/ffn.py), so the gradient is that of the function the
kernel computes, and no kernel of its own is needed. Under the trainer's
per-frame checkpoint the recomputed forward launches the kernels again,
while the backward stays plain PyTorch. The lattice pair is the exception:
each permutation's backward is the other's kernel (kernels/lattice.py).

The model calls the functions below, named like the wrappers. Each takes
its Function only when autograd would record the call (grad mode on and an
input that requires grad); otherwise it calls the wrapper itself, so that
serving launches what it launched before, with no tracing of its own. Both
branches launch the same kernel. Row 10 (``sab_attn_v_slots``) has no
Function: it has none in the JAX package and no caller in the model.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import chain2, ffn, lattice, level, sab
from turtlevsr_tpu_torch.kernels.ffn import records

_LEAF = object()  # the place of a tensor in a flattened call


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (dicts, lists, tuples) with each tensor
    replaced by _LEAF and appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node

    return build(spec)


def _kernel_function(name: str, module, wrapper: str, plain):
    """A Function whose forward is ``module.<wrapper>`` (looked up at each
    call) and whose backward is autograd through ``plain``; it is applied
    as ``F.apply(spec, *leaves)`` to a call flattened by _flatten."""

    def forward(ctx, spec, *leaves):
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*leaves)
        args, kwargs = _unflatten(spec, leaves)
        return getattr(module, wrapper)(*args, **kwargs)

    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() if n else t.detach()
                      for t, n in zip(ctx.saved_tensors, need)]
            args, kwargs = _unflatten(ctx.spec, inputs)
            outs = plain(*args, **kwargs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else [None] * len(wanted))
        return (None, *[next(got) if n else None for n in need])

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward),
        "__doc__": f"``{wrapper}`` forward, autograd through "
                   f"``{plain.__name__}`` backward."})


# one Function per row of the kernel table (PERF.md); the JAX custom_vjp
# each stands for in turtlevsr_tpu/kernels/vjp.py
BlockFFN = _kernel_function(  # rows 1 and 2: ffn_op
    "BlockFFN", ffn, "fused_block_ffn", ffn.ffn_plain)
QKVStats = _kernel_function(  # row 3: qkv_stats_op
    "QKVStats", ffn, "fused_qkv_stats", ffn.qkv_stats_plain)
SplitProj = _kernel_function(  # row 4: split_proj_op
    "SplitProj", ffn, "fused_ln_split_proj", ffn.split_proj_plain)
Conv3x3 = _kernel_function(  # row 5: conv3_op
    "Conv3x3", ffn, "fused_conv3x3", ffn.conv3x3_plain)
CHMStats = _kernel_function(  # row 6: chm_stats_op
    "CHMStats", ffn, "fused_chm_stats", ffn.chm_stats_plain)
SABProbs = _kernel_function(  # row 7: sab_attn_probs_op
    "SABProbs", sab, "sab_attn_probs", sab.sab_attn_probs_plain)
AttnVMerge = _kernel_function(  # row 11: sab_av_merge_op
    "AttnVMerge", sab, "sab_attn_v_merge", sab.attn_v_merge_plain)
SparseSoftmax = _kernel_function(  # row 12: sab_softmax_op
    "SparseSoftmax", sab, "sab_sparse_softmax", sab.sparse_softmax_plain)
TwoStage = _kernel_function(  # row 13: two_stage_op
    "TwoStage", chain2, "fused_two_stage", chain2.two_stage_plain)
ChannelRun = _kernel_function(  # row 14: channel_run_op
    "ChannelRun", level, "fused_channel_gffw_run",
    level.channel_gffw_run_plain)


def _call(fn, module, wrapper: str, args: tuple, kwargs: dict):
    """The wrapper itself, or its Function when autograd would record."""
    if torch.is_grad_enabled():
        leaves: list = []
        spec = _flatten((args, kwargs), leaves)
        if records(*leaves):
            return fn.apply(spec, *leaves)
    return getattr(module, wrapper)(*args, **kwargs)


def fused_block_ffn(x, **kw):
    return _call(BlockFFN, ffn, "fused_block_ffn", (x,), kw)


def fused_qkv_stats(x, **kw):
    return _call(QKVStats, ffn, "fused_qkv_stats", (x,), kw)


def fused_ln_split_proj(x, **kw):
    return _call(SplitProj, ffn, "fused_ln_split_proj", (x,), kw)


def fused_conv3x3(x, weight, bias=None, **kw):
    return _call(Conv3x3, ffn, "fused_conv3x3", (x, weight, bias), kw)


def fused_chm_stats(x, x_sp, **kw):
    return _call(CHMStats, ffn, "fused_chm_stats", (x, x_sp), kw)


def sab_attn_probs(q, k, temp, fvalid=None, **kw):
    return _call(SABProbs, sab, "sab_attn_probs", (q, k, temp, fvalid), kw)


def sab_attn_v_merge(a, v, ws: int, h: int, w: int):
    return _call(AttnVMerge, sab, "sab_attn_v_merge", (a, v, ws, h, w), {})


def sab_sparse_softmax(scores, local_mask, k_top: int = 5):
    return _call(SparseSoftmax, sab, "sab_sparse_softmax",
                 (scores, local_mask, k_top), {})


def fused_two_stage(x, st1, st2, **kw):
    return _call(TwoStage, chain2, "fused_two_stage", (x, st1, st2), kw)


def fused_channel_gffw_run(x, blocks, heads: int):
    return _call(ChannelRun, level, "fused_channel_gffw_run",
                 (x, blocks, heads), {})


def lattice_split(x, ws: int):
    if records(x):
        return lattice.LatticeSplit.apply(x, ws)
    return lattice.lattice_split(x, ws)


def lattice_merge(t, ws: int, h: int, w: int):
    if records(t):
        return lattice.LatticeMerge.apply(t, ws, h, w)
    return lattice.lattice_merge(t, ws, h, w)
