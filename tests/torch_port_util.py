"""Shared helpers of the tests that hold the PyTorch port
(turtlevsr_tpu_torch) against the JAX package: inputs and weights are made
from a seed with numpy and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reference_oracle import tiny_opt

# the tiny model of the parity tests with the CHM blocks replaced by Channel
# blocks: the shape of the `gopro_t1_fhr` configuration
FHR_OVERRIDES = {"decoder1_attn_type2": "Channel",
                 "decoder2_attn_type2": "Channel",
                 "decoder3_attn_type2": "Channel"}


def tiny_fhr_opt(**overrides) -> dict:
    return tiny_opt(**{**FHR_OVERRIDES, **overrides})


def numpy_tree_like(tree, rng: np.random.RandomState):
    """A parameter tree of float64 numpy arrays shaped like ``tree``, every
    leaf random: zero-initialised scales (gamma, beta) and the unit
    temperature too, so that every branch takes part."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        shape = np.shape(node)
        if name == "temperature":
            return 0.5 + rng.rand(*shape)
        if name == "weight" and len(shape) == 1:  # LayerNorm weight
            return 1.0 + 0.2 * rng.standard_normal(shape)
        if name == "weight":
            fan_in = int(np.prod(shape[:3]))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        return 0.3 * rng.standard_normal(shape)

    return walk(tree, "")


def to_jnp(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def t(a, dtype=torch.float64) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype)


def close(got, want, atol, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# Kernel cases: small and ragged shapes, masked lanes, every FFN mode. On the
# card the kernels are held against the plain versions at these cases; on the
# CPU the plain versions are held against the JAX package at the same ones.
# ---------------------------------------------------------------------------

# float32: fp32 sums in another order, values to ~10. bfloat16: the plain
# versions round where the kernels round; a result may land on the other
# side of one bf16 rounding boundary (2^-8 relative, values to ~10)
KERNEL_TOL = {torch.float32: 3e-5, torch.bfloat16: 0.08}

FFN_KERNEL_CASES = {
    # name: (B, H, W, C, E, mode, pair, po, biases, scale, ffw2, ln_bias)
    "gate_pair_po_batched": (2, 11, 13, 16, 20, "gate", True, "batched",
                             True, False, False, True),
    "gate_pair_po_shared_wide": (1, 8, 8, 144, 16, "gate", True, "shared",
                                 False, False, False, True),
    "gate_pair_no_po": (1, 16, 8, 48, 24, "gate", True, None, False, False,
                        False, True),
    "gate_no_pair_biasfree_ln": (1, 9, 7, 16, 40, "gate", False, None, False,
                                 False, False, False),
    "gelu_scale": (1, 8, 16, 16, 32, "gelu", False, None, True, True, False,
                   True),
    "gelu_ffw2": (1, 10, 9, 80, 48, "gelu", False, None, True, True, True,
                  True),
    "gelu_ragged_hidden": (1, 8, 8, 32, 70, "gelu", False, None, True, False,
                           False, True),
    "gate_c512": (1, 9, 8, 512, 48, "gate", True, "batched", False, False,
                  False, True),
    "gelu_no_dw": (1, 9, 11, 32, 64, "gelu", False, None, True, True, False,
                   True),
    "gate_no_dw": (1, 8, 8, 16, 24, "gate", True, None, False, False, False,
                   True),
}
# The calls the wgmma body takes (kernels/csrc/ffn_wg.cu: bf16, a depthwise
# stage, C in 128 / 256 / 512, E a multiple of 32; at most one x2 map, or the
# chained FFW at C = 128) at the model's widths, on a ragged map of two
# entries. Cases named tile_* stay on the mma.sync body (csrc/ffn.cu): the
# model's forms at C = 64, which the plan keeps there, and calls just outside
# the new body's conditions (C, then E). Same fields as FFN_KERNEL_CASES.
FFN_WG_CASES = {
    **{f"gate_pair_po_batched_c{c}": (2, 37, 53, c, c * 5 // 2, "gate", True,
                                      "batched", True, False, False, True)
       for c in (128, 256, 512)},
    "gate_pair_no_po_c512": (2, 37, 53, 512, 1280, "gate", True, None, False,
                             False, False, True),
    "gate_pair_po_shared_c256": (2, 37, 53, 256, 640, "gate", True, "shared",
                                 False, False, False, True),
    "gelu_scale_c128": (2, 37, 53, 128, 256, "gelu", False, None, True, True,
                        False, True),
    "tile_gate_pair_po_batched_c64": (2, 37, 53, 64, 160, "gate", True,
                                      "batched", True, False, False, True),
    "tile_gate_no_pair_biasfree_ln_c64": (2, 37, 53, 64, 160, "gate", False,
                                          None, False, False, False, False),
    "tile_gelu_scale_c64": (2, 37, 53, 64, 128, "gelu", False, None, True,
                            True, False, True),
    "tile_outside_c96": (2, 37, 53, 96, 240, "gate", True, "batched", True,
                         False, False, True),
    "tile_outside_e48_c128": (2, 37, 53, 128, 48, "gate", True, "batched",
                              True, False, False, True),
    # the chained FFW (enc2's ReducedAttn+FFW blocks; F = 2C), also with
    # bias-free LayerNorms; at C = 64 (enc1's) it stays on ffn.cu
    "gelu_scale_ffw2_c128": (2, 37, 53, 128, 256, "gelu", False, None, True,
                             True, True, True),
    "gelu_scale_ffw2_biasfree_ln_c128": (1, 19, 21, 128, 256, "gelu", False,
                                         None, True, True, True, False),
    "tile_gelu_scale_ffw2_c64": (2, 37, 53, 64, 128, "gelu", False, None,
                                 True, True, True, True),
}
# The calls the C = 64 body takes (kernels/csrc/ffn_c64.cu: bf16, a
# depthwise stage, C = 64; no x2 map, one or a list of maps with a po each
# in gate mode, the chained FFW in gelu mode, F = 2C) at the model's hidden
# widths: ragged maps whose sides the 16 x 8 tiles do not divide, batches of
# two with per-batch po, maps smaller than a tile and grids of fewer tiles
# than the card has SMs. Cases named tile_* are just outside the body's
# forms and stay on ffn.cu. Same fields as FFN_KERNEL_CASES.
FFN_C64_CASES = {
    "gate_no_pair_ragged": (2, 37, 53, 64, 160, "gate", False, None, False,
                            False, False, True),
    "gate_no_pair_biasfree_ln_one_tile": (1, 16, 8, 64, 160, "gate", False,
                                          None, False, False, False, False),
    "gelu_scale_ragged": (2, 37, 53, 64, 128, "gelu", False, None, True, True,
                          False, True),
    "gelu_scale_e64_smaller_than_a_tile": (1, 9, 7, 64, 64, "gelu", False,
                                           None, True, True, False, True),
    "gate_pair_po_batched_ragged": (2, 37, 53, 64, 160, "gate", True,
                                    "batched", True, False, False, True),
    "gate_pair_po_shared_few_tiles": (2, 20, 20, 64, 160, "gate", True,
                                      "shared", False, False, False, True),
    "gate_pair_po_batched_15_tiles": (15, 40, 40, 64, 160, "gate", True,
                                      "batched", False, False, False, True),
    "gelu_scale_ffw2_ragged": (2, 37, 53, 64, 128, "gelu", False, None, True,
                               True, True, True),
    "gelu_scale_ffw2_biasfree_ln_small": (1, 9, 11, 64, 128, "gelu", False,
                                          None, True, True, True, False),
    "tile_gate_pair_no_po": (2, 37, 53, 64, 160, "gate", True, None, False,
                             False, False, True),
    "tile_gelu_pair_po": (2, 37, 53, 64, 128, "gelu", True, "batched", True,
                          False, False, True),
}
# The lists the C = 64 body takes (gate, up to 4 maps; dec1's CHM call is a
# stacked entry of 3 maps and one more); tile_*: 5 maps, whose po matrices
# do not fit its shared memory beside two ring slots. Same fields as
# FFN_LIST_CASES.
FFN_C64_LIST_CASES = {
    "lists_stack3_single_ragged": (2, 37, 53, 64, 160, 3, 1, True, False,
                                   True),
    "lists_stack3_single_15_tiles": (15, 40, 40, 64, 160, 3, 1, True, False,
                                     True),
    "lists_two_singles_shared_po_b": (1, 20, 20, 64, 160, 0, 2, False, True,
                                      False),
    "tile_lists_stack4_single": (2, 37, 53, 64, 160, 4, 1, True, False, True),
}
# (B, H, W, C, heads, biases)
QKV_KERNEL_SHAPES = [(2, 11, 13, 16, 2, True), (1, 8, 9, 128, 2, False),
                     (1, 9, 8, 48, 1, False)]
# (B, H, W, C, E, n_out, biases)
SPLIT_KERNEL_SHAPES = [(2, 11, 13, 16, 16, 3, True),
                       (1, 8, 9, 32, 40, 2, False)]
# (B, H, W, Cin, Cout, bias)
CONV_KERNEL_SHAPES = [(2, 11, 13, 3, 16, False), (1, 8, 16, 16, 3, True),
                      (1, 9, 9, 24, 20, True), (1, 9, 9, 32, 140, False)]


class Maker:
    """Seeded tensors of one type on one device, made with numpy."""

    def __init__(self, seed, dtype, device="cpu"):
        self.rng = np.random.RandomState(seed)
        self.dtype, self.device = dtype, device

    def __call__(self, *shape, scale=1.0):
        a = self.rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(self.device, self.dtype)


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def ffn_kernel_case(name, m: Maker, cases=None):
    """(x, keyword arguments of fused_block_ffn) of one FFN case of
    ``cases`` (FFN_KERNEL_CASES by default)."""
    b, h, w, c, e, mode, pair, po, biases, scale, ffw2, lnb = (
        FFN_KERNEL_CASES if cases is None else cases)[name]
    ch = 2 * e if mode == "gate" else e
    x = m(b, h, w, c)
    kw = dict(ln_w=m(c), ln_b=m(c) if lnb else None,
              w1=m(c, ch, scale=c ** -0.5), wd=m(3, 3, ch, scale=0.3),
              w2=m(e, c, scale=e ** -0.5), mode=mode)
    if biases:
        kw.update(b1=m(ch), bd=m(ch), b2=m(c))
    if name.endswith("_no_dw"):  # the branch without a depthwise stage
        kw["wd"] = None
        kw.pop("bd", None)
    if scale:
        kw["scale"] = m(c)
    if pair:
        kw["x2"] = m(b, h, w, c)
    if po:
        kw["po_w"] = m(*((b, c, c) if po == "batched" else (c, c)),
                       scale=c ** -0.5)
        if biases:
            kw["po_b"] = m(c)
    if ffw2:  # ln_bias: both LayerNorms with a bias, or neither
        f = 2 * c
        kw["ffw2"] = dict(ln_w=m(c), ln_b=m(c) if lnb else None,
                          w1=m(c, f, scale=c ** -0.5), b1=m(f),
                          w2=m(f, c, scale=f ** -0.5), b2=m(c), scale=m(c))
    return x, kw


def chain_kernel_case(m: Maker, b, h, w, c, ch, biases, ln_bias=True):
    x = m(b, h, w, c)
    kw = dict(ln_w=m(c), ln_b=m(c) if ln_bias else None,
              w1=m(c, ch, scale=c ** -0.5), wd=m(3, 3, ch, scale=0.3))
    if biases:
        kw.update(b1=m(ch), bd=m(ch))
    return x, kw


# ---------------------------------------------------------------------------
# Cases of the kernels of the causal history model (CHM) path
# ---------------------------------------------------------------------------

# name: (B, H, W, C, E, maps in the stacked entry, single maps, per-batch
#        matrices, po_b, ln_bias)
FFN_LIST_CASES = {
    "stack3_single_batched": (2, 11, 13, 16, 20, 3, 1, True, True, True),
    "stack1_single_shared_c48": (1, 8, 9, 48, 24, 1, 1, False, False, False),
    "stack4_single_c144": (1, 8, 8, 144, 16, 4, 1, True, False, True),
    "two_singles": (1, 9, 8, 32, 16, 0, 2, True, False, True),
    # the CHM blocks' widths at dec2 and dec3 (4 stacked history maps and the
    # current one); on the card these are held on ffn.cu's list form, the
    # wgmma body's being FFN_WG_LIST_CASES
    "stack4_single_c128": (2, 11, 13, 128, 320, 4, 1, True, False, True),
    "stack4_single_c256": (1, 9, 8, 256, 640, 4, 1, True, True, True),
}
# The lists the wgmma body takes (gate, C = 128 or 256; the CHM blocks'
# call at dec3 and dec2): a stacked entry of 4 maps and one more on ragged
# whole-frame maps (183 x 315, 367 x 633) and 15 tiles (80 x 80, 160 x 160),
# five single maps with po_b, a shared po; tile_* stay on ffn.cu (dec1's C =
# 64). Same fields as FFN_LIST_CASES.
FFN_WG_LIST_CASES = {
    "lists_stack4_single_c256_ragged": (1, 183, 315, 256, 640, 4, 1, True,
                                        False, True),
    "lists_stack4_single_c128_ragged": (1, 367, 633, 128, 320, 4, 1, True,
                                        False, True),
    "lists_stack4_single_c256_15_tiles": (15, 80, 80, 256, 640, 4, 1, True,
                                          False, True),
    "lists_stack4_single_c128_15_tiles": (15, 160, 160, 128, 320, 4, 1, True,
                                          False, True),
    "lists_five_singles_po_b_c128": (2, 37, 53, 128, 320, 0, 5, True, True,
                                     True),
    "lists_stack2_two_singles_shared_c256": (2, 37, 53, 256, 640, 2, 2,
                                             False, True, False),
    "tile_lists_stack4_single_c64": (2, 37, 53, 64, 160, 4, 1, True, False,
                                     True),
}
# (B, H, W, C, heads, NF, ln_bias)
CHM_KERNEL_SHAPES = [(2, 11, 13, 16, 2, 1, True), (1, 8, 9, 48, 1, 3, False),
                     (1, 9, 8, 144, 3, 2, True), (1, 8, 8, 32, 4, 4, True)]
# (B, H, W, Cin, Cout, bias, ln_bias)
CONV_LN_KERNEL_SHAPES = [(2, 11, 13, 16, 16, False, True),
                         (1, 9, 9, 48, 20, True, False),
                         (1, 8, 9, 144, 144, False, True)]
# (B, NF, hq, wq, D): HW not a multiple of the 16-row tile, HW < 5
SAB_KERNEL_SHAPES = [(1, 1, 3, 5, 32), (2, 3, 5, 8, 144), (1, 2, 2, 2, 16),
                     (1, 3, 9, 7, 64)]
# (N, hh, ww, ws, C)
LATTICE_KERNEL_SHAPES = [(2, 3, 5, 2, 8), (1, 2, 3, 4, 64), (3, 4, 2, 2, 128),
                         (1, 3, 2, 2, 48), (1, 2, 2, 8, 16), (2, 1, 3, 2, 144)]


def ffn_list_case(name, m: Maker, cases=None):
    """(x, keyword arguments of fused_block_ffn) with lists of x2 maps, of
    ``cases`` (FFN_LIST_CASES by default)."""
    b, h, w, c, e, n_stack, n_single, batched, po_b, lnb = (
        FFN_LIST_CASES if cases is None else cases)[name]
    x = m(b, h, w, c)
    kw = dict(ln_w=m(c), ln_b=m(c) if lnb else None,
              w1=m(c, 2 * e, scale=c ** -0.5), wd=m(3, 3, 2 * e, scale=0.3),
              w2=m(e, c, scale=e ** -0.5), mode="gate")
    x2 = ([m(b, n_stack, h, w, c)] if n_stack else []) + [
        m(b, h, w, c) for _ in range(n_single)]
    shape = (b, c, c) if batched else (c, c)
    kw["x2"] = x2
    kw["po_w"] = [m(*shape, scale=c ** -0.5)
                  for _ in range(n_stack + n_single)]
    if po_b:
        kw["po_b"] = m(c)
    return x, kw


def chm_kernel_case(m: Maker, b, h, w, c, heads, nf, ln_bias):
    """(x, x_sp, keyword arguments of fused_chm_stats)."""
    kw = dict(ln_w=m(c), ln_b=m(c) if ln_bias else None,
              w_qkv=m(c, 3 * c, scale=c ** -0.5),
              wd_qkv=m(3, 3, 3 * c, scale=0.3),
              w_kv=m(c, 2 * c, scale=c ** -0.5),
              wd_kv=m(3, 3, 2 * c, scale=0.3), heads=heads)
    return m(b, h, w, c), m(b, nf, h, w, c), kw


def sab_kernel_case(m: Maker, b, nf, hq, wq, d, exact: bool):
    """(q, k, temp, fvalid) of one SAB case. exact: entries are small
    integers over 8 and the temperature a power of two, so every score is
    exact in fp32 whatever the order of the sum, and many scores tie."""
    hw = hq * wq
    if exact:
        q = torch.from_numpy(m.rng.randint(-2, 3, (b, hw, d)) / 8.0)
        k = torch.from_numpy(m.rng.randint(-2, 3, (b, nf, hw, d)) / 8.0)
        temp = torch.tensor([0.5])
    else:
        q = torch.from_numpy(m.rng.standard_normal((b, hw, d)))
        k = torch.from_numpy(m.rng.standard_normal((b, nf, hw, d)))
        q = q / q.norm(dim=-1, keepdim=True)
        k = k / k.norm(dim=-1, keepdim=True)
        temp = torch.tensor([1.7])
    fvalid = torch.ones(nf)
    if nf > 1:
        fvalid[1] = 0.0  # one invalid frame: zero rows
    to = dict(device=m.device, dtype=m.dtype)
    return (q.to(**to), k.to(**to), temp.to(m.device),
            fvalid.to(m.device))


def sab_compare(got, want):
    """(share of rows whose support differs, largest error on the rows whose
    support agrees) of two (B, NF, HW, HW) probability tensors."""
    got, want = got.float(), want.float()
    same = ((got != 0) == (want != 0)).all(dim=-1)
    err = ((got - want).abs().amax(dim=-1) * same).max().item()
    return 1.0 - same.float().mean().item(), err


# ---------------------------------------------------------------------------
# Cases of the run kernel (a run of Channel + gated-FFN blocks) and of the
# attention @ values kernel
# ---------------------------------------------------------------------------

# (B, H, W, C, E, heads, blocks of the run, ln_bias)
LEVEL_KERNEL_SHAPES = [(2, 11, 13, 16, 20, 2, 3, True),
                       (1, 8, 9, 48, 24, 1, 2, False),
                       (1, 9, 8, 128, 40, 2, 1, True),
                       (3, 16, 16, 32, 16, 4, 4, True),
                       (1, 10, 10, 144, 16, 3, 2, False)]
# (B, NF, hh, ww, ws, C, v as views of one ring buffer)
ATTN_V_KERNEL_SHAPES = [(1, 1, 3, 5, 2, 8, False), (2, 3, 5, 8, 2, 16, True),
                        (1, 2, 2, 2, 4, 64, True), (1, 4, 9, 7, 2, 40, False),
                        (2, 1, 10, 10, 2, 128, True)]


def level_kernel_case(m: Maker, b, h, w, c, e, heads, n_blocks, ln_bias):
    """(x, blocks) of fused_channel_gffw_run: one dict of bias-free kernel
    layout weights per block of the run."""
    blocks = [dict(
        ln1_w=1.0 + m(c, scale=0.2), ln1_b=m(c, scale=0.2) if ln_bias else None,
        w_qkv=m(c, 3 * c, scale=c ** -0.5), wd_qkv=m(3, 3, 3 * c, scale=0.3),
        temp=1.0 + 0.5 * m(heads).abs(), wpo=m(c, c, scale=c ** -0.5),
        ln2_w=1.0 + m(c, scale=0.2), ln2_b=m(c, scale=0.2) if ln_bias else None,
        w1=m(c, 2 * e, scale=c ** -0.5), wd=m(3, 3, 2 * e, scale=0.3),
        w2=m(e, c, scale=e ** -0.5)) for _ in range(n_blocks)]
    return m(b, h, w, c, scale=0.5), blocks


def attn_v_kernel_case(m: Maker, b, nf, hh, ww, ws, c, ring: bool):
    """(a (B * NF, HW, HW) sparse rows that sum to one, the list of NF value
    tensors (B, HW, ws * ws * C))."""
    hw, d = hh * ww, ws * ws * c
    a = torch.from_numpy(m.rng.rand(b * nf, hw, hw).astype(np.float32))
    a = a * (a > 0.7)  # most entries zero, as the clipped softmax leaves them
    a = a / a.sum(dim=-1, keepdim=True).clamp_min(1e-6)
    a = a.to(m.device, m.dtype)
    if ring:  # ring positions are views with the ring's batch stride
        buf = m(b, nf, hw, d)
        vs = [buf[:, i] for i in range(nf)]
    else:
        vs = [m(b, hw, d) for _ in range(nf)]
    return a, vs


# ---------------------------------------------------------------------------
# Cases of the two-stage kernel (row 13) and of the sparse softmax (row 12)
# ---------------------------------------------------------------------------

# name: (B, H, W, C, E1, E2, kind, biases of the second stage, ln_bias). A
# pair: two gelu stages with scale and an FFW (F = 2C) after each; ra_gffw: a
# gelu stage, then the gate. Ragged tiles, maps smaller than a tile, hidden
# widths that are no multiple of the chunk.
TWO_STAGE_KERNEL_CASES = {
    "pair_c16": (2, 11, 13, 16, 32, 32, "pair", True, True),
    "pair_c64": (1, 9, 17, 64, 128, 128, "pair", True, False),
    "pair_c128": (1, 10, 8, 128, 256, 256, "pair", True, True),
    "pair_c48_ragged_hidden": (1, 8, 9, 48, 70, 40, "pair", True, True),
    "ra_gffw_c64": (1, 12, 16, 64, 128, 160, "ra_gffw", False, True),
    "ra_gffw_c16_bias": (2, 7, 9, 16, 32, 20, "ra_gffw", True, False),
    "ra_gffw_tiny_map": (1, 3, 5, 32, 64, 24, "ra_gffw", True, True),
}
# the forms of the Hopper bodies of row 13 (csrc/chain2_wg.cu), bf16: maps
# that the 16 x 8 (C = 64) or 8 x 8 (C = 128) output tiles do not divide,
# maps smaller than a tile, batches, without biases or LN bias, and grids of
# more tiles than an H100 has SMs (a block of the C = 64 body walks several,
# its next input box loaded during the current one)
TWO_STAGE_WG_CASES = {
    "wg_pair_c64_ragged": (2, 37, 29, 64, 128, 128, "pair", True, True),
    "wg_pair_c64_no_ln_bias": (1, 20, 24, 64, 128, 128, "pair", False, False),
    "wg_pair_c64_smaller_than_a_tile": (1, 5, 3, 64, 128, 128, "pair", True,
                                        True),
    "wg_pair_c64_walk": (4, 64, 72, 64, 128, 128, "pair", True, True),
    "wg_ra_gffw_c64_ragged": (2, 33, 41, 64, 128, 160, "ra_gffw", True, True),
    "wg_ra_gffw_c64_walk": (3, 100, 60, 64, 128, 160, "ra_gffw", False,
                            False),
    "wg_pair_c128_ragged": (2, 19, 13, 128, 256, 256, "pair", True, True),
    "wg_pair_c128_no_ln_bias": (1, 16, 24, 128, 256, 256, "pair", False,
                                False),
    "wg_pair_c128_smaller_than_a_tile": (1, 3, 5, 128, 128, 128, "pair",
                                         True, True),
}
# (BN, Q, K, hq, wq of the mask's token grid, exact scores). K < 5 follows
# the unfused chain; K = 20000 needs fewer rows a block
SPARSE_KERNEL_SHAPES = [(2, 16, 128, 8, 16, False), (3, 10, 130, 10, 13, True),
                        (1, 6, 3, 2, 3, False), (2, 24, 400, 20, 20, False),
                        (1, 5, 20000, 100, 200, True)]


def two_stage_kernel_case(name, m: Maker, cases=None):
    """(x, st1, st2, ffw1, ffw2) of fused_two_stage, one case of ``cases``
    (TWO_STAGE_KERNEL_CASES by default)."""
    b, h, w, c, e1, e2, kind, biases, lnb = (cases or TWO_STAGE_KERNEL_CASES
                                             )[name]

    def stage(e, mode, with_b, scale):
        ch = 2 * e if mode == "gate" else e
        st = dict(ln_w=1.0 + m(c, scale=0.2),
                  ln_b=m(c, scale=0.2) if lnb else None,
                  w1=m(c, ch, scale=c ** -0.5), wd=m(3, 3, ch, scale=0.3),
                  w2=m(e, c, scale=e ** -0.5), mode=mode)
        if with_b:
            st.update(b1=m(ch, scale=0.2), bd=m(ch, scale=0.2),
                      b2=m(c, scale=0.2))
        if scale:
            st["scale"] = m(c, scale=0.5)
        return st

    def ffw():
        f = 2 * c
        return dict(ln_w=1.0 + m(c, scale=0.2),
                    ln_b=m(c, scale=0.2) if lnb else None,
                    w1=m(c, f, scale=c ** -0.5), b1=m(f, scale=0.2),
                    w2=m(f, c, scale=f ** -0.5), b2=m(c, scale=0.2),
                    scale=m(c, scale=0.5))

    x = m(b, h, w, c, scale=0.5)
    st1 = stage(e1, "gelu", True, True)
    if kind == "pair":
        return x, st1, stage(e2, "gelu", True, True), ffw(), ffw()
    return x, st1, stage(e2, "gate", biases, False), None, None


def sparse_kernel_case(m: Maker, bn, q, k, hq, wq, exact):
    """(scores (BN, Q, K), local mask (Q, K)) of sab_sparse_softmax: the
    mask is that of the first Q query tokens on an (hq, wq) grid."""
    from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

    if exact:
        s = torch.from_numpy(m.rng.randint(-8, 9, (bn, q, k)) / 8.0)
    else:
        s = torch.from_numpy(m.rng.standard_normal((bn, q, k)))
    mask = local_window_mask(hq, wq, 4, rows=slice(0, q))[:, :k]
    return (s.to(m.device, m.dtype), mask.to(m.device, m.dtype))
