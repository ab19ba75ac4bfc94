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


def ffn_kernel_case(name, m: Maker):
    """(x, keyword arguments of fused_block_ffn) of one FFN case."""
    b, h, w, c, e, mode, pair, po, biases, scale, ffw2, lnb = (
        FFN_KERNEL_CASES[name])
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
    if ffw2:
        f = 2 * c
        kw["ffw2"] = dict(ln_w=m(c), ln_b=m(c), w1=m(c, f, scale=c ** -0.5),
                          b1=m(f), w2=m(f, c, scale=f ** -0.5), b2=m(c),
                          scale=m(c))
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


def ffn_list_case(name, m: Maker):
    """(x, keyword arguments of fused_block_ffn) with lists of x2 maps."""
    b, h, w, c, e, n_stack, n_single, batched, po_b, lnb = FFN_LIST_CASES[name]
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
