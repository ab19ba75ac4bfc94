"""Shared helpers of the tests that hold the PyTorch port
(turtlevsr_tpu_torch) against the JAX package: inputs and weights are made
from a seed with numpy and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reference_oracle import tiny_opt

# the tiny model of the parity tests with the CHM blocks (not ported yet)
# replaced by Channel blocks: the shape of the `gopro_t1_fhr` configuration
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
