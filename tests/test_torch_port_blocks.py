"""Port vs JAX package: one Turtle block of each kind on the serving path,
against ``attn_block_apply`` with kernels='xla' (CPU, float64 and float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import close, numpy_tree_like, t, to_jnp
from turtlevsr_tpu.core import cache as jcache
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu_torch.core import cache as tcache
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.models import blocks as TB

torch.set_num_threads(1)
ATOL64 = 1e-9  # the bar of tests/test_model_parity.py
# float32: a block is some 10 chained roundings on values of order 10
ATOL32 = 5e-5


def _specs(attn, ffw, dim=8, heads=2, bias=False, ln_bias=True):
    common = dict(attn_type=attn, ffw_type=ffw, dim=dim, num_heads=heads,
                  ffn_expansion_factor=2.5, bias=bias,
                  layernorm_bias=ln_bias, num_frames_tocache=2)
    return JB.BlockSpec(kernels="xla", **common), TB.BlockSpec(**common)


def _pair(attn, ffw, seed, **kw):
    jspec, tspec = _specs(attn, ffw, **kw)
    rng = np.random.RandomState(seed)
    tree = numpy_tree_like(
        JB.attn_block_init(jax.random.PRNGKey(0), jspec), rng)
    block = TB.TurtleAttnBlock(tspec).double().eval()
    load_jax_params(block, tree)
    return jspec, tree, block, rng


@pytest.mark.parametrize("attn,ffw", [("ReducedAttn", "FFW"),
                                      ("ReducedAttn", "GFFW"),
                                      ("Channel", "GFFW")])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias",
                                                        "BiasFree"])
def test_cacheless_block_float64(attn, ffw, bias, ln_bias):
    jspec, tree, block, rng = _pair(attn, ffw, 0, bias=bias, ln_bias=ln_bias)
    x = rng.standard_normal((2, 9, 13, 8))  # not a multiple of any tile
    want, slot = JB.attn_block_apply(to_jnp(tree, jnp.float64),
                                     jnp.asarray(x), jspec, None)
    with torch.inference_mode():
        got, tslot = block(t(x), None)
    assert slot is None and tslot is None
    close(got, want, ATOL64)


@pytest.mark.parametrize("attn,ffw", [("ReducedAttn", "FFW"),
                                      ("Channel", "GFFW"), ("FHR", "GFFW")])
def test_block_float32(attn, ffw):
    jspec, tree, block, rng = _pair(attn, ffw, 1)
    block = block.float()
    x = rng.standard_normal((1, 8, 16, 8))
    want, _ = JB.attn_block_apply(to_jnp(tree, jnp.float32),
                                  jnp.asarray(x, jnp.float32), jspec, None)
    with torch.inference_mode():
        got, _ = block(t(x, torch.float32), None)
    assert got.dtype == torch.float32
    close(got, want, ATOL32)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_fhr_block_with_slot_float64(heads):
    """FHR + GFFW over 4 frames with a 2-frame ring: the history is read,
    masked while it fills, and overwritten once it wraps."""
    jspec, tree, block, rng = _pair("FHR", "GFFW", 2, heads=heads)
    b, h, w, c, n_frames = 1, 6, 7, 8, 2
    ctok = c // heads
    jslot = jcache.fhr_slot_init(b, heads, n_frames, ctok, h * w, jnp.float64)
    tslot = tcache.fhr_slot_init(b, heads, n_frames, ctok, h * w,
                                 torch.float64, device="cpu")
    jp = to_jnp(tree, jnp.float64)
    for _ in range(4):
        x = rng.standard_normal((b, h, w, c))
        want, jslot = JB.attn_block_apply(jp, jnp.asarray(x), jspec, jslot)
        with torch.inference_mode():
            got, tslot = block(t(x), tslot)
        close(got, want, ATOL64)
        close(tslot["k"], jslot["k"], ATOL64)
        close(tslot["v"], jslot["v"], ATOL64)
        assert int(tslot["n"]) == int(jslot["n"])


def test_zero_scales_leave_the_residual():
    """gamma = beta = 0 (the initial values): a ReducedAttn+FFW block is the
    identity, which is why the other tests draw them."""
    _, tspec = _specs("ReducedAttn", "FFW")
    block = TB.TurtleAttnBlock(tspec).double().eval()
    x = t(np.random.RandomState(3).standard_normal((1, 8, 8, 8)))
    with torch.inference_mode():
        got, _ = block(x, None)
    close(got, x.numpy(), 1e-12)


def test_kernel_weights_follow_parameter_updates():
    jspec, tree, block, rng = _pair("Channel", "GFFW", 4)
    x = t(rng.standard_normal((1, 8, 8, 8)))
    with torch.inference_mode():
        before, _ = block(x, None)
        block.ffn.project_out.weight.mul_(2.0)
        after, _ = block(x, None)
    assert (before - after).abs().max() > 1e-3
    tree["ffn"]["project_out"]["weight"] = (
        tree["ffn"]["project_out"]["weight"] * 2.0)
    want, _ = JB.attn_block_apply(to_jnp(tree, jnp.float64),
                                  jnp.asarray(x.numpy()), jspec, None)
    close(after, want, ATOL64)


@pytest.mark.parametrize("attn,ffw", [("NoAttn", "GFFW"), ("Channel", "FFW"),
                                      ("FHR", "FFW"), ("CHM", "FFW")])
def test_unported_blocks_raise_at_build_time(attn, ffw):
    _, tspec = _specs(attn, ffw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TB.TurtleAttnBlock(tspec)
