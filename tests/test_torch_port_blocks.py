"""Port vs JAX package: one Turtle block of each kind on the serving path,
against ``attn_block_apply`` with kernels='xla' (CPU, float64 and float32),
the blocks that end in the pointwise FFW also against the fused route in
interpret mode."""

import dataclasses

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
    """Every block type of the option files is ported now: these four build;
    what raises when a block is built is a type the option files do not
    know. The test keeps the name it had while these four raised (their
    parity cases are `test_ffw_and_noattn_blocks_float64` and its neighbours)."""
    _, tspec = _specs(attn, ffw)
    block = TB.TurtleAttnBlock(tspec)
    assert (block.attn is None) == (attn == "NoAttn")
    with pytest.raises(ValueError, match="unknown attention type"):
        TB.TurtleAttnBlock(dataclasses.replace(tspec, attn_type="Window"))
    with pytest.raises(ValueError, match="unknown FFW type"):
        TB.TurtleAttnBlock(dataclasses.replace(tspec, ffw_type="MLP"))


# ---------------------------------------------------------------------------
# blocks without attention, and attention followed by the pointwise FFW (the
# FFN pass without a depthwise stage)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn,ffw", [("NoAttn", "GFFW"), ("NoAttn", "FFW"),
                                      ("Channel", "FFW"), ("FHR", "FFW")])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias",
                                                        "BiasFree"])
def test_ffw_and_noattn_blocks_float64(attn, ffw, bias, ln_bias):
    jspec, tree, block, rng = _pair(attn, ffw, 5, bias=bias, ln_bias=ln_bias)
    x = rng.standard_normal((2, 9, 13, 8))
    want, _ = JB.attn_block_apply(to_jnp(tree, jnp.float64), jnp.asarray(x),
                                  jspec, None)
    with torch.inference_mode():
        got, tslot = block(t(x), None)
    assert tslot is None
    close(got, want, ATOL64)


@pytest.mark.parametrize("attn,ffw", [("NoAttn", "FFW"), ("Channel", "FFW")])
def test_ffw_blocks_match_the_fused_route_interpret_float32(attn, ffw):
    """kernels='pallas' in interpret mode: `_fused_ffn_half` with FFW reaches
    the Pallas kernel's branch without a depthwise stage (W % 8 == 0)."""
    jspec, tree, block, rng = _pair(attn, ffw, 6, dim=16)
    block = block.float()
    jspec = dataclasses.replace(jspec, kernels="pallas")
    x = rng.standard_normal((1, 8, 16, 16)).astype(np.float32)
    want, _ = JB.attn_block_apply(to_jnp(tree, jnp.float32), jnp.asarray(x),
                                  jspec, None)
    with torch.inference_mode():
        got, _ = block(t(x, torch.float32), None)
    close(got, want, ATOL32)


@pytest.mark.parametrize("heads", [1, 2])
def test_fhr_ffw_block_with_slot_float64(heads):
    jspec, tree, block, rng = _pair("FHR", "FFW", 7, heads=heads)
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


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_chm_ffw_block_four_frames_float64(bias):
    """CHM + FFW with a 2-frame ring: the folded route's per-map matrices
    (bias-free) and the unfolded route's projected map both enter the FFW
    pass as its attention branch."""
    jspec, tspec = _specs("CHM", "FFW", bias=bias)
    jspec = dataclasses.replace(jspec, scale_patchsize=2)
    tspec = dataclasses.replace(tspec, scale_patchsize=2)
    rng = np.random.RandomState(8)
    tree = numpy_tree_like(
        JB.attn_block_init(jax.random.PRNGKey(0), jspec), rng)
    block = TB.TurtleAttnBlock(tspec).double().eval()
    load_jax_params(block, tree)
    b, h, w, c, ws = 2, 8, 12, 8, 4
    hw = (h // ws) * (w // ws)
    jslot = jcache.sab_slot_init(b, 2, hw, 2 * c, hw, ws * ws * c,
                                 jnp.float64)
    tslot = tcache.sab_slot_init(b, 2, hw, 2 * c, hw, ws * ws * c,
                                 torch.float64, device="cpu")
    jp = to_jnp(tree, jnp.float64)
    for _ in range(4):
        x = rng.standard_normal((b, h, w, c))
        want, jslot = JB.attn_block_apply(jp, jnp.asarray(x), jspec, jslot)
        with torch.inference_mode():
            got, tslot = block(t(x), tslot)
        close(got, want, ATOL64)
        close(tslot["v"], jslot["v"], ATOL64)


def test_ffw_level_in_a_model_float64():
    """The tiny model with enc3's FFN set to FFW (the shape of
    `gopro_enc3_ffw`) through both packages."""
    from reference_oracle import tiny_opt
    from turtlevsr_tpu.config.options import (
        model_config_from_options as j_config,
    )
    from turtlevsr_tpu.models import turtle as JT
    from turtlevsr_tpu_torch.models import build_model

    opt = tiny_opt(encoder3_ffw_type="FFW")
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(9))
    model = build_model(opt, device="cpu", dtype=torch.float64)
    load_jax_params(model, tree)
    rng = np.random.RandomState(10)
    jc, tc = JT.init_cache(jcfg, 1, 32, 32, jnp.float64), model.init_cache(
        1, 32, 32)
    jp = to_jnp(tree, jnp.float64)
    for _ in range(3):
        pair = rng.rand(1, 2, 32, 32, 3)
        want, jc = JT.forward(jp, jcfg, jnp.asarray(pair), jc)
        with torch.inference_mode():
            got, tc = model(t(pair), tc)
        close(got, want, ATOL64)


# ---------------------------------------------------------------------------
# the fused plan of a CHM block: attention @ v and the merge in one call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_chm_block_with_attn_v_merge_equals_the_split_route(bias, monkeypatch):
    _, tspec = _specs("CHM", "GFFW", bias=bias)
    tspec = dataclasses.replace(tspec, scale_patchsize=2)
    split = TB.TurtleAttnBlock(tspec).double().eval()
    fused = TB.TurtleAttnBlock(tspec, fuse=("attn_v_merge",)).double().eval()
    rng = np.random.RandomState(11)
    with torch.no_grad():
        for p in split.parameters():
            p.copy_(t(rng.standard_normal(tuple(p.shape)) * 0.3 + (
                1.0 if p.dim() == 1 else 0.0)))
    fused.load_state_dict(split.state_dict())
    calls = {"merge": 0, "lattice": 0}
    real_merge, real_lattice = TB.sab_attn_v_merge, TB.lattice_merge
    monkeypatch.setattr(TB, "sab_attn_v_merge", lambda *a, **k: (
        calls.__setitem__("merge", calls["merge"] + 1), real_merge(*a, **k))[1])
    monkeypatch.setattr(TB, "lattice_merge", lambda *a, **k: (
        calls.__setitem__("lattice", calls["lattice"] + 1),
        real_lattice(*a, **k))[1])
    b, h, w, c, ws = 2, 8, 12, 8, 4
    hw = (h // ws) * (w // ws)
    s0 = tcache.sab_slot_init(b, 2, hw, 2 * c, hw, ws * ws * c, torch.float64,
                              device="cpu")
    s1 = tcache.sab_slot_init(b, 2, hw, 2 * c, hw, ws * ws * c, torch.float64,
                              device="cpu")
    for i in range(4):
        x = t(rng.standard_normal((b, h, w, c)))
        with torch.inference_mode():
            want, s0 = split(x, s0)
            assert calls == {"merge": i, "lattice": i + 1}
            got, s1 = fused(x, s1)
        assert calls == {"merge": i + 1, "lattice": i + 1}
        close(got, want.numpy(), 1e-12)
        close(s1["v"], s0["v"].numpy(), 0)
