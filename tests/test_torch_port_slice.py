"""Port vs JAX package: the serving slices as a whole, tiny models shaped
like `gopro` (CHM blocks end the decoder levels) and `gopro_t1_fhr` (Channel
blocks there) on the CPU (the port runs its plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import close, numpy_tree_like, t, tiny_fhr_opt, to_jnp
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.eval.engine import InferenceEngine as JEngine
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu_torch.eval.engine import InferenceEngine as TEngine
from turtlevsr_tpu_torch.io.torch_convert import (
    jax_tree_from_model,
    load_jax_params,
)
from turtlevsr_tpu_torch.models import build_model

torch.set_num_threads(1)
ATOL64 = 1e-9  # the bar of tests/test_model_parity.py
# float32 through 11 blocks and 8 convs, values of order 1..10
ATOL32 = 2e-4
N_FRAMES = 5  # num_frames_tocache is 2 in the tiny model: the ring wraps


def _models(seed, dtype=torch.float64, make_opt=tiny_fhr_opt, **overrides):
    opt = make_opt(**overrides)
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(seed))
    model = build_model(opt, device="cpu", dtype=dtype)
    load_jax_params(model, tree)
    return jcfg, tree, model


def _check_cache(tcache, jcache, atol):
    assert len(tcache) == len(jcache) == 8
    for ts, js in zip(tcache, jcache):
        assert (ts is None) == (js is None)
        if ts is not None:
            assert tuple(ts["k"].shape) == tuple(js["k"].shape)
            close(ts["k"], js["k"], atol)
            close(ts["v"], js["v"], atol)
            assert int(ts["n"]) == int(js["n"])


@pytest.mark.parametrize("hw", [(32, 64), (40, 52)],
                         ids=["32x64", "40x52_padded"])
def test_forward_five_frames_float64(hw):
    h, w = hw
    jcfg, tree, model = _models(0)
    jp = to_jnp(tree, jnp.float64)
    rng = np.random.RandomState(1)
    frames = rng.rand(N_FRAMES + 1, 1, h, w, 3)
    jcache = JT.init_cache(jcfg, 1, h, w, jnp.float64)
    tcache = model.init_cache(1, h, w)
    assert [s is None for s in tcache] == [True, True, True, False, False,
                                           True, True, True]
    jstep = jax.jit(lambda p, x, c: JT.forward(p, jcfg, x, c))
    for i in range(N_FRAMES):
        pair = np.stack([frames[i], frames[i + 1]], axis=1)  # (1, 2, H, W, 3)
        want, jcache = jstep(jp, jnp.asarray(pair), jcache)
        with torch.inference_mode():
            got, tcache = model(t(pair), tcache)
        assert got.shape == (1, h, w, 3)
        close(got, want, ATOL64)
        _check_cache(tcache, jcache, ATOL64)
    assert int(tcache[3]["n"]) == N_FRAMES


def test_forward_float32():
    jcfg, tree, model = _models(2, dtype=torch.float32)
    jp = to_jnp(tree, jnp.float32)
    rng = np.random.RandomState(3)
    jcache = JT.init_cache(jcfg, 1, 32, 32, jnp.float32)
    tcache = model.init_cache(1, 32, 32)
    for _ in range(3):
        pair = rng.rand(1, 2, 32, 32, 3).astype(np.float32)
        want, jcache = JT.forward(jp, jcfg, jnp.asarray(pair), jcache)
        with torch.inference_mode():
            got, tcache = model(t(pair, torch.float32), tcache)
        assert got.dtype == torch.float32
        close(got, want, ATOL32)
        _check_cache(tcache, jcache, ATOL32)


def test_use_both_input_and_layernorm_biasfree():
    jcfg, tree, model = _models(4, use_both_input=True,
                                LayerNorm_type="BiasFree")
    pair = np.random.RandomState(5).rand(1, 2, 32, 32, 3)
    want, _ = JT.forward(to_jnp(tree, jnp.float64), jcfg, jnp.asarray(pair),
                         JT.init_cache(jcfg, 1, 32, 32, jnp.float64))
    with torch.inference_mode():
        got, _ = model(t(pair), model.init_cache(1, 32, 32))
    close(got, want, ATOL64)


@pytest.mark.parametrize("dtype,atol", [("float64", ATOL64),
                                        ("float32", ATOL32)])
def test_both_engines_five_frames(dtype, atol):
    """Frames through both InferenceEngines (whole mode), caches threaded
    inside; first frame uses prev = cur; reset starts a new video."""
    jcfg, tree, model = _models(6)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    jeng = JEngine(jcfg, to_jnp(tree, jnp.float64), mode="whole", dtype=jd)
    teng = TEngine(model, mode="whole", dtype=td, device="cpu")
    frames = np.random.RandomState(7).rand(N_FRAMES, 40, 52, 3).astype(
        np.float32)
    first = None
    for i, fr in enumerate(frames):
        want = jeng.step(fr)
        got = teng.step(fr)
        assert got.shape == (40, 52, 3) and got.dtype == np.float32
        close(got, want, atol if dtype == "float32" else 1e-6)
        first = got if i == 0 else first
    _check_cache(teng._cache, jeng._cache, atol)
    dev = teng.step_async(frames[0])
    assert isinstance(dev, torch.Tensor) and dev.dtype == td
    teng.reset()
    close(teng.step(frames[0]), first, 0)


def test_param_tree_round_trip():
    _, tree, model = _models(8)
    back = jax_tree_from_model(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape
        close(b, a, 0)
    fresh = build_model(tiny_fhr_opt(), device="cpu", dtype=torch.float64)
    load_jax_params(fresh, back)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  fresh.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_load_jax_params_is_strict():
    _, tree, model = _models(9)
    extra = dict(tree, bogus={"weight": np.zeros(3)})
    with pytest.raises(ValueError, match="without a parameter"):
        load_jax_params(model, extra)
    missing = {k: v for k, v in tree.items() if k != "ending"}
    with pytest.raises(ValueError, match="without a leaf"):
        load_jax_params(model, missing)
    bad = dict(tree, ending={"weight": np.zeros((3, 3, 4, 3)),
                             "bias": tree["ending"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad)


def test_state_dict_names_are_the_reference_modules():
    model = build_model(tiny_fhr_opt(), device="cpu")
    keys = set(model.state_dict())
    for k in ("input_projection.weight", "down1_2.body.0.weight",
              "up4_3.body.0.weight", "reduce_chan_level3.weight",
              "ending.bias", "latent.transformer_blocks.0.attn.temperature",
              "latent.transformer_blocks.0.attn.qkv_dwconv.weight",
              "encoder_level1.transformer_blocks.0.attn.beta",
              "encoder_level1.transformer_blocks.0.ffn.gamma",
              "refinement.transformer_blocks.0.ffn.project_in.weight",
              "decoder_level3.transformer_blocks.1.norm1.body.bias"):
        assert k in keys, k
    sd = model.state_dict()
    assert sd["encoder_level1.transformer_blocks.0.attn.beta"].shape == (
        1, 8, 1, 1)
    assert sd["input_projection.weight"].shape == (8, 3, 3, 3)  # OIHW


def test_init_params_statistics():
    g = torch.Generator().manual_seed(3)
    model = build_model(tiny_fhr_opt(), device="cpu", generator=g)
    blk = model.encoder_level1.transformer_blocks[0]
    assert blk.attn.beta.abs().max() == 0 and blk.ffn.gamma.abs().max() == 0
    assert torch.equal(blk.norm1.body.weight, torch.ones(8))
    w = model.up4_3.body[0].weight  # (128, 64, 3, 3): fan_in 576
    bound = 1 / np.sqrt(64 * 9)
    assert w.abs().max() <= bound
    assert abs(w.std().item() - bound / np.sqrt(3)) < 0.05 * bound
    again = build_model(tiny_fhr_opt(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, again.up4_3.body[0].weight)


# ---------------------------------------------------------------------------
# the shipped shape: CHM blocks end the decoder levels (`gopro`)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(32, 64), (40, 52)],
                         ids=["32x64", "40x52_padded"])
def test_chm_forward_five_frames_float64(hw):
    """The unchanged tiny_opt() through both packages, caches threaded: the
    SAB rings (2 frames) fill and wrap, the FHR ring too."""
    h, w = hw
    jcfg, tree, model = _models(10, make_opt=tiny_opt)
    jp = to_jnp(tree, jnp.float64)
    frames = np.random.RandomState(11).rand(N_FRAMES + 1, 1, h, w, 3)
    jcache = JT.init_cache(jcfg, 1, h, w, jnp.float64)
    tcache = model.init_cache(1, h, w)
    assert [s is None for s in tcache] == [True, True, True, False, False,
                                           False, False, False]
    jstep = jax.jit(lambda p, x, c: JT.forward(p, jcfg, x, c))
    for i in range(N_FRAMES):
        pair = np.stack([frames[i], frames[i + 1]], axis=1)
        want, jcache = jstep(jp, jnp.asarray(pair), jcache)
        with torch.inference_mode():
            got, tcache = model(t(pair), tcache)
        assert got.shape == (1, h, w, 3)
        close(got, want, ATOL64)
        _check_cache(tcache, jcache, ATOL64)
    assert int(tcache[7]["n"]) == N_FRAMES


@pytest.mark.parametrize("overrides", [
    dict(bias=True), dict(LayerNorm_type="BiasFree"),
    dict(num_frames_tocache=3)], ids=["bias", "BiasFree", "ring3"])
def test_chm_forward_option_variants_float64(overrides):
    jcfg, tree, model = _models(12, make_opt=tiny_opt, **overrides)
    jp = to_jnp(tree, jnp.float64)
    rng = np.random.RandomState(13)
    jcache = JT.init_cache(jcfg, 1, 32, 32, jnp.float64)
    tcache = model.init_cache(1, 32, 32)
    for _ in range(4):
        pair = rng.rand(1, 2, 32, 32, 3)
        want, jcache = JT.forward(jp, jcfg, jnp.asarray(pair), jcache)
        with torch.inference_mode():
            got, tcache = model(t(pair), tcache)
        close(got, want, ATOL64)
    _check_cache(tcache, jcache, ATOL64)


def test_chm_forward_float32():
    jcfg, tree, model = _models(14, dtype=torch.float32, make_opt=tiny_opt)
    jp = to_jnp(tree, jnp.float32)
    rng = np.random.RandomState(15)
    jcache = JT.init_cache(jcfg, 1, 32, 32, jnp.float32)
    tcache = model.init_cache(1, 32, 32)
    for _ in range(3):
        pair = rng.rand(1, 2, 32, 32, 3).astype(np.float32)
        want, jcache = JT.forward(jp, jcfg, jnp.asarray(pair), jcache)
        with torch.inference_mode():
            got, tcache = model(t(pair, torch.float32), tcache)
        close(got, want, ATOL32)


@pytest.mark.parametrize("dtype,atol", [("float64", ATOL64),
                                        ("float32", ATOL32)])
def test_chm_both_engines_five_frames(dtype, atol):
    jcfg, tree, model = _models(16, make_opt=tiny_opt)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    jeng = JEngine(jcfg, to_jnp(tree, jnp.float64), mode="whole", dtype=jd)
    teng = TEngine(model, mode="whole", dtype=td, device="cpu")
    frames = np.random.RandomState(17).rand(N_FRAMES, 40, 52, 3).astype(
        np.float32)
    for fr in frames:
        close(teng.step(fr), jeng.step(fr),
              atol if dtype == "float32" else 1e-6)
    _check_cache(teng._cache, jeng._cache, atol)


def test_chm_param_tree_strict_load_and_names():
    """load_jax_params is strict with the SAB and CHM names; the state-dict
    names are the reference's."""
    _, tree, model = _models(18, make_opt=tiny_opt)
    keys = set(model.state_dict())
    i1 = len(model.decoder_level1.transformer_blocks) - 1
    i3 = len(model.decoder_level3.transformer_blocks) - 1
    last = f"decoder_level1.transformer_blocks.{i1}.attn."
    for k in ("spatial_aligner.temperature", "spatial_aligner.qk.weight",
              "spatial_aligner.qk_dwconv.weight", "spatial_aligner.v.weight",
              "spatial_aligner.v_dwconv.weight", "spatial_aligner.k2.weight",
              "spatial_aligner.k2_dwconv.weight", "spatial_aligner.q2.weight",
              "spatial_aligner.q2_dwconv.weight",
              "spatial_aligner.project_out.weight", "ChanAttn.temperature",
              "ChanAttn.qkv.weight", "ChanAttn.qkv_dwconv.weight",
              "ChanAttn.project_out.weight", "kv.weight", "kv_dwconv.weight"):
        assert last + k in keys, k
    sd = model.state_dict()
    # the coarsest decoder level: window 4; the finest: window 16
    assert sd[f"decoder_level3.transformer_blocks.{i3}.attn.spatial_aligner."
              "k2_dwconv.weight"].shape[2:] == (4, 4)
    assert sd[last + "spatial_aligner.k2_dwconv.weight"].shape == (
        16, 1, 16, 16)
    back = jax_tree_from_model(model)
    fresh = build_model(tiny_opt(), device="cpu", dtype=torch.float64)
    load_jax_params(fresh, back)
    for (ka, va), (kb, vb) in zip(sd.items(), fresh.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    blocks = list(tree["decoder_level1"]["transformer_blocks"])
    pruned = {k: v for k, v in blocks[i1]["attn"].items() if k != "kv_dwconv"}
    blocks[i1] = dict(blocks[i1], attn=pruned)
    bad = dict(tree, decoder_level1={"transformer_blocks": blocks})
    with pytest.raises(ValueError, match="without a leaf"):
        load_jax_params(model, bad)
