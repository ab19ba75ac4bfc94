"""Port vs JAX package: the t0 family (Turtle_arch: deraining, desnowing) and
the SR family (Turtlesuper_t1_arch: x4 video super-resolution) on the CPU,
where the port runs its plain versions. Tiny models, weights and inputs made
with numpy from a seed and handed to both packages; float64 at 1e-9, the
engines' float32 overlap-add at the float32 tolerance of the tiled tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reference_oracle import tiny_opt
from torch_port_util import close, numpy_tree_like, t, to_jnp
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.core import cache as jcache
from turtlevsr_tpu.eval import engine as JE
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu.ops import resize as JR
from turtlevsr_tpu_torch.core import cache as tcache
from turtlevsr_tpu_torch.eval import engine as TE
from turtlevsr_tpu_torch.io.torch_convert import (
    jax_tree_from_model,
    load_jax_params,
)
from turtlevsr_tpu_torch.models import blocks as TB
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.ops import resize as TR

torch.set_num_threads(1)
ATOL64 = 1e-9  # the bar of tests/test_model_parity.py
# the engines return float32 frames; tiled ones overlap-add in float32
ATOL_ENGINE = 2e-6
N_FRAMES = 5  # num_frames_tocache is 2 in the tiny model: the rings wrap
MODELS = {"t0": "Turtle_arch", "sr": "Turtlesuper_t1_arch"}


def _models(seed, variant, dtype=torch.float64, fuse=(), **overrides):
    opt = tiny_opt(model=MODELS[variant], **overrides)
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(seed))
    model = build_model(opt, device="cpu", dtype=dtype, fuse=fuse)
    load_jax_params(model, tree)
    return jcfg, tree, model


def _check_cache(tc, jc, atol):
    """The slots field by field: shapes, values, counts."""
    assert len(tc) == len(jc) == 8
    for ts, js in zip(tc, jc):
        assert (ts is None) == (js is None)
        if ts is None:
            continue
        for f in ("k", "v"):
            assert tuple(ts[f].shape) == tuple(js[f].shape), f
            close(ts[f], js[f], atol)
        assert int(ts["n"]) == int(js["n"])


@pytest.mark.parametrize("variant,hw", [
    ("t0", (32, 64)), ("t0", (40, 52)), ("sr", (8, 16)), ("sr", (10, 13))],
    ids=["t0_32x64", "t0_40x52_padded", "sr_8x16", "sr_10x13_padded"])
def test_forward_five_frames_float64(variant, hw):
    """Five cache-threaded frames (the 2-frame rings wrap) through both
    packages' forward. SR: the output is (4H, 4W); t0: the SAB slots keep a
    vestigial zero K field."""
    h, w = hw
    jcfg, tree, model = _models(0, variant)
    jp = to_jnp(tree, jnp.float64)
    frames = np.random.RandomState(1).rand(N_FRAMES + 1, 1, h, w, 3)
    jc = JT.init_cache(jcfg, 1, h, w, jnp.float64)
    tc = model.init_cache(1, h, w)
    jstep = jax.jit(lambda p, x, c: JT.forward(p, jcfg, x, c))
    s = 4 if variant == "sr" else 1
    for i in range(N_FRAMES):
        pair = np.stack([frames[i], frames[i + 1]], axis=1)
        want, jc = jstep(jp, jnp.asarray(pair), jc)
        with torch.inference_mode():
            got, tc = model(t(pair), tc)
        assert got.shape == (1, s * h, s * w, 3)
        close(got, want, ATOL64)
        _check_cache(tc, jc, ATOL64)
    assert int(tc[7]["n"]) == N_FRAMES
    if variant == "t0":
        for i in (5, 6, 7):
            assert tuple(tc[i]["k"].shape) == (1, 2, 8, 8)
            assert not tc[i]["k"].any()


@pytest.mark.parametrize("variant", ["t0", "sr"])
def test_use_both_input_float64(variant):
    """The previous frame enters the model too (x4 upsampled for SR)."""
    jcfg, tree, model = _models(2, variant, use_both_input=True,
                                LayerNorm_type="BiasFree")
    h, w = (8, 8) if variant == "sr" else (32, 32)
    pair = np.random.RandomState(3).rand(1, 2, h, w, 3)
    want, _ = JT.forward(to_jnp(tree, jnp.float64), jcfg, jnp.asarray(pair),
                         JT.init_cache(jcfg, 1, h, w, jnp.float64))
    with torch.inference_mode():
        got, _ = model(t(pair), model.init_cache(1, h, w))
    close(got, want, ATOL64)


def _t0_block(seed, bias, ln_bias=True, heads=2, dim=8, patch=2, ring=3):
    common = dict(attn_type="CHM", ffw_type="GFFW", dim=dim, num_heads=heads,
                  ffn_expansion_factor=2.5, bias=bias, layernorm_bias=ln_bias,
                  num_frames_tocache=ring, scale_patchsize=patch,
                  variant="t0")
    jspec = JB.BlockSpec(kernels="xla", **common)
    tree = numpy_tree_like(JB.attn_block_init(jax.random.PRNGKey(0), jspec),
                           np.random.RandomState(seed))
    block = TB.TurtleAttnBlock(TB.BlockSpec(**common)).double().eval()
    load_jax_params(block, tree)
    return jspec, tree, block


@pytest.mark.parametrize("bias,ln_bias", [(False, True), (True, True),
                                          (False, False)],
                         ids=["nobias", "bias", "ln_biasfree"])
def test_t0_chm_block_five_frames_float64(bias, ln_bias):
    """The t0 CHM block over 5 frames with a 3-frame ring: the aligned
    frames are the stored windowed values (the scores are dead code), the K
    field stays a zero buffer. bias=True takes the unfolded route."""
    jspec, tree, block = _t0_block(0, bias, ln_bias)
    b, h, w, c, ws, ring = 2, 8, 12, 8, 4, 3
    hw = (h // ws) * (w // ws)
    jslot = jcache.sab_slot_init(b, ring, 8, 8, hw, ws * ws * c, jnp.float64)
    tslot = tcache.sab_slot_init(b, ring, 8, 8, hw, ws * ws * c,
                                 torch.float64, device="cpu")
    jp = to_jnp(tree, jnp.float64)
    rng = np.random.RandomState(4)
    for i in range(5):
        x = rng.standard_normal((b, h, w, c))
        want, jslot = JB.attn_block_apply(jp, jnp.asarray(x), jspec, jslot)
        with torch.inference_mode():
            got, tslot = block(t(x), tslot)
        close(got, want, ATOL64)
        close(tslot["v"], jslot["v"], ATOL64)
        assert not tslot["k"].any()
        assert int(tslot["n"]) == int(jslot["n"]) == i + 1
    # no slot: the current frame alone
    x = rng.standard_normal((1, h, w, c))
    want, _ = JB.attn_block_apply(jp, jnp.asarray(x), jspec, None)
    with torch.inference_mode():
        got, none = block(t(x), None)
    assert none is None
    close(got, want, ATOL64)


def test_sab_slot_append_v_leaves_k_and_wraps():
    slot = tcache.sab_slot_init(1, 3, 8, 8, 4, 6, torch.float64,
                                device="cpu")
    for i in range(5):
        slot = tcache.sab_slot_append_v(slot, torch.full((1, 4, 6), i + 1.0))
    assert int(slot["n"]) == 5 and not slot["k"].any()
    # positions 0, 1, 2 hold frames 4, 5, 3 (ring position = n % 3)
    assert slot["v"][0, :, 0, 0].tolist() == [4.0, 5.0, 3.0]


# ---------------------------------------------------------------------------
# the resizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((2, 7, 9, 3), 4), ((1, 5, 6, 4), 2),
                                         ((1, 1, 3, 2), 4)])
def test_upsample_bilinear_matches_jax_and_interpolate(shape, scale):
    x = np.random.RandomState(5).rand(*shape)
    got = TR.upsample_bilinear(t(x), scale)
    close(got, JR.upsample_bilinear(jnp.asarray(x), scale), ATOL64)
    lib = F.interpolate(t(x).permute(0, 3, 1, 2), scale_factor=scale,
                        mode="bilinear", align_corners=False)
    close(got, lib.permute(0, 2, 3, 1), ATOL64)


@pytest.mark.parametrize("shape,out", [((2, 16, 20, 3), (4, 5)),
                                       ((1, 13, 9, 2), (3, 2)),
                                       ((1, 6, 7, 3), (15, 11)),
                                       ((1, 32, 32, 3), (8, 8))])
def test_resize_bicubic_matches_jax_and_interpolate(shape, out):
    x = np.random.RandomState(6).rand(*shape)
    got = TR.resize_bicubic(t(x), *out)
    assert got.shape == (shape[0], *out, shape[3])
    close(got, JR.resize_bicubic(jnp.asarray(x), *out), ATOL64)
    lib = F.interpolate(t(x).permute(0, 3, 1, 2), size=out, mode="bicubic",
                        align_corners=False)
    close(got, lib.permute(0, 2, 3, 1), ATOL64)


def test_resizers_sum_in_float32_and_round_once():
    """bfloat16 maps: the products run in float32, one rounding at the
    end."""
    x = torch.rand(1, 8, 12, 3).bfloat16()
    got = TR.resize_bicubic(x, 2, 3)
    assert got.dtype == torch.bfloat16
    want = TR.resize_bicubic(x.float(), 2, 3).bfloat16()
    assert torch.equal(got, want)
    assert np.array_equal(TR._resize_matrix(4, 16, "linear"),
                          JR._resize_matrix(4, 16, "linear"))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["whole", "tiled"])
def test_sr_engines_five_frames(mode):
    """SR: high-resolution frames in, each frame (whole) or each tile of the
    grid planned on the high-resolution frame (tiled) resized bicubic /4 on
    the device, caches at the low resolution, the x4 output at the input's
    resolution. 40 x 56 frames; tiles of 32 (8 at the model's input), overlap
    8: 2 x 2 tiles in chunks of 3 + 1."""
    jcfg, tree, model = _models(7, "sr")
    kw = dict(mode=mode, tile=32, tile_overlap=8, max_tile_batch=3)
    jeng = JE.InferenceEngine(jcfg, to_jnp(tree, jnp.float64),
                              dtype=jnp.float64, **kw)
    teng = TE.InferenceEngine(model, dtype=torch.float64, device="cpu", **kw)
    frames = np.random.RandomState(8).rand(N_FRAMES, 40, 56, 3).astype(
        np.float32)
    for fr in frames:
        want, got = jeng.step(fr), teng.step(fr)
        assert got.shape == (40, 56, 3)
        close(got, want, ATOL_ENGINE if mode == "tiled" else 1e-6)
    for ts, js in zip(teng._cache, jeng._cache):
        if ts is not None:  # the caches are at the low resolution
            assert ts["k"].shape[0] == (4 if mode == "tiled" else 1)
            close(ts["v"], js["v"], ATOL64)
            assert int(ts["n"]) == N_FRAMES
    # dec1's slot, a window of 16: 8 x 8 model tiles upsampled to 32 x 32,
    # or 10 x 14 frames upsampled to 40 x 56 and padded to 64 x 64
    want_hw = (32 // 16) ** 2 if mode == "tiled" else (64 // 16) ** 2
    assert teng._cache[7]["v"].shape[2] == want_hw


def test_t0_tiled_engines_five_frames():
    jcfg, tree, model = _models(9, "t0")
    kw = dict(mode="tiled", tile=32, tile_overlap=8, max_tile_batch=4)
    jeng = JE.InferenceEngine(jcfg, to_jnp(tree, jnp.float64),
                              dtype=jnp.float64, **kw)
    teng = TE.InferenceEngine(model, dtype=torch.float64, device="cpu", **kw)
    frames = np.random.RandomState(10).rand(N_FRAMES, 50, 70, 3).astype(
        np.float32)
    for fr in frames:
        close(teng.step(fr), jeng.step(fr), ATOL_ENGINE)
    for ts, js in zip(teng._cache, jeng._cache):
        if ts is not None:
            assert ts["k"].shape == js["k"].shape
            close(ts["v"], js["v"], ATOL64)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["t0", "sr"])
def test_param_tree_round_trip_and_strict_state_dict(variant):
    """The JAX tree of either family round-trips, the t0 SAB's unused
    parameters (qk, q2, k2, their dwconvs, temperature) included, and a
    reference-named state dict loads with strict=True."""
    _, tree, model = _models(11, variant)
    back = jax_tree_from_model(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        close(b, a, 0)
    sd = model.state_dict()
    sab = "decoder_level1.transformer_blocks.0.attn.spatial_aligner."
    for name in ("temperature", "qk.weight", "qk_dwconv.weight", "q2.weight",
                 "q2_dwconv.weight", "k2.weight", "k2_dwconv.weight",
                 "v.weight", "v_dwconv.weight", "project_out.weight"):
        assert sab + name in sd, name
    fresh = build_model(tiny_opt(model=MODELS[variant]), device="cpu",
                        dtype=torch.float64)
    fresh.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError):
        fresh.load_state_dict({k: v for k, v in sd.items()
                               if "spatial_aligner.q2." not in k},
                              strict=True)


# ---------------------------------------------------------------------------
# the command line: --task derain | sr, dry runs on the CPU at a tiny size
# ---------------------------------------------------------------------------

# dim 16 and pairs of blocks: the conv-only levels take the two-stage plan
TINY_CLI = dict(dim=16, Enc_blocks=[2, 3, 2], num_refinement_blocks=2)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """data/{blur,gt}/video0/0000i.png (40 x 56, the high-resolution frames
    for SR) and tiny option files of the t0 and SR families."""
    import yaml
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_cli_t0_sr")
    rng = np.random.RandomState(12)
    for i in range(3):
        gt = rng.randint(0, 256, (40, 56, 3), dtype=np.uint8)
        deg = np.clip(gt.astype(np.int32) + rng.randint(-20, 21, gt.shape), 0,
                      255).astype(np.uint8)
        for side, img in (("gt", gt), ("blur", deg)):
            d = root / "data" / side / "video0"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(d / f"{i:05d}.png")
    for variant, model in MODELS.items():
        with open(root / f"tiny_{variant}.yml", "w") as f:
            yaml.safe_dump(tiny_opt(model=model, **TINY_CLI), f)
    return root


@pytest.mark.parametrize("tile", [0, 32], ids=["whole", "tiled"])
@pytest.mark.parametrize("task", ["derain", "sr"])
def test_cli_task_dry_run_on_the_cpu(cli_dir, capsys, task, tile):
    """python -m turtlevsr_tpu_torch.cli.infer --task derain|sr --device cpu
    on a tiny model of the task's family: the frames stream, the metrics
    compare the output with the ground truth at the input's resolution (SR:
    the high-resolution frames), and the two_stage plan gives the same
    frames as the split plan."""
    from PIL import Image

    from turtlevsr_tpu_torch.cli import infer as TI

    variant = "sr" if task == "sr" else "t0"
    res = {}
    for fuse in ([], ["two_stage"]):
        save = cli_dir / f"out_{task}_{tile}_{len(fuse)}"
        argv = ["--task", task, "-opt", str(cli_dir / f"tiny_{variant}.yml"),
                "--data_dir", str(cli_dir / "data" / "blur"), "--device",
                "cpu", "--dtype", "float32", "--max_frames", "2",
                "--save_path", str(save), "--tile", str(tile),
                "--tile_overlap", "8"]
        if fuse:
            argv += ["--fuse", *fuse]
        res[len(fuse)] = TI.main(argv)
        out = capsys.readouterr().out
        assert res[len(fuse)]["frames"] == 2
        assert "Overall PSNR" in out
        pred = np.asarray(Image.open(save / "model" / "video0" /
                                     "Frame_1_Pred.png"))
        assert pred.shape == (40, 56, 3)
    assert res[0]["psnr"] == res[1]["psnr"]
    assert all(np.isfinite(res[0]["psnr"]))
