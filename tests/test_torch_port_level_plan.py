"""Which body of the run kernel (row 14) each fused_channel_gffw_run launch
gets: csrc/level_wg.cu (the wgmma bodies of rows 3 and 1 as phases of one
cooperative persistent grid) for bf16 runs with 64 channels a head, C =
128, 256 or 512, E a multiple of 32 and one LayerNorm form in all blocks;
csrc/level.cu for every other run. Runs on the CPU: the plan by dtype,
width, heads, E and LayerNorm biases; the new body's shared memory mirror;
the weights the wrapper stacks for it, held against the blocks' dicts and
the JAX package's stacking axis; chip_smoke.py's launch table for the
fused-plan paths held against the runs the model makes and the plan."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import Maker, level_kernel_case
from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
# (B, H, W, C, heads, E): the runs of the shipped models at 15 tiles of 320
# (enc3 and dec3, the latent, dec2) and the latent of a whole 720p frame
SERVING_RUNS = {"enc3": (15, 80, 80, 256, 4, 640),
                "latent": (15, 40, 40, 512, 8, 1280),
                "dec2": (15, 160, 160, 128, 2, 320),
                "latent_whole": (1, 92, 160, 512, 8, 1280)}


def _plan(b, h, w, c, heads, e, dtype=BF16, ln_b=frozenset({(True, True)}),
          ch=None):
    return LV._level_plan(b, h, w, c, heads, e, 2 * e if ch is None else ch,
                          dtype, ln_b)


@pytest.mark.parametrize("run", list(SERVING_RUNS))
@pytest.mark.parametrize("ln_b", [(True, True), (False, False)],
                         ids=["WithBias", "BiasFree"])
def test_plan_sends_the_serving_runs_to_the_new_body(run, ln_b):
    b, h, w, c, heads, e = SERVING_RUNS[run]
    body, geo = _plan(b, h, w, c, heads, e, ln_b={ln_b})
    assert body == "wg"
    # the statistics body's grid on the same map: phase (a) splits the map as
    # the split route's row 3 launch does, so the partial rows are the same
    sw = K._sw_geometry(b, h, w, c, False, 132)
    assert (geo["blocks"], geo["rows"]) == (sw["blocks"], sw["rows"])
    assert geo["blocks"] == min(132, b * K._tiles(h, w))
    assert (geo["smem"], *geo["stages"]) == LV._lv_smem(c)


@pytest.mark.parametrize("change", ["float32", "c64", "c192", "c1024",
                                    "ctok32", "ctok128", "e_not_32",
                                    "ch_not_2e", "mixed_ln1_b",
                                    "mixed_ln2_b"])
def test_plan_keeps_the_other_runs_on_level_cu(change):
    args = dict(b=15, h=80, w=80, c=256, heads=4, e=640)
    assert _plan(**args)[0] == "wg"
    args.update({
        "float32": dict(dtype=torch.float32),
        "c64": dict(c=64, heads=1, e=160),
        "c192": dict(c=192, heads=3, e=480),
        "c1024": dict(c=1024, heads=16, e=2560),
        "ctok32": dict(heads=8),
        "ctok128": dict(heads=2),
        "e_not_32": dict(e=648),
        "ch_not_2e": dict(ch=1296),
        "mixed_ln1_b": dict(ln_b=frozenset({(True, True), (False, True)})),
        "mixed_ln2_b": dict(ln_b=frozenset({(False, False), (False, True)})),
    }[change])
    assert _plan(**args) == ("tile", None)


@pytest.mark.parametrize("c", [128, 256, 512])
def test_lv_smem_gives_each_phase_its_own_stages(c):
    """A region that holds either the statistics body's ring and its q and k
    tiles (2 x 64 x 64 bf16) or the FFN body's ring and its 64 x (64 + 8)
    bf16 activation chunk, then the fp32 hidden chunk (100 x 128) and the LN
    halo (100 x (C + 8) bf16) and two mbarriers a stage of either ring: each
    phase gets as many 16 KB stages as its own kernel, within 227 KB."""
    s_stats, s_ffn = K._sw_smem(c, False)[1], K._wg_smem(c, True)[1]
    assert (s_stats, s_ffn) == {128: (8, 8), 256: (6, 7), 512: (3, 4)}[c]
    region = max(s_stats * 16384 + 2 * 64 * 64 * 2,
                 s_ffn * 16384 + 64 * (64 + 8) * 2)
    smem = (1024 + region + 100 * 128 * 4 + 100 * (c + 8) * 2
            + 16 * (s_stats + s_ffn))
    assert LV._lv_smem(c) == (smem, s_stats, s_ffn)
    assert smem <= 232448


@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias",
                                                        "BiasFree"])
def test_stacked_weights_are_the_blocks_in_run_order(ln_bias):
    """Block i's weight at [i] of one (N, ...) tensor, along the first axis
    on which the JAX kernel stacks its weights (``jnp.stack(arrs, 0)``);
    LayerNorm biases that the blocks do not have stay absent."""
    _, blocks = level_kernel_case(Maker(3, torch.float32, "cpu"), 1, 8, 8,
                                  128, 320, 2, 3, ln_bias)
    for key in LV._BLOCK_KEYS:
        got = LV._stack(blocks, key)
        if blocks[0][key] is None:
            assert got is None and key in ("ln1_b", "ln2_b") and not ln_bias
            continue
        assert got.shape == (3, *blocks[0][key].shape) and got.is_contiguous()
        for i, blk in enumerate(blocks):
            assert torch.equal(got[i], blk[key])
        jax_stacked = np.asarray(jnp.stack(
            [jnp.asarray(blk[key].numpy()) for blk in blocks], 0))
        np.testing.assert_array_equal(got.numpy(), jax_stacked)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_runs(path, overrides, fuse, monkeypatch):
    """(shape of x, blocks, heads) of every run launch of one 64 x 64 frame of
    the model, on the CPU (the plan reads widths, not H and W)."""
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu", fuse=fuse)
    calls = []
    plain = TT.fused_channel_gffw_run

    def recorder(x, blocks, heads):
        calls.append((tuple(x.shape), blocks, heads))
        return plain(x, blocks, heads)

    monkeypatch.setattr(TT, "fused_channel_gffw_run", recorder)
    frames = torch.rand(1, 2, 64, 64, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, model.init_cache(1, 64, 64))
    return calls


@pytest.mark.parametrize("tag", ["gopro", "gopro_t1_fhr", "gopro_enc3_ffw",
                                 "gopro_fused", "gopro_two_stage", "derain",
                                 "derain_two_stage", "sr", "sr_two_stage"])
def test_chip_smoke_run_launches_are_the_plans(tag, monkeypatch):
    """chip_smoke.py's launches a model call of row 14: level_wg (4 under the
    fused plan: the runs of enc3, the latent, dec3 and dec2) and level.cu's
    (none on any path), as the plan gives them for the runs the model
    makes; 12 a tiled deblur frame (three model calls of 15 tiles)."""
    cs = _chip_smoke()
    want = cs.LAUNCHES_PER_CALL[tag]
    config = tag.split("_")[0] if tag.endswith(("_fused", "_two_stage")) \
        else tag
    fuse = {"fused": cs.FUSED_PLAN, "stage": cs.TWO_STAGE}.get(
        tag.rsplit("_", 1)[-1], ())
    if "channel_runs" not in fuse:
        assert want["level_run"] == want["level_wg"] == 0
        return
    path, overrides = cs.CONFIGS[config]
    calls = _record_runs(path, overrides, fuse, monkeypatch)
    bodies = []
    for (b, h, w, c), blocks, heads in calls:
        e, ch = blocks[0]["w2"].shape[0], blocks[0]["w1"].shape[1]
        ln_b = {(blk.get("ln1_b") is not None, blk.get("ln2_b") is not None)
                for blk in blocks}
        bodies.append(LV._level_plan(b, h, w, c, heads, e, ch, BF16,
                                     ln_b)[0])
        assert len(blocks) <= LV.MAX_RUN  # one launch a run
    assert [len(blocks) for _, blocks, _ in calls] == [
        n for *_, n in cs.RUN_LEVELS.values()]
    assert (len(calls), bodies.count("wg")) == (want["level_run"],
                                                want["level_wg"])
    assert bodies == ["wg"] * 4  # level.cu: no launch on any path
    assert want["level_wg"] * 3 == 12  # a tiled deblur frame: 3 model calls
