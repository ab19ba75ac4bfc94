"""Float32 serving on the card: every kernel call of one frame of each
shipped model at full width, in float32, is taken by a body of the card.

Runs on the CPU. Each shipped option file (gopro, derain, sr) builds at full
width and runs one frame of a small map in float32 (the calls' widths and
forms do not depend on H and W); every call of the five wrappers whose
float32 bodies widen to C = 256 and 512 (rows 1, 3, 4, 5 and 6), and of row
13 under ``two_stage``, is recorded and handed to its float32 plan
(kernels/ffn.py ``_ffn_f32_plan`` and the others, kernels/chain2.py
``_two_stage_f32_plan``, kernels/level.py ``_level_f32_plan``), mirrored
from each source's dispatch: every call is taken, in at most the shared
memory a block can have, with the LN halo in device memory at C = 512. The
frame runs under ``fuse=()``, ``two_stage`` and the full plan
(``channel_runs``, ``attn_v_merge``, ``two_stage``: rows 14, 11 and 13 in
float32). Row 14 takes float32 up to C = 512 and refuses wider maps with its
stated error. The wrappers' launch code passes its checks at C = 256 and 512
in float32 (the launch itself stubbed: there is no card here), and the
port's float32 engine holds the JAX package's float32 engine at a tiny
configuration, under ``fuse=()`` and under the full plan.
"""

import importlib.util
import os
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import (
    Maker,
    close,
    level_kernel_case,
    numpy_tree_like,
    to_jnp,
)
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.eval.engine import InferenceEngine as JEngine
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.eval.engine import InferenceEngine as TEngine
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as turtle_mod

SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100
# the shipped files: (option file, input side; the SR model takes
# low-resolution frames, x4 inside)
FILES = {"gopro": ("options/Turtle_Deblur_Gopro.yml", 64),
         "derain": ("options/Turtle_Derain.yml", 64),
         "sr": ("options/Turtle_SR_MVSR.yml", 16)}
WRAPPERS = ("fused_block_ffn", "fused_qkv_stats", "fused_ln_split_proj",
            "fused_conv3x3", "fused_chm_stats", "fused_two_stage",
            "fused_channel_gffw_run", "sab_attn_v_merge")
# every fused plan at once: rows 14, 11 and 13 on the path
FULL_PLAN = ("channel_runs", "attn_v_merge", "two_stage")
# each wrapper's launch counter (turtlevsr_tpu_torch.kernels.launch_counts)
COUNTERS = {"fused_block_ffn": "ffn", "fused_qkv_stats": "qkv_stats",
            "fused_ln_split_proj": "split_proj", "fused_conv3x3": "conv3x3",
            "fused_chm_stats": "chm_stats", "fused_two_stage": "two_stage",
            "fused_channel_gffw_run": "level_run",
            "sab_attn_v_merge": "attn_v_merge"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
# the bodies whose LN halo lives in device memory above C = 256 in float32
# (row 5's halo and two weight stages fit in shared memory at 512)
HALO_IN_DEVICE_MEMORY_AT_512 = ("fused_block_ffn", "fused_qkv_stats",
                                "fused_ln_split_proj", "fused_chm_stats",
                                "fused_channel_gffw_run")
# the port's float32 engine against the JAX package's, whole frames through
# the tiny model's blocks and convs in float32 (the tolerance of
# tests/test_torch_port_slice.py's float32 engines)
ATOL32 = 2e-4


def _record(path, side, fuse=()):
    """[(wrapper, args, kwargs)] of one float32 frame of the model the option
    file describes, under the fused plan ``fuse``."""
    opt = load_options(path, is_train=False)
    model = build_model(opt, device="cpu", dtype=torch.float32, fuse=fuse)
    calls = []
    saved = []
    for mod in (blocks_mod, turtle_mod):
        for name in WRAPPERS:
            if hasattr(mod, name):
                fn = getattr(mod, name)
                saved.append((mod, name, fn))

                def recorder(*args, _name=name, _fn=fn, **kw):
                    calls.append((_name, args, kw))
                    return _fn(*args, **kw)

                setattr(mod, name, recorder)
    try:
        cache = model.init_cache(1, side, side)
        frames = torch.rand(1, 2, side, side, 3,
                            generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            model(frames, cache)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def _f32_plan(name, args, kw):
    """The float32 plan's geometry of one recorded call (raises where its
    body does not take it)."""
    x = args[0]
    if name == "sab_attn_v_merge":
        v = args[1][0] if isinstance(args[1], (list, tuple)) else args[1]
        return _attn_v_f32_geometry(*x.shape[:2], v.shape[-1])
    b, h, w, c = x.shape
    if name == "fused_block_ffn":
        f = kw["ffw2"]["w1"].shape[1] if kw.get("ffw2") is not None else 0
        return K._ffn_f32_plan(b, h, w, c, len(K._x2_maps(kw.get("x2"))), f)
    if name == "fused_qkv_stats":
        return K._qkv_f32_plan(b, h, w, c, kw["heads"])
    if name == "fused_ln_split_proj":
        return K._split_f32_plan(b, h, w, c)
    if name == "fused_conv3x3":
        return K._conv_f32_plan(b, h, w, c, args[1].shape[3],
                                kw.get("ln_w") is not None)
    if name == "fused_chm_stats":
        return K._chm_f32_plan(b, h, w, c, kw["heads"], args[1].shape[1])
    if name == "fused_two_stage":
        return C2._two_stage_f32_plan(b, h, w, c)
    if name == "fused_channel_gffw_run":
        return LV._level_f32_plan(b, h, w, c,
                                  args[2] if len(args) > 2 else kw["heads"])
    raise AssertionError(f"{name} is not on a path")


def _attn_v_f32_geometry(bn, hw, d):
    """csrc/attn_v.cu in float32 (dispatch_attn_v<float>, av_smem): the
    query tile of 80, 64 or 48 rows that leaves the fewest empty rows, 128
    columns of D a block, a ring of 3 stages of (BM x 40) a and (32 x 136) v
    floats; grid (HW / BM, D / 128, BN), its second side at most 65535."""
    pads = {bm: -hw % bm for bm in (80, 64, 48)}
    bm = min(pads, key=lambda k: (pads[k], -k))
    smem = max(3 * (bm * 40 + 32 * 136), bm * 136) * 4
    grid = (-(-hw // bm), -(-d // 128), bn)
    assert grid[1] <= 65535 and bn <= 65535
    return dict(tile=bm, blocks=grid[0] * grid[1] * grid[2], smem=smem)


def _row(name, args, kw):
    """The table row of PERF.md a call belongs to (5: the 3x3 conv with its
    LayerNorm; the plain convs are row 5 too, on the body they always had)."""
    if name == "fused_conv3x3":
        return "5 (LN)" if kw.get("ln_w") is not None else "5"
    return {"fused_block_ffn": "1" if kw.get("wd") is not None else "2",
            "fused_qkv_stats": "3", "fused_ln_split_proj": "4",
            "fused_chm_stats": "6", "fused_two_stage": "13",
            "fused_channel_gffw_run": "14", "sab_attn_v_merge": "11"}[name]


@pytest.mark.parametrize("fuse", [(), ("two_stage",), FULL_PLAN],
                         ids=["fuse_none", "two_stage", "full_plan"])
@pytest.mark.parametrize("family", list(FILES))
def test_every_float32_call_is_taken_by_a_card_body(family, fuse):
    """Every recorded call goes to a body that takes it in float32, in at
    most a block's shared memory; at C = 512 with the LN halo in device
    memory (a scratch of one slice a tile). The calls wider than 128
    channels, which the wrappers refused in float32 before the bodies
    widened, are on the path: rows 1 and 3 at C = 256 and 512, row 4 at C =
    512, row 5's LayerNorm at 256 and, in the causal history model's files,
    row 6 at 256. Under the full plan the Channel blocks' rows 1 and 3 run
    inside row 14's runs, at C = 128, 256 and 512 (the scratch at 512 one
    slice a tile of the batch), and row 11 takes every CHM block of the
    files that have the alignment attention."""
    calls = _record(*FILES[family], fuse=fuse)
    wide = set()
    for name, args, kw in calls:
        geo = _f32_plan(name, args, kw)
        c = args[0].shape[-1]
        assert geo["smem"] <= SMEM_LIMIT, (name, c)
        if name in HALO_IN_DEVICE_MEMORY_AT_512:
            # one slice a tile of the batch (row 14's persistent blocks walk
            # its `items` tiles; the others launch one block a tile)
            tiles = geo.get("items", geo["blocks"])
            assert geo["halo"] == ("device" if c > 256 else "shared")
            assert geo["scratch"] == (tiles * 100 * (c + 8) if c > 256 else 0)
        if c > 128:
            wide.add((_row(name, args, kw), c))
        if fuse:
            assert name != "fused_two_stage" or c <= 128
    want = {("1", 256), ("1", 512), ("4", 512), ("5 (LN)", 256), ("6", 256)}
    if "channel_runs" in fuse:
        want |= {("14", 256), ("14", 512)}
        runs = [args[0].shape[-1] for name, args, _ in calls
                if name == "fused_channel_gffw_run"]
        assert sorted(runs) == [128, 256, 256, 512]
    else:
        want |= {("3", 256), ("3", 512)}
    assert want <= wide, sorted(wide)
    assert sum(name == "fused_two_stage" for name, _, _ in calls) == (
        6 if "two_stage" in fuse else 0)
    assert sum(name == "sab_attn_v_merge" for name, _, _ in calls) == (
        3 if "attn_v_merge" in fuse and family != "derain" else 0)
    if family == "gopro" and fuse == FULL_PLAN:
        # chip_smoke.py's exact launches of its gopro_f32_fused path
        cs = _chip_smoke()
        assert cs.FULL_PLAN == FULL_PLAN
        want = cs.LAUNCHES_PER_CALL_F32["gopro_fused"]
        for wrapper, counter in COUNTERS.items():
            assert sum(name == wrapper for name, _, _ in calls) == want[
                counter], wrapper


def test_float32_lists_of_maps_at_the_widest_level():
    """dec3's list (4 stacked history maps and the current one) at C = 256
    fits beside the halo in shared memory: 218,368 bytes."""
    geo = K._ffn_f32_plan(1, 184, 320, 256, 5, 0)
    assert (geo["halo"], geo["smem"]) == ("shared", 218368)
    with pytest.raises(ValueError, match="csrc/ffn.cu takes float32 lists of "
                       "x2 maps up to C = 256"):
        K._ffn_f32_plan(1, 92, 160, 512, 5, 0)


# row 14 in float32 (csrc/level.cu): (B, H, W, C, heads) of runs of the
# paths -> (shared memory, halo, scratch floats). enc3 / dec3 at a padded
# 720p frame (920 tiles), the latent there (240 tiles) and at 15 tiles of 320
# (375 tiles): 100 x (C + 8) floats a tile, 49.9 and 78.0 MB
LEVEL_F32_RUNS = {
    "enc3_whole_frame": ((1, 184, 320, 256, 4), (218368, "shared", 0)),
    "latent_whole_frame": ((1, 92, 160, 512, 8),
                           (178304, "device", 240 * 100 * 520)),
    "latent_15_tiles": ((15, 40, 40, 512, 8),
                        (178304, "device", 375 * 100 * 520)),
    "dec2_whole_frame": ((1, 368, 640, 128, 2), (134400, "shared", 0)),
}


@pytest.mark.parametrize("run", list(LEVEL_F32_RUNS))
def test_channel_runs_float32_taken_up_to_512(run):
    """Row 14 takes the runs of the paths in float32: the LN halo of both of
    its tile phases in shared memory up to C = 256, in a device-memory
    scratch of one slice a tile at C = 512, within a block's shared memory,
    one block an SM above C = 128 (a cooperative grid of at most 132)."""
    (b, h, w, c, heads), (smem, halo, scratch) = LEVEL_F32_RUNS[run]
    geo = LV._level_f32_plan(b, h, w, c, heads)
    items = b * -(-h // 8) * -(-w // 8)
    assert (geo["smem"], geo["halo"], geo["scratch"]) == (smem, halo, scratch)
    assert geo["items"] == items and geo["blocks"] == min(items, 132)
    assert geo["smem"] <= SMEM_LIMIT


def test_channel_runs_float32_refused_beyond_512(monkeypatch):
    """A float32 run wider than csrc/level.cu takes (C = 528), or with more
    than 64 channels a head, is refused by the plan with the body and the
    limit, and by the wrapper before any build."""
    with pytest.raises(ValueError, match="csrc/level.cu takes float32 maps "
                       "of C a multiple of 16 up to 512, got C=528"):
        LV._level_f32_plan(1, 8, 8, 528, 8)
    with pytest.raises(ValueError, match="csrc/level.cu takes float32 "
                       "C / heads <= 64"):
        LV._level_f32_plan(1, 8, 8, 256, 2)

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(LV.build, "load", no_build)
    monkeypatch.setattr(LV, "_sm_count", lambda device: 132)
    x = Maker(3, torch.float32)(1, 8, 8, 528)
    with pytest.raises(ValueError, match="csrc/level.cu takes float32 maps "
                       "of C a multiple of 16 up to 512"):
        LV._launch(x, [{}], 8)


class _FakeLib:
    """Stands in for a built library on the CPU: the shared-memory queries
    answer 0, each launch is recorded and succeeds."""

    def __init__(self):
        self.launches = []

    def __getattr__(self, fn):
        if fn.endswith("_smem"):
            return lambda *a: 0
        if fn == "turtle_reduce_rows":
            return lambda *a: 0

        def launch(ptrs, ints, is_bf16, stream):
            self.launches.append((list(ptrs), list(ints), is_bf16))
            return 0
        return launch


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("row", ["1", "3", "4", "5", "6"])
def test_float32_wide_calls_pass_the_wrapper_checks(row, c, monkeypatch):
    """The launch code of each widened wrapper, on a float32 map at C = 256
    and 512, reaches its kernel's launch (stubbed here: one launch recorded)
    with the LN halo's scratch address last where the halo lives in device
    memory, and null at C = 256. Before the bodies widened these calls were
    refused with "up to 128"."""
    fake = _FakeLib()
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    KP.reset_launch_counts()
    m = Maker(7, torch.float32)
    heads = c // 64
    b, h, w = 1, 11, 13
    x = m(b, h, w, c)
    ln = dict(ln_w=m(c), ln_b=m(c))
    if row == "1":
        K._ffn_launch(x, m(b, h, w, c), m(b, c, c), None, ln["ln_w"],
                      ln["ln_b"], m(c, 2 * c), None, m(3, 3, 2 * c), None,
                      m(c, c), None, None, "gate", None)
        tail = 20 + 5
    elif row == "3":
        K._qkv_stats_launch(x, ln["ln_w"], ln["ln_b"], m(c, 3 * c), None,
                            m(3, 3, 3 * c), None, heads)
        tail = 9
    elif row == "4":
        K._split_proj_launch(x, ln["ln_w"], ln["ln_b"], m(c, 3 * c), None,
                             m(3, 3, 3 * c), None, 3)
        tail = 11
    elif row == "5":
        K._conv3x3_launch(x, m(3, 3, c, c), None, ln["ln_w"], ln["ln_b"])
        tail = None
    else:
        K._chm_stats_launch(x, m(b, 2, h, w, c), ln["ln_w"], ln["ln_b"],
                            m(c, 3 * c), m(3, 3, 3 * c), m(c, 2 * c),
                            m(3, 3, 2 * c), heads)
        tail = 11
    assert len(fake.launches) == 1
    ptrs, _, is_bf16 = fake.launches[0]
    assert is_bf16 == 0
    if tail is not None:  # the halo's scratch: the last address passed
        assert len(ptrs) == tail + 1
        assert (ptrs[tail] is not None) == (c > 256)
    counts = KP.launch_counts()
    assert sum(counts.values()) == 1  # the wrapper's own count, no Hopper body


@pytest.mark.parametrize("c", [256, 512])
def test_float32_channel_run_passes_the_wrapper_checks(c, monkeypatch):
    """Row 14's launch code on a float32 run at C = 256 and 512 reaches
    csrc/level.cu's launch (stubbed here: one launch recorded) with the
    blocks' weights, null past the run, and the LN halo's scratch address
    last: B x tiles x 100 x (C + 8) floats at C = 512, null at 256."""
    fake = _FakeLib()
    monkeypatch.setattr(LV.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    monkeypatch.setattr(LV, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    scratch = []
    real_scratch = LV._halo_scratch

    def record(geo, x):
        t = real_scratch(geo, x)
        scratch.append(t)
        return t

    monkeypatch.setattr(LV, "_halo_scratch", record)
    KP.reset_launch_counts()
    b, h, w, heads, n = 2, 11, 13, c // 64, 3
    x, blocks = level_kernel_case(Maker(9, torch.float32), b, h, w, c,
                                  c // 2, heads, n, True)
    LV._launch(x, blocks, heads)
    assert len(fake.launches) == 1
    ptrs, ints, is_bf16 = fake.launches[0]
    assert is_bf16 == 0 and ints == [b, h, w, c, c, c // 2, heads, n]
    keys = len(LV._BLOCK_KEYS)
    assert len(ptrs) == 7 + keys * LV.MAX_RUN + 1
    assert all(p is None for p in ptrs[7 + keys * n:-1])
    if c > 256:
        assert scratch[0].numel() == b * 2 * 2 * 100 * (c + 8)
        assert ptrs[-1] == scratch[0].data_ptr()
    else:
        assert scratch == [None] and ptrs[-1] is None
    counts = KP.launch_counts()
    assert counts["level_run"] == 1 and counts["level_wg"] == 0


@pytest.mark.parametrize("fuse", [(), FULL_PLAN],
                         ids=["fuse_none", "full_plan"])
@pytest.mark.parametrize("model", ["Turtle_t1_arch", "Turtle_arch"])
def test_float32_engine_matches_the_jax_float32_engine(model, fuse):
    """The port's InferenceEngine(dtype=torch.float32) against the JAX
    package's float32 engine, whole frames, on the same weights carried
    across, 4 cache-threaded frames (the rings wrap), at the tiny
    configuration; the port also under the full plan (its runs, attention @
    v with the merge and the conv-only levels' two stages: the same
    function)."""
    opt = tiny_opt(model)
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(31))
    net = build_model(opt, device="cpu", dtype=torch.float32, fuse=fuse)
    load_jax_params(net, tree)
    jeng = JEngine(jcfg, to_jnp(tree, jnp.float32), mode="whole",
                   dtype=jnp.float32)
    teng = TEngine(net, mode="whole", dtype=torch.float32, device="cpu")
    frames = np.random.RandomState(32).rand(4, 40, 52, 3).astype(np.float32)
    for fr in frames:
        got, want = teng.step(fr), jeng.step(fr)
        assert got.shape == (40, 52, 3) and got.dtype == np.float32
        close(got, want, ATOL32)
