"""Frames other than 1280x720: every kernel call of a padded 1920x1080 frame
and of the tiled presets at 1080p and at DAVIS's 854x480 is taken by a body
of the card; the presets' tile grids there are the JAX engine's; the port's
engine holds the JAX package's at a frame whose height pads as 1080 does;
row 7's plain version holds the JAX kernel where ties straddle the float32
body's key blocks.

Runs on the CPU. A frame of each shipped option file is run on fake tensors
(shapes only, no arithmetic, as ``cli/bench.py``'s ``count_macs`` runs its
model), every wrapper call recorded and handed to the plan that its launch
code asks, in bf16 and in float32 (kernels/ffn.py, kernels/sab.py): each
call gets a body that takes it, within a block's shared memory; row 7 in
float32 at 8160 keys gets csrc/sab_f32.cu, whose shared memory is the same
at every key count. The launches a model call that the plans give are
chip_smoke.py's tables of its frame-sizes phase.
"""

import functools
import importlib.util
import os
import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from test_torch_port_float32 import _f32_plan
from torch_port_util import close, numpy_tree_like, to_jnp
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.eval import engine as JE
from turtlevsr_tpu.kernels import sab as jsab
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu_torch.cli.infer import TASK_PRESETS
from turtlevsr_tpu_torch.config.options import (
    load_options,
    model_config_from_options,
)
from turtlevsr_tpu_torch.eval import engine as TE
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as turtle_mod

torch.set_num_threads(1)
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every shipped option file, by its command-line task
FILES = {"deblur": "options/Turtle_Deblur_Gopro.yml",
         "denoise": "options/Turtle_Denoise_Davis.yml",
         "derain": "options/Turtle_Derain.yml",
         "raindrop": "options/Turtle_Derain_VRDS.yml",
         "desnow": "options/Turtle_Desnow.yml",
         "sr": "options/Turtle_SR_MVSR.yml"}
WRAPPERS = ("fused_block_ffn", "fused_qkv_stats", "fused_ln_split_proj",
            "fused_conv3x3", "fused_chm_stats", "sab_attn_probs",
            "lattice_split", "lattice_merge")
FRAME_1080 = (1080, 1920)  # the model pads it to 1088 x 1920
KEYS_1080 = (1088 // 16) * (1920 // 16)  # window tokens at every CHM level
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _record(path: str, h: int, w: int, dtype_name: str, batch: int = 1):
    """(model config, [(wrapper, args, kwargs)]) of one model call on a
    batch of [previous, current] pairs of (h, w) frames (the low-resolution
    size for the SR variant), on fake tensors of the type."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from turtlevsr_tpu_torch.models.blocks import KernelWeights
    from turtlevsr_tpu_torch.models.turtle import Turtle

    dtype = DTYPES[dtype_name]
    cfg = model_config_from_options(load_options(os.path.join(ROOT, path),
                                                 is_train=False))
    with torch.device("meta"):
        model = Turtle(cfg).eval().to(dtype)
    calls, saved = [], []
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
        with (FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad(),
              warnings.catch_warnings()):
            # the weight cache's key reads data_ptr(), which a fake tensor
            # warns of
            warnings.filterwarnings("ignore", "Accessing the data pointer")
            model.to_empty(device="cpu")
            for m in model.modules():
                if isinstance(m, KernelWeights):
                    m.kernel_weights()
            model(torch.zeros(batch, 2, h, w, 3, dtype=dtype),
                  model.init_cache(batch, h, w))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return cfg, calls


def _ffn_body(x, kw, dtype):
    b, h, w, c = x.shape
    ch = kw["w1"].shape[1]
    mode = kw["mode"]
    e = ch // 2 if mode == "gate" else ch
    n_x2 = len(K._x2_maps(kw.get("x2")))
    po = kw.get("po_w")
    batched = (po is not None and not isinstance(po, (list, tuple))
               and po.dim() == 3)
    f = kw["ffw2"]["w1"].shape[1] if kw.get("ffw2") is not None else 0
    return K._ffn_plan(b, h, w, c, ch, e, mode, n_x2, po is not None, batched,
                       f, kw.get("wd") is not None, dtype)


def _taken(name, args, kw, dtype) -> list:
    """The launch counters (turtlevsr_tpu_torch.kernels.launch_counts) one
    recorded call adds to, from the plan its wrapper's launch code asks;
    raises where no body takes the call, asserts that a body's shared
    memory fits a block."""
    x = args[0]
    f32 = dtype == torch.float32
    if f32 and name not in ("sab_attn_probs", "lattice_split",
                            "lattice_merge"):
        geo = _f32_plan(name, args, kw)  # raises where not taken
        assert geo["smem"] <= SMEM_LIMIT, (name, x.shape)
    if name == "fused_block_ffn":
        body, geo = _ffn_body(x, kw, dtype)
        extra = {"wg": ["ffn_wg"], "c64": ["ffn_c64"], "pw": ["ffn_pw"],
                 "f32": ["ffn_f32"]}
        no_dw = ["ffn_no_dw"] if kw.get("wd") is None else []
        counters = ["ffn", *no_dw, *extra.get(body, [])]
    elif name == "fused_qkv_stats":
        body, geo = K._qkv_plan(*x.shape, kw["heads"],
                                kw.get("b1") is not None
                                or kw.get("bd") is not None, dtype)
        counters = ["qkv_stats"] + {"wg": ["qkv_wg"], "f32": ["qkv_f32"]}.get(
            body, [])
    elif name == "fused_ln_split_proj":
        b, h, w, c = x.shape
        n_out = kw["n_out"]
        e = kw["w1"].shape[1] // n_out
        body, geo = K._split_plan(b, h, w, c, e, n_out,
                                  kw.get("ln_w") is not None,
                                  kw.get("b1") is not None
                                  or kw.get("bd") is not None, dtype)
        counters = ["split_proj"] + {"wg": ["split_wg"], "c64": ["split_c64"],
                                     "f32": ["split_f32"]}.get(body, [])
    elif name == "fused_chm_stats":
        body, geo = K._chm_plan(*x.shape, kw["heads"], dtype,
                                nf=args[1].shape[1])
        counters = ["chm_stats"] + {"wg": ["chm_wg"], "f32": ["chm_f32"]}.get(
            body, [])
    elif name == "fused_conv3x3":
        body, geo = K._conv_plan(*x.shape, args[1].shape[3],
                                 kw.get("ln_w") is not None, dtype)
        counters = ["conv3x3"] + (["conv3x3_f32"] if body == "f32" else [])
    elif name == "sab_attn_probs":
        q, k = args[0], args[1]
        b, hw, d = q.shape
        nf = k.shape[1]
        body = S._sab_plan(b, nf, hw, d, dtype, 4, kw["grid_wq"])
        geo = None
        if body == "wg":
            geo = dict(smem=S._sb_smem(d)[0])
            assert b * nf * hw < 2 ** 31 and hw <= S._SB_MAX_KEYS
        elif body == "f32":
            geo = dict(smem=S._sf_smem())
        else:
            rows = S._pick_rows(hw, d, dtype == torch.bfloat16)  # raises
            geo = dict(smem=S._tile_smem(hw, d, rows,
                                         dtype == torch.bfloat16))
        assert max(b, nf) <= 65535
        counters = ["sab"] + {"wg": ["sab_wg"], "f32": ["sab_f32"]}.get(
            body, [])
    else:  # the lattice pair: images, 16-byte pieces of a pixel, of an image
        src = args[0]
        n = src.shape[0]
        es = 4 if f32 else 2
        vectors = src[0].numel() * es // 16
        assert n <= 65535 and (src.shape[-1] * es) % 16 == 0
        assert vectors < 2 ** 32
        body, geo, counters = "tile", None, [name]
    if geo is not None:
        assert geo["smem"] <= SMEM_LIMIT, (name, x.shape, body)
    if f32 and name in ("fused_block_ffn", "fused_qkv_stats",
                        "fused_ln_split_proj", "fused_chm_stats"):
        # every float32 call of rows 1, 3, 4 and 6 on its float32 body
        assert body == "f32", (name, x.shape)
    if not f32 and name not in ("fused_conv3x3", "lattice_split",
                                "lattice_merge"):
        # every bf16 call of rows 1-4, 6 and 7 on a body designed for the
        # card, but dec1's row 7 on a 20 x 20 token grid (PERF.md, row 7)
        on_tile = name == "sab_attn_probs" and tuple(args[0].shape[1:]) == (
            400, 128)
        assert (body == "tile") == on_tile, (name, x.shape)
    return counters


def _counts(calls, dtype) -> Counter:
    out = Counter()
    for name, args, kw in calls:
        out.update(_taken(name, args, kw, dtype))
    return out


def _frame_size(task):
    """The model's input of a 1920x1080 frame: the SR variant takes it
    resized /4."""
    h, w = FRAME_1080
    return (h // 4, w // 4) if task == "sr" else (h, w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("task", list(FILES))
def test_every_call_of_a_1080p_frame_is_taken(task, dtype):
    """One 1920x1080 frame (padded to 1088 x 1920 inside the model) of each
    shipped file, in bf16 and in float32: every recorded call has a body
    that takes it, in a block's shared memory; the CHM files' row 7 at 8160
    keys on sab_wg.cu in bf16 and on sab_f32.cu in float32, where sab.cu's
    block of 8 float32 query rows would need 295,680 bytes."""
    cfg, calls = _record(FILES[task], *_frame_size(task), dtype)
    assert turtle_mod.padded_hw(cfg, *_frame_size(task)) == (1088, 1920)
    counts = _counts(calls, DTYPES[dtype])
    sab = [args for name, args, _ in calls if name == "sab_attn_probs"]
    for args in sab:
        assert args[0].shape[1] == KEYS_1080
    if cfg.variant != "t0":
        assert len(sab) == 3
        assert counts["sab_wg" if dtype == "bf16" else "sab_f32"] == 3
        assert S._tile_smem(KEYS_1080, 512, 8, False) == 295680 > SMEM_LIMIT
    else:
        assert not sab
    if task == "deblur":
        cs = _chip_smoke()
        path = "gopro_1080" if dtype == "bf16" else "gopro_f32_1080"
        want = cs.LAUNCHES_FRAME_SIZES[path]
        assert {k: counts[k] for k in want} == want
        assert sum(counts.values()) == sum(want.values())


@pytest.mark.parametrize("path,task,batches", [
    ("deblur_tiled_1080", "deblur", (15, 8)),
    ("denoise_tiled_480", "denoise", (8,))])
def test_tiled_paths_launch_the_chip_smoke_tables(path, task, batches):
    """The tiled paths of chip_smoke.py's frame-sizes phase, a model call of
    each chunk (tiles of 320: deblur at 1080p 6 chunks of 15 and one of 8,
    denoise at 854x480 one of 8), bf16: the launches a call are the
    phase's table whatever the chunk; dec1's row 7 (D = 128, 20 x 20
    tokens) on sab.cu."""
    want = _chip_smoke().LAUNCHES_FRAME_SIZES[path]
    tile = TASK_PRESETS[task]["tile"]
    for b in batches:
        _, calls = _record(FILES[task], tile, tile, "bf16", b)
        counts = _counts(calls, torch.bfloat16)
        assert {k: counts[k] for k in want} == want, b
        assert sum(counts.values()) == sum(want.values())


# (task, frame (h, w), tiles): the presets' grids at 1920x1080 and, for the
# denoise preset, at DAVIS's 854x480 (reflect-padded to 480 x 856)
GRIDS = [("deblur", (1080, 1920), 98), ("denoise", (1080, 1920), 50),
         ("derain", (1080, 1920), 50), ("sr", (1080, 1920), 60),
         ("denoise", (480, 854), 8)]


@pytest.mark.parametrize("task,frame,tiles", GRIDS,
                         ids=[f"{g[0]}-{g[1][1]}x{g[1][0]}" for g in GRIDS])
def test_preset_grids_at_other_frame_sizes(task, frame, tiles):
    """The port's tile grid is the JAX engine's at the preset's tile and
    overlap; the engine's chunks of 15 leave a ragged last one (98 tiles:
    6 x 15 + 8)."""
    preset = TASK_PRESETS[task]
    eng = TE.InferenceEngine.__new__(TE.InferenceEngine)
    eng.tile, eng.tile_overlap = preset["tile"], preset["tile_overlap"]
    hp, wp, t_, his, wis = eng.tile_plan(*frame)
    jeng = JE.InferenceEngine.__new__(JE.InferenceEngine)
    jeng.tile, jeng.tile_overlap = preset["tile"], preset["tile_overlap"]
    assert jeng._grid_size(*frame) == (tiles, t_) == (len(his) * len(wis),
                                                     preset["tile"])
    assert his == JE._tile_grid(hp, t_, t_ - preset["tile_overlap"])
    assert wis == JE._tile_grid(wp, t_, t_ - preset["tile_overlap"])
    chunks = [min(15, tiles - a) for a in range(0, tiles, 15)]
    assert chunks == {98: [15] * 6 + [8], 50: [15] * 3 + [5],
                      60: [15] * 4, 8: [8]}[tiles]


def _models(seed):
    opt = tiny_opt()
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(seed))
    model = build_model(opt, device="cpu", dtype=torch.float32)
    load_jax_params(model, tree)
    return jcfg, tree, model


# a frame whose height pads as 1080 does (56 = 24 mod 32: 8 rows of the
# model's pad; 1080 = 24 mod 32); the tiled engine's ragged last chunk in
# float32 is test_torch_port_tiled.py's test_tiled_engine_float32_model
FRAME_PAD8 = (56, 96)
ATOL32 = 2e-4  # float32 through the tiny model (test_torch_port_slice.py)


def test_float32_engine_at_a_frame_padded_as_1080():
    """The port's float32 engine against the JAX package's, whole frames
    that the model pads by 8 rows, 4 frames (the rings wrap)."""
    jcfg, tree, model = _models(41)
    jeng = JE.InferenceEngine(jcfg, to_jnp(tree, jnp.float32), mode="whole",
                              dtype=jnp.float32)
    teng = TE.InferenceEngine(model, mode="whole", dtype=torch.float32,
                              device="cpu")
    h, w = FRAME_PAD8
    assert turtle_mod.padded_hw(model.cfg, h, w)[0] - h == 8
    frames = np.random.RandomState(43).rand(4, h, w, 3).astype(np.float32)
    for fr in frames:
        got = teng.step(fr)
        assert got.shape == (h, w, 3) and got.dtype == np.float32
        close(got, jeng.step(fr), ATOL32)


# row 7 across the float32 body's key blocks (128 keys each): 424 keys on a
# 53 x 8 grid, three blocks and a remainder of 40
HQ, WQ, D = 53, 8, 32
TIED = [126, 127, 128, 129, 255, 256, 383, 384, 400]


def _tied_case(rng, nf):
    """Integer-valued q and k over 8 (every score exact in float32 in any
    order) where query 0's best score is held by the keys TIED, which
    straddle the key blocks' boundaries, all outside its window: the first
    five of them must be kept."""
    hw = HQ * WQ
    q = rng.randint(-2, 3, (1, hw, D)) / 8.0
    k = rng.randint(-2, 3, (1, nf, hw, D)) / 8.0
    q[0, 0] = 2 / 8.0
    k[0, :, TIED] = 2 / 8.0
    return q, k


@pytest.mark.parametrize("n_local", [0, 4])
def test_sab_plain_matches_pallas_across_key_blocks(n_local):
    """sab_attn_probs_plain against the JAX package's sab_fused_attn_probs
    (interpret mode, as the package's own tests run it on the CPU), float32,
    one invalid frame: the same support bit for bit, the values within
    1e-6; query 0 keeps the first five of its nine tied keys."""
    nf = 3
    q, k = _tied_case(np.random.RandomState(47), nf)
    fv = np.ones(nf)
    fv[1] = 0.0
    temp = 0.5
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = np.asarray(jsab.sab_fused_attn_probs(
        f32(q), f32(k).transpose(0, 1, 3, 2), WQ, f32(temp), f32(fv),
        n_local=n_local, interpret=True))
    tt = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    got = S.sab_attn_probs(tt(q), tt(k), tt([temp]), tt(fv), grid_wq=WQ,
                           n_local=n_local).numpy()
    assert np.array_equal(got != 0, want != 0)
    close(got, want, 1e-6)
    assert not got[:, 1].any()
    row0 = np.flatnonzero(got[0, 0, 0])
    window = [j for j in range(HQ * WQ)
              if j // WQ + j % WQ <= n_local]  # query 0 sits at (0, 0)
    assert set(row0) == set(TIED[:5]) | {j for j in window
                                         if got[0, 0, 0, j] != 0}
    assert not set(TIED[5:]) & set(row0)


def test_sab_plan_sends_long_float32_rows_to_the_f32_body():
    """Row 7's plan in float32: csrc/sab_f32.cu wherever sab.cu's block of 8
    query rows does not fit (8160 keys at every CHM level of 1080p, D = 512
    / 256 / 128) and wherever its grid has a block an SM; its shared memory
    is one figure at every key count; the refusals sab.cu keeps (a local
    radius past 4 at a long row, a bf16 row of D = 16 past its block) still
    raise."""
    assert S._sf_smem() == 67328 <= SMEM_LIMIT
    for d, nf in ((512, 4), (256, 4), (128, 3)):
        assert S._tile_smem(KEYS_1080, d, 8, False) > SMEM_LIMIT
        assert S._sab_plan(1, nf, KEYS_1080, d, torch.float32, 4, 120) \
            == "f32"
        assert S._sab_plan(1, nf, KEYS_1080, d, torch.bfloat16, 4, 120) \
            == "wg"
    assert S._sab_plan(1, 4, KEYS_1080, 512, torch.float32, 5, 120) == "tile"
    # where sab.cu's block holds the rows: the float32 body from a grid of
    # 132 blocks of 64 rows (one an SM), where it measured faster
    for (b, nf, hw, d), body in (((1, 4, 3680, 512), "f32"),
                                 ((1, 3, 3680, 128), "f32"),
                                 ((15, 3, 400, 128), "f32"),
                                 ((1, 4, 256, 512), "tile"),
                                 ((2, 3, 144, 128), "tile"),
                                 ((33, 1, 256, 128), "f32"),
                                 ((1, 3, 2816, 16), "f32"),
                                 ((1, 3, 2752, 16), "tile")):
        assert S._sab_plan(b, nf, hw, d, torch.float32, 4, 1) == body, (
            b, nf, hw, d)
    with pytest.raises(ValueError, match="shared memory"):
        S._pick_rows(KEYS_1080, 512, False)
    with pytest.raises(ValueError, match="shared memory"):
        S._pick_rows(20000, 16, True)
    assert S._pick_rows(400, 512, False) == 16  # a 20 x 20 grid fits sab.cu
    # sab.cu's block: the q tile of 16 rows and 8 or 16 rows of HW scores
    assert S._tile_smem(3680, 128, 16, True) == (16 * 136 + 16 * 3720) * 2

