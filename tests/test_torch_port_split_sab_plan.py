"""Which body of the split projection (row 4) and of the alignment
attention's probabilities (row 7) each call of the shipped families gets:
the wgmma bodies of kernels/csrc/split_wg.cu (bf16, LayerNorm, no biases,
E = C = 128, 256, 512: every call of the shipped families but dec1's SAB
q, k at C = 64, which takes the C = 64 body of kernels/csrc/split_c64.cu)
and kernels/csrc/sab_wg.cu (bf16, D a multiple of 64 up to 512, a local
radius of at most 4: every call but dec1's on the 20 x 20 token grid of a
320 tile); the mma.sync bodies (split_proj.cu, sab.cu) for that grid,
float32, biases, no LayerNorm, other widths. Runs on the CPU: each
family at full width through one frame of a small map (the plans depend on
widths and forms, not on H and W), every call recorded and handed to the
plan as the card would see it (bf16). Also row 7's arithmetic that the
host can replay: the key's grid row in fp32 and the order of the softmax's
sum against row 12's."""

import numpy as np
import pytest
import torch

from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model

from test_torch_port_ffn_plan import FAMILIES

SMEM_LIMIT = 232448
# row 4 calls a model call makes: (C, n_out) -> count (the latent FHR
# blocks' q, k, v at C = 512; the SAB q, k of the CHM blocks at dec3, dec2,
# dec1); row 7 calls: (D, frames) of the three CHM blocks of the t1 family
SPLIT_CALLS = {"gopro": {(512, 3): 2, (256, 2): 1, (128, 2): 1, (64, 2): 1},
               "gopro_t1_fhr": {(512, 3): 2},
               "derain": {(512, 3): 2},
               "sr": {(512, 3): 2, (256, 2): 1, (128, 2): 1, (64, 2): 1}}
SAB_CALLS = {"gopro": [512, 256, 128], "gopro_t1_fhr": [], "derain": [],
             "sr": [512, 256, 128]}


def _record(family, monkeypatch):
    path, overrides, side = FAMILIES[family]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu")
    split, sab = [], []
    plain_split, plain_sab = blocks_mod.fused_ln_split_proj, blocks_mod.sab_attn_probs

    def rec_split(x, **kw):
        split.append((tuple(x.shape), kw))
        return plain_split(x, **kw)

    def rec_sab(q, k, temp, fvalid=None, **kw):
        sab.append((tuple(q.shape), tuple(k.shape), kw))
        return plain_sab(q, k, temp, fvalid, **kw)

    monkeypatch.setattr(blocks_mod, "fused_ln_split_proj", rec_split)
    monkeypatch.setattr(blocks_mod, "sab_attn_probs", rec_sab)
    cache = model.init_cache(1, side, side)
    frames = torch.rand(1, 2, side, side, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, cache)
    return split, sab


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_row_4_call_its_body(family, monkeypatch):
    split, _ = _record(family, monkeypatch)
    calls = {}
    for (b, h, w, c), kw in split:
        n_out = kw["n_out"]
        e = kw["w1"].shape[1] // n_out
        calls[(c, n_out)] = calls.get((c, n_out), 0) + 1
        has_bias = kw.get("b1") is not None or kw.get("bd") is not None
        assert kw.get("ln_w") is not None and not has_bias and e == c
        body, geo = K._split_plan(b, h, w, c, e, n_out, True, has_bias,
                                  torch.bfloat16)
        if c == 64:  # dec1's SAB q, k: the C = 64 body
            assert body == "c64", n_out
            assert (geo["smem"], geo["stages"]) == K._sc_smem(n_out)
            assert geo["smem"] <= SMEM_LIMIT and geo["stages"] >= 2
            assert geo["tiles"] == b * (-(-h // 16)) * (-(-w // 8))
            assert geo["blocks"] == min(geo["tiles"], 132)
            continue
        assert body == "wg", (c, n_out)
        assert geo["smem"] <= SMEM_LIMIT and geo["stages"] >= 2
        assert geo["blocks"] == min(b * (-(-h // 8)) * (-(-w // 8)), 132)
        assert geo["passes"] * 128 == n_out * c
    assert calls == SPLIT_CALLS[family]


# the token grids row 7 meets on the paths, (maps a call, hq, wq): a whole
# padded 720p frame (46 x 80 at every CHM level), 15 tiles of 320 (20 x 20)
# and 15 SR tiles (16 x 16)
PATH_GRIDS = [(1, 46, 80), (15, 20, 20), (15, 16, 16)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_row_7_call_its_body(family, monkeypatch):
    """The recorded calls' widths and frames at the paths' token grids (the
    plan depends on the grid too): the wgmma body everywhere but dec1's call
    at 15 tiles of 320 (D = 128 on a 20 x 20 grid), where sab.cu was
    faster."""
    _, sab = _record(family, monkeypatch)
    assert [qs[-1] for qs, _, _ in sab] == SAB_CALLS[family]
    for _, (_, nf, _, d), kw in sab:
        for b, hq, wq in PATH_GRIDS:
            body = S._sab_plan(b, nf, hq * wq, d, torch.bfloat16,
                               kw.get("n_local", 4), wq)
            if d == 128 and (b, hq, wq) == (15, 20, 20):
                assert body == "tile"
                continue
            assert body == "wg", (d, hq, wq)


@pytest.mark.parametrize("c", K._SPLIT_WG_WIDTHS)
def test_split_wg_shared_memory_fits_a_block(c):
    smem, stages = K._spw_smem(c)
    assert smem <= SMEM_LIMIT
    assert 4 <= stages <= 8


@pytest.mark.parametrize("d", [64, 128, 256, 384, 512])
def test_sab_wg_shared_memory_fits_a_block(d):
    smem, stages = S._sb_smem(d)
    assert smem <= SMEM_LIMIT
    assert 4 <= stages <= 8


@pytest.mark.parametrize("change", ["float32", "biases", "no_ln", "e_ne_c",
                                    "c64", "c96", "c1024"])
def test_split_plan_keeps_the_other_calls_on_the_tile_body(change):
    args = dict(b=2, h=37, w=53, c=256, e=256, n_out=2, has_ln=True,
                has_bias=False, dtype=torch.bfloat16)
    assert K._split_plan(**args)[0] == "wg"
    args.update({  # float32 outside csrc/split_f32.cu's forms: no LN
                 "float32": dict(dtype=torch.float32, has_ln=False),
                 "biases": dict(has_bias=True),
                 "no_ln": dict(has_ln=False),
                 "e_ne_c": dict(e=128, n_out=4),
                 # C = 64 without LayerNorm: outside the C = 64 body too
                 "c64": dict(c=64, e=64, has_ln=False),
                 "c96": dict(c=96, e=96),
                 "c1024": dict(c=1024, e=1024)}[change])
    assert K._split_plan(**args) == ("tile", None)


@pytest.mark.parametrize("change", ["float32", "d16", "d144", "d1024",
                                    "radius5", "keys_2e20_plus",
                                    "d128_20x20_grid"])
def test_sab_plan_keeps_the_other_calls_on_the_tile_body(change):
    """The bf16 calls the wgmma body does not take go to sab.cu; float32
    calls have a body of their own (csrc/sab_f32.cu), which takes this
    grid of 420 blocks (tests/test_torch_port_frame_sizes.py holds its
    rule)."""
    args = dict(b=15, nf=4, hw=400, d=512, dtype=torch.bfloat16)
    assert S._sab_plan(**args) == "wg"
    args.update({"float32": dict(dtype=torch.float32),
                 "d16": dict(d=16), "d144": dict(d=144),
                 "d1024": dict(d=1024), "radius5": dict(n_local=5),
                 "keys_2e20_plus": dict(b=1, hw=2 ** 20 + 8),
                 "d128_20x20_grid": dict(nf=3, d=128)}[change])
    assert S._sab_plan(**args) == ("f32" if change == "float32" else "tile")


# (B, NF, hq, wq, D) the plan sends to the wgmma body whatever the count of
# its blocks: a small ragged grid (HW = 221, 24 blocks of 128 rows), the SR
# tiles' 16 x 16 grid at D = 128, dec1's whole frame, a 2 x 2 grid, and
# D = 256 on the 20 x 20 grid of fewer tiles
WG_SHAPES = [(3, 4, 13, 17, 512), (15, 3, 16, 16, 128), (1, 3, 46, 80, 128),
             (1, 1, 2, 2, 64), (5, 4, 20, 20, 256)]


@pytest.mark.parametrize("shape", WG_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sab_plan_sends_other_grids_to_the_wg_body(shape):
    b, nf, hq, wq, d = shape
    assert S._sab_plan(b, nf, hq * wq, d, torch.bfloat16, 4, wq) == "wg"


# the token grids of a 320 tile at every CHM level, of a padded 720p frame,
# and a ragged one (HW = 221: not a multiple of 8 or of the 128 rows and
# keys of a block and a key tile)
GRIDS = [(20, 20), (46, 80), (13, 17)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sab_wg_key_row_in_fp32_is_exact(grid):
    """The key's grid row that sab_wg.cu's sb_key_row computes in fp32,
    (j + 0.5) * (1 / wq) rounded down, is the integer one."""
    hq, wq = grid
    hw = hq * wq
    j = np.arange(hw)
    rwq = np.float32(1.0) / np.float32(wq)
    ky = ((j.astype(np.float32) + np.float32(0.5)) * rwq).astype(np.int64)
    assert np.array_equal(ky, j // wq)


def _row_12_sum(idx, vals):
    """sparse_softmax_row's sum: lane l adds the values of the entries
    j = l (mod 32) in ascending j, then __shfl_xor from 16 down to 1."""
    lanes = [np.float32(0)] * 32
    for j, v in sorted(zip(idx, vals)):
        lanes[j % 32] = np.float32(lanes[j % 32] + v)
    for m in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[l] + lanes[l ^ m]) for l in range(32)]
    return lanes[0]


def _row_7_wg_sum(idx, vals):
    """sab_wg.cu's sum: thread t of the quad keeps the eight lane sums of the
    entries j = t (mod 4) (lane t + 4 u, u = (j mod 32) / 4), adds them as
    the tree's steps 16, 8, 4 do, then shuffles with t ^ 2 and t ^ 1."""
    per_t = []
    for t in range(4):
        ls = [np.float32(0)] * 8
        for j, v in sorted(zip(idx, vals)):
            if j % 4 == t:
                ls[(j >> 2) & 7] = np.float32(ls[(j >> 2) & 7] + v)
        for u in range(4):
            ls[u] = np.float32(ls[u] + ls[u + 4])
        for u in range(2):
            ls[u] = np.float32(ls[u] + ls[u + 2])
        per_t.append(np.float32(ls[0] + ls[1]))
    per_t = [np.float32(per_t[t] + per_t[t ^ 2]) for t in range(4)]
    per_t = [np.float32(per_t[t] + per_t[t ^ 1]) for t in range(4)]
    assert len({float(v) for v in per_t}) == 1
    return per_t[0]


@pytest.mark.parametrize("seed", range(6))
def test_sab_wg_sum_order_is_row_12s(seed):
    """The softmax's denominator in the wgmma body's order equals row 12's
    bit for bit, over the at most 46 entries of a row at 3680 keys."""
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 47)
    idx = rng.choice(3680, n, replace=False)
    vals = np.exp(rng.standard_normal(n).astype(np.float32) * 4)
    assert _row_7_wg_sum(idx, vals) == _row_12_sum(idx, vals)


# the paths chip_smoke.py drives whole-frame, as (configuration, fused plan)
SPLIT_PATHS = {"gopro": ("gopro", ()), "gopro_t1_fhr": ("gopro_t1_fhr", ()),
               "gopro_enc3_ffw": ("gopro_enc3_ffw", ()),
               "gopro_fused": ("gopro", ("channel_runs", "attn_v_merge")),
               "gopro_two_stage": ("gopro", ("two_stage",)),
               "derain": ("derain", ()), "sr": ("sr", ())}


@pytest.mark.parametrize("tag", list(SPLIT_PATHS))
def test_chip_smoke_split_launch_table_is_the_plans(tag, monkeypatch):
    """chip_smoke.py holds each path's row 4 launches a model call to
    LAUNCHES_PER_CALL: the path's calls, the plan's answer for each (whole
    padded frames and chunks of 15 tiles alike); split_proj.cu takes
    none."""
    from test_torch_port_ffn_plan import _chip_smoke

    cs = _chip_smoke()
    config, fuse = SPLIT_PATHS[tag]
    path, overrides = cs.CONFIGS[config]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu", fuse=fuse)
    calls = []
    plain = blocks_mod.fused_ln_split_proj

    def rec(x, **kw):
        calls.append((tuple(x.shape), kw))
        return plain(x, **kw)

    monkeypatch.setattr(blocks_mod, "fused_ln_split_proj", rec)
    side = 16 if config == "sr" else 64
    cache = model.init_cache(1, side, side)
    frames = torch.rand(1, 2, side, side, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, cache)
    want = cs.LAUNCHES_PER_CALL[tag]
    for b, h, w in ((1, 736, 1280), (15, 320, 320)):
        bodies = [K._split_plan(b, h, w, shape[-1],
                                kw["w1"].shape[1] // kw["n_out"], kw["n_out"],
                                kw.get("ln_w") is not None,
                                kw.get("b1") is not None, torch.bfloat16)[0]
                  for shape, kw in calls]
        assert (len(bodies), bodies.count("wg"), bodies.count("c64")) == (
            want["split_proj"], want["split_wg"], want["split_c64"])
        assert "tile" not in bodies
