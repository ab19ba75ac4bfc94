"""Which body of the statistics kernels (rows 3 and 6) each call of the
shipped families gets: the wgmma body of kernels/csrc/stats_wg.cuh
(qkv_wg.cu, chm_wg.cu) for the bf16 calls with 64 channels a head at C =
64, 128, 256, 512 (row 3) and C = 64, 128, 256 (row 6): every call of the
shipped families; the mma.sync bodies (qkv_stats.cu, chm_stats.cu) for
float32, biases, other head widths and, for row 6, C = 512. Runs on the CPU: each family at full width through one frame of a
small map (the plan depends on widths and forms, not on H and W), every
fused_qkv_stats and fused_chm_stats call recorded and handed to the plan as
the card would see it (bf16)."""

import pytest
import torch

from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model

from test_torch_port_ffn_plan import FAMILIES

SMEM_LIMIT = 232448
# row 3 calls a model call makes at each width, and row 6 calls (C, frames
# aligned); gopro_t1_fhr's CHM blocks are Channel blocks
QKV_WIDTHS = {"gopro": {256: 19, 512: 9, 128: 5, 64: 1},
              "gopro_t1_fhr": {256: 20, 512: 9, 128: 6, 64: 2},
              "derain": {256: 19, 512: 9, 128: 5, 64: 1},
              "sr": {256: 19, 512: 9, 128: 5, 64: 1}}
CHM_CALLS = {"gopro": [(256, 4), (128, 4), (64, 3)], "gopro_t1_fhr": [],
             "derain": [(256, 4), (128, 4), (64, 3)],
             "sr": [(256, 4), (128, 4), (64, 3)]}


def _record(family, monkeypatch):
    path, overrides, side = FAMILIES[family]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu")
    qkv, chm = [], []
    plain_qkv, plain_chm = blocks_mod.fused_qkv_stats, blocks_mod.fused_chm_stats

    def rec_qkv(x, **kw):
        qkv.append((tuple(x.shape), kw))
        return plain_qkv(x, **kw)

    def rec_chm(x, x_sp, **kw):
        chm.append((tuple(x.shape), tuple(x_sp.shape), kw))
        return plain_chm(x, x_sp, **kw)

    monkeypatch.setattr(blocks_mod, "fused_qkv_stats", rec_qkv)
    monkeypatch.setattr(blocks_mod, "fused_chm_stats", rec_chm)
    cache = model.init_cache(1, side, side)
    frames = torch.rand(1, 2, side, side, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, cache)
    return qkv, chm


def _check_geometry(geo, b, h, w):
    assert geo["smem"] <= SMEM_LIMIT
    assert geo["stages"] >= 2
    n_tiles = (-(-h // 8)) * (-(-w // 8))
    assert geo["blocks"] == min(b * n_tiles, 132)
    assert 1 <= geo["rows"] <= n_tiles


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_row_3_call_its_body(family, monkeypatch):
    qkv, _ = _record(family, monkeypatch)
    widths, n_wg = {}, 0
    for (b, h, w, c), kw in qkv:
        heads = kw["heads"]
        widths[c] = widths.get(c, 0) + 1
        has_bias = kw.get("b1") is not None or kw.get("bd") is not None
        body, geo = K._qkv_plan(b, h, w, c, heads, has_bias, torch.bfloat16)
        assert c == 64 * heads and not has_bias and kw.get("ln_b") is not None
        assert body == "wg", (c, heads)
        _check_geometry(geo, b, h, w)
        n_wg += 1
    assert widths == QKV_WIDTHS[family]
    assert n_wg == len(qkv)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_row_6_call_its_body(family, monkeypatch):
    _, chm = _record(family, monkeypatch)
    assert [(s[-1], sp[1]) for s, sp, _ in chm] == CHM_CALLS[family]
    for (b, h, w, c), _, kw in chm:
        body, geo = K._chm_plan(b, h, w, c, kw["heads"], torch.bfloat16)
        assert body == "wg", c
        _check_geometry(geo, b, h, w)


@pytest.mark.parametrize("c,chm", [(64, False), (128, False), (256, False),
                                   (512, False), (64, True), (128, True),
                                   (256, True)])
def test_stats_wg_shared_memory_fits_a_block(c, chm):
    smem, stages = K._sw_smem(c, chm)
    assert smem <= SMEM_LIMIT
    assert 3 <= stages <= 8


@pytest.mark.parametrize("change", ["float32", "biases", "ctok32", "ctok16",
                                    "c96", "c1024"])
def test_qkv_plan_keeps_the_other_calls_on_the_tile_body(change):
    args = dict(b=2, h=37, w=53, c=256, heads=4, has_bias=False,
                dtype=torch.bfloat16)
    assert K._qkv_plan(**args)[0] == "wg"
    args.update({"float32": dict(dtype=torch.float32),
                 "biases": dict(has_bias=True),
                 "ctok32": dict(heads=8),
                 "ctok16": dict(c=64, heads=4),
                 "c96": dict(c=96, heads=2),
                 "c1024": dict(c=1024, heads=16)}[change])
    assert K._qkv_plan(**args) == ("tile", None)


@pytest.mark.parametrize("change", ["float32", "ctok32", "c96", "c512"])
def test_chm_plan_keeps_the_other_calls_on_the_tile_body(change):
    args = dict(b=2, h=37, w=53, c=128, heads=2, dtype=torch.bfloat16)
    assert K._chm_plan(**args)[0] == "wg"
    args.update({"float32": dict(dtype=torch.float32),
                 "ctok32": dict(heads=4),
                 "c96": dict(c=96, heads=2),
                 "c512": dict(c=512, heads=8)}[change])
    assert K._chm_plan(**args) == ("tile", None)


@pytest.mark.parametrize("b,n_tiles,blocks", [(1, 35, 35), (2, 35, 70),
                                              (3, 169, 132), (15, 100, 132),
                                              (1, 14720, 132), (7, 3, 21)])
def test_persistent_grid_rows_cover_every_block_of_an_entry(b, n_tiles,
                                                           blocks):
    """Every (entry, block) pair that the kernel's ranges make has a row of
    its own below the plan's row count; the rows of an entry are in the
    order of its tiles."""
    rows = K._sw_rows(b, n_tiles, blocks)
    total = b * n_tiles
    seen = {}
    for g in range(blocks):
        for i in range(g * total // blocks, (g + 1) * total // blocks):
            e = i // n_tiles
            first = ((e * n_tiles + 1) * blocks - 1) // total
            seen.setdefault(e, []).append(g - first)
    for e in range(b):
        assert seen[e][0] == 0
        assert all(0 <= r < rows for r in seen[e])
        assert seen[e] == sorted(seen[e])
    assert rows == max(max(r) + 1 for r in seen.values())
