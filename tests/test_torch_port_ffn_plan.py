"""Which body of the conv-FFN kernel (row 1) each FFN call of the shipped
families gets: the wgmma body of kernels/csrc/ffn_wg.cu for every
depthwise call at C = 128, 256 and 512 (single maps, the lists of the
causal history model at C = 128 and 256, the chained FFW at C = 128), the
C = 64 body of kernels/csrc/ffn_c64.cu for every depthwise call at C = 64
(the refinement's halves, dec1's Channel and CHM halves, enc1's chained
FFW), the body of kernels/csrc/ffn_pw.cu for the FFW pass without a
depthwise stage at C = 128 and 256 (enc3's in gopro_enc3_ffw); the
mma.sync body of kernels/csrc/ffn.cu for none of them. Runs on the CPU: each family at full width through one
frame of a small map (the plan depends on widths and forms, not on H and
W), every fused_block_ffn call recorded and handed to the plan as the card
would see it (bf16); the same for each path of chip_smoke.py, whose table
of launches a model call must be what the plan gives."""

import functools
import importlib.util
import os

import pytest
import torch

from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model

# the configurations chip_smoke.py streams: the shipped files, gopro_t1_fhr
# with the CHM blocks set to Channel by the caller; (file, overrides, input
# side: the SR model takes low-resolution frames, x4 inside)
FAMILIES = {
    "gopro": ("options/Turtle_Deblur_Gopro.yml", {}, 64),
    "gopro_t1_fhr": ("options/Turtle_Deblur_Gopro.yml",
                     {"decoder1_attn_type2": "Channel",
                      "decoder2_attn_type2": "Channel",
                      "decoder3_attn_type2": "Channel"}, 64),
    "derain": ("options/Turtle_Derain.yml", {}, 64),
    "sr": ("options/Turtle_SR_MVSR.yml", {}, 16),
}
WG_WIDTHS = (128, 256, 512)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(path, overrides, side, fuse=()):
    """Every fused_block_ffn call of one frame of the model the option file
    (with overrides) describes, under the fused plan ``fuse``."""
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu", fuse=fuse)
    calls = []
    plain = blocks_mod.fused_block_ffn

    def recorder(x, **kw):
        calls.append((tuple(x.shape), kw))
        return plain(x, **kw)

    blocks_mod.fused_block_ffn = recorder
    try:
        cache = model.init_cache(1, side, side)
        frames = torch.rand(1, 2, side, side, 3,
                            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model(frames, cache)
    finally:
        blocks_mod.fused_block_ffn = plain
    return calls


def _plan(shape, kw):
    b, h, w, c = shape
    ch = kw["w1"].shape[1]
    mode = kw["mode"]
    e = ch // 2 if mode == "gate" else ch
    n_x2 = len(K._x2_maps(kw.get("x2")))
    po = kw.get("po_w")
    batched = (po is not None and not isinstance(po, (list, tuple))
               and po.dim() == 3)
    f = kw["ffw2"]["w1"].shape[1] if kw.get("ffw2") is not None else 0
    return K._ffn_plan(b, h, w, c, ch, e, mode, n_x2, po is not None, batched,
                       f, kw.get("wd") is not None, torch.bfloat16)


def _form(kw):
    lists = len(K._x2_maps(kw.get("x2"))) > 1
    return "lists" if lists else "ffw2" if kw.get("ffw2") is not None else "one"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_single_map_call_its_body(family):
    """Every recorded row 1 call, single maps, lists and the chained FFW
    alike: the wgmma body for every depthwise call at C >= 128, the C = 64
    body for every depthwise call at C = 64, row 2's body for an FFW pass
    without a depthwise stage at C = 128 or 256 (ffn.cu at other widths)."""
    calls = _record(*FAMILIES[family])
    assert calls
    n_wg, forms = 0, set()
    for shape, kw in calls:
        body, geo = _plan(shape, kw)
        c = shape[-1]
        if kw.get("wd") is None:
            assert body == ("pw" if c in (128, 256) else "tile"), (
                shape, kw["mode"])
        elif c == 64:
            assert body == "c64", (shape, kw["mode"], _form(kw))
            assert geo["smem"] <= 232448 and 2 <= geo["stages"] <= 4
            assert geo["tiles"] == shape[0] * (-(-shape[1] // 16)) * (
                -(-shape[2] // 8))
            forms.add((_form(kw), kw["mode"], c))
        else:
            assert c in WG_WIDTHS
            assert body == "wg", (shape, kw["mode"], _form(kw))
            assert geo["smem"] <= 232448
            assert geo["stages"] >= 2
            assert geo["blocks"] == shape[0] * (-(-shape[1] // 8)) * (
                -(-shape[2] // 8))
            n_wg += 1
            forms.add((_form(kw), kw["mode"], c))
    # every family runs Channel blocks at C = 128, 256 and 512, and enc2's
    # ReducedAttn+FFW blocks; the CHM blocks of all but gopro_t1_fhr end
    # dec3 and dec2 with lists. At C = 64: the refinement's GFFW and
    # ReducedAttn halves, dec1's Channel half (CHM list in all but
    # gopro_t1_fhr), enc1's ReducedAttn+FFW blocks
    want = {("one", "gate", 128), ("one", "gate", 256), ("one", "gate", 512),
            ("ffw2", "gelu", 128), ("one", "gate", 64), ("one", "gelu", 64),
            ("ffw2", "gelu", 64)}
    if family != "gopro_t1_fhr":
        want |= {("lists", "gate", 256), ("lists", "gate", 128),
                 ("lists", "gate", 64)}
    assert forms == want
    assert n_wg > 0


# the paths chip_smoke.py drives, as (configuration, fused plan); tiled
# streams make the same calls on tiles, whose sizes the plan does not read
FUSED, TWO_STAGE = ("channel_runs", "attn_v_merge"), ("two_stage",)
PATHS = {"gopro": ("gopro", ()), "gopro_t1_fhr": ("gopro_t1_fhr", ()),
         "gopro_enc3_ffw": ("gopro_enc3_ffw", ()),
         "gopro_fused": ("gopro", FUSED),
         "gopro_two_stage": ("gopro", TWO_STAGE),
         "derain": ("derain", ()), "derain_two_stage": ("derain", TWO_STAGE),
         "sr": ("sr", ()), "sr_two_stage": ("sr", TWO_STAGE)}


@pytest.mark.parametrize("tag", list(PATHS))
def test_chip_smoke_launch_table_is_the_plans(tag):
    """chip_smoke.py holds each path's FFN launches a model call to
    LAUNCHES_PER_CALL: the calls of that path, the plan's answer for each."""
    cs = _chip_smoke()
    assert set(PATHS) == set(cs.LAUNCHES_PER_CALL)
    assert (FUSED, TWO_STAGE) == (cs.FUSED_PLAN, cs.TWO_STAGE)
    config, fuse = PATHS[tag]
    path, overrides = cs.CONFIGS[config]
    calls = _record(path, overrides, 16 if config == "sr" else 64, fuse)
    wg = sum(_plan(shape, kw)[0] == "wg" for shape, kw in calls)
    c64 = sum(_plan(shape, kw)[0] == "c64" for shape, kw in calls)
    pw = sum(_plan(shape, kw)[0] == "pw" for shape, kw in calls)
    no_dw = sum(kw.get("wd") is None for _, kw in calls)
    want = cs.LAUNCHES_PER_CALL[tag]
    assert (len(calls), wg, c64, no_dw, pw) == (
        want["ffn"], want["ffn_wg"], want["ffn_c64"], want["ffn_no_dw"],
        want["ffn_pw"])
    # ffn.cu: no launch on any path, with a depthwise stage or without
    assert len(calls) == wg + c64 + pw and pw == no_dw


@pytest.mark.parametrize("c", WG_WIDTHS)
@pytest.mark.parametrize("mode", ["gate", "gelu"])
def test_wg_shared_memory_fits_a_block(c, mode):
    smem, stages = K._wg_smem(c, mode == "gate")
    assert smem <= 232448
    assert 2 <= stages <= 8


@pytest.mark.parametrize("change", ["float32", "no_dw", "ffw2", "two_maps",
                                    "c64", "c96", "e48"])
def test_plan_keeps_the_other_calls_on_the_tile_body(change):
    args = dict(b=2, h=37, w=53, c=256, ch=1280, e=640, mode="gate", n_x2=1,
                has_po=True, po_batched=True, f=0, has_dw=True,
                dtype=torch.bfloat16)
    assert K._ffn_plan(**args)[0] == "wg"
    c64 = dict(c=64, ch=320, e=160)
    args.update({"float32": dict(dtype=torch.float32),
                 "no_dw": dict(has_dw=False),
                 # just outside the C = 64 body's forms (the serving forms:
                 # test_plan_sends_the_c64_forms_to_the_c64_body): the
                 # chained FFW in gate mode, five maps (their po matrices
                 # leave room for one ring slot), a map without po
                 "ffw2": dict(c=64, ch=256, e=128, n_x2=0, has_po=False,
                              f=128),
                 "two_maps": dict(c64, n_x2=5),
                 "c64": dict(c64, has_po=False),
                 "c96": dict(c=96, ch=480, e=240),
                 "e48": dict(ch=96, e=48)}[change])
    assert K._ffn_plan(**args) == ("tile", None)


# the serving forms at C = 64: (E, mode, x2 maps, F); the refinement's GFFW
# and ReducedAttn halves, dec1's Channel half and CHM list, enc1's chained
# FFW; and lists of two or three maps
C64_FORMS = {"refinement_gffw": (160, "gate", 0, 0),
             "refinement_ra": (128, "gelu", 0, 0),
             "dec1_channel": (160, "gate", 1, 0),
             "dec1_lists": (160, "gate", 4, 0),
             "enc1_ffw2": (128, "gelu", 0, 128),
             "two_maps": (160, "gate", 2, 0), "three_maps": (160, "gate", 3, 0)}


@pytest.mark.parametrize("form", list(C64_FORMS))
@pytest.mark.parametrize("batched", [True, False], ids=["po_b", "po_shared"])
def test_plan_sends_the_c64_forms_to_the_c64_body(form, batched):
    e, mode, n_x2, f = C64_FORMS[form]
    ch = 2 * e if mode == "gate" else e
    body, geo = K._ffn_plan(15, 320, 320, 64, ch, e, mode, n_x2, n_x2 > 0,
                            batched, f, True, torch.bfloat16)
    assert body == "c64"
    assert geo["tiles"] == 15 * 20 * 40 and geo["blocks"] == 132
    assert (geo["smem"], geo["stages"]) == K._c64_smem(
        ch, e, mode == "gate", n_x2, f)
    assert 2 <= geo["stages"] <= 4 and geo["smem"] <= 232448
    # a whole 736 x 1280 frame, and a grid of fewer tiles than SMs
    assert K._ffn_plan(1, 736, 1280, 64, ch, e, mode, n_x2, n_x2 > 0,
                       batched, f, True, torch.bfloat16)[1]["tiles"] == 7360
    assert K._ffn_plan(1, 20, 20, 64, ch, e, mode, n_x2, n_x2 > 0, batched,
                       f, True, torch.bfloat16)[1]["blocks"] == 6


# the new forms of the wgmma body: (C, E, mode, x2 maps, F); the lists of the
# CHM blocks at dec3 and dec2 (a stacked entry of 4 maps and one more), five
# single maps, two maps, the chained FFW of enc2
NEW_FORMS = {"dec3_lists": (256, 640, "gate", 5, 0),
             "dec2_lists": (128, 320, "gate", 5, 0),
             "two_maps_c256": (256, 640, "gate", 2, 0),
             "five_maps_c128": (128, 320, "gate", 5, 0),
             "enc2_ffw2": (128, 256, "gelu", 0, 256)}


@pytest.mark.parametrize("form", list(NEW_FORMS))
@pytest.mark.parametrize("batched", [True, False], ids=["po_b", "po_shared"])
def test_plan_sends_lists_and_the_chained_ffw_to_the_wg_body(form, batched):
    c, e, mode, n_x2, f = NEW_FORMS[form]
    ch = 2 * e if mode == "gate" else e
    body, geo = K._ffn_plan(15, 80, 80, c, ch, e, mode, n_x2, n_x2 > 0,
                            batched, f, True, torch.bfloat16)
    assert body == "wg"
    assert geo["blocks"] == 15 * 100 and geo["stages"] >= 2
    assert geo["smem"] == K._wg_smem(c, mode == "gate")[0] <= 232448


@pytest.mark.parametrize("change", ["c512_lists", "gelu_lists", "ffw2_c256",
                                    "ffw2_f192", "ffw2_gate", "ffw2_pair"])
def test_plan_keeps_forms_outside_the_new_ones_on_the_tile_body(change):
    """Just outside the new forms: lists at C = 512 (no path has them;
    ffn.cu's shared memory refuses them too) or in gelu mode, the chained
    FFW at another width, another F, in gate mode or with an x2 map."""
    args = {"c512_lists": (512, 1280, "gate", 5, 0),
            "gelu_lists": (128, 256, "gelu", 5, 0),
            "ffw2_c256": (256, 512, "gelu", 0, 512),
            "ffw2_f192": (128, 256, "gelu", 0, 192),
            "ffw2_gate": (128, 320, "gate", 0, 256),
            "ffw2_pair": (128, 256, "gelu", 1, 256)}[change]
    c, e, mode, n_x2, f = args
    ch = 2 * e if mode == "gate" else e
    assert K._ffn_plan(2, 37, 53, c, ch, e, mode, n_x2, n_x2 > 1, True, f,
                       True, torch.bfloat16) == ("tile", None)


def test_stacked_entries_are_read_in_place_map_by_map():
    """The x2 addresses and batch strides the launch hands the kernel for a
    stacked (B, M, H, W, C) entry and a single map, and the stacked
    (M, B, C, C) matrices: map m of batch entry b starts at ptrs[m] +
    b * strides[m] elements, its matrix at rows (m B + b) C of the stack
    (the kernel's po tensor map)."""
    b, m_st, h, w, c = 3, 4, 5, 7, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(b, h, w, c, dtype=torch.bfloat16)
    stack = torch.randn(b, m_st, h, w, c, generator=gen).bfloat16()
    single = torch.randn(b, h, w, c, generator=gen).bfloat16()
    pos = [torch.randn(b, c, c, generator=gen).bfloat16()
           for _ in range(m_st + 1)]
    ptrs, strides, n, po, batched = K._x2_operands(x, [stack, single], pos)
    assert n == m_st + 1 and batched and po.shape == (n, b, c, c)
    maps = [stack[:, j] for j in range(m_st)] + [single]
    flat = po.reshape(-1, c)
    for j, mp in enumerate(maps):
        for bb in range(b):
            start = ptrs[j] + bb * strides[j] * 2
            assert start == mp[bb].data_ptr()
            assert torch.equal(flat[(j * b + bb) * c:(j * b + bb + 1) * c],
                               pos[j][bb])
    assert ptrs[n:] == [None] * (K._MAX_X2 - n)
