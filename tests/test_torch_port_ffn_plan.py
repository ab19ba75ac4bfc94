"""Which body of the conv-FFN kernel (row 1) each FFN call of the shipped
families gets: the wgmma body of kernels/csrc/ffn_wg.cu for every
single-map depthwise call at C = 128, 256 and 512, the mma.sync body of
kernels/csrc/ffn.cu for the lists of the causal history model, the chained
FFW and C = 64. Runs on the CPU: each family at full width through one frame
of a small map (the plan depends on widths and forms, not on H and W), every
fused_block_ffn call recorded and handed to the plan as the card would see
it (bf16)."""

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


def _record_calls(family, monkeypatch):
    path, overrides, side = FAMILIES[family]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu")
    calls = []
    plain = blocks_mod.fused_block_ffn

    def recorder(x, **kw):
        calls.append((tuple(x.shape), kw))
        return plain(x, **kw)

    monkeypatch.setattr(blocks_mod, "fused_block_ffn", recorder)
    cache = model.init_cache(1, side, side)
    frames = torch.rand(1, 2, side, side, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, cache)
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
    return K._ffn_plan(b, h, w, c, ch, e, mode, n_x2, po is not None, batched,
                       kw.get("ffw2") is not None, kw.get("wd") is not None,
                       torch.bfloat16)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_gives_every_single_map_call_its_body(family, monkeypatch):
    calls = _record_calls(family, monkeypatch)
    assert calls
    n_wg = 0
    for shape, kw in calls:
        body, geo = _plan(shape, kw)
        c = shape[-1]
        lists = len(K._x2_maps(kw.get("x2"))) > 1
        chained = kw.get("ffw2") is not None
        if lists or chained or kw.get("wd") is None or c not in WG_WIDTHS:
            assert body == "tile", (shape, kw["mode"])
            assert geo is None
        else:
            assert body == "wg", (shape, kw["mode"])
            assert geo["smem"] <= 232448
            assert geo["stages"] >= 2
            assert geo["blocks"] == shape[0] * (-(-shape[1] // 8)) * (
                -(-shape[2] // 8))
            n_wg += 1
    # every family runs Channel blocks at C = 128, 256 and 512
    assert n_wg > 0


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
                has_po=True, po_batched=True, has_ffw2=False, has_dw=True,
                dtype=torch.bfloat16)
    assert K._ffn_plan(**args)[0] == "wg"
    args.update({"float32": dict(dtype=torch.float32),
                 "no_dw": dict(has_dw=False),
                 "ffw2": dict(has_ffw2=True),
                 "two_maps": dict(n_x2=2),
                 "c64": dict(c=64, ch=320, e=160),
                 "c96": dict(c=96, ch=480, e=240),
                 "e48": dict(ch=96, e=48)}[change])
    assert K._ffn_plan(**args) == ("tile", None)
