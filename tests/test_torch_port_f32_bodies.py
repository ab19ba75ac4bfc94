"""The float32 bodies of rows 1 and 3 (kernels/csrc/ffn_f32.cu,
kernels/csrc/qkv_f32.cu): which float32 calls their plans take, their launch
geometry and scratch, and the refusals outside their forms.

Runs on the CPU. Every fused_block_ffn and fused_qkv_stats call of one model
call in float32 (recorded on fake tensors, as
tests/test_torch_port_frame_sizes.py does) at the frame sizes and tile
batches the float32 paths and the shipped presets give (1280x720, DAVIS's
854x480, 15 and a last 8 tiles of 320, SR's tiles of 256 at the high
resolution, the harness's 256 x 256, the train step's 2 x 192 x 192) goes
to the float32 body, its products' static shared
memory within a block's; the launch code reaches the body's launch (stubbed:
no card here) with the maps between its launches; a call outside the forms
goes to csrc/ffn.cu or csrc/qkv_stats.cu, and where neither takes it the
plan raises naming the body and its limit. The float32 walks of every
shipped file are in tests/test_torch_port_float32.py and
tests/test_torch_port_frame_sizes.py (1920x1080); the kernels' arithmetic
against the plain versions runs on the card (tests/test_torch_port_cuda.py
-k "f32_body").
"""

import pytest
import torch

from test_torch_port_float32 import _FakeLib, _chip_smoke
from test_torch_port_frame_sizes import FILES, _record
from torch_port_util import Maker
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.kernels import ffn as K

SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100
# (task, (batch, model input h, w)): whole frames, the tiled presets' chunks
# (SR's tiles of 256 enter the model at 64), the harness, the train step
SIZES = {
    "deblur_1280x720": ("deblur", (1, 720, 1280)),
    "deblur_15_tiles_of_320": ("deblur", (15, 320, 320)),
    "deblur_last_8_tiles_of_320": ("deblur", (8, 320, 320)),
    "deblur_bench_256": ("deblur", (1, 256, 256)),
    "deblur_train_2x192": ("deblur", (2, 192, 192)),
    "denoise_854x480": ("denoise", (1, 480, 854)),
    "derain_1280x720": ("derain", (1, 720, 1280)),
    "desnow_24_tiles_of_320": ("desnow", (15, 320, 320)),
    "sr_15_tiles_of_256": ("sr", (15, 64, 64)),
}


def _ffn_args(args, kw):
    x = args[0]
    b, h, w, c = x.shape
    ch = kw["w1"].shape[1]
    mode = kw["mode"]
    f = kw["ffw2"]["w1"].shape[1] if kw.get("ffw2") is not None else 0
    return dict(b=b, h=h, w=w, c=c, ch=ch,
                e=ch // 2 if mode == "gate" else ch, mode=mode,
                n_x2=len(K._x2_maps(kw.get("x2"))),
                has_po=kw.get("po_w") is not None, po_batched=False, f=f,
                has_dw=kw.get("wd") is not None, dtype=torch.float32)


@pytest.mark.parametrize("size", list(SIZES))
def test_every_float32_call_of_rows_1_and_3_on_the_float32_bodies(size):
    """Each float32 call of rows 1 and 3 gets its float32 body: the plan
    answers "f32", the products' shared memory fits a block, the scratch
    (h, a, x', the LayerNorm statistics; the Gram kernel's rows) is the
    launch code's; at 720p the counts are chip_smoke.py's table."""
    task, (b, h, w) = SIZES[size]
    _, calls = _record(FILES[task], h, w, "f32", b)
    n_ffn = n_qkv = 0
    for name, args, kw in calls:
        if name == "fused_block_ffn":
            a = _ffn_args(args, kw)
            body, geo = K._ffn_plan(**a)
            assert body == "f32", a
            px = a["b"] * a["h"] * a["w"]
            assert geo["scratch"] == px * (
                (a["c"] if a["has_po"] else 0) + a["ch"] + a["e"]
                + (a["c"] + a["f"] if a["f"] else 0) + 2)
            n_ffn += 1
        elif name == "fused_qkv_stats":
            x = args[0]
            body, geo = K._qkv_plan(*x.shape, kw["heads"], False,
                                    torch.float32)
            assert body == "f32", x.shape
            assert 1 <= geo["rows"] <= -(-x.shape[1] // 4) * -(-x.shape[2]
                                                                // 16)
            n_qkv += 1
        else:
            continue
        assert geo["smem"] <= 48 * 1024 <= SMEM_LIMIT  # static shared memory
    assert n_ffn == 51 and n_qkv == 34
    if size == "deblur_1280x720":
        want = _chip_smoke().LAUNCHES_PER_CALL_F32["gopro"]
        assert (want["ffn_f32"], want["qkv_f32"]) == (n_ffn, n_qkv)


# (C, E, mode, x2 maps, po, F): the float32 forms of the paths
FORMS = {
    "dec3_gate_pair_po": (256, 640, "gate", 1, True, 0),
    "latent_gate_pair_po": (512, 1280, "gate", 1, True, 0),
    "latent_fhr_pair_no_po": (512, 1280, "gate", 1, False, 0),
    "dec3_list_4_plus_1": (256, 640, "gate", 5, True, 0),
    "dec2_list_4_plus_1": (128, 320, "gate", 5, True, 0),
    "dec1_list_3_plus_1": (64, 160, "gate", 4, True, 0),
    "enc2_gelu_ffw2": (128, 256, "gelu", 0, False, 256),
    "enc1_gelu_ffw2": (64, 128, "gelu", 0, False, 128),
    "refinement_gate": (64, 160, "gate", 0, False, 0),
    "refinement_gelu": (64, 128, "gelu", 0, False, 0),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_ffn_f32_geometry_mirrors_the_launch_sequence(form):
    """The float32 body's launches for one call, as turtle_ffn_f32_launch
    makes them: the x' product (with po; K = maps x C), the rows'
    statistics and pw1 (N = CH), the taps, pw2 (N = C), the chained FFW's
    statistics and two products; blocks of 128 rows x 128 columns (64 for
    outputs of at most 64 channels)."""
    c, e, mode, n_x2, po, f = FORMS[form]
    b, h, w = 2, 93, 161
    ch = 2 * e if mode == "gate" else e
    geo = K._ffn_f32_geometry(b, h, w, c, ch, e, mode, n_x2, po, f, True)
    rows = -(-h * w // 128)

    def blocks(n):
        return b * rows * -(-n // (64 if n <= 64 else 128))

    want = {"pw1": blocks(ch), "pw1 LN": b * -(-h * w // 8),
            "taps": b * -(-w // 16) * -(-h // 4) * -(-e // 64),
            "pw2": blocks(c)}
    if po:
        want["x'"] = blocks(c)
    if f:
        want.update({"ffw1": blocks(f), "ffw1 LN": b * -(-h * w // 8),
                     "ffw2": blocks(c)})
    assert geo["launches"] == want
    assert geo["smem"] == (2 * 8 * 132 + 2 * 8 * (64 if max(
        n for n in (c, ch, f) if n) <= 64 else 128)) * 4
    assert K._ffn_plan(b, h, w, c, ch, e, mode, n_x2, po, True, f, True,
                       torch.float32) == ("f32", geo)


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_qkv_f32_grid_covers_the_card(c):
    """Row 3's Gram kernel: about two blocks an SM in all, at most one a
    tile of 4 x 16 pixels, at least one a head and batch entry."""
    heads = c // 64
    for b, h, w in ((1, 736 // (c // 64), 1280 // (c // 64)), (15, 40, 40),
                    (2, 3, 5)):
        geo = K._qkv_f32_geometry(b, h, w, c, heads, 132)
        g = geo["rows"]
        assert 1 <= g <= -(-h // 4) * -(-w // 16)
        assert geo["launches"]["gram"] == g * heads * b
        if g < -(-h // 4) * -(-w // 16):
            assert 264 <= g * heads * b < 264 + heads * b


@pytest.mark.parametrize("change", ["no_dw", "e_not_multiple_of_4", "c528",
                                    "c8", "lists_without_po", "f24"])
def test_ffn_f32_geometry_refuses_outside_its_forms(change):
    """The float32 body's plan raises, naming the body and its forms, for a
    call it does not take; _ffn_plan sends such a call to csrc/ffn.cu."""
    args = dict(b=1, h=8, w=8, c=256, ch=1280, e=640, mode="gate", n_x2=1,
                has_po=True, f=0, has_dw=True)
    args.update({"no_dw": dict(has_dw=False),
                 "e_not_multiple_of_4": dict(ch=140, e=70, mode="gelu"),
                 "c528": dict(c=528), "c8": dict(c=8),
                 "lists_without_po": dict(n_x2=3, has_po=False),
                 "f24": dict(c=128, ch=256, e=256, mode="gelu", n_x2=0,
                             has_po=False, f=24)}[change])
    with pytest.raises(ValueError, match="csrc/ffn_f32.cu takes float32 "
                       "calls with a depthwise stage"):
        K._ffn_f32_geometry(**args)
    body, _ = K._ffn_plan(**args, po_batched=True, dtype=torch.float32)
    assert body == "tile"


@pytest.mark.parametrize("c,heads", [(256, 8), (512, 16), (576, 9), (48, 1)])
def test_qkv_f32_geometry_refuses_outside_its_forms(c, heads):
    """64 channels a head up to C = 512, or csrc/qkv_stats.cu; beyond its
    own limits (C / heads <= 64, C up to 512) the old body's plan raises."""
    with pytest.raises(ValueError, match="csrc/qkv_f32.cu takes float32 maps "
                       "of 64 channels a head"):
        K._qkv_f32_geometry(1, 8, 8, c, heads)
    assert K._qkv_plan(1, 8, 8, c, heads, False, torch.float32) == (
        "tile", None)
    if c > 512:
        with pytest.raises(ValueError, match="csrc/qkv_stats.cu takes"):
            K._qkv_f32_plan(1, 8, 8, c, heads)


def test_float32_call_no_body_takes_raises_before_any_build(monkeypatch):
    """A float32 list of x2 maps without a depthwise stage at C = 512: not
    the float32 body's form, and beyond csrc/ffn.cu's lists (up to C =
    256): the wrapper raises with the old body's limit before it builds or
    launches anything."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(K.build, "load", no_build)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    m = Maker(5, torch.float32)
    c = 512
    x = m(1, 8, 8, c)
    with pytest.raises(ValueError, match="csrc/ffn.cu takes float32 lists "
                       "of x2 maps up to C = 256"):
        K._ffn_launch(x, [m(1, 8, 8, c), m(1, 8, 8, c)], [m(c, c), m(c, c)],
                      None, m(c), m(c), m(c, 2 * c), None, None, None,
                      m(c, c), None, None, "gate", None)


@pytest.mark.parametrize("form", ["ffw2", "fhr", "qkv_biases"])
def test_f32_bodies_launch_code_passes_its_scratch(form, monkeypatch):
    """The launch code of the float32 bodies (stubbed launch): the chained
    FFW's y and g maps, the FHR pair's x2 read in place (no x'), row 3 with
    both biases; one launch of the wrapper each, counted on the float32
    body."""
    fake = _FakeLib()
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    KP.reset_launch_counts()
    m = Maker(9, torch.float32)
    b, h, w = 2, 9, 11
    if form == "ffw2":
        c, f = 128, 256
        ffw2 = dict(ln_w=m(c), ln_b=m(c), w1=m(c, f), b1=m(f), w2=m(f, c),
                    b2=m(c), scale=m(c))
        K._ffn_launch(m(b, h, w, c), None, None, None, m(c), m(c), m(c, f),
                      m(f), m(3, 3, f), m(f), m(f, c), m(c), m(c), "gelu",
                      ffw2)
        want = [False, True, True, True, True, True]
    elif form == "fhr":
        c = 512
        K._ffn_launch(m(b, h, w, c), m(b, h, w, c), None, None, m(c), m(c),
                      m(c, 4 * c), None, m(3, 3, 4 * c), None, m(2 * c, c),
                      None, None, "gate", None)
        want = [False, True, True, False, False, True]
    else:
        c = 256
        K._qkv_stats_launch(m(b, h, w, c), m(c), m(c), m(c, 3 * c),
                            m(3 * c), m(3, 3, 3 * c), m(3 * c), 4)
    ptrs, ints, is_bf16 = fake.launches[0]
    counts = KP.launch_counts()
    assert len(fake.launches) == 1 and is_bf16 == 0
    if form == "qkv_biases":
        g = K._qkv_f32_grid(b, h, w, 4, 132)
        assert ints == [b, h, w, c, 4, g] and None not in ptrs
        assert counts["qkv_stats"] == counts["qkv_f32"] == 1
    else:
        assert [p is not None for p in ptrs[25:]] == want
        assert counts["ffn"] == counts["ffn_f32"] == 1
