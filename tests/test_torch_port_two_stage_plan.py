"""Which body rows 12 and 13 give each call: row 13's Hopper bodies of
kernels/csrc/chain2_wg.cu (bf16: the pair of ReducedAttn+FFW blocks at C =
64 and 128, the ReducedAttn+GFFW block at C = 64) for every two-stage call
the shipped families make under ("two_stage",), chain2.cu for the rest;
row 12's streaming body of kernels/csrc/sparse_wg.cu for bf16 score rows of
a multiple of 8 keys, sab.cu for the rest. Runs on the CPU: each family at
full width through one frame of a small map (the plan depends on widths and
forms, not on H and W), every fused_two_stage call recorded and handed to
the plan as the card would see it (bf16); chip_smoke.py's table of launches
a model call must be what the plan gives. Also the wrappers' refusals, made
before any build."""

import pytest
import torch

from test_torch_port_ffn_plan import FAMILIES, _chip_smoke
from turtlevsr_tpu_torch import kernels as kernels_pkg
from turtlevsr_tpu_torch.config.options import load_options
from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as TT

BF16 = torch.bfloat16
SMEM_LIMIT = 232448
PAIR64 = (("gelu", 128, 128), ("gelu", 128, 128))       # enc1
RA_GFFW64 = (("gelu", 128, 0), ("gate", 160, 0))        # the refinement
PAIR128 = (("gelu", 256, 256), ("gelu", 256, 256))      # enc2


def _form(st, ffw):
    return (st["mode"], st["w2"].shape[0],
            ffw["w1"].shape[1] if ffw is not None else 0)


def _record(family, monkeypatch):
    """(shape, form of stage 1, form of stage 2) of every fused_two_stage
    call of one frame under ("two_stage",)."""
    path, overrides, side = FAMILIES[family]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    model = build_model(opt, device="cpu", fuse=("two_stage",))
    calls = []
    real = TT.fused_two_stage

    def recorder(x, st1, st2, *, ffw1=None, ffw2=None):
        calls.append((tuple(x.shape), _form(st1, ffw1), _form(st2, ffw2)))
        return real(x, st1, st2, ffw1=ffw1, ffw2=ffw2)

    monkeypatch.setattr(TT, "fused_two_stage", recorder)
    frames = torch.rand(1, 2, side, side, 3,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(frames, model.init_cache(1, side, side))
    return calls


@pytest.mark.parametrize("family", ["gopro", "derain", "sr"])
def test_plan_sends_every_two_stage_call_to_the_hopper_bodies(family,
                                                              monkeypatch):
    """Every call of the conv-only levels: enc1's pair and the refinement's
    two blocks at C = 64 to the C = 64 body, enc2's three pairs at C = 128 to
    the C = 128 body; chain2.cu none; as many launches as chip_smoke.py's
    table says a model call makes."""
    calls = _record(family, monkeypatch)
    forms = []
    for (b, h, w, c), f1, f2 in calls:
        body, geo = C2._two_stage_plan(b, h, w, c, f1, f2, BF16)
        assert body == ("c64" if c == 64 else "wg"), (c, f1, f2)
        assert geo["smem"] <= SMEM_LIMIT
        forms.append((c, f1, f2))
    assert sorted(forms) == sorted([(64, *PAIR64), (64, *RA_GFFW64),
                                    (64, *RA_GFFW64), (128, *PAIR128),
                                    (128, *PAIR128), (128, *PAIR128)])
    want = _chip_smoke().LAUNCHES_PER_CALL[f"{family}_two_stage"]
    assert want["two_stage"] == want["two_stage_wg"] == len(calls) == 6


@pytest.mark.parametrize("tag", ["gopro", "gopro_t1_fhr", "gopro_enc3_ffw",
                                 "gopro_fused", "derain", "sr"])
def test_chip_smoke_has_no_two_stage_launch_off_the_two_stage_plan(tag):
    want = _chip_smoke().LAUNCHES_PER_CALL[tag]
    assert want["two_stage"] == want["two_stage_wg"] == 0
    assert want["sab_sparse_softmax"] == want["sparse_wg"] == 0


# (B, H, W, C, forms) of the paths: whole padded 720p frames (736 x 1280 at
# enc1 and the refinement, 368 x 640 at enc2), 15 tiles of 320 and of the SR
# tiles' 256
PATH_SHAPES = [(1, 736, 1280, 64, PAIR64), (1, 368, 640, 128, PAIR128),
               (1, 736, 1280, 64, RA_GFFW64), (15, 320, 320, 64, PAIR64),
               (15, 160, 160, 128, PAIR128), (15, 320, 320, 64, RA_GFFW64),
               (15, 256, 256, 64, PAIR64), (13, 128, 128, 128, PAIR128),
               (1, 37, 29, 64, RA_GFFW64), (2, 19, 13, 128, PAIR128)]


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_two_stage_plan_geometry(shape):
    """The C = 64 body: 16 x 8 output tiles, a persistent grid of one block
    an SM (fewer where there are fewer tiles); the C = 128 body: one 8 x 8
    tile a block, a ring of at least two stages; both within a block's
    shared memory."""
    b, h, w, c, (f1, f2) = shape
    body, geo = C2._two_stage_plan(b, h, w, c, f1, f2, BF16, n_sm=132)
    assert geo["smem"] <= SMEM_LIMIT
    if c == 64:
        tiles = b * -(-h // 16) * -(-w // 8)
        assert body == "c64" and geo["tile"] == (16, 8)
        assert geo["tiles"] == tiles and geo["blocks"] == min(tiles, 132)
        assert geo["form"] == ("pair" if f2[0] == "gelu" else "ra_gffw")
    else:
        tiles = b * -(-h // 8) * -(-w // 8)
        assert body == "wg" and geo["tile"] == (8, 8)
        assert geo["tiles"] == geo["blocks"] == tiles
        assert geo["stages"] >= 2


# calls the Hopper bodies do not take: float32, other widths, the forms
# swapped or cut, hidden widths their chunks do not divide, one FFW alone
OTHER_CALLS = {
    "float32": (64, *PAIR64, torch.float32),
    "c16": (16, ("gelu", 32, 32), ("gelu", 32, 32), BF16),
    "c48_ra_gffw": (48, ("gelu", 96, 0), ("gate", 64, 0), BF16),
    "c256": (256, ("gelu", 512, 512), ("gelu", 512, 512), BF16),
    "c64_gate_first": (64, ("gate", 128, 0), ("gate", 160, 0), BF16),
    "c64_ffw_f64": (64, ("gelu", 128, 64), ("gelu", 128, 64), BF16),
    "c64_one_ffw": (64, ("gelu", 128, 128), ("gelu", 128, 0), BF16),
    "c64_e96": (64, ("gelu", 96, 128), ("gelu", 128, 128), BF16),
    "c64_gate_e20": (64, ("gelu", 128, 0), ("gate", 20, 0), BF16),
    "c128_ra_gffw": (128, ("gelu", 256, 0), ("gate", 320, 0), BF16),
    "c128_e192": (128, ("gelu", 192, 256), ("gelu", 256, 256), BF16),
    "c128_no_ffw": (128, ("gelu", 256, 0), ("gelu", 256, 0), BF16),
}


@pytest.mark.parametrize("change", list(OTHER_CALLS))
def test_two_stage_plan_keeps_other_calls_on_chain2_cu(change):
    c, f1, f2, dtype = OTHER_CALLS[change]
    assert C2._two_stage_plan(1, 40, 40, c, f1, f2, dtype) == ("tile", None)


def test_two_stage_c64_smem_grows_with_the_weights():
    """The C = 64 body keeps both stages' w1 and w2: wide enough stages no
    longer fit, and the plan then leaves them to chain2.cu."""
    assert C2._k64_smem(*PAIR64) <= SMEM_LIMIT
    assert C2._k64_smem(*RA_GFFW64) <= SMEM_LIMIT
    wide = (("gelu", 384, 128), ("gelu", 384, 128))
    assert C2._k64_smem(*wide) > SMEM_LIMIT
    assert C2._two_stage_plan(1, 64, 64, 64, *wide, BF16) == ("tile", None)


# (BN, Q, K) of row 12 at the paths' score shapes: a padded 720p frame's 46 x
# 80 window tokens (4 / 4 / 3 frames at dec3 / dec2 / dec1), 15 tiles of 320
# (20 x 20 tokens), 15 SR tiles (16 x 16)
SPARSE_PATH_SHAPES = [(4, 3680, 3680), (3, 3680, 3680), (60, 400, 400),
                      (60, 256, 256), (45, 400, 400)]


@pytest.mark.parametrize("shape", SPARSE_PATH_SHAPES)
def test_sparse_plan_sends_the_score_rows_to_the_streaming_body(shape):
    bn, q, k = shape
    body, geo = S._sparse_plan(bn, q, k, BF16)
    assert body == "wg"
    assert geo["smem"] == S._spw_smem(k) <= SMEM_LIMIT
    assert geo["grid"] == (q, -(-bn // 4)) and geo["entries"] == 4


@pytest.mark.parametrize("change", ["float32", "k_130", "k_3", "k_4",
                                    "k_24000"])
def test_sparse_plan_keeps_other_calls_on_sab_cu(change):
    bn, q, k, dtype = 4, 400, 400, BF16
    if change == "float32":
        dtype = torch.float32
    else:
        k = int(change[2:])
    assert S._sparse_plan(bn, q, k, dtype) == ("tile", None)


def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name} for a call it refuses")

    monkeypatch.setattr(build, "load", refuse)


def _stage(c, e, mode="gelu"):
    ch = 2 * e if mode == "gate" else e
    return dict(ln_w=torch.ones(c, dtype=BF16), w1=torch.zeros(c, ch, dtype=BF16),
                wd=torch.zeros(3, 3, ch, dtype=BF16),
                w2=torch.zeros(e, c, dtype=BF16), mode=mode)


REFUSED_TWO_STAGE = {
    "c24": lambda: (torch.zeros(1, 8, 8, 24, dtype=BF16), _stage(24, 48),
                    _stage(24, 48), {}),
    "c256": lambda: (torch.zeros(1, 8, 8, 256, dtype=BF16), _stage(256, 512),
                     _stage(256, 512), {}),
    "float64": lambda: (torch.zeros(1, 8, 8, 64, dtype=torch.float64),
                        _stage(64, 128), _stage(64, 128), {}),
    "no_taps": lambda: (torch.zeros(1, 8, 8, 64, dtype=BF16),
                        {**_stage(64, 128), "wd": None}, _stage(64, 128), {}),
    "bad_mode": lambda: (torch.zeros(1, 8, 8, 64, dtype=BF16),
                         _stage(64, 128), {**_stage(64, 128), "mode": "relu"},
                         {}),
    "w2_shape": lambda: (torch.zeros(1, 8, 8, 64, dtype=BF16),
                         _stage(64, 128),
                         {**_stage(64, 128), "w2": torch.zeros(64, 64,
                                                                dtype=BF16)},
                         {}),
    "ffw_f24": lambda: (torch.zeros(1, 8, 8, 64, dtype=BF16), _stage(64, 128),
                        _stage(64, 128),
                        {"ffw1": dict(ln_w=torch.ones(64, dtype=BF16),
                                      w1=torch.zeros(64, 24, dtype=BF16),
                                      b1=torch.zeros(24, dtype=BF16),
                                      w2=torch.zeros(24, 64, dtype=BF16),
                                      b2=torch.zeros(64, dtype=BF16),
                                      scale=torch.zeros(64, dtype=BF16))}),
    "not_contiguous": lambda: (
        torch.zeros(1, 8, 8, 64, dtype=BF16).transpose(1, 2),
        _stage(64, 128), _stage(64, 128), {}),
}


@pytest.mark.parametrize("case", list(REFUSED_TWO_STAGE))
def test_two_stage_wrapper_refuses_bad_shapes_before_any_build(case,
                                                               monkeypatch):
    _no_build(monkeypatch)
    x, st1, st2, kw = REFUSED_TWO_STAGE[case]()
    with pytest.raises(ValueError):
        C2._launch(x, st1, st2, kw.get("ffw1"), kw.get("ffw2"))


@pytest.mark.parametrize("case", ["float64", "too_many_entries"])
def test_sparse_wrapper_refuses_bad_shapes_before_any_build(case,
                                                            monkeypatch):
    _no_build(monkeypatch)
    if case == "float64":
        scores = torch.zeros(2, 8, 8, dtype=torch.float64)
    else:
        scores = torch.zeros(65536, 1, 8, dtype=BF16)
    with pytest.raises(ValueError):
        S._sparse_launch(scores, torch.zeros(scores.shape[1:],
                                             dtype=scores.dtype), 5)


def test_launch_counts_read_the_new_bodies():
    counts = kernels_pkg.launch_counts()
    assert {"two_stage", "two_stage_wg", "sab_sparse_softmax",
            "sparse_wg"} <= set(counts)
    C2.fused_two_stage.launches_wg = 3
    S.sab_sparse_softmax.launches_wg = 2
    counts = kernels_pkg.launch_counts()
    assert (counts["two_stage_wg"], counts["sparse_wg"]) == (3, 2)
    kernels_pkg.reset_launch_counts()
    counts = kernels_pkg.launch_counts()
    assert (counts["two_stage_wg"], counts["sparse_wg"]) == (0, 0)
