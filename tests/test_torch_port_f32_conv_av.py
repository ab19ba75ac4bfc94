"""The float32 bodies of rows 5 and 11 (kernels/csrc/conv_f32.cu,
kernels/csrc/attn_v_f32.cu, both on csrc/f32_tile.cuh's hooked product):
which float32 calls their plans take, their launch geometry and scratch, the
refusals outside their forms, and torch mirrors of what the kernels compute
where they gather and where they store.

Runs on the CPU. Every fused_conv3x3 and sab_attn_v_merge call of one model
call in float32 (recorded on fake tensors under the ``attn_v_merge`` plan, as
tests/test_torch_port_frame_sizes.py records) at the sizes of
tests/test_torch_port_f32_bodies.py and at 1920x1080 goes to the float32
body, its shared memory within a block's; the launch code reaches the
body's launch (stubbed: no card here) with the LayerNorm's statistics
scratch; the product's tile kinds mirror csrc/f32_tile.cuh's; the implicit GEMM's A gather (the shifted pixel rows, the zero
padding after the LayerNorm, K padded at Cin = 3) and the merge's store
addresses, mirrored in torch, give the plain versions in float64. The
kernels' arithmetic against the plain versions runs on the card
(tests/test_torch_port_cuda.py -k "f32_body").
"""

import os
import re
import warnings

import pytest
import torch

from test_torch_port_f32_bodies import SIZES
from test_torch_port_float32 import _FakeLib, _chip_smoke
from test_torch_port_frame_sizes import FILES
from torch_port_util import Maker
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.config.options import (
    load_options,
    model_config_from_options,
)
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import turtle as turtle_mod
from turtlevsr_tpu_torch.ops.norm import LN_EPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100
WRAPPERS = ("fused_conv3x3", "sab_attn_v_merge")
ALL_SIZES = {**SIZES, "deblur_1920x1080": ("deblur", (1, 1080, 1920))}


def _record(path: str, h: int, w: int, batch: int, wrappers=WRAPPERS,
            fuse=("attn_v_merge",)):
    """[(wrapper, args, kwargs)] of the wrappers' calls (rows 5 and 11) in
    one float32 model call on a batch of [previous, current] pairs of (h, w)
    frames, on fake tensors, under the plan ``fuse`` (``attn_v_merge``: row
    11's only caller)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from turtlevsr_tpu_torch.models.blocks import KernelWeights
    from turtlevsr_tpu_torch.models.turtle import Turtle

    cfg = model_config_from_options(load_options(os.path.join(ROOT, path),
                                                 is_train=False))
    with torch.device("meta"):
        model = Turtle(cfg, fuse=fuse).eval().to(torch.float32)
    calls, saved = [], []
    for mod in (blocks_mod, turtle_mod):
        for name in wrappers:
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
            warnings.filterwarnings("ignore", "Accessing the data pointer")
            model.to_empty(device="cpu")
            for m in model.modules():
                if isinstance(m, KernelWeights):
                    m.kernel_weights()
            model(torch.zeros(batch, 2, h, w, 3),
                  model.init_cache(batch, h, w))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return cfg, calls


@pytest.mark.parametrize("size", list(ALL_SIZES))
def test_every_float32_call_of_rows_5_and_11_on_the_float32_bodies(size):
    """Each float32 call of rows 5 and 11 gets its float32 body: the plan
    answers "f32", the shared memory fits a block, the LayerNorm forms get
    their statistics scratch; the ending conv (Cout = 3) the narrow body;
    at 720p the counts are chip_smoke.py's table."""
    task, (b, h, w) = ALL_SIZES[size]
    cfg, calls = _record(FILES[task], h, w, b)
    n_conv = n_av = n_ln = 0
    for name, args, kw in calls:
        x = args[0]
        if name == "fused_conv3x3":
            bb, hh, ww, cin = x.shape
            cout = args[1].shape[3]
            ln = kw.get("ln_w") is not None
            body, geo = K._conv_plan(bb, hh, ww, cin, cout, ln, torch.float32)
            assert body == "f32", (x.shape, cout)
            assert geo["scratch"] == (bb * hh * ww * 2 if ln else 0)
            assert geo["body"] == ("narrow" if cout <= 4 else "product")
            n_conv += 1
            n_ln += ln
        else:
            v = args[1][0] if isinstance(args[1], (list, tuple)) else args[1]
            body, geo = S._attn_v_plan(x.shape[0], x.shape[1], v.shape[-1],
                                       torch.float32)
            assert body == "f32", x.shape
            n_av += 1
        assert geo["smem"] <= SMEM_LIMIT
    sab = cfg.variant != "t0"
    assert n_conv == 11 and n_ln == 3
    assert n_av == (3 if sab else 0)
    if size == "deblur_1280x720":
        cs = _chip_smoke()
        assert cs.LAUNCHES_PER_CALL_F32["gopro"]["conv3x3_f32"] == n_conv
        assert cs.LAUNCHES_PER_CALL_F32["gopro_fused"]["attn_v_f32"] == n_av


# (B, H, W, Cin, Cout, LN): the paths' forms, ragged maps, tile batches
CONV_FORMS = [(1, 92, 160, 512, 1024, False), (2, 37, 53, 3, 64, False),
              (1, 731, 1273, 64, 3, False), (15, 80, 80, 256, 256, True),
              (8, 320, 320, 64, 32, False), (1, 19, 27, 16, 5, False),
              (2, 23, 29, 128, 40, True), (1, 9, 9, 64, 3, True)]


@pytest.mark.parametrize("form", CONV_FORMS, ids=str)
def test_conv_f32_geometry_mirrors_the_launch_sequence(form, monkeypatch):
    """Row 5's float32 launches, as turtle_conv_f32_launch makes them: the
    narrow body for Cout <= 4 without the LayerNorm (32 x 32 pixels a
    block), else the rows' statistics with the LayerNorm (a warp a pixel)
    and the product on the tile of Cout (256 x 32 up to 32 channels, 128 x
    64 up to 64, else 128 x 128; 64 x 64 where the 128-row tile's grid has
    fewer blocks than half the card's 132 SMs); the launch code passes the
    geometry's ints and the statistics scratch (stubbed launch), one launch
    of the wrapper counted on the float32 body."""
    b, h, w, cin, cout, ln = form
    geo = K._conv_f32_geometry(b, h, w, cin, cout, ln)
    m = h * w
    if cout <= 4 and not ln:
        want = {"narrow": b * -(-w // 32) * -(-h // 32)}
        assert geo["smem"] == (34 * 34 * 20 + 9 * 16 * 4) * 4
        assert geo["ints"] == [0, 0]
    else:
        bm, bn = (256, 32) if cout <= 32 else (128, 64) if cout <= 64 else (
            128, 128)
        if bn > 32 and b * -(-m // bm) * -(-cout // bn) < 66:
            bm, bn = 64, 64
        want = {"product": b * -(-m // bm) * -(-cout // bn)}
        if ln:
            want["LN"] = b * -(-m // 8)
        assert K._fp_tile(geo["kind"]) == (bm, bn)
        assert geo["smem"] == K._fp_smem(geo["kind"])
        assert geo["ints"] == [1, K._FP_KINDS[geo["kind"]][0]]
    assert geo["launches"] == want and geo["blocks"] == sum(want.values())
    assert geo["scratch"] == (b * m * 2 if ln else 0)
    assert K._conv_plan(b, h, w, cin, cout, ln, torch.float32) == ("f32", geo)
    assert K._conv_plan(b, h, w, cin, cout, ln, torch.bfloat16) == (
        "tile", None)

    fake = _FakeLib()
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    KP.reset_launch_counts()
    mk = Maker(3, torch.float32)
    x = mk(1, 5, 7, cin)
    lnk = dict(ln_w=mk(cin), ln_b=None) if ln else {}
    K._conv3x3_launch(x, mk(3, 3, cin, cout), mk(cout), lnk.get("ln_w"),
                      lnk.get("ln_b"))
    (ptrs, ints, is_bf16), = fake.launches
    tiny = K._conv_f32_geometry(1, 5, 7, cin, cout, ln)
    assert is_bf16 == 0 and ints == [1, 5, 7, cin, cout, *tiny["ints"]]
    assert len(ptrs) == 7 and (ptrs[6] is not None) == ln
    counts = KP.launch_counts()
    assert counts["conv3x3"] == counts["conv3x3_f32"] == 1


# (B, H, W, Cin, Cout, LN) -> the product's tile kind, as measured best on
# the paths' shapes: the ring at Cin >= 512 where A and B are copied as they
# lie, the warps' layout with stages of 16 at Cout <= 64, the 64 x 64 tile
# for grids under 66 blocks
CONV_KINDS = {
    (1, 92, 160, 512, 1024, False): "ring",
    (1, 92, 160, 512, 1024, True): "wide",
    (1, 92, 160, 512, 1022, False): "wide",
    (1, 184, 320, 256, 512, False): "wide",
    (1, 184, 320, 256, 256, True): "wide",
    (1, 368, 640, 128, 64, False): "half_w",
    (1, 736, 1280, 64, 32, False): "quarter",
    (1, 736, 1280, 3, 64, False): "half_w",
    (1, 16, 16, 512, 1024, False): "small",
    (1, 32, 32, 256, 128, False): "small",
    (1, 64, 64, 128, 64, False): "small",
    (1, 16, 16, 64, 32, False): "quarter",
    (1, 9, 9, 64, 3, True): "quarter",
}


@pytest.mark.parametrize("form", list(CONV_KINDS), ids=str)
def test_conv_f32_tile_kind_by_shape(form):
    """The tile kind row 5's plan gives a shape (kernels/ffn.py
    _conv_f32_geometry): one of the kinds csrc/conv_f32.cu instantiates
    (ConvP::KINDS), with its shared memory."""
    geo = K._conv_f32_geometry(*form)
    assert geo["body"] == "product" and geo["kind"] == CONV_KINDS[form]
    assert geo["smem"] == K._fp_smem(geo["kind"]) <= SMEM_LIMIT


def _source(name: str) -> str:
    with open(os.path.join(ROOT, "turtlevsr_tpu_torch", "kernels", "csrc",
                           name)) as f:
        return f.read()


# the tile kinds each problem class of csrc/f32_tile.cuh's product
# instantiates (P::KINDS): the kinds its plan gives
KINDS_OF = {"f32_tile.cuh": {"wide", "half"},
            "conv_f32.cu": {"wide", "ring", "half_w", "quarter", "small"},
            "attn_v_f32.cu": {"wide"}}


@pytest.mark.parametrize("kind", list(K._FP_KINDS))
def test_fp_kinds_mirror_the_source(kind):
    """kernels/ffn.py's _FP_KINDS against csrc/f32_tile.cuh: the kind's id
    is its place in FpKind, its tile and flags those of fp_rm, fp_tn, fp_tx
    and fp_flags; each problem class (GemmP for rows 1 and 3, ConvP, AvP)
    instantiates the kinds its plan gives and no other."""
    src = _source("f32_tile.cuh")
    enum = re.search(r"enum FpKind \{([^}]*)\}", src).group(1)
    names = [e.split("=")[0].strip() for e in enum.split(",")]
    kid, rm, tn, tx, flags = K._FP_KINDS[kind]
    assert names.index("FP_" + kind.upper()) == kid
    assert (rm, tn, tx) == (4 if kind == "small" else 8,
                            8 if kind in ("wide", "ring") else 4,
                            8 if kind == "quarter" else 16)
    assert flags == {"wide": 0, "half": 0, "ring": 7}.get(kind, 6)
    pats = {"f32_tile.cuh": r"struct GemmP \{\s+using Args = F32Gemm;\s+"
            r"static constexpr unsigned KINDS = ([^;]*);",
            "conv_f32.cu": r"static constexpr unsigned KINDS =\s+([^;]*);",
            "attn_v_f32.cu": r"static constexpr unsigned KINDS = ([^;]*);"}
    for f, pat in pats.items():
        taken = re.findall(r"1u << (FP_\w+)",
                           re.search(pat, _source(f)).group(1))
        assert set(taken) == {"FP_" + k.upper() for k in KINDS_OF[f]}, f
    assert any(kind in kinds for kinds in KINDS_OF.values())


def _gathered_a(x, ln_w=None, ln_b=None):
    """A (B, H W, K8) of conv_f32.cu's implicit GEMM as its loader stages
    it: row m is output pixel (y, x), column k = tap Cin + c < 9 Cin holds
    channel c of pixel (y + dy - 1, x + dx - 1) of k's tap (dy, dx) of the
    LayerNorm's output, zeros outside the image (after the LayerNorm) and
    past 9 Cin up to the multiple of the stage (27 -> 32 at Cin = 3)."""
    b, h, w, cin = x.shape
    if ln_w is not None:
        mu = x.mean(-1, keepdim=True)
        rs = 1.0 / torch.sqrt((x - mu).square().mean(-1, keepdim=True)
                              + LN_EPS)
        x = ((x - mu) * rs * ln_w + ln_b) if ln_b is not None else (
            x * rs * ln_w)
    k_all = 9 * cin
    k8 = -(-k_all // 8) * 8
    m = torch.arange(h * w)
    y, xx = m // w, m % w
    k = torch.arange(k8)
    tap, c = k // cin, k % cin
    yy = y[:, None] + tap[None, :] // 3 - 1
    xs = xx[:, None] + tap[None, :] % 3 - 1
    valid = ((k < k_all)[None, :] & (yy >= 0) & (yy < h) & (xs >= 0)
             & (xs < w))
    src = yy.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    a = x.reshape(b, h * w, cin)[:, src, c.clamp(max=cin - 1)[None, :]
                                 .expand(h * w, -1)]
    return a * valid, k8


@pytest.mark.parametrize("shape", [(2, 7, 9, 3, 5, False, None),
                                   (1, 6, 11, 16, 24, True, None),
                                   (2, 5, 8, 64, 3, True, None),
                                   (1, 9, 7, 64, 40, False, True),
                                   (2, 4, 13, 32, 8, True, False)],
                         ids=str)
def test_conv_f32_gather_mirror_is_the_plain_conv(shape):
    """The implicit GEMM's A as conv_f32.cu stages it, times the weight as
    its (9 Cin, Cout) matrix (zero rows past 9 Cin), plus the bias, is the
    plain version in float64: the shift, the zero padding of LN(x) and the
    K padding at Cin = 3 mirrored."""
    b, h, w, cin, cout, bias, ln = shape
    mk = Maker(11, torch.float64)
    x, wt = mk(b, h, w, cin), mk(3, 3, cin, cout)
    bb = mk(cout) if bias else None
    lnk = {} if ln is None else dict(ln_w=1.0 + 0.2 * mk(cin),
                                     ln_b=mk(cin) if ln else None)
    a, k8 = _gathered_a(x, **lnk)
    bmat = torch.zeros(k8, cout, dtype=torch.float64)
    bmat[:9 * cin] = wt.reshape(9 * cin, cout)
    got = (a @ bmat).reshape(b, h, w, cout)
    if bb is not None:
        got = got + bb
    want = K.conv3x3_plain(x, wt, bb, **lnk)
    torch.testing.assert_close(got, want, atol=1e-9, rtol=0)


def _store_offsets(bn, hw, d, c, merge, ws, hh, ww):
    """attn_v_f32.cu's store (AvP::store): the flat offset of output element
    (n, query m, column d) in the merged maps (BN, H, W, c) or the slots
    (BN, S, HW, c)."""
    n = torch.arange(bn)[:, None, None]
    m = torch.arange(hw)[None, :, None]
    dd = torch.arange(d)[None, None, :]
    s, cc = dd // c, dd % c
    if merge:
        p1, p2, i, j = s // ws, s % ws, m // ww, m % ww
        return ((n * (ws * hh) + p1 * hh + i) * (ws * ww) + p2 * ww + j) * c \
            + cc
    return ((n * (d // c) + s) * hw + m) * c + cc


@pytest.mark.parametrize("shape", [(1, 1, 3, 5, 2, 8), (2, 3, 4, 4, 2, 16),
                                   (1, 5, 2, 3, 4, 8), (2, 2, 5, 4, 1, 24)],
                         ids=str)
def test_attn_v_f32_store_mirror_is_the_plain_merge(shape):
    """The products of every entry, stored at attn_v_f32.cu's addresses
    (each thread's four columns in one slot), are the plain merge and slots
    in float64, the values of entry b * NF + i read from ring view i."""
    b, nf, hh, ww, ws, c = shape
    hw, d = hh * ww, ws * ws * c
    mk = Maker(13, torch.float64)
    a = mk(b * nf, hw, hw).abs()
    ring = mk(b, nf, hw, d)
    vs = [ring[:, i] for i in range(nf)]
    tok = torch.stack([a[bi * nf + i] @ vs[i][bi] for bi in range(b)
                       for i in range(nf)])
    for d4 in range(0, d, 4):  # a thread's piece stays in its slot
        assert d4 // c == (d4 + 3) // c
    for merge in (True, False):
        out = torch.zeros(b * nf * hw * d, dtype=torch.float64)
        out[_store_offsets(b * nf, hw, d, c, merge, ws, hh, ww).flatten()] = \
            tok.flatten()
        if merge:
            want = S.attn_v_merge_plain(a, vs, ws, hh * ws, ww * ws)
        else:
            want = S.attn_v_slots_plain(a, vs, c)
        torch.testing.assert_close(out.reshape(want.shape), want, atol=1e-9,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(8, 400, 4096), (4, 3680, 4096),
                                   (3, 3680, 16384), (2, 221, 16)], ids=str)
def test_attn_v_f32_geometry_and_launch(shape, monkeypatch):
    """Row 11's float32 launch, as turtle_attn_v_f32_launch makes it: the
    product over BN entries on the 128 x 128 tile, csrc/attn_v.cu's ints;
    the launch code (stubbed) sends a float32 call there with the ring
    views' own batch strides."""
    bn, hw, d = shape
    geo = S._attn_v_f32_geometry(bn, hw, d)
    assert geo["blocks"] == bn * -(-hw // 128) * -(-d // 128)
    assert geo["smem"] == K._fp_smem("wide") == 2 * 8 * (128 + 4 + 128) * 4
    assert geo["kind"] == "wide"
    assert S._attn_v_plan(bn, hw, d, torch.float32) == ("f32", geo)
    assert S._attn_v_plan(bn, hw, d, torch.bfloat16) == ("tile", None)

    fake = _FakeLib()
    monkeypatch.setattr(S.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    KP.reset_launch_counts()
    mk = Maker(5, torch.float32)
    nf, hq, wq, ws = 2, 3, 5, 2
    a = mk(2 * nf, hq * wq, hq * wq)
    ring = mk(2, nf, hq * wq, ws * ws * 8)
    vs = [ring[:, i] for i in range(nf)]
    S._attn_v_launch("sab_attn_v_merge", a, vs,
                     torch.empty(2 * nf, hq * ws, wq * ws, 8), 8, True, ws,
                     hq, wq)
    (ptrs, ints, _), = fake.launches
    assert len(ptrs) == 7 and ptrs[4:] == [None] * 3
    assert ints[9:12] == [hq * wq * hq * wq, nf * hq * wq * 32,
                          nf * hq * wq * 32]
    assert len(ints) == 15


def test_calls_outside_the_forms_raise_before_any_build(monkeypatch):
    """The float32 bodies' geometries raise naming the body and its forms;
    the wrappers' launch code raises before it builds or launches
    anything for such calls."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(K.build, "load", no_build)
    with pytest.raises(ValueError, match="csrc/conv_f32.cu takes float32 "
                       "calls with the LayerNorm at Cin a multiple of 4 up "
                       "to 512"):
        K._conv_f32_geometry(1, 8, 8, 516, 64, True)
    with pytest.raises(ValueError, match="csrc/conv_f32.cu takes"):
        K._conv_f32_geometry(70000, 1, 1, 4, 4, False)
    with pytest.raises(ValueError, match="csrc/attn_v_f32.cu takes float32 "
                       "up to 65535 entries, D a multiple of 8"):
        S._attn_v_f32_geometry(4, 400, 12)
    with pytest.raises(ValueError, match="csrc/attn_v_f32.cu takes"):
        S._attn_v_f32_geometry(70000, 4, 8)
    mk = Maker(7, torch.float32)
    x = mk(1, 4, 4, 520)
    with pytest.raises(ValueError, match="C must be a multiple of 16 up to "
                       "512"):
        K._conv3x3_launch(x, mk(3, 3, 520, 8), None, mk(520), None)
    a = mk(2, 4, 4)
    with pytest.raises(ValueError, match="slot width must be a multiple of "
                       "8"):
        S._attn_v_launch("sab_attn_v_merge", a, [mk(2, 4, 12)],
                         torch.empty(2, 4, 4, 12), 12, True, 1, 2, 2)
