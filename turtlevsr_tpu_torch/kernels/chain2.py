"""Two chained depthwise stages in one pass over the map (row 13), and its
plain version.

A stage is a dict in the layout of ``fused_block_ffn``'s keywords: {ln_w,
ln_b?, w1 (C, CH), b1?, wd (3, 3, CH), bd?, w2 (E, C), b2?, scale?, mode}
with mode 'gelu' (E = CH) or 'gate' (E = CH / 2); an FFW is {ln_w, ln_b?,
w1 (C, F), b1, w2 (F, C), b2, scale}. ``fused_two_stage`` launches a
kernel on a CUDA tensor (or raises): the Hopper bodies of
``csrc/chain2_wg.cu`` for the bf16 forms of the conv-only levels, the
kernel of ``csrc/chain2.cu`` for the rest (:func:`_two_stage_plan`). On a
CPU tensor, and only there, it runs the plain version: the two split FFN
chains, with y rounded to the map's type between them, where the split
kernels store it.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _SMEM_LIMIT,
    _call,
    _check,
    _check_map,
    _check_smem,
    _need_cuda,
    _sm_count,
    ffn_plain,
)

TWO_STAGE_MAX_C = 128  # the widest map csrc/chain2.cu takes
_STAGE_KEYS = ("ln_w", "ln_b", "w1", "b1", "wd", "bd", "w2", "b2", "scale")
_FFW_KEYS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "scale")


def two_stage_supported(c: int) -> bool:
    """Whether the kernel takes maps of c channels (the levels' gate)."""
    return c % 16 == 0 and 16 <= c <= TWO_STAGE_MAX_C


def two_stage_plain(x, st1, st2, *, ffw1=None, ffw2=None):
    """Plain version of :func:`fused_two_stage`."""
    y = ffn_plain(x, **st1, ffw2=ffw1)
    return ffn_plain(y, **st2, ffw2=ffw2)


def _stage_operands(i: int, x, st, ffw):
    """(16 addresses, 4 ints) of one stage and its FFW."""
    c = x.shape[-1]
    if st.get("wd") is None:
        raise ValueError(f"stage {i}: a stage of fused_two_stage needs its "
                         "depthwise taps wd")
    mode = st["mode"]
    if mode not in ("gate", "gelu"):
        raise ValueError(f"stage {i}: unknown mode {mode!r}")
    ch = st["w1"].shape[1]
    e = ch // 2 if mode == "gate" else ch
    shapes = {"ln_w": (c,), "ln_b": (c,), "w1": (c, ch), "b1": (ch,),
              "wd": (3, 3, ch), "bd": (ch,), "w2": (e, c), "b2": (c,),
              "scale": (c,)}
    ptrs = [_check(f"st{i}.{k}", st.get(k), x, shapes[k]) for k in _STAGE_KEYS]
    f = 0
    if ffw is None:
        ptrs += [None] * len(_FFW_KEYS)
    else:
        f = ffw["w1"].shape[1]
        if f % 16:
            raise ValueError(f"ffw{i}: F must be a multiple of 16, got {f}")
        fshapes = {"ln_w": (c,), "ln_b": (c,), "w1": (c, f), "b1": (f,),
                   "w2": (f, c), "b2": (c,), "scale": (c,)}
        for k in _FFW_KEYS:
            if k != "ln_b" and ffw.get(k) is None:
                raise ValueError(f"ffw{i}: {k} is required")
            ptrs.append(_check(f"ffw{i}.{k}", ffw.get(k), x, fshapes[k]))
    return ptrs, [ch, e, int(mode == "gate"), f]


# the Hopper bodies (csrc/chain2_wg.cu), mirrored from the source (a card
# test holds the shared memory to it): at C = 64 a persistent grid over 16 x
# 8 output tiles, both stages' w1 and w2 resident, beside them the 20 x 12
# input box (also the y tile), the chained FFW's buffer (f_w1 and f_w2 of a
# stage), the fp32 hidden chunk (240 x 64), the activation chunk (180 x 72
# bf16) and both stages' taps; at C = 128 one 8 x 8 tile a block, the
# weights through a ring of 16 KB stages beside the LN halo (144 x 136
# bf16), the fp32 hidden chunk (144 x 128), the activation chunk and the y
# tile (100 x 136 bf16 each)
_K64_TILE = (16, 8)
_K64_SLOT, _K64_FFW, _K64_HID, _K64_ACT = 30720, 32768, 61440, 25920
_K128_REST = 144 * 136 * 2 + 144 * 128 * 4 + 2 * 100 * 136 * 2
_K128_STAGE, _K128_MAX_STAGES, _ALIGN = 16384, 8, 1024


def _k64_smem(form1, form2) -> int:
    """Bytes of shared memory of the C = 64 body for the stages' forms
    (mode, e, f): the input box, each stage's w1 (64 x CH) and w2 (E x 64),
    the FFW buffer (both stages with the chained FFW), the hidden and
    activation chunks, each stage's taps (9 x CH) and two mbarriers."""
    weights = 0
    for mode, e, _ in (form1, form2):
        ch = 2 * e if mode == "gate" else e
        weights += 128 * ch + 128 * e + 18 * ch
    ffw = _K64_FFW if form1[2] and form2[2] else 0
    return (_ALIGN + _K64_SLOT + weights + ffw + _K64_HID + _K64_ACT + 16)


def _k128_smem() -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the C = 128 body: its fixed
    parts, then as many ring stages, with their two mbarriers, as fit."""
    stages = min(_K128_MAX_STAGES,
                 (_SMEM_LIMIT - _ALIGN - _K128_REST) // (_K128_STAGE + 16))
    return _ALIGN + stages * _K128_STAGE + _K128_REST + 16 * stages, stages


def _two_stage_plan(b, h, w, c, form1, form2, dtype, n_sm: int = 132):
    """The body of one fused_two_stage call, chosen by its shape and the
    stages' forms (mode, e, f; f the chained FFW's hidden width, 0: none):
    ("c64", geometry) or ("wg", geometry) for the Hopper bodies of
    csrc/chain2_wg.cu, else ("tile", None) for csrc/chain2.cu. The Hopper
    bodies take bf16 in the forms of the conv-only levels: at C = 64 a pair
    of ReducedAttn+FFW blocks (both stages gelu, e % 64 == 0, f = 2C: enc1)
    or a ReducedAttn+GFFW block (gelu e % 64 == 0 then gate e % 32 == 0, no
    FFW: the refinement); at C = 128 a pair (both gelu, e % 128 == 0, f =
    2C: enc2). The geometry: the output tile, the tiles, the grid's blocks
    (C = 64: a persistent grid of one block an SM, n_sm at most), the ring
    stages (C = 128) and the shared memory."""
    if dtype != torch.bfloat16:
        return "tile", None
    (m1, e1, f1), (m2, e2, f2) = form1, form2
    if c == 64:
        pair = (m1 == m2 == "gelu" and f1 == f2 == 2 * c and not e1 % 64
                and not e2 % 64)
        ra_gffw = (m1 == "gelu" and not f1 and not e1 % 64 and m2 == "gate"
                   and not f2 and not e2 % 32)
        smem = _k64_smem(form1, form2)
        if not (pair or ra_gffw) or smem > _SMEM_LIMIT:
            return "tile", None
        th, tw = _K64_TILE
        n_tiles = b * -(-h // th) * -(-w // tw)
        return "c64", dict(tile=_K64_TILE, tiles=n_tiles,
                           blocks=min(n_tiles, n_sm), stages=1, smem=smem,
                           form="pair" if pair else "ra_gffw")
    if (c == 128 and m1 == m2 == "gelu" and f1 == f2 == 2 * c
            and not e1 % 128 and not e2 % 128):
        smem, stages = _k128_smem()
        n_tiles = b * -(-h // 8) * -(-w // 8)
        return "wg", dict(tile=(8, 8), tiles=n_tiles, blocks=n_tiles,
                          stages=stages, smem=smem, form="pair")
    return "tile", None


# csrc/chain2.cu's tile (two_stage_smem): stage 1's 12 x 12 input halo, its
# fp32 hidden chunk (144 x 72), the activation chunk and the 10 x 10 ring of
# stage 1's output
_C2_N_IN1, _C2_N_RING, _C2_HS, _C2_AS, _C2_XPAD = 144, 100, 72, 72, 8


def _two_stage_f32_plan(b, h, w, c):
    """The geometry of one float32 fused_two_stage call, on csrc/chain2.cu,
    mirrored from its launch and two_stage_smem: C a multiple of 16 up to
    128, one 8 x 8 tile a block, 203,008 bytes of shared memory at C = 128.
    Raises ValueError, naming the body and the limit, for a call it does
    not take."""
    if not two_stage_supported(c):
        raise ValueError(f"fused_two_stage: csrc/chain2.cu takes float32 maps "
                         f"of C a multiple of 16 up to {TWO_STAGE_MAX_C}, got "
                         f"C={c}")
    xs = c + _C2_XPAD
    smem = 4 * (_C2_N_IN1 * xs + _C2_N_IN1 * _C2_HS + _C2_N_RING * _C2_AS
                + _C2_N_RING * xs)
    return dict(tile=(8, 8), blocks=b * -(-h // 8) * -(-w // 8), smem=smem)


def _form(st, ffw, ints) -> tuple:
    """A stage's (mode, e, f) from its operands' ints [ch, e, gate, f]."""
    return (st["mode"], ints[1], ints[3] if ffw is not None else 0)


def _launch(x, st1, st2, ffw1, ffw2):
    _check_map("x", x)
    b, h, w, c = x.shape
    if not two_stage_supported(c):
        raise ValueError(f"fused_two_stage: C must be a multiple of 16 up to "
                         f"{TWO_STAGE_MAX_C}, got {c}")
    if x.dtype == torch.float32:  # raises before any launch if not taken
        _two_stage_f32_plan(b, h, w, c)
    if b > 65535:
        raise ValueError(f"fused_two_stage: at most 65535 maps, got {b}")
    p1, i1 = _stage_operands(1, x, st1, ffw1)
    p2, i2 = _stage_operands(2, x, st2, ffw2)
    out = torch.empty_like(x)
    ptrs = [x.data_ptr(), out.data_ptr(), *p1, *p2]
    ints = [b, h, w, c, *i1, *i2]
    body, geo = _two_stage_plan(b, h, w, c, _form(st1, ffw1, i1),
                                _form(st2, ffw2, i2), x.dtype,
                                _sm_count(x.device))
    if body != "tile":  # its shared memory fits by construction
        _call(build.load("chain2_wg").turtle_two_stage_wg_launch, ptrs,
              ints + [geo["blocks"]], x, "fused_two_stage")
        fused_two_stage.launches_wg += 1
    else:
        lib = build.load("chain2")
        _check_smem("fused_two_stage", lib.turtle_two_stage_smem(
            c, int(x.dtype == torch.bfloat16)))
        _call(lib.turtle_two_stage_launch, ptrs, ints, x, "fused_two_stage")
    fused_two_stage.launches += 1
    return out


def fused_two_stage(x, st1, st2, *, ffw1=None, ffw2=None):
    """out = stage2(stage1(x)) on an NHWC map, each stage
    y + scale * (pw2(act(dw3x3(pw1(LN y) + b1) + bd)) + b2), optionally
    followed by its pointwise FFW y + scale_f * (pw5(gelu(pw4(LN2 y) + b4))
    + b5), in one pass over the map: a pair of ReducedAttn+FFW blocks (stage
    = a block's ReducedAttn dict, ffw = its FFW dict) or one ReducedAttn+GFFW
    block (stage 1 its ReducedAttn, stage 2 its gated FFN).

    Replaces ``fused_two_stage`` in turtlevsr_tpu/kernels/chain2.py (bound
    by operations at C = 128, by bytes at C = 64). Two kernels, chosen by
    shape before the launch (:func:`_two_stage_plan`): the Hopper bodies of
    csrc/chain2_wg.cu (TMA, wgmma, stage 1's output kept in shared memory)
    for the bf16 forms of the conv-only levels (``launches_wg`` counts
    them), csrc/chain2.cu for every other call. Takes C a multiple of 16 up
    to 128."""
    if x.device.type == "cpu":
        return two_stage_plain(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    _need_cuda("fused_two_stage", x)
    return _launch(x, st1, st2, ffw1, ffw2)


fused_two_stage.launches = 0
fused_two_stage.launches_wg = 0  # those of them on csrc/chain2_wg.cu
