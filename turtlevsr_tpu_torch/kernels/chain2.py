"""Two chained depthwise stages in one pass over the map (row 13), and its
plain version.

A stage is a dict in the layout of ``fused_block_ffn``'s keywords: {ln_w,
ln_b?, w1 (C, CH), b1?, wd (3, 3, CH), bd?, w2 (E, C), b2?, scale?, mode}
with mode 'gelu' (E = CH) or 'gate' (E = CH / 2); an FFW is {ln_w, ln_b?,
w1 (C, F), b1, w2 (F, C), b2, scale}. ``fused_two_stage`` launches the
kernel of ``csrc/chain2.cu`` on a CUDA tensor (or raises); on a CPU tensor,
and only there, it runs the plain version: the two split FFN chains, with y
rounded to the map's type between them, where the split kernels store it.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _call,
    _check,
    _check_map,
    _check_smem,
    _need_cuda,
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


def _launch(x, st1, st2, ffw1, ffw2):
    _check_map("x", x)
    b, h, w, c = x.shape
    if not two_stage_supported(c):
        raise ValueError(f"fused_two_stage: C must be a multiple of 16 up to "
                         f"{TWO_STAGE_MAX_C}, got {c}")
    if b > 65535:
        raise ValueError(f"fused_two_stage: at most 65535 maps, got {b}")
    p1, i1 = _stage_operands(1, x, st1, ffw1)
    p2, i2 = _stage_operands(2, x, st2, ffw2)
    out = torch.empty_like(x)
    lib = build.load("chain2")
    _check_smem("fused_two_stage", lib.turtle_two_stage_smem(
        c, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_two_stage_launch, [x.data_ptr(), out.data_ptr(), *p1,
                                        *p2], [b, h, w, c, *i1, *i2], x,
          "fused_two_stage")
    fused_two_stage.launches += 1
    return out


def fused_two_stage(x, st1, st2, *, ffw1=None, ffw2=None):
    """out = stage2(stage1(x)) on an NHWC map, each stage
    y + scale * (pw2(act(dw3x3(pw1(LN y) + b1) + bd)) + b2), optionally
    followed by its pointwise FFW y + scale_f * (pw5(gelu(pw4(LN2 y) + b4))
    + b5), in one pass over the map: a pair of ReducedAttn+FFW blocks (stage
    = a block's ReducedAttn dict, ffw = its FFW dict) or one ReducedAttn+GFFW
    block (stage 1 its ReducedAttn, stage 2 its gated FFN).

    Replaces ``fused_two_stage`` in turtlevsr_tpu/kernels/chain2.py
    (kernel: csrc/chain2.cu; bound by operations at C = 128, by bytes at
    C = 64). Takes C a multiple of 16 up to 128."""
    if x.device.type == "cpu":
        return two_stage_plain(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    _need_cuda("fused_two_stage", x)
    return _launch(x, st1, st2, ffw1, ffw2)


fused_two_stage.launches = 0
