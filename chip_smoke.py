#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--frames 6] [--size 1280x720] [--phase all]
                          [--profile] [--ptxas]

(--profile traces three more frames of `gopro` with torch.profiler.)

Phases, one JSON object per line on standard output:

  device   the card's name and power limit as nvidia-smi gives them
  build    nvcc builds the seven sources of turtlevsr_tpu_torch/kernels/csrc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the shapes the 720p serving paths give it (bf16): errors
           beside the stated tolerance, the kernel's time, the plain
           version's, a PyTorch library call's where one computes the same
           function, and the least time the card could take (bound)
  slice    two configurations at full width and depth, seeded random
           weights, frames streamed through InferenceEngine.step: `gopro`
           (options/Turtle_Deblur_Gopro.yml unchanged: CHM blocks end the
           decoder levels) and `gopro_t1_fhr` (the same file with those
           blocks set to Channel). For each: shape, finiteness, the exact
           kernel launches per frame, agreement with the same frames run
           through the plain versions on the card, ms per frame, peak memory

then, when both the kernels and the slice ran, the line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero; without a CUDA device the script exits 2
before it prints any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from turtlevsr_tpu_torch.config.options import (
    load_options,
    model_config_from_options,
)
from turtlevsr_tpu_torch.eval.engine import InferenceEngine
from turtlevsr_tpu_torch import kernels as kernels_pkg
from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as turtle_mod

ROOT = os.path.dirname(os.path.abspath(__file__))
OPTION_FILE = os.path.join(ROOT, "options", "Turtle_Deblur_Gopro.yml")
# gopro: the shipped GoPro model as the file gives it. gopro_t1_fhr: the
# same with the CHM blocks replaced by Channel blocks; applied by the
# caller, the file is unchanged
GOPRO_T1_FHR = {"decoder1_attn_type2": "Channel",
                "decoder2_attn_type2": "Channel",
                "decoder3_attn_type2": "Channel"}
# exact launches per frame: a CHM block launches each of its kernels once
# (q, k split projection, composite v conv, lattice split, probabilities,
# lattice merge, statistics, FFN); a Channel block the statistics and the FFN
LAUNCHES_PER_FRAME = {
    "gopro": {"ffn": 51, "qkv_stats": 34, "split_proj": 5, "conv3x3": 11,
              "chm_stats": 3, "sab": 3, "lattice_merge": 3,
              "lattice_split": 3},
    "gopro_t1_fhr": {"ffn": 51, "qkv_stats": 37, "split_proj": 2,
                     "conv3x3": 8, "chm_stats": 0, "sab": 0,
                     "lattice_merge": 0, "lattice_split": 0},
}
# the decoder levels of `gopro`: (scale, C, heads, window, cached frames)
CHM_LEVELS = {"dec3": (4, 256, 4, 4, 3), "dec2": (2, 128, 2, 8, 3),
              "dec1": (1, 64, 1, 16, 2)}

# published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# tensor-core rate of its type (bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Tolerances, bf16. The plain versions round where the kernels round, so the
# two differ by the order of fp32 sums and by erff against torch's erf: a
# result lands now and then on the other side of a bf16 rounding boundary,
# one ulp = 2^-8 relative. KERNEL_TOL bounds |kernel - plain| by that one
# ulp of the largest output magnitude plus slack for a second flip in the
# chained FFW; the statistics are fp32 sums over up to 10^6 pixels of
# products that each may carry such a flip in q or k.
KERNEL_REL_TOL = 2.0 ** -7
STATS_REL_TOL = 2.0 ** -9
# the probabilities of the alignment attention: another order of the fp32
# sum moves a score now and then across a bf16 rounding boundary and so
# changes which five entries of a row are kept (bf16 scores of unit vectors
# take a few hundred values: near-ties are the normal case). On normal
# inputs the share of rows whose support differs is held under this limit
# and the other rows to SAB_TOL; on inputs whose scores are exact in fp32 the
# support must be equal bit for bit.
SAB_MAX_FLIP_SHARE = 0.25
SAB_TOL = 2.0 ** -6
SAB_EXACT_TOL = 2.0 ** -9
# the slice: 41 blocks deep, rounding flips feed forward through every later
# block; PSNR of the kernel path against the plain path on the card, on
# pictures in [0, 1]
SLICE_MIN_PSNR = 40.0

KERNEL_INFO = {
    "ffn": ("turtlevsr_tpu_torch/kernels/csrc/ffn.cu",
            "turtlevsr_tpu/kernels/ffn.py:2024"),
    "qkv_stats": ("turtlevsr_tpu_torch/kernels/csrc/qkv_stats.cu",
                  "turtlevsr_tpu/kernels/ffn.py:985"),
    "split_proj": ("turtlevsr_tpu_torch/kernels/csrc/split_proj.cu",
                   "turtlevsr_tpu/kernels/ffn.py:1732"),
    "conv3x3": ("turtlevsr_tpu_torch/kernels/csrc/conv3x3.cu",
                "turtlevsr_tpu/kernels/ffn.py:1622"),
    "chm_stats": ("turtlevsr_tpu_torch/kernels/csrc/chm_stats.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1267"),
    "sab": ("turtlevsr_tpu_torch/kernels/csrc/sab.cu",
            "turtlevsr_tpu/kernels/sab.py:138"),
    "lattice_merge": ("turtlevsr_tpu_torch/kernels/csrc/lattice.cu",
                      "turtlevsr_tpu/kernels/lattice.py:59"),
    "lattice_split": ("turtlevsr_tpu_torch/kernels/csrc/lattice.cu",
                      "turtlevsr_tpu/kernels/lattice.py:79"),
}


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Inputs:
    """Seeded inputs, made with numpy and moved to the card as bf16."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def __call__(self, *shape, scale: float = 1.0) -> torch.Tensor:
        a = self.rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to("cuda", torch.bfloat16)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    ref = max(want.abs().max().item(), 1e-30)
    return err, err / ref


def numel_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------


def ffn_case(inp: Inputs, name, h, w, c, e, mode, *, pair=False, po=False,
             biases=False, scale=False, ffw2=False, dw=True, iters=5,
             stacked=0):
    ch = 2 * e if mode == "gate" else e
    x = inp(1, h, w, c)
    kw = dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
              w1=inp(c, ch, scale=c ** -0.5), wd=inp(3, 3, ch, scale=0.3),
              w2=inp(e, c, scale=e ** -0.5), mode=mode)
    if biases:
        kw.update(b1=inp(ch, scale=0.2), bd=inp(ch, scale=0.2),
                  b2=inp(c, scale=0.2))
    if not dw:  # the branch without a depthwise stage
        kw["wd"] = None
        kw.pop("bd", None)
    if scale:
        kw["scale"] = inp(c, scale=0.5)
    if pair:
        kw["x2"] = inp(1, h, w, c)
    if po:
        kw["po_w"] = inp(1, c, c, scale=c ** -0.5)
    n_maps = int(pair)
    if stacked:  # the CHM block's call: `stacked` history maps and one more
        n_maps = stacked + 1
        kw["x2"] = [inp(1, stacked, h, w, c), inp(1, h, w, c)]
        kw["po_w"] = [inp(1, c, c, scale=c ** -0.5) for _ in range(n_maps)]
    f = 2 * c
    if ffw2:
        kw["ffw2"] = dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                          w1=inp(c, f, scale=c ** -0.5), b1=inp(f, scale=0.2),
                          w2=inp(f, c, scale=f ** -0.5), b2=inp(c, scale=0.2),
                          scale=inp(c, scale=0.5))
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    want = K.ffn_plain(x, **kw)
    err, rel = rel_err(got, want)
    px = h * w
    flops = 2.0 * px * (c * ch + (9 * ch if dw else 0) + e * c
                        + (n_maps * c * c if po or stacked else 0)
                        + (2 * c * f if ffw2 else 0))
    weights = [v for v in kw.values() if torch.is_tensor(v) and v.dim() < 4]
    weights += list(kw.get("ffw2", {}).values())
    if stacked:
        weights += kw["x2"] + kw["po_w"]
    n_bytes = numel_bytes(x, None if stacked else kw.get("x2"), got, *weights)
    b_ms, b_by = bound(n_bytes, flops)
    return dict(kernel="ffn", case=name, shape=[1, h, w, c], hidden=ch,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                ok=rel <= KERNEL_REL_TOL and bool(torch.isfinite(got.float()).all()),
                ms=cuda_ms(lambda: K.fused_block_ffn(x, **kw), iters),
                plain_ms=cuda_ms(lambda: K.ffn_plain(x, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def chain_weights(inp: Inputs, c, ch):
    return dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                w1=inp(c, ch, scale=c ** -0.5), wd=inp(3, 3, ch, scale=0.3))


def qkv_case(inp: Inputs, name, h, w, c, heads, iters=5):
    x = inp(1, h, w, c)
    kw = chain_weights(inp, c, 3 * c)
    v, g, s = K.fused_qkv_stats(x, heads=heads, **kw)
    torch.cuda.synchronize()
    wv, wg, ws = K.qkv_stats_plain(x, heads=heads, **kw)
    err_v, rel_v = rel_err(v, wv)
    err_g, rel_g = rel_err(g, wg)
    err_s, rel_s = rel_err(s, ws)
    # per pixel: pw1 C x 3C, nine taps on 3C channels, the per-head diagonal
    # blocks of the Gram (heads x ctok x ctok = C x ctok), the two norms
    px, ctok = h * w, c // heads
    flops = 2.0 * px * (c * 3 * c + 9 * 3 * c + c * ctok + 2 * c)
    b_ms, b_by = bound(numel_bytes(x, v, g, s, *kw.values()), flops)
    return dict(kernel="qkv_stats", case=name, shape=[1, h, w, c],
                heads=heads, max_abs_err=max(err_v, err_g / px, err_s / px),
                rel_err=rel_v, rel_err_gram=rel_g, rel_err_norms=rel_s,
                tol_rel=KERNEL_REL_TOL, tol_rel_stats=STATS_REL_TOL,
                ok=(rel_v <= KERNEL_REL_TOL and rel_g <= STATS_REL_TOL
                    and rel_s <= STATS_REL_TOL),
                ms=cuda_ms(lambda: K.fused_qkv_stats(x, heads=heads, **kw),
                           iters),
                plain_ms=cuda_ms(
                    lambda: K.qkv_stats_plain(x, heads=heads, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def split_case(inp: Inputs, name, h, w, c, n_out, iters=5):
    x = inp(1, h, w, c)
    kw = chain_weights(inp, c, n_out * c)
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    want = K.split_proj_plain(x, n_out=n_out, **kw)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    flops = 2.0 * h * w * (c * n_out * c + 9 * n_out * c)
    b_ms, b_by = bound(numel_bytes(x, *got, *kw.values()), flops)
    return dict(kernel="split_proj", case=name, shape=[1, h, w, c],
                n_out=n_out, max_abs_err=err, rel_err=rel,
                tol_rel=KERNEL_REL_TOL, ok=rel <= KERNEL_REL_TOL,
                ms=cuda_ms(lambda: K.fused_ln_split_proj(x, n_out=n_out, **kw),
                           iters),
                plain_ms=cuda_ms(
                    lambda: K.split_proj_plain(x, n_out=n_out, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def conv_case(inp: Inputs, name, h, w, cin, cout, bias, iters=5, ln=False):
    x = inp(1, h, w, cin)
    wt = inp(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = inp(cout, scale=0.2) if bias else None
    lnk = dict(ln_w=1.0 + inp(cin, scale=0.2),
               ln_b=inp(cin, scale=0.2)) if ln else {}
    got = K.fused_conv3x3(x, wt, bb, **lnk)
    torch.cuda.synchronize()
    want = K.conv3x3_plain(x, wt, bb, **lnk)
    err, rel = rel_err(got, want)
    # the library's call for the same function: cuDNN through F.conv2d on
    # the same NHWC memory (channels_last), bf16; timed here, used nowhere.
    # With the LayerNorm in front no single call computes the function.
    lib = None
    if not ln:
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bb, padding=1), iters)
    b_ms, b_by = bound(numel_bytes(x, wt, bb, got, *lnk.values()),
                       2.0 * h * w * (9 * cin * cout + (8 * cin if ln else 0)))
    return dict(kernel="conv3x3", case=name, shape=[1, h, w, cin], cout=cout,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                ok=rel <= KERNEL_REL_TOL,
                ms=cuda_ms(lambda: K.fused_conv3x3(x, wt, bb, **lnk), iters),
                plain_ms=cuda_ms(lambda: K.conv3x3_plain(x, wt, bb, **lnk),
                                 2, 1),
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def chm_case(inp: Inputs, name, h, w, c, heads, nf, iters=3):
    x, x_sp = inp(1, h, w, c), inp(1, nf, h, w, c)
    kw = dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
              w_qkv=inp(c, 3 * c, scale=c ** -0.5),
              wd_qkv=inp(3, 3, 3 * c, scale=0.3),
              w_kv=inp(c, 2 * c, scale=c ** -0.5),
              wd_kv=inp(3, 3, 2 * c, scale=0.3), heads=heads)
    got = K.fused_chm_stats(x, x_sp, **kw)
    torch.cuda.synchronize()
    want = K.chm_stats_plain(x, x_sp, **kw)
    (err_v, rel_v), (err_vh, rel_vh) = (rel_err(got[i], want[i])
                                        for i in (0, 1))
    rel_stats = max(rel_err(got[i], want[i])[1] for i in (2, 3, 4))
    err_stats = max(rel_err(got[i], want[i])[0] for i in (2, 3, 4))
    del want
    # per pixel: pw1 and nine taps for the 3 + 2 NF chains, the per-head
    # diagonal blocks of the NF + 1 Grams, the NF + 2 sums of squares
    px, ctok = h * w, c // heads
    flops = 2.0 * px * ((3 + 2 * nf) * (c * c + 9 * c) + (nf + 1) * c * ctok
                        + (nf + 2) * c)
    tensors = [v for v in kw.values() if torch.is_tensor(v)]
    b_ms, b_by = bound(numel_bytes(x, x_sp, *got, *tensors), flops)
    return dict(kernel="chm_stats", case=name, shape=[1, nf, h, w, c],
                heads=heads, max_abs_err=max(err_v, err_vh, err_stats / px),
                rel_err=max(rel_v, rel_vh), rel_err_stats=rel_stats,
                tol_rel=KERNEL_REL_TOL, tol_rel_stats=STATS_REL_TOL,
                ok=(max(rel_v, rel_vh) <= KERNEL_REL_TOL
                    and rel_stats <= STATS_REL_TOL),
                ms=cuda_ms(lambda: K.fused_chm_stats(x, x_sp, **kw), iters),
                plain_ms=cuda_ms(lambda: K.chm_stats_plain(x, x_sp, **kw),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sab_inputs(inp: Inputs, nf, hw, d, exact: bool):
    """Unit vectors, or (exact) small integers over 8 with a temperature of
    one half: every score is then exact in fp32 whatever the order of the
    sum, and rows tie many times."""
    if exact:
        q = torch.from_numpy(inp.rng.randint(-2, 3, (1, hw, d)) / 8.0)
        k = torch.from_numpy(inp.rng.randint(-2, 3, (1, nf, hw, d)) / 8.0)
        temp = torch.tensor([0.5], device="cuda")
        return (q.to("cuda", torch.bfloat16), k.to("cuda", torch.bfloat16),
                temp)
    q, k = inp(1, hw, d).float(), inp(1, nf, hw, d).float()
    q = (q / q.norm(dim=-1, keepdim=True)).bfloat16()
    k = (k / k.norm(dim=-1, keepdim=True)).bfloat16()
    return q, k, torch.tensor([1.7], device="cuda")


def sab_compare(got, want):
    """(share of rows whose support differs, largest error on the others)."""
    same = ((got != 0) == (want != 0)).all(dim=-1)
    err = ((got.float() - want.float()).abs().amax(dim=-1) * same).max().item()
    return 1.0 - same.float().mean().item(), err


def sab_case(inp: Inputs, name, hq, wq, d, nf, iters=3):
    hw = hq * wq
    fv = torch.ones(nf, device="cuda")
    # (a) exact scores: the same support, bit for bit
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True)
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    exact_same = bool(torch.equal(got != 0, want != 0))
    exact_err = (got.float() - want.float()).abs().max().item()
    # (b) unit vectors, the last frame invalid
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=False)
    fv[-1] = 0.0 if nf > 1 else 1.0
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    share, err = sab_compare(got, want)
    rows_ok = bool(((got.float().sum(-1) - fv[None, :, None]).abs()
                    <= 0.02).all())
    del want
    b_ms, b_by = bound(numel_bytes(q, k, got), 2.0 * nf * hw * hw * d)
    return dict(kernel="sab", case=name, shape=[1, nf, hw, d], grid=[hq, wq],
                max_abs_err=max(err, exact_err), rel_err=err,
                exact_inputs_same_support=exact_same,
                exact_inputs_max_abs_err=exact_err, tol_exact=SAB_EXACT_TOL,
                rows_support_differs_share=share,
                max_flip_share=SAB_MAX_FLIP_SHARE, tol=SAB_TOL,
                ok=(exact_same and exact_err <= SAB_EXACT_TOL and rows_ok
                    and share <= SAB_MAX_FLIP_SHARE and err <= SAB_TOL),
                ms=cuda_ms(lambda: S.sab_attn_probs(q, k, temp, fv,
                                                    grid_wq=wq), iters),
                plain_ms=cuda_ms(lambda: S.sab_attn_probs_plain(
                    q, k, temp, fv, grid_wq=wq), 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def lattice_case(inp: Inputs, name, h, w, c, ws, n, merge: bool, iters=5):
    hh, ww = h // ws, w // ws
    if merge:
        src = inp(n, hh * ww, ws * ws * c)
        fn = lambda: L.lattice_merge(src, ws, h, w)  # noqa: E731
        plain = lambda: L.lattice_merge_plain(src, ws, h, w)  # noqa: E731
    else:
        src = inp(n, h, w, c)
        fn = lambda: L.lattice_split(src, ws)  # noqa: E731
        plain = lambda: L.lattice_split_plain(src, ws)  # noqa: E731
    got = fn()
    torch.cuda.synchronize()
    want = plain()  # the library's call too: permute(...) and one copy
    exact = bool(torch.equal(got, want))
    err = 0.0 if exact else rel_err(got, want)[0]
    b_ms, b_by = bound(2 * numel_bytes(src), 0.0)
    plain_ms = cuda_ms(plain, iters)
    return dict(kernel="lattice_merge" if merge else "lattice_split",
                case=name, shape=list(src.shape), window=ws,
                max_abs_err=err, rel_err=err, tol_rel=0.0, ok=exact,
                ms=cuda_ms(fn, iters), plain_ms=plain_ms,
                library_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def attn_v_times(inp: Inputs, h: int, w: int) -> dict:
    """attention @ v of the alignment attention is torch.matmul, as the JAX
    package leaves it to its compiler: its time at the three levels, per
    frame of video (NF products each), beside its operations bound."""
    out = {}
    for name, (s, c, _, ws, ring) in CHM_LEVELS.items():
        hw, dv, nf = (h // s // ws) * (w // s // ws), ws * ws * c, ring + 1
        a, v = inp(1, hw, hw), inp(1, hw, dv)
        dst = torch.empty(1, hw, dv, device="cuda", dtype=torch.bfloat16)
        ms = cuda_ms(lambda: torch.matmul(a, v, out=dst), 5) * nf
        out[name] = dict(shape=[nf, hw, hw, dv], ms_per_frame=ms,
                         bound_ms=2.0 * nf * hw * hw * dv / BF16_FLOP_PER_S
                         * 1e3)
    return out


def kernel_cases(seed: int, h: int, w: int) -> list[dict]:
    """Every kernel at shapes of the serving path for padded frames of
    (h, w); the first case of each kernel is the one its row reports."""
    inp = Inputs(seed)
    h2, w2, h3, w3, h4, w4 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    cases = [
        lambda: ffn_case(inp, "gate+pair+po(B,C,C) dec3/enc3", h3, w3, 256,
                         640, "gate", pair=True, po=True),
        lambda: ffn_case(inp, "gate+pair+po(B,C,C) latent", h4, w4, 512,
                         1280, "gate", pair=True, po=True),
        lambda: ffn_case(inp, "gate+pair, no po (FHR) latent", h4, w4, 512,
                         1280, "gate", pair=True),
        lambda: ffn_case(inp, "gate, no pair (refinement)", h, w, 64, 160,
                         "gate", iters=3),
        lambda: ffn_case(inp, "gelu+scale (refinement RA)", h, w, 64, 128,
                         "gelu", biases=True, scale=True, iters=3),
        lambda: ffn_case(inp, "gelu+scale+ffw2 (enc1 RA+FFW)", h, w, 64, 128,
                         "gelu", biases=True, scale=True, ffw2=True, iters=3),
        lambda: ffn_case(inp, "gelu+scale+ffw2 (enc2 RA+FFW)", h2, w2, 128,
                         256, "gelu", biases=True, scale=True, ffw2=True),
        lambda: ffn_case(inp, "gelu+scale, no dw (an FFW half alone; not on "
                         "the main path)", h, w, 64, 128, "gelu", biases=True,
                         scale=True, dw=False, iters=3),
        lambda: qkv_case(inp, "enc3/dec3", h3, w3, 256, 4),
        lambda: qkv_case(inp, "latent", h4, w4, 512, 8),
        lambda: qkv_case(inp, "dec1", h, w, 64, 1, iters=3),
        lambda: split_case(inp, "latent FHR q,k,v", h4, w4, 512, 3),
        lambda: conv_case(inp, "up4_3 512->1024", h4, w4, 512, 1024, False),
        lambda: conv_case(inp, "input 3->64", h, w, 3, 64, False, iters=3),
        lambda: conv_case(inp, "ending 64->3 +bias", h, w, 64, 3, True,
                          iters=3),
        lambda: conv_case(inp, "down1_2 64->32", h, w, 64, 32, False,
                          iters=3),
        # the remaining kernel instantiations and shapes of the main path
        lambda: ffn_case(inp, "gate+pair+po(B,C,C) dec2", h2, w2, 128, 320,
                         "gate", pair=True, po=True),
        lambda: ffn_case(inp, "gate+pair+po(B,C,C) dec1", h, w, 64, 160,
                         "gate", pair=True, po=True, iters=3),
        lambda: qkv_case(inp, "dec2", h2, w2, 128, 2),
        lambda: conv_case(inp, "down2_3 128->64", h2, w2, 128, 64, False),
        lambda: conv_case(inp, "down3_4 256->128", h3, w3, 256, 128, False),
        lambda: conv_case(inp, "up3_2 256->512", h3, w3, 256, 512, False),
        lambda: conv_case(inp, "up2_1 128->256", h2, w2, 128, 256, False),
    ]
    # the CHM blocks of `gopro`: the four kernels of the alignment and the
    # routing, and the new shapes of the FFN (lists), the split projection
    # (two maps) and the conv (with LayerNorm), level by level
    for lvl, (s, c, heads, ws, ring) in CHM_LEVELS.items():
        hl, wl, nf = h // s, w // s, ring + 1
        it = 3 if s == 1 else 5
        cases += [
            lambda lvl=lvl, hl=hl, wl=wl, c=c, heads=heads, nf=nf: chm_case(
                inp, lvl, hl, wl, c, heads, nf),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, nf=nf: sab_case(
                inp, lvl, hl // ws, wl // ws, 2 * c, nf),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, nf=nf, it=it:
                lattice_case(inp, lvl, hl, wl, c, ws, nf, True, it),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, it=it: lattice_case(
                inp, lvl, hl, wl, c, ws, 1, False, it),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, nf=nf, it=it: ffn_case(
                inp, f"gate + {nf} stacked + 1 maps, po(B,C,C) each (CHM "
                f"{lvl})", hl, wl, c, int(c * 2.5), "gate", stacked=nf,
                iters=it),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, it=it: split_case(
                inp, f"SAB q,k {lvl}", hl, wl, c, 2, it),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, it=it: conv_case(
                inp, f"LN + composite v {lvl} {c}->{c}", hl, wl, c, c, False,
                it, ln=True),
        ]
    out = []
    for make in cases:
        res = make()
        emit({"phase": "kernel_case", **res})
        out.append(res)
        torch.cuda.empty_cache()
    emit({"phase": "attention_at_v_matmul", "route": "torch.matmul",
          **attn_v_times(inp, h, w)})
    return out


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def randomise_scales(model: torch.nn.Module, seed: int) -> None:
    """gamma, beta are zero and temperature one at initialisation: draw them
    so that the FFW and ReducedAttn branches and the softmax take part."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "beta"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            elif leaf == "temperature":
                p.copy_(1.0 + torch.rand(p.shape, generator=gen))


@contextlib.contextmanager
def plain_versions():
    """Route the model's fused calls to the plain versions on the card, for
    the comparison only (the port itself has no such switch)."""
    plain = {"fused_block_ffn": K.ffn_plain,
             "fused_qkv_stats": K.qkv_stats_plain,
             "fused_ln_split_proj": K.split_proj_plain,
             "fused_conv3x3": K.conv3x3_plain,
             "fused_chm_stats": K.chm_stats_plain,
             "sab_attn_probs": S.sab_attn_probs_plain,
             "lattice_split": L.lattice_split_plain,
             "lattice_merge": L.lattice_merge_plain}
    saved = []
    for mod in (blocks_mod, turtle_mod):
        for name, fn in plain.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def make_frames(seed: int, n: int, h: int, w: int) -> list[np.ndarray]:
    """A drifting smooth pattern plus noise, HWC float32 in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        base = np.stack([
            0.5 + 0.4 * np.sin((xx + 7 * t) / (23.0 + 5 * c))
            * np.cos((yy - 3 * t) / (31.0 - 4 * c)) for c in range(3)], -1)
        noise = rng.standard_normal((h, w, 3)).astype(np.float32) * 0.05
        frames.append(np.clip(base + noise, 0.0, 1.0).astype(np.float32))
    return frames


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)


def options_of(config: str) -> dict:
    opt = load_options(OPTION_FILE, is_train=False)
    if config == "gopro_t1_fhr":
        opt.update(GOPRO_T1_FHR)
    return opt


def profile_frames(engine: InferenceEngine, frames: list,
                   untraced_ms: float, config: str) -> None:
    """Device time by kernel name over a few steady frames, from
    torch.profiler, and the device's idle share: busy time against the ms
    per frame taken WITHOUT the tracer (tracing multiplies the host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fr in frames:
            engine.step(fr)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    # device events only (kernels, copies): an aten op's entry repeats the
    # time of the kernels it launched
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3 / len(frames), evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the library's matrix products (attention @ v above all) by name
    gemm = sum(ms for k, ms, _ in rows if any(
        tag in k.lower() for tag in ("gemm", "cutlass", "nvjet", "xmma",
                                     "cublas")))
    own = sum(ms for k, ms, _ in rows if "turtle" in k)
    emit({"phase": "profile", "config": config, "frames": len(frames),
          "library_matmul_ms_per_frame": gemm,
          "own_kernels_ms_per_frame": own,
          "wall_ms_per_frame_traced": wall_ms,
          "device_busy_ms_per_frame": busy if rows else "not measured",
          "ms_per_frame_untraced": untraced_ms,
          "device_idle_share": max(0.0, 1.0 - busy / untraced_ms) if rows
          else "not measured",
          "top_device_ms_per_frame": [
              {"name": k[:80], "ms": ms, "calls_per_frame": n / len(frames)}
              for k, ms, n in rows[:24]]})


def run_slice(config: str, seed: int, n_frames: int, width: int,
              height: int, trace: bool = False) -> dict:
    opt = options_of(config)
    model = build_model(opt, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    cfg = model.cfg
    engine = InferenceEngine(model, mode="whole", dtype=torch.bfloat16)
    frames = make_frames(seed + 2, n_frames, height, width)
    ring = max(lvl.num_frames_tocache for lvl in (cfg.latent, cfg.dec3,
                                                   cfg.dec2, cfg.dec1))
    require(n_frames > ring, f"need more than {ring} frames to wrap the rings")

    # main path: counts set to 0 just before, read just after; the peak of
    # device memory is that of the stream, not of the phases before it
    torch.cuda.reset_peak_memory_stats()
    kernels_pkg.reset_launch_counts()
    outs, times = [], []
    for fr in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.step(fr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    counts = kernels_pkg.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, out in enumerate(outs):
        require(out.shape == (height, width, 3),
                f"frame {i}: output shape {out.shape}")
        require(bool(np.isfinite(out).all()), f"frame {i}: non-finite output")
    for name, per_frame in LAUNCHES_PER_FRAME[config].items():
        require(counts[name] == per_frame * n_frames,
                f"{name}: {counts[name]} launches over {n_frames} frames, "
                f"expected {per_frame} per frame")

    # the same frames through the plain versions on the card
    engine.reset()
    with plain_versions():
        t0 = time.perf_counter()
        plain_outs = [engine.step(fr) for fr in frames]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    require(kernels_pkg.launch_counts() == counts,
            "the plain run must launch no kernel")
    psnrs = [psnr(a, b) for a, b in zip(outs, plain_outs)]
    max_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    change = [float(np.abs(o - f).mean()) for o, f in zip(outs, frames)]
    res = dict(
        phase="slice", config=config, frame=[height, width, 3],
        padded=list(turtle_mod.padded_hw(cfg, height, width)), dtype="bfloat16",
        frames=n_frames, ring_frames=ring, params=sum(
            p.numel() for p in model.parameters()),
        launches=counts, launches_per_frame={
            k: v / n_frames for k, v in counts.items()},
        ms_per_frame=times, ms_per_frame_after_warmup=float(
            np.mean(times[2:])), plain_ms_per_frame=plain_ms,
        psnr_vs_plain_db=psnrs, min_psnr_db=SLICE_MIN_PSNR,
        max_abs_err_vs_plain=max_err, mean_abs_change_of_input=change,
        peak_memory_gib=peak_gb)
    emit(res)
    if trace:
        profile_frames(engine, frames[:3], res["ms_per_frame_after_warmup"],
                       config)
    require(min(psnrs) >= SLICE_MIN_PSNR,
            f"kernel path and plain path disagree: PSNR {psnrs}")
    require(min(change) > 0, "the model returned its input unchanged")
    del engine, model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------


def kernel_rows(cases: list[dict], counts: dict, by_path: dict) -> list[dict]:
    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], case=head["case"],
            cases=[{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err", "rel_err")}
                   for c in mine]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames of `gopro`; `gopro_t1_fhr` streams 4")
    ap.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", default="all",
                    choices=("all", "build", "kernels", "slice"))
    ap.add_argument("--profile", action="store_true",
                    help="after the slice, trace 3 more frames with "
                         "torch.profiler: device time by kernel, idle share")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and shared-memory report")
    args = ap.parse_args(argv)
    width, height = (int(v) for v in args.size.lower().split("x"))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's main path runs on the "
              "card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    try:
        t0 = time.perf_counter()
        build.build_all(verbose=args.ptxas)
        for name in build.KERNEL_SOURCES:
            build.load(name)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "sources": [f"{n}.cu" for n in build.KERNEL_SOURCES],
              "flags": list(build.NVCC_FLAGS)})
        hp, wp = turtle_mod.padded_hw(
            model_config_from_options(options_of("gopro")), height, width)
        cases, counts, by_path = [], {}, {}
        if args.phase in ("all", "kernels"):
            cases = kernel_cases(args.seed, hp, wp)
            bad = [c["case"] for c in cases if not c["ok"]]
            require(not bad, f"kernels disagree with their plain versions: "
                             f"{bad}")
        if args.phase in ("all", "slice"):
            # the earlier path first (4 frames wrap its 3-frame ring), then
            # this slice's main path
            for config, n in (("gopro_t1_fhr", 4), ("gopro", args.frames)):
                by_path[config] = run_slice(
                    config, args.seed, n, width, height,
                    trace=args.profile and config == "gopro")["launches"]
            counts = by_path["gopro"]
        if args.phase == "all":
            for name in KERNEL_INFO:
                require(counts.get(name, 0) > 0,
                        f"the main path never launched {name}")
            for name in ("ffn", "qkv_stats", "split_proj", "conv3x3"):
                require(by_path["gopro_t1_fhr"][name] > 0,
                        f"the gopro_t1_fhr path never launched {name}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if cases and counts:  # launches are those of this run's main path
        emit({"kernels": kernel_rows(cases, counts, by_path)})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
