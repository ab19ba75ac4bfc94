#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--frames 6] [--size 1280x720] [--phase all]
                          [--profile] [--ptxas]

(--profile traces a few more frames of each whole-frame stream but
`gopro_enc3_ffw` and of each tiled stream under each plan, with
torch.profiler.)

Phases, one JSON object per line on standard output:

  device   the card's name and power limit as nvidia-smi gives them
  build    nvcc builds the ten sources of turtlevsr_tpu_torch/kernels/csrc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the shapes the 720p serving paths give it (bf16), whole
           padded frames and chunks of 15 tiles alike: errors beside the
           stated tolerance, the kernel's time, the plain
           version's, a PyTorch library call's where one computes the same
           function, and the least time the card could take (bound); the
           two-stage kernel also against the split launches it replaces, the
           sparse softmax also against the probabilities kernel; attention @ v
           also at the whole frame's dec3 shape, the 3x3 conv also on maps
           and Cout that its tiles do not divide
  slice    five configurations at full width and depth, seeded random
           weights, frames streamed through InferenceEngine.step: `gopro`
           (options/Turtle_Deblur_Gopro.yml unchanged: CHM blocks end the
           decoder levels) and `gopro_t1_fhr` (the same file with those
           blocks set to Channel) and `gopro_enc3_ffw` (the same file with
           encoder level 3's FFN set to the pointwise FFW: the FFN kernel's
           branch without a depthwise stage), `derain`
           (options/Turtle_Derain.yml unchanged: the t0 family) and `sr`
           (options/Turtle_SR_MVSR.yml unchanged: high-resolution frames in
           and out), then `gopro` under the fused plan ("two_stage",). For
           each: shape, finiteness, the exact kernel launches
           per frame, agreement with the same frames run through the plain
           versions on the card, ms per frame, peak memory
  tiled    `gopro`, `derain` and `sr` through
           `turtlevsr_tpu_torch.cli.infer.main --task deblur|derain|sr` on a
           folder of frames written from the seed, at the task's preset
           (deblur: tile 320, overlap 192, 45 tiles of a 1280x720 frame in
           three chunks of 15; derain: 320 / 128, 24 tiles in chunks of 15 +
           9; sr: 256 / 64 on the high-resolution frame, 28 tiles of 64 x 64
           at the model's input in chunks of 15 + 13), under the empty fused
           plan and ("two_stage",), `gopro` under ("channel_runs",
           "attn_v_merge") too; each against the same frames through the
           plain versions on the card

then, when the kernels, the slice and the tiled phase ran, the line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero; without a CUDA device the script exits 2
before it prints any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
from turtlevsr_tpu_torch.cli import infer as infer_cli
from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as turtle_mod
from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

ROOT = os.path.dirname(os.path.abspath(__file__))
OPTION_FILE = os.path.join(ROOT, "options", "Turtle_Deblur_Gopro.yml")
# gopro: the shipped GoPro model as the file gives it. gopro_t1_fhr: the
# same with the CHM blocks replaced by Channel blocks; applied by the
# caller, the file is unchanged
GOPRO_T1_FHR = {"decoder1_attn_type2": "Channel",
                "decoder2_attn_type2": "Channel",
                "decoder3_attn_type2": "Channel"}
# gopro_enc3_ffw: the same with encoder level 3's FFN set to the pointwise
# FFW, whose pass is the FFN kernel without a depthwise stage
GOPRO_ENC3_FFW = {"encoder3_ffw_type": "FFW"}
# derain: the shipped deraining model (Turtle_arch, the t0 family; the
# desnowing file differs from it only in its datasets), sr: the shipped x4
# video super-resolution model (Turtlesuper_t1_arch), both unchanged
CONFIGS = {
    "gopro": (OPTION_FILE, {}),
    "gopro_t1_fhr": (OPTION_FILE, GOPRO_T1_FHR),
    "gopro_enc3_ffw": (OPTION_FILE, GOPRO_ENC3_FFW),
    "derain": (os.path.join(ROOT, "options", "Turtle_Derain.yml"), {}),
    "sr": (os.path.join(ROOT, "options", "Turtle_SR_MVSR.yml"), {}),
}
# the command line's task of each configuration streamed tiled
TASKS = {"gopro": "deblur", "derain": "derain", "sr": "sr"}
# exact launches per model call: a CHM block launches each of its kernels
# once (t1: q, k split projection, composite v conv, lattice split,
# probabilities, lattice merge, statistics, FFN; t0: composite v conv,
# lattice split, lattice merge, statistics, FFN); a Channel block the
# statistics and the FFN. Under the fused plan the 33 Channel blocks of the
# four runs (enc3 10, latent 9, dec3 9, dec2 5) are 4 run launches, and
# attention @ v with the merge is one launch per CHM block. Under the
# two_stage plan enc1's pair, enc2's three pairs and the refinement's two
# blocks are 6 two-stage launches where the split route makes 12 FFN ones.
_NONE = {"attn_v_slots": 0, "attn_v_merge": 0, "level_run": 0, "ffn_no_dw": 0,
         "two_stage": 0, "sab_sparse_softmax": 0}
_GOPRO = {"ffn": 51, "qkv_stats": 34, "split_proj": 5, "conv3x3": 11,
          "chm_stats": 3, "sab": 3, "lattice_merge": 3, "lattice_split": 3}
_DERAIN = {**_GOPRO, "split_proj": 2, "sab": 0}
_TWO_STAGE = {"ffn": 39, "two_stage": 6}
LAUNCHES_PER_CALL = {
    "gopro": {**_GOPRO, **_NONE},
    "gopro_t1_fhr": {"ffn": 51, "qkv_stats": 37, "split_proj": 2,
                     "conv3x3": 8, "chm_stats": 0, "sab": 0,
                     "lattice_merge": 0, "lattice_split": 0, **_NONE},
    "gopro_enc3_ffw": {**_GOPRO, **_NONE, "ffn_no_dw": 10},
    "gopro_fused": {**_GOPRO, **_NONE, "ffn": 18, "qkv_stats": 1,
                    "lattice_merge": 0, "attn_v_merge": 3, "level_run": 4},
    "gopro_two_stage": {**_GOPRO, **_NONE, **_TWO_STAGE},
    "derain": {**_DERAIN, **_NONE},
    "derain_two_stage": {**_DERAIN, **_NONE, **_TWO_STAGE},
    "sr": {**_GOPRO, **_NONE},
    "sr_two_stage": {**_GOPRO, **_NONE, **_TWO_STAGE},
}
FRAMES_PER_RUN = 6  # whole-frame and tiled streams: the 3-frame rings wrap
MAX_TILE_BATCH = 15  # the engine's default chunk
FUSED_PLAN = ("channel_runs", "attn_v_merge")
TWO_STAGE = ("two_stage",)
# the tiled streams: configuration -> the plans each runs under; the tile
# and overlap are the task's preset (deblur 320 / 192: 45 tiles of a 720p
# frame; derain 320 / 128: 24 tiles; sr 256 / 64 at the high resolution: 28
# tiles, 64 x 64 at the model's input)
TILED_PLANS = {"gopro": ((), FUSED_PLAN, TWO_STAGE), "derain": ((), TWO_STAGE),
               "sr": ((), TWO_STAGE)}
TILE = infer_cli.TASK_PRESETS["deblur"]["tile"]  # the kernel cases' tiles
# the runs of Channel+GFFW blocks of `gopro`: (scale, C, heads, blocks)
RUN_LEVELS = {"enc3": (4, 256, 4, 10), "latent": (8, 512, 8, 9),
              "dec3": (4, 256, 4, 9), "dec2": (2, 128, 2, 5)}
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
# attention @ v: fp32 sums of exact products in another order, one rounding
ATTN_V_REL_TOL = 2.0 ** -7
# a run of N blocks against its plain version: a flip of one block feeds the
# next (KERNEL_REL_TOL a block); against the split kernels, whose device code
# and rounding points it shares, only the exp and the divide of the small
# softmax differ: one limit whatever the length of the run
RUN_SPLIT_REL_TOL = 2.0 ** -7
# two chained stages against their plain version: KERNEL_REL_TOL a stage
TWO_STAGE_REL_TOL = 2 * KERNEL_REL_TOL
# the sparse softmax on given scores: both versions keep the same entries;
# the values differ by the fp32 sum order and expf, one bf16 rounding of
# values <= 1
SPARSE_TOL = 2.0 ** -7

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
    # the FFN kernel's branch without a depthwise stage (wd absent)
    "ffn_no_dw": ("turtlevsr_tpu_torch/kernels/csrc/ffn.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1843"),
    # one kernel with two epilogues and a wrapper for each (the model calls
    # sab_attn_v_merge, turtlevsr_tpu/kernels/sab.py:282, which reaches the
    # same pallas_call there): its launches are those of both wrappers
    "attn_v": ("turtlevsr_tpu_torch/kernels/csrc/attn_v.cu",
               "turtlevsr_tpu/kernels/sab.py:223"),
    "level_run": ("turtlevsr_tpu_torch/kernels/csrc/level.cu",
                  "turtlevsr_tpu/kernels/level.py:315"),
    "two_stage": ("turtlevsr_tpu_torch/kernels/csrc/chain2.cu",
                  "turtlevsr_tpu/kernels/chain2.py:308"),
    "sab_sparse_softmax": ("turtlevsr_tpu_torch/kernels/csrc/sab.cu",
                           "turtlevsr_tpu/kernels/sab.py:328"),
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
    """Seeded normal inputs, drawn on the card (the cases at 15 tiles hold
    some 10^10 values in all) and rounded to bf16."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)  # the integer inputs
        self.gen = torch.Generator("cuda").manual_seed(seed)

    def __call__(self, *shape, scale: float = 1.0) -> torch.Tensor:
        a = torch.randn(*shape, device="cuda", generator=self.gen)
        return (a * scale).bfloat16()


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
             stacked=0, batch=1):
    ch = 2 * e if mode == "gate" else e
    x = inp(batch, h, w, c)
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
        kw["x2"] = inp(batch, h, w, c)
    if po:
        kw["po_w"] = inp(batch, c, c, scale=c ** -0.5)
    n_maps = int(pair)
    if stacked:  # the CHM block's call: `stacked` history maps and one more
        n_maps = stacked + 1
        kw["x2"] = [inp(batch, stacked, h, w, c), inp(batch, h, w, c)]
        kw["po_w"] = [inp(batch, c, c, scale=c ** -0.5)
                      for _ in range(n_maps)]
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
    del want
    px = batch * h * w
    flops = 2.0 * px * (c * ch + (9 * ch if dw else 0) + e * c
                        + (n_maps * c * c if po or stacked else 0)
                        + (2 * c * f if ffw2 else 0))
    weights = [v for v in kw.values() if torch.is_tensor(v) and v.dim() < 4]
    weights += list(kw.get("ffw2", {}).values())
    if stacked:
        weights += kw["x2"] + kw["po_w"]
    n_bytes = numel_bytes(x, None if stacked else kw.get("x2"), got, *weights)
    b_ms, b_by = bound(n_bytes, flops)
    return dict(kernel="ffn" if dw else "ffn_no_dw", case=name,
                shape=[batch, h, w, c], hidden=ch,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                ok=rel <= KERNEL_REL_TOL and bool(torch.isfinite(got.float()).all()),
                ms=cuda_ms(lambda: K.fused_block_ffn(x, **kw), iters),
                plain_ms=cuda_ms(lambda: K.ffn_plain(x, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def chain_weights(inp: Inputs, c, ch):
    return dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                w1=inp(c, ch, scale=c ** -0.5), wd=inp(3, 3, ch, scale=0.3))


def qkv_case(inp: Inputs, name, h, w, c, heads, iters=5, batch=1):
    x = inp(batch, h, w, c)
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
    flops = 2.0 * batch * px * (c * 3 * c + 9 * 3 * c + c * ctok + 2 * c)
    b_ms, b_by = bound(numel_bytes(x, v, g, s, *kw.values()), flops)
    return dict(kernel="qkv_stats", case=name, shape=[batch, h, w, c],
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


def split_case(inp: Inputs, name, h, w, c, n_out, iters=5, batch=1):
    x = inp(batch, h, w, c)
    kw = chain_weights(inp, c, n_out * c)
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    want = K.split_proj_plain(x, n_out=n_out, **kw)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    flops = 2.0 * batch * h * w * (c * n_out * c + 9 * n_out * c)
    b_ms, b_by = bound(numel_bytes(x, *got, *kw.values()), flops)
    return dict(kernel="split_proj", case=name, shape=[batch, h, w, c],
                n_out=n_out, max_abs_err=err, rel_err=rel,
                tol_rel=KERNEL_REL_TOL, ok=rel <= KERNEL_REL_TOL,
                ms=cuda_ms(lambda: K.fused_ln_split_proj(x, n_out=n_out, **kw),
                           iters),
                plain_ms=cuda_ms(
                    lambda: K.split_proj_plain(x, n_out=n_out, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def conv_case(inp: Inputs, name, h, w, cin, cout, bias, iters=5, ln=False,
              batch=1):
    x = inp(batch, h, w, cin)
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
                       2.0 * batch * h * w * (9 * cin * cout
                                              + (8 * cin if ln else 0)))
    return dict(kernel="conv3x3", case=name, shape=[batch, h, w, cin],
                cout=cout,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                ok=rel <= KERNEL_REL_TOL,
                ms=cuda_ms(lambda: K.fused_conv3x3(x, wt, bb, **lnk), iters),
                plain_ms=cuda_ms(lambda: K.conv3x3_plain(x, wt, bb, **lnk),
                                 2, 1),
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def chm_case(inp: Inputs, name, h, w, c, heads, nf, iters=3, batch=1):
    x, x_sp = inp(batch, h, w, c), inp(batch, nf, h, w, c)
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
    flops = 2.0 * batch * px * ((3 + 2 * nf) * (c * c + 9 * c)
                                + (nf + 1) * c * ctok + (nf + 2) * c)
    tensors = [v for v in kw.values() if torch.is_tensor(v)]
    b_ms, b_by = bound(numel_bytes(x, x_sp, *got, *tensors), flops)
    return dict(kernel="chm_stats", case=name, shape=[batch, nf, h, w, c],
                heads=heads, max_abs_err=max(err_v, err_vh, err_stats / px),
                rel_err=max(rel_v, rel_vh), rel_err_stats=rel_stats,
                tol_rel=KERNEL_REL_TOL, tol_rel_stats=STATS_REL_TOL,
                ok=(max(rel_v, rel_vh) <= KERNEL_REL_TOL
                    and rel_stats <= STATS_REL_TOL),
                ms=cuda_ms(lambda: K.fused_chm_stats(x, x_sp, **kw), iters),
                plain_ms=cuda_ms(lambda: K.chm_stats_plain(x, x_sp, **kw),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sab_inputs(inp: Inputs, nf, hw, d, exact: bool, batch: int = 1):
    """Unit vectors, or (exact) small integers over 8 with a temperature of
    one half: every score is then exact in fp32 whatever the order of the
    sum, and rows tie many times."""
    if exact:
        q = torch.from_numpy(inp.rng.randint(-2, 3, (batch, hw, d)) / 8.0)
        k = torch.from_numpy(inp.rng.randint(-2, 3, (batch, nf, hw, d)) / 8.0)
        temp = torch.tensor([0.5], device="cuda")
        return (q.to("cuda", torch.bfloat16), k.to("cuda", torch.bfloat16),
                temp)
    q, k = inp(batch, hw, d).float(), inp(batch, nf, hw, d).float()
    q = (q / q.norm(dim=-1, keepdim=True)).bfloat16()
    k = (k / k.norm(dim=-1, keepdim=True)).bfloat16()
    return q, k, torch.tensor([1.7], device="cuda")


def sab_compare(got, want):
    """(share of rows whose support differs, largest error on the others)."""
    same = ((got != 0) == (want != 0)).all(dim=-1)
    err = ((got.float() - want.float()).abs().amax(dim=-1) * same).max().item()
    return 1.0 - same.float().mean().item(), err


def sab_case(inp: Inputs, name, hq, wq, d, nf, iters=3, batch=1):
    hw = hq * wq
    fv = torch.ones(nf, device="cuda")
    # (a) exact scores: the same support, bit for bit
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True, batch=batch)
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    exact_same = bool(torch.equal(got != 0, want != 0))
    exact_err = (got.float() - want.float()).abs().max().item()
    # (b) unit vectors, the last frame invalid
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=False, batch=batch)
    fv[-1] = 0.0 if nf > 1 else 1.0
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    share, err = sab_compare(got, want)
    rows_ok = bool(((got.float().sum(-1) - fv[None, :, None]).abs()
                    <= 0.02).all())
    del want
    b_ms, b_by = bound(numel_bytes(q, k, got),
                       2.0 * batch * nf * hw * hw * d)
    return dict(kernel="sab", case=name, shape=[batch, nf, hw, d],
                grid=[hq, wq],
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


def attn_v_case(inp: Inputs, name, b, nf, hq, wq, ws, c, merge=True, iters=5):
    """Attention @ v at the shape a CHM block gives it: nf - 1 ring positions
    (views of one buffer, as the cache stores them) and the current frame's
    values. library: torch.matmul per position and, for the merge, the
    library's permuted copy."""
    hw, d, h, w = hq * wq, ws * ws * c, hq * ws, wq * ws
    a = torch.rand(b * nf, hw, hw, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(hw + d))
    a = a * (a > 0.88)  # some 48 of 400 entries a row, as the softmax leaves
    a = (a / a.sum(-1, keepdim=True).clamp_min(1e-6)).bfloat16()
    ring = inp(b, max(nf - 1, 1), hw, d)
    vs = [ring[:, i] for i in range(nf - 1)] + [inp(b, hw, d)]
    if merge:
        fn = lambda: S.sab_attn_v_merge(a, vs, ws, h, w)  # noqa: E731
        plain = lambda: S.attn_v_merge_plain(a, vs, ws, h, w)  # noqa: E731
    else:
        fn = lambda: S.sab_attn_v_slots(a, vs, c)  # noqa: E731
        plain = lambda: S.attn_v_slots_plain(a, vs, c)  # noqa: E731
    got = fn()
    torch.cuda.synchronize()
    want = plain()
    err, rel = rel_err(got, want)
    del want
    a4 = a.reshape(b, nf, hw, hw)
    tok = torch.empty(b, nf, hw, d, device="cuda", dtype=torch.bfloat16)

    def library():
        for i, vi in enumerate(vs):
            torch.matmul(a4[:, i], vi, out=tok[:, i])
        if merge:
            return L.lattice_merge_plain(tok.reshape(b * nf, hw, d), ws, h, w
                                         ).contiguous()
        return tok.reshape(b * nf, hw, ws * ws, c).permute(0, 2, 1, 3
                                                           ).contiguous()

    b_ms, b_by = bound(numel_bytes(a, *vs, got), 2.0 * b * nf * hw * hw * d)
    return dict(kernel="attn_v", case=name, epilogue="merge" if merge
                else "slots", shape=[b * nf, hw, hw, d], window=ws,
                max_abs_err=err,
                rel_err=rel, tol_rel=ATTN_V_REL_TOL,
                ok=rel <= ATTN_V_REL_TOL and bool(
                    torch.isfinite(got.float()).all()),
                ms=cuda_ms(fn, iters), plain_ms=cuda_ms(plain, 1, 0),
                library_ms=cuda_ms(library, iters), bound_ms=b_ms,
                bound_by=b_by)


def run_case(inp: Inputs, name, b, h, w, c, heads, n_blocks, iters=3):
    """A run of Channel+GFFW blocks: the run kernel against its plain version
    and against the 2 N split launches it replaces (their time is split_ms,
    no library call computes the run)."""
    e = int(c * 2.5)
    x = inp(b, h, w, c)
    blocks = [dict(
        ln1_w=1.0 + inp(c, scale=0.2), ln1_b=inp(c, scale=0.2),
        w_qkv=inp(c, 3 * c, scale=c ** -0.5),
        wd_qkv=inp(3, 3, 3 * c, scale=0.3),
        temp=1.0 + inp(heads, scale=0.3).abs(),
        wpo=inp(c, c, scale=c ** -0.5), ln2_w=1.0 + inp(c, scale=0.2),
        ln2_b=inp(c, scale=0.2), w1=inp(c, 2 * e, scale=c ** -0.5),
        wd=inp(3, 3, 2 * e, scale=0.3), w2=inp(e, c, scale=e ** -0.5))
        for _ in range(n_blocks)]
    got = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    split = LV.channel_gffw_run_split(x, blocks, heads)
    err_s, rel_s = rel_err(got, split)
    del split
    want = LV.channel_gffw_run_plain(x, blocks, heads)
    err, rel = rel_err(got, want)
    del want
    tol = KERNEL_REL_TOL * n_blocks
    # one map read, one map written, the weights; per pixel and block the
    # three chains, the head blocks of the Gram, the norms, v @ po', the
    # gate chains and pw2
    px, ctok = b * h * w, c // heads
    flops = 2.0 * n_blocks * px * (c * 3 * c + 27 * c + c * ctok + 2 * c
                                   + c * c + c * 2 * e + 18 * e + e * c)
    weights = [v for blk in blocks for v in blk.values()]
    b_ms, b_by = bound(numel_bytes(x, got, *weights), flops)
    return dict(kernel="level_run", case=name, shape=[b, h, w, c],
                heads=heads, blocks=n_blocks, max_abs_err=err, rel_err=rel,
                tol_rel=tol, max_abs_err_vs_split=err_s,
                rel_err_vs_split=rel_s, tol_rel_vs_split=RUN_SPLIT_REL_TOL,
                ok=(rel <= tol and rel_s <= RUN_SPLIT_REL_TOL
                    and bool(torch.isfinite(got.float()).all())),
                ms=cuda_ms(lambda: LV.fused_channel_gffw_run(x, blocks, heads),
                           iters, 1),
                split_ms=cuda_ms(
                    lambda: LV.channel_gffw_run_split(x, blocks, heads),
                    iters, 1),
                plain_ms=cuda_ms(
                    lambda: LV.channel_gffw_run_plain(x, blocks, heads), 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def two_stage_case(inp: Inputs, name, kind, b, h, w, c, e1, e2, iters=3):
    """Row 13 at the shape a conv-only level gives it: a pair of
    ReducedAttn+FFW blocks (kind "pair") or a ReducedAttn+GFFW block
    ("ra_gffw"), against its plain version and against the split route it
    replaces (two FFN launches; their time is split_ms, no library call
    computes the chain)."""
    x = inp(b, h, w, c)

    def stage(e, mode):
        ch = 2 * e if mode == "gate" else e
        st = dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                  w1=inp(c, ch, scale=c ** -0.5), wd=inp(3, 3, ch, scale=0.3),
                  w2=inp(e, c, scale=e ** -0.5), mode=mode)
        if mode == "gelu":  # the ReducedAttn: biases, and beta as its scale
            st.update(b1=inp(ch, scale=0.2), bd=inp(ch, scale=0.2),
                      b2=inp(c, scale=0.2), scale=inp(c, scale=0.5))
        return st

    def ffw():
        f = 2 * c
        return dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                    w1=inp(c, f, scale=c ** -0.5), b1=inp(f, scale=0.2),
                    w2=inp(f, c, scale=f ** -0.5), b2=inp(c, scale=0.2),
                    scale=inp(c, scale=0.5))

    st1 = stage(e1, "gelu")
    if kind == "pair":
        st2, ffw1, ffw2 = stage(e2, "gelu"), ffw(), ffw()
    else:
        st2, ffw1, ffw2 = stage(e2, "gate"), None, None
    kw = dict(ffw1=ffw1, ffw2=ffw2)
    got = C2.fused_two_stage(x, st1, st2, **kw)
    torch.cuda.synchronize()
    want = C2.two_stage_plain(x, st1, st2, **kw)
    err, rel = rel_err(got, want)
    del want

    def split():
        y = K.fused_block_ffn(x, ffw2=ffw1, **st1)
        return K.fused_block_ffn(y, ffw2=ffw2, **st2)

    split_out = split()
    bit_equal = bool(torch.equal(got, split_out))
    err_s, rel_s = rel_err(got, split_out)
    del split_out
    px = b * h * w
    flops = 0.0
    weights = []
    for st, f in ((st1, ffw1), (st2, ffw2)):
        ch = st["w1"].shape[1]
        flops += 2.0 * px * (c * ch + 9 * ch + st["w2"].shape[0] * c
                             + (4 * c * c if f else 0))
        weights += [v for v in st.values() if torch.is_tensor(v)]
        weights += [v for v in (f or {}).values() if torch.is_tensor(v)]
    b_ms, b_by = bound(numel_bytes(x, got, *weights), flops)
    return dict(kernel="two_stage", case=name, shape=[b, h, w, c],
                hidden=[e1, e2], max_abs_err=err, rel_err=rel,
                tol_rel=TWO_STAGE_REL_TOL, bit_equal_to_split=bit_equal,
                max_abs_err_vs_split=err_s, rel_err_vs_split=rel_s,
                ok=rel <= TWO_STAGE_REL_TOL and rel_s <= TWO_STAGE_REL_TOL
                and bool(torch.isfinite(got.float()).all()),
                ms=cuda_ms(lambda: C2.fused_two_stage(x, st1, st2, **kw),
                           iters),
                split_ms=cuda_ms(split, iters),
                plain_ms=cuda_ms(lambda: C2.two_stage_plain(x, st1, st2, **kw),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sparse_case(inp: Inputs, name, b, nf, hq, wq, d, iters=3):
    """Row 12 on the scores of an alignment attention (B * NF entries of
    HW x HW on an (hq, wq) window grid) and the grid's local mask, against
    its plain version and against row 7 on the same q, k: exact inputs make
    every score exact whatever the order of its sum, and the scores are
    rounded to bf16 as row 7 rounds them, so the two agree bit for bit."""
    hw = hq * wq
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True, batch=b)
    scores = (torch.einsum("bqd,bnkd->bnqk", q.float(), k.float())
              * temp).bfloat16().reshape(b * nf, hw, hw).contiguous()
    mask = local_window_mask(hq, wq, 4, torch.bfloat16, "cuda")
    got = S.sab_sparse_softmax(scores, mask)
    torch.cuda.synchronize()
    row7 = S.sab_attn_probs(q, k, temp, None, grid_wq=wq)
    equal_row7 = bool(torch.equal(got, row7.reshape(got.shape)))
    del row7
    want = S.sparse_softmax_plain(scores, mask)
    same_support = bool(torch.equal(got != 0, want != 0))
    err = (got.float() - want.float()).abs().max().item()
    del want
    b_ms, b_by = bound(numel_bytes(scores, mask, got), 0.0)
    return dict(kernel="sab_sparse_softmax", case=name, shape=[b * nf, hw, hw],
                grid=[hq, wq], max_abs_err=err, rel_err=err, tol=SPARSE_TOL,
                same_support_as_plain=same_support,
                bit_equal_to_row_7=equal_row7,
                ok=same_support and err <= SPARSE_TOL and equal_row7,
                ms=cuda_ms(lambda: S.sab_sparse_softmax(scores, mask), iters),
                plain_ms=cuda_ms(lambda: S.sparse_softmax_plain(scores, mask),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


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


def path_cases(inp: Inputs, b: int, h: int, w: int, tag: str = "") -> list:
    """One case for every kernel instantiation and shape that a model call of
    `gopro` launches on a batch of b maps of (h, w): whole padded frames
    (b = 1) or a chunk of tiles. The same tolerances at either size."""
    h2, w2, h3, w3, h4, w4 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    big = 3  # iterations at the widest maps

    def ffn(name, *a, **kw):
        return lambda: ffn_case(inp, name + tag, *a, batch=b, **kw)

    def qkv(name, *a, **kw):
        return lambda: qkv_case(inp, name + tag, *a, batch=b, **kw)

    def split(name, *a, **kw):
        return lambda: split_case(inp, name + tag, *a, batch=b, **kw)

    def conv(name, *a, **kw):
        return lambda: conv_case(inp, name + tag, *a, batch=b, **kw)

    cases = [
        ffn("gate+pair+po(B,C,C) dec3/enc3", h3, w3, 256, 640, "gate",
            pair=True, po=True),
        ffn("gate+pair+po(B,C,C) latent", h4, w4, 512, 1280, "gate",
            pair=True, po=True),
        ffn("gate+pair, no po (FHR) latent", h4, w4, 512, 1280, "gate",
            pair=True),
        ffn("gate, no pair (refinement)", h, w, 64, 160, "gate", iters=big),
        ffn("gelu+scale (refinement RA)", h, w, 64, 128, "gelu", biases=True,
            scale=True, iters=big),
        ffn("gelu+scale+ffw2 (enc1 RA+FFW)", h, w, 64, 128, "gelu",
            biases=True, scale=True, ffw2=True, iters=big),
        ffn("gelu+scale+ffw2 (enc2 RA+FFW)", h2, w2, 128, 256, "gelu",
            biases=True, scale=True, ffw2=True),
        qkv("enc3/dec3", h3, w3, 256, 4),
        qkv("latent", h4, w4, 512, 8),
        qkv("dec1", h, w, 64, 1, iters=big),
        split("latent FHR q,k,v", h4, w4, 512, 3),
        conv("up4_3 512->1024", h4, w4, 512, 1024, False),
        conv("input 3->64", h, w, 3, 64, False, iters=big),
        conv("ending 64->3 +bias", h, w, 64, 3, True, iters=big),
        conv("down1_2 64->32", h, w, 64, 32, False, iters=big),
        # the remaining kernel instantiations and shapes of the path
        ffn("gate+pair+po(B,C,C) dec2", h2, w2, 128, 320, "gate", pair=True,
            po=True),
        ffn("gate+pair+po(B,C,C) dec1", h, w, 64, 160, "gate", pair=True,
            po=True, iters=big),
        qkv("dec2", h2, w2, 128, 2),
        conv("down2_3 128->64", h2, w2, 128, 64, False),
        conv("down3_4 256->128", h3, w3, 256, 128, False),
        conv("up3_2 256->512", h3, w3, 256, 512, False),
        conv("up2_1 128->256", h2, w2, 128, 256, False),
    ]
    # the CHM blocks: the four kernels of the alignment and the routing, and
    # the shapes they give the FFN (lists), the split projection (two maps)
    # and the conv (with LayerNorm), level by level
    for lvl, (s, c, heads, ws, ring) in CHM_LEVELS.items():
        hl, wl, nf = h // s, w // s, ring + 1
        it = big if s == 1 else 5
        cases += [
            lambda lvl=lvl, hl=hl, wl=wl, c=c, heads=heads, nf=nf: chm_case(
                inp, lvl + tag, hl, wl, c, heads, nf, batch=b),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, nf=nf: sab_case(
                inp, lvl + tag, hl // ws, wl // ws, 2 * c, nf, batch=b),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, nf=nf, it=it:
                lattice_case(inp, lvl + tag, hl, wl, c, ws, nf * b, True, it),
            lambda lvl=lvl, hl=hl, wl=wl, c=c, ws=ws, it=it: lattice_case(
                inp, lvl + tag, hl, wl, c, ws, b, False, it),
            ffn(f"gate + {nf} stacked + 1 maps, po(B,C,C) each (CHM {lvl})",
                hl, wl, c, int(c * 2.5), "gate", stacked=nf, iters=it),
            split(f"SAB q,k {lvl}", hl, wl, c, 2, it),
            conv(f"LN + composite v {lvl} {c}->{c}", hl, wl, c, c, False, it,
                 ln=True),
        ]
    return cases


def kernel_cases(seed: int, h: int, w: int) -> list[dict]:
    """Every kernel at the shapes the serving paths give it: whole padded
    frames of (h, w), then a chunk of tiles (the tiled stream's model call);
    the first case of each kernel is the one its row reports."""
    inp = Inputs(seed)
    h3, w3, h4, w4 = h // 4, w // 4, h // 8, w // 8
    tb, tl = MAX_TILE_BATCH, TILE
    cases = path_cases(inp, 1, h, w)
    # the branch without a depthwise stage: an FFW half alone, and the FFW
    # pass of enc3 in `gopro_enc3_ffw` (whole-frame only)
    cases += [
        lambda: ffn_case(inp, "gelu+scale, no dw (an FFW half alone; not on "
                         "the main path)", h, w, 64, 128, "gelu", biases=True,
                         scale=True, dw=False, iters=3),
        lambda: ffn_case(inp, "gelu+scale, no dw (FFW pass of enc3 in "
                         "gopro_enc3_ffw)", h3, w3, 256, 512, "gelu",
                         biases=True, scale=True, dw=False),
    ]
    # tiled streaming, 15 tiles of 320 x 320 a model call: every kernel of
    # the path again at that batch (grid dimensions, offsets and the partial
    # rows grow with it; 400 window tokens at each CHM level)
    cases += path_cases(inp, tb, tl, tl, f", {tb} tiles")
    # under the fused plan: the runs of Channel+GFFW blocks, and attention @ v
    # with the merge at the three CHM levels
    for lvl, (s_, c, heads, n) in RUN_LEVELS.items():
        cases.append(lambda lvl=lvl, s_=s_, c=c, heads=heads, n=n: run_case(
            inp, f"{lvl} x{n}, {tb} tiles", tb, tl // s_, tl // s_, c, heads,
            n))
    cases.append(lambda: run_case(inp, "latent x9, whole frame", 1, h4, w4,
                                  512, 8, 9))
    for lvl, (s_, c, _, ws, ring) in CHM_LEVELS.items():
        side = tl // s_ // ws
        cases.append(lambda lvl=lvl, c=c, ws=ws, ring=ring, side=side:
                     attn_v_case(inp, f"merge {lvl}, {tb} tiles", tb,
                                 ring + 1, side, side, ws, c))
    cases.append(lambda: attn_v_case(inp, f"slots dec3, {tb} tiles", tb, 4,
                                     20, 20, 4, 256, merge=False))
    # the dec3 shape of `gopro` whole-frame: 4 entries of 3680 window tokens
    # (both query tiles are timed: 80 rows fill 400 and 3680 alike)
    cases.append(lambda: attn_v_case(inp, "merge dec3, whole frame", 1, 4,
                                     h3 // 4, w3 // 4, 4, 256, iters=3))
    # the conv's tiles cut by the map's edges and Cout: maps whose sides the
    # pixel tiles (8 x 16, 16 x 16, 16 x 32) do not divide, Cout that the N
    # tiles (128, 64, 32, 16) do not divide
    hr, wr = h // 8 - 1, w // 8 - 3
    cases += [
        lambda: conv_case(inp, "ragged 512->1000", hr, wr, 512, 1000, True),
        lambda: conv_case(inp, "ragged 256->200", 2 * hr + 1, 2 * wr + 1,
                          256, 200, False),
        lambda: conv_case(inp, "ragged 128->40, 2 maps", 4 * hr + 3,
                          4 * wr + 5, 128, 40, True, batch=2),
        lambda: conv_case(inp, "ragged 64->24", h - 5, w - 7, 64, 24, False,
                          iters=3),
        lambda: conv_case(inp, "ragged 64->5 +bias", h - 5, w - 7, 64, 5, True,
                          iters=3),
        lambda: conv_case(inp, "ragged 3->72", h - 5, w - 7, 3, 72, True,
                          iters=3),
        lambda: conv_case(inp, "ragged LN + v 256->256", 2 * hr + 1,
                          2 * wr + 1, 256, 256, False, ln=True),
    ]
    # under the two_stage plan: the conv-only levels (enc1 and enc2 pairs of
    # ReducedAttn+FFW blocks, the refinement's ReducedAttn+GFFW blocks),
    # whole padded frames and 15 tiles
    h2, w2, tl2 = h // 2, w // 2, tl // 2
    cases += [
        lambda: two_stage_case(inp, "enc1 pair", "pair", 1, h, w, 64, 128,
                               128),
        lambda: two_stage_case(inp, "enc2 pair", "pair", 1, h2, w2, 128, 256,
                               256),
        lambda: two_stage_case(inp, "refinement RA+GFFW", "ra_gffw", 1, h, w,
                               64, 128, 160),
        lambda: two_stage_case(inp, f"enc1 pair, {tb} tiles", "pair", tb, tl,
                               tl, 64, 128, 128),
        lambda: two_stage_case(inp, f"enc2 pair, {tb} tiles", "pair", tb,
                               tl2, tl2, 128, 256, 256),
        lambda: two_stage_case(inp, f"refinement RA+GFFW, {tb} tiles",
                               "ra_gffw", tb, tl, tl, 64, 128, 160),
    ]
    # the sparse softmax on given scores: the window-token grids of the three
    # CHM levels (46 x 80 tokens at every level of a padded 720p frame), and
    # dec3 at 15 tiles (20 x 20 tokens, 4 frames each)
    for lvl, (s_, c, _, ws, ring) in CHM_LEVELS.items():
        hq, wq = h // s_ // ws, w // s_ // ws
        cases.append(lambda lvl=lvl, c=c, hq=hq, wq=wq, nf=ring + 1:
                     sparse_case(inp, f"{lvl} scores", 1, nf, hq, wq, 2 * c))
    cases.append(lambda: sparse_case(inp, f"dec3 scores, {tb} tiles", tb, 4,
                                     tl // 4 // 4, tl // 4 // 4, 512))
    out = []
    for make in cases:
        t0 = time.perf_counter()
        res = make()
        res["case_seconds"] = time.perf_counter() - t0
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
             "lattice_merge": L.lattice_merge_plain,
             "sab_attn_v_merge": S.attn_v_merge_plain,
             "fused_channel_gffw_run": LV.channel_gffw_run_plain,
             "fused_two_stage": C2.two_stage_plain}
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
    path, overrides = CONFIGS[config]
    opt = load_options(path, is_train=False)
    opt.update(overrides)
    return opt


def profile_frames(engine: InferenceEngine, frames: list,
                   untraced_ms: float, config: str, **extra) -> None:
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
    emit({"phase": "profile", "config": config, **extra,
          "frames": len(frames),
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
              height: int, trace: bool = False, fuse: tuple = ()) -> dict:
    opt = options_of(config)
    model = build_model(opt, device="cuda", fuse=fuse,
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    cfg = model.cfg
    scale = cfg.sr_scale if cfg.variant == "sr" else 1  # HR frames in and out
    engine = InferenceEngine(model, mode="whole", dtype=torch.bfloat16)
    frames = make_frames(seed + 2, n_frames, height, width)
    ring = max(lvl.num_frames_tocache for lvl in (cfg.latent, cfg.dec3,
                                                   cfg.dec2, cfg.dec1))
    require(n_frames > ring, f"need more than {ring} frames to wrap the rings")

    # main path: counts set to 0 just before, read just after; the peak of
    # device memory is that of the stream, not of the phases before it
    torch.cuda.reset_peak_memory_stats()
    kernels_pkg.reset_launch_counts()
    # two clocks per frame: the host's around the step, and CUDA events
    # around what the step queued (from its first kernel's start to its last
    # one's end: the host's share before the upload and after the fetch is
    # outside them)
    outs, times, events = [], [], []
    for fr in frames:
        torch.cuda.synchronize()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        out = engine.step(fr)
        ev[1].record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        events.append(ev[0].elapsed_time(ev[1]))
        outs.append(out)
    counts = kernels_pkg.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, out in enumerate(outs):
        require(out.shape == (height, width, 3),
                f"frame {i}: output shape {out.shape}")
        require(bool(np.isfinite(out).all()), f"frame {i}: non-finite output")
    tag = config + ("_two_stage" if fuse else "")
    for name, per_frame in LAUNCHES_PER_CALL[tag].items():
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
        phase="slice", config=config, plan=list(fuse), variant=cfg.variant,
        option_file=os.path.relpath(CONFIGS[config][0], ROOT),
        frame=[height, width, 3],
        padded=list(turtle_mod.padded_hw(cfg, height // scale, width // scale)),
        dtype="bfloat16",
        frames=n_frames, ring_frames=ring, params=sum(
            p.numel() for p in model.parameters()),
        launches=counts, launches_per_frame={
            k: v / n_frames for k, v in counts.items()},
        ms_per_frame=times, ms_per_frame_after_warmup=float(
            np.mean(times[2:])), ms_per_frame_min_max=[
            min(times[2:]), max(times[2:])],
        event_ms_per_frame=events, event_ms_per_frame_after_warmup=float(
            np.mean(events[2:])), plain_ms_per_frame=plain_ms,
        psnr_vs_plain_db=psnrs, min_psnr_db=SLICE_MIN_PSNR,
        max_abs_err_vs_plain=max_err, mean_abs_change_of_input=change,
        peak_memory_gib=peak_gb)
    emit(res)
    if trace:
        profile_frames(engine, frames[:3], res["ms_per_frame_after_warmup"],
                       config, plan=list(fuse))
    require(min(psnrs) >= SLICE_MIN_PSNR,
            f"kernel path and plain path disagree: PSNR {psnrs}")
    require(min(change) > 0, "the model returned its input unchanged")
    del engine, model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# tiled streaming through the command line's entry point
# ---------------------------------------------------------------------------


def read_pngs(folder: str, n: int) -> list[np.ndarray]:
    from PIL import Image

    return [np.asarray(Image.open(os.path.join(
        folder, f"Frame_{i + 1}_Pred.png")), np.float32) / 255.0
        for i in range(n)]


def tiled_tag(config: str, plan: tuple) -> str:
    name = {(): "tiled", FUSED_PLAN: "tiled_fused",
            TWO_STAGE: "tiled_two_stage"}[tuple(plan)]
    return name if config == "gopro" else f"{config}_{name}"


def run_tiled(config: str, seed: int, width: int, height: int,
              trace: bool) -> dict:
    """One configuration tiled at its task's preset through cli.infer.main,
    under each of its plans, against the plain versions on the card. The
    weights are a state_dict file written from the seed (scales drawn), the
    frames a folder of PNGs (the high-resolution ones for SR); main builds
    the model, the tiled engine and the loop itself."""
    from PIL import Image

    n = FRAMES_PER_RUN
    task = TASKS[config]
    preset = infer_cli.TASK_PRESETS[task]
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{config}_")
    by_plan = {}
    try:
        model = build_model(options_of(config), device="cuda",
                            generator=torch.Generator().manual_seed(seed))
        randomise_scales(model, seed + 1)
        weights = os.path.join(work, "weights.pth")
        torch.save(model.state_dict(), weights)
        cfg = model.cfg
        del model
        video = os.path.join(work, "frames", "video0")
        os.makedirs(video)
        for i, fr in enumerate(make_frames(seed + 2, n, height, width)):
            Image.fromarray((fr * 255.0).round().astype(np.uint8)).save(
                os.path.join(video, f"{i:05d}.png"))

        def cli(tag: str, fuse: tuple) -> dict:
            # the task's preset (tile, overlap); the option file by its path
            argv = ["--task", task, "-opt", CONFIGS[config][0],
                    "--model_path", weights, "--data_dir",
                    os.path.join(work, "frames"), "--no_gt", "--max_frames",
                    str(n), "--save_path", os.path.join(work, tag)]
            if fuse:
                argv += ["--fuse", *fuse]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels_pkg.reset_launch_counts()
            with contextlib.redirect_stdout(sys.stderr):  # its own report
                res = infer_cli.main(argv)
            torch.cuda.synchronize()
            res["launches"] = kernels_pkg.launch_counts()
            res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            res["outs"] = read_pngs(os.path.join(work, tag, "video0"), n)
            torch.cuda.empty_cache()
            return res

        with plain_versions():
            plain = cli("plain", ())
        require(not any(plain["launches"].values()),
                "the plain run must launch no kernel")
        eng = InferenceEngine.__new__(InferenceEngine)
        eng.tile, eng.tile_overlap = preset["tile"], preset["tile_overlap"]
        _, _, t, his, wis = eng.tile_plan(height, width)
        n_tiles = len(his) * len(wis)
        calls = -(-n_tiles // MAX_TILE_BATCH)  # model calls per frame
        scale = cfg.sr_scale if cfg.variant == "sr" else 1
        for fuse in TILED_PLANS[config]:
            tag = tiled_tag(config, fuse)
            res = cli(tag, fuse)
            require(res["frames"] == n, f"{tag}: {res['frames']} frames")
            # an output's copy to the host is queued behind the next frame's
            # kernels (one stream), so fetch i returns when frame i + 1 is
            # done and the last two fetches come together: the times of
            # frames 2 .. n - 1 are the differences but the last
            clock = res["fetch_clock"]
            ms = [(b - a) * 1e3 for a, b in zip(clock, clock[1:])]
            psnrs = [psnr(a, b) for a, b in zip(res["outs"], plain["outs"])]
            for i, out in enumerate(res["outs"]):
                require(out.shape == (height, width, 3),
                        f"{tag} frame {i}: output shape {out.shape}")
            key = config + {(): "", FUSED_PLAN: "_fused",
                            TWO_STAGE: "_two_stage"}[tuple(fuse)]
            for name, per_call in LAUNCHES_PER_CALL[key].items():
                require(res["launches"][name] == per_call * calls * n,
                        f"{tag} {name}: {res['launches'][name]} launches "
                        f"over {n} frames of {calls} model calls, expected "
                        f"{per_call} per call")
            out = dict(
                phase="tiled", config=config, variant=cfg.variant,
                task=task, plan=list(fuse),
                entry="turtlevsr_tpu_torch.cli.infer.main",
                frame=[height, width, 3], tile=t,
                tile_overlap=preset["tile_overlap"], tiles=n_tiles,
                model_tile=t // scale, max_tile_batch=MAX_TILE_BATCH,
                model_calls_per_frame=calls, dtype="bfloat16", frames=n,
                launches=res["launches"], launches_per_frame={
                    k: v / n for k, v in res["launches"].items()},
                ms_between_fetches=ms,
                ms_per_frame_after_warmup=float(np.mean(ms[:-1])),
                ms_per_frame_min_max=[min(ms[:-1]), max(ms[:-1])],
                fps_end_to_end=res["frames"] / res["seconds"],
                fps_device_loop=res["frames"] / res["device_loop_seconds"],
                plain_fps_device_loop=plain["frames"]
                / plain["device_loop_seconds"],
                psnr_vs_plain_db=psnrs, min_psnr_db=SLICE_MIN_PSNR,
                max_abs_err_vs_plain=max(float(np.abs(a - b).max()) for a, b
                                         in zip(res["outs"], plain["outs"])),
                peak_memory_gib=res["peak_memory_gib"])
            emit(out)
            require(min(psnrs) >= SLICE_MIN_PSNR,
                    f"{tag}: kernel path and plain path disagree: PSNR "
                    f"{psnrs}")
            by_plan[tag] = out
        if trace:
            for fuse in TILED_PLANS[config]:
                tag = tiled_tag(config, fuse)
                model = build_model(options_of(config), device="cuda",
                                    fuse=fuse)
                model.load_state_dict(torch.load(weights, weights_only=True))
                engine = InferenceEngine(
                    model, mode="tiled", tile=preset["tile"],
                    tile_overlap=preset["tile_overlap"],
                    max_tile_batch=MAX_TILE_BATCH, dtype=torch.bfloat16)
                frames = make_frames(seed + 2, 4, height, width)
                for fr in frames[:2]:
                    engine.step(fr)
                profile_frames(engine, frames[2:],
                               by_plan[tag]["ms_per_frame_after_warmup"],
                               config, mode="tiled", plan=list(fuse))
                del engine, model
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return by_plan


# ---------------------------------------------------------------------------


def kernel_rows(cases: list[dict], by_path: dict) -> list[dict]:
    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]
        counters = ("attn_v_merge", "attn_v_slots") if name == "attn_v" else (
            name,)
        per_path = {p: sum(c[k] for k in counters) for p, c in by_path.items()}
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(per_path.values()), launches_by_path=per_path,
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], case=head["case"],
            cases=[{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err", "rel_err", "split_ms",
                                      "rel_err_vs_split", "bit_equal_to_split",
                                      "bit_equal_to_row_7") if k in c}
                   for c in mine]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES_PER_RUN,
                    help="frames of the whole-frame streams but "
                         "`gopro_enc3_ffw`")
    ap.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", default="all",
                    choices=("all", "build", "kernels", "slice", "tiled"))
    ap.add_argument("--profile", action="store_true",
                    help="after each whole-frame stream (but "
                         "`gopro_enc3_ffw`) and each tiled stream under each "
                         "plan, trace a few more frames with torch.profiler: "
                         "device time by kernel, idle share")
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
        cases, by_path = [], {}
        if args.phase in ("all", "kernels"):
            cases = kernel_cases(args.seed, hp, wp)
            bad = [c["case"] for c in cases if not c["ok"]]
            require(not bad, f"kernels disagree with their plain versions: "
                             f"{bad}")
        if args.phase in ("all", "slice"):
            # the earlier slices' paths (the frames wrap the 3-frame rings),
            # the FFW pass of the kernel without a depthwise stage, the t0 and
            # SR families whole-frame, and `gopro` under the two_stage plan
            for config, n, fuse in (
                    ("gopro_t1_fhr", args.frames, ()),
                    ("gopro", args.frames, ()), ("gopro_enc3_ffw", 4, ()),
                    ("derain", args.frames, ()), ("sr", args.frames, ()),
                    ("gopro", args.frames, TWO_STAGE)):
                tag = config + ("_two_stage" if fuse else "")
                by_path[tag] = run_slice(
                    config, args.seed, n, width, height, fuse=fuse,
                    trace=args.profile and config != "gopro_enc3_ffw"
                )["launches"]
        if args.phase in ("all", "tiled"):
            # the command line's tiled streams, each under its plans
            for config in TILED_PLANS:
                for tag, res in run_tiled(config, args.seed, width, height,
                                          args.profile).items():
                    by_path[tag] = res["launches"]
        if args.phase == "all":
            # every path launched the kernels that lie on it (the exact
            # counts were held above); attn_v_slots is the second epilogue of
            # the kernel that attn_v_merge launches and has no caller of its
            # own in the model, nor has sab_sparse_softmax (row 12)
            t0_chm = ("ffn", "qkv_stats", "split_proj", "conv3x3",
                      "chm_stats", "lattice_merge", "lattice_split")
            t1_chm = t0_chm + ("sab",)
            on_path = {
                "gopro_t1_fhr": ("ffn", "qkv_stats", "split_proj", "conv3x3"),
                "gopro": t1_chm, "gopro_enc3_ffw": ("ffn_no_dw",),
                "derain": t0_chm, "sr": t1_chm,
                "gopro_two_stage": t1_chm + ("two_stage",), "tiled": t1_chm,
                "tiled_fused": ("ffn", "qkv_stats", "split_proj", "conv3x3",
                                "chm_stats", "sab", "lattice_split",
                                "attn_v_merge", "level_run"),
                "tiled_two_stage": t1_chm + ("two_stage",),
                "derain_tiled": t0_chm,
                "derain_tiled_two_stage": t0_chm + ("two_stage",),
                "sr_tiled": t1_chm, "sr_tiled_two_stage": t1_chm + (
                    "two_stage",),
            }
            require(set(by_path) == set(on_path),
                    f"paths run: {sorted(by_path)}")
            for path, names in on_path.items():
                for name in names:
                    require(by_path[path][name] > 0,
                            f"the {path} path never launched {name}")
            require(by_path["tiled_fused"]["lattice_merge"] == 0,
                    "the fused plan still launched lattice_merge")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if cases and len(by_path) == 13:  # launches are those of this run's paths
        emit({"kernels": kernel_rows(cases, by_path)})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
