#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--frames 6] [--size 1280x720] [--phase all]
                          [--profile] [--ptxas] [--cases TEXT]

(--cases TEXT, with --phase kernels: only the kernel cases whose
"<kernel>: <case>" holds TEXT, e.g. "ffn: gate+pair+po(B,C,C) latent"; given
more than once, those that hold any of them; with --phase float32 its
kernel cases alone, e.g. "ffn_f32:" for row 1's float32 body; such a run
prints no result line and no ok line.)

(--profile traces a few more frames of each whole-frame stream and of each
tiled stream under each plan, with torch.profiler.)

Phases, one JSON object per line on standard output:

  device   the card's name and power limit as nvidia-smi gives them
  build    nvcc builds the twenty-six sources of turtlevsr_tpu_torch/kernels/csrc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the shapes the 720p serving paths give it (bf16), whole
           padded frames and chunks of 15 tiles alike: errors beside the
           stated tolerance, the kernel's time, the plain
           version's, a PyTorch library call's where one computes the same
           function, and the least time the card could take (bound); the
           two-stage kernel also against the split launches it replaces, the
           sparse softmax also against the probabilities kernel; rows 12 and
           13 on the bodies their plans give each call (sparse_wg.cu, bit
           for bit sab.cu, and chain2_wg.cu; those two, off the paths now,
           at dec3's and enc1's shape); rows 1, 2, 3, 4, 6 and 7 on the body
           their plans give each call (the wgmma bodies of ffn_wg.cu (one
           map, the CHM lists, the chained FFW), ffn_c64.cu (row 1 at C =
           64), ffn_pw.cu (row 2), qkv_wg.cu, split_wg.cu, split_c64.cu (row
           4 at C = 64), chm_wg.cu and sab_wg.cu, also on ragged maps; row
           14's runs on level_wg.cu also against the model's split route,
           split_ms; row 1's
           mma.sync body and level.cu, off the paths now, at dec1's and the
           latent's shape; row 7's
           calls that its plan keeps on sab.cu also on the wgmma body,
           wg_ms; the mma.sync bodies of rows 3, 4, 6 and 7, off the path
           now, at the latent's or dec3's shape); attention @ v also at
           the whole frame's dec3 shape, the 3x3 conv also on maps and Cout
           that its tiles do not divide; then the float32 forms of rows 1,
           3, 4 and 6 at every width of the float32 paths (C = 64-512),
           whole frames and 15 tiles, on their float32 bodies
           (csrc/ffn_f32.cu, qkv_f32.cu, split_f32.cu, chm_f32.cu: the old
           bodies' time on the same inputs beside each, tile_ms, pw1's
           product alone on cuBLAS, pw1_matmul_ms, and each CUDA launch's
           device time at the whole frame, launch_ms), csrc/ffn.cu,
           qkv_stats.cu, split_proj.cu and chm_stats.cu in float32 (forced;
           the LN halo in device memory at C = 512), rows 5
           and 11 on their float32 bodies (csrc/conv_f32.cu: the eight convs
           without LayerNorm at the frame beside F.conv2d, TF32 off, and the
           LayerNorm forms of dec3, dec2, dec1; csrc/attn_v_f32.cu at dec3's,
           dec2's and dec1's whole frame beside torch.matmul; each beside the
           old body's time on the same inputs, tile_ms), conv3x3.cu's and
           attn_v.cu's float tiles (forced), and of rows 14 (level.cu at C =
           256 and 512, also against its split route), 13 (the enc1 and
           enc2 pairs' whole frame, also against its split
           route), against the plain versions in float32 (TF32 off) at the
           card tests' float32 limits, bound by float32 FMA; row 7 in
           float32 at the CHM levels of the padded 720p frame (3680 keys),
           of 15 tiles of 320, of 256 x 256, of 2 x 192 x 192 and of a
           padded 1920x1080 frame (8160 keys) on the body its plan gives
           (csrc/sab_f32.cu from a grid of one block an SM, else sab.cu),
           each also on the other body where sab.cu's block holds the rows
           (its time, bit for bit the same), row 7 in bf16 (sab_wg.cu) and
           rows 8 and 9 (bf16 and float32) at the 1080p frame's three CHM
           levels
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
  app      `turtlevsr_tpu_torch.app.restore_video` for "Video Deblurring
           (GoPro)" as the web app calls it: an mp4 of 4 synthetic 1280x720
           frames (cv2), the shipped option file, reference-format weights
           from the seed as custom_model_path; whole frames (tile 0) and
           tiled (tile 320, the engine's overlap 128: 24 tiles), then
           `restore_image` on one decoded frame. The restored PNGs and the
           launches a frame bit for bit against InferenceEngine on the same
           weights, grid and decoded frames; PSNR against the same app under
           the plain versions; fps (the app's frame loop over all frames)
           and its ms a frame, peak memory, and the frame counts and sizes
           of the four videos (restored, wipe, side by side at double
           width, slider)
  train    `make_train_step` (BPTT over a clip, each frame checkpointed,
           bf16 from float32 masters) at each option file's training recipe
           (batch_size_per_gpu 2, n_sequence 5, gt_size 192, the file's
           AdamW and schedule), seeded weights with the scales drawn,
           synthetic clips: `gopro` four steps (ms per step: median of
           steps 2-4), then one step each of `gopro` under ("two_stage",)
           and under ("channel_runs", "attn_v_merge"), `derain` and `sr`
           (LQ 48 x 48 in, 192 x 192 out). For each: the losses, peak
           memory, the exact launches a step, and the gradient at the
           initial weights of the kernel route against the plain versions'
           in bf16 and float32 on the card (with --profile, one more `gopro`
           step traced); then `gopro` in float32 (compute_dtype float32,
           fuse=()), two steps: the same figures, its first gradient and
           loss held to the float32 plain ones of the `gopro` run (relative
           L2 at most 1e-4, the loss within 1e-5 relative)
  train-cli  `turtlevsr_tpu_torch.cli.train.main` as a user runs it, on a
           copy of options/Turtle_Deblur_Gopro.yml that changes only the
           data folders (one synthetic video each, written from the seed at
           the run's frame size: 8 train and 5 val frames) and three
           frequencies (print 1, save 3, val 3): `--max_iters 6`, then
           `--max_iters 8` (auto-resumed from 6), then `--export_pth`. Holds
           every logged loss finite and every logged lr to the schedule,
           the reference-format files of iterations 3, 6 and 8, the export
           (loads strict, equals net_g_8 bit for bit), the exact launches
           (the steps' and the validated frames'), and the validation PSNR
           within 0.05 dB of the same masters through the plain versions;
           reports each call's iteration and data times (the log's `time
           (data)`), peak memory and seconds, beside the train phase's ms a
           step when that ran
  train-dist  data parallelism on the one card, at the same recipe and on
           the same folders: `torch.distributed.run --nproc_per_node 1` of
           `cli.train.main --launcher pytorch` (NCCL) against `--launcher
           none`, 3 iterations each (one loader thread): the losses, the
           validation, net_g and the training state bit for bit, the time of
           one gradient all-reduce at world size 1; two ranks over gloo (a
           copy of the file with dist_params.backend gloo, batch_size_per_gpu
           1), 3 steps of make_train_step(group=...) on a clip each: the
           masters bit for bit between the ranks, the group's first loss
           against one process's step on both clips, the all-reduce's time,
           each rank's peak memory; the tiled deblur stream with its 45 tiles
           split into 3 shards on the card (InferenceEngine(devices=...))
           against the single-device engine: frames and launches a frame bit
           for bit, ms a frame of each. Each launch of ranks has a time
           limit and its exit code is checked; the ranks report their
           launches (`chip_smoke.py --child KIND OUT ARGS` is such a rank)

  bench    `turtlevsr_tpu_torch.cli.bench.main` as its users call it, on
           the shipped option files and seeded weights: inference of
           `gopro`, `derain` and `sr` at 256 x 256 (SR: the low-resolution
           input, 1024 x 1024 out) and of `gopro` under ("two_stage",), 30
           timed calls after 5: the parameters (the slice phase's count),
           the MACs a frame (`count_macs`, against the counts of the
           model's shapes), fps, the launches a model call (the slice
           phase's), the first call's output against the same call under
           the plain versions on the card (at least 40 dB); a run with
           `--trace_dir` (the trace holds the card's kernels);
           `--train_step` at the GoPro recipe, 2 timed steps after 1 (the
           train phase's launches a step); `--numerics` at 256 x 256 (4
           frames) and tiled at 192 x 192 (tile 128, overlap 64: 2 x 2
           tiles, 3 frames), bf16 on the kernels against float32 on the
           CPU's plain versions, at least 40 dB a frame, into one merged
           artifact in a scratch folder; the traced run's device busy a
           call and idle share

  float32  float32 serving, each path against the same frames through the
           plain versions in float32 on the card (TF32 off): `gopro`
           whole-frame through InferenceEngine(dtype=torch.float32), 4
           frames, then the same under the full plan ("channel_runs",
           "attn_v_merge", "two_stage": level.cu, attn_v.cu and chain2.cu in
           float32), its frames also against `gopro`'s under fuse=();
           `derain` tiled through `cli.infer.main --task derain
           --dtype float32` (24 tiles, 3 frames); `cli.bench.main --dtype
           float32` on `gopro` at 256 x 256 (5 timed calls, the first held
           against the plain versions). Each: ms a frame (a call), PSNR to
           plain (at least 40 dB), peak, the exact launches (rows 1 and 3 on
           their float32 bodies, the others on the widened mma.sync bodies,
           none on a bf16-only body). Alone (--phase float32) it also runs
           the float32 kernel cases

  frame-sizes  frames other than 1280x720: `gopro` whole-frame at
           1920x1080 (padded to 1088 x 1920: 8160 keys at every CHM level)
           in bf16 and in float32 (row 7 on csrc/sab_f32.cu), the deblur
           preset through `cli.infer.main --task deblur` at 1920x1080 (98
           tiles: chunks of 15 and a last one of 8) and the denoise preset
           (`--task denoise`: Turtle_Denoise_Davis.yml, sigma-50 noise) at
           DAVIS's 854x480 (8 tiles, one chunk), 4 frames each: PSNR to the
           plain versions on the card (40 dB in bf16, 80 in float32), the
           exact launches a model call, ms a frame and peak memory, beside
           the card's name and power limit

and, run alone (not part of all; no result line, no ok line):

  level-phases  row 14's Hopper body (csrc/level_wg.cu) with each of its
           phases left out in turn, beside the whole body, its split route
           and that route's two kernels on the same inputs
  two-stage-phases  row 13's Hopper bodies (csrc/chain2_wg.cu) with each of
           their phases left out in turn, beside the whole body, its split
           route and chain2.cu on the same inputs, at 15 tiles

then each phase's seconds and the script's, then, when the kernels, the
slice, the tiled,
the app, the bench, the train, the train-cli, the train-dist, the
float32 and the frame-sizes phase ran,
the line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero; without a CUDA device the script exits 2
before it prints any result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import logging
import os
import re
import shutil
import signal
import socket
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
from turtlevsr_tpu_torch.cli import bench as bench_cli
from turtlevsr_tpu_torch.cli import infer as infer_cli
from turtlevsr_tpu_torch.cli import train as train_cli
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
from turtlevsr_tpu_torch import parallel
from turtlevsr_tpu_torch.train.lr_schedule import build_schedule
from turtlevsr_tpu_torch.train.step import (
    TrainState,
    clip_loss_fn,
    make_optimizer,
    make_train_step,
)
from turtlevsr_tpu_torch.utils.img import img_from_float

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
    # the denoise preset's model (Turtle_t1_arch; MEST and CTS are CHM and
    # FHR), unchanged: the frame-sizes phase streams it at DAVIS's frames
    "denoise": (os.path.join(ROOT, "options", "Turtle_Denoise_Davis.yml"),
                {}),
}
# the command line's task of each configuration streamed tiled
TASKS = {"gopro": "deblur", "derain": "derain", "sr": "sr",
         "denoise": "denoise"}
# exact launches per model call: a CHM block launches each of its kernels
# once (t1: q, k split projection, composite v conv, lattice split,
# probabilities, lattice merge, statistics, FFN; t0: composite v conv,
# lattice split, lattice merge, statistics, FFN); a Channel block the
# statistics and the FFN. Under the fused plan the 33 Channel blocks of the
# four runs (enc3 10, latent 9, dec3 9, dec2 5) are 4 run launches, all on
# csrc/level_wg.cu (kernels/level.py _level_plan; level.cu has none;
# tests/test_torch_port_level_plan.py holds these counts to it), and
# attention @ v with the merge is one launch per CHM block. Under the
# two_stage plan enc1's pair, enc2's three pairs and the refinement's two
# blocks are 6 two-stage launches where the split route makes 12 FFN ones,
# all on csrc/chain2_wg.cu (kernels/chain2.py _two_stage_plan; chain2.cu has
# none; tests/test_torch_port_two_stage_plan.py holds these counts to it).
# The FFN launches at C = 64 (enc1's two ReducedAttn+FFW blocks, dec1's two
# blocks, the refinement's four passes: 8 a model call; under two_stage
# dec1's two) are the C = 64 body's (ffn_c64.cu), every other one with a
# depthwise stage the wgmma body's, the FFW passes without one (enc3 of
# gopro_enc3_ffw) ffn_pw.cu's (kernels/ffn.py _ffn_plan;
# tests/test_torch_port_ffn_plan.py holds these counts to it); ffn.cu has
# none. The split projection's calls at C >= 128 (the latent FHR blocks,
# the SAB q, k at dec3 and dec2) are split_wg.cu's, dec1's SAB q, k
# split_c64.cu's (_split_plan; tests/test_torch_port_split_sab_plan.py);
# split_proj.cu has none.
_NONE = {"attn_v_slots": 0, "attn_v_merge": 0, "level_run": 0, "level_wg": 0,
         "ffn_no_dw": 0, "sab_f32": 0, "ffn_f32": 0, "qkv_f32": 0,
         "conv3x3_f32": 0, "attn_v_f32": 0, "split_f32": 0, "chm_f32": 0,
         "ffn_pw": 0, "two_stage": 0, "two_stage_wg": 0,
         "sab_sparse_softmax": 0, "sparse_wg": 0}
_GOPRO = {"ffn": 51, "ffn_wg": 43, "ffn_c64": 8, "qkv_stats": 34,
          "qkv_wg": 34,
          "split_proj": 5, "split_wg": 4, "split_c64": 1, "conv3x3": 11,
          "chm_stats": 3, "chm_wg": 3, "sab": 3, "sab_wg": 3,
          "lattice_merge": 3, "lattice_split": 3}
_DERAIN = {**_GOPRO, "split_proj": 2, "split_wg": 2, "split_c64": 0,
           "sab": 0, "sab_wg": 0}
_TWO_STAGE = {"ffn": 39, "ffn_wg": 37, "ffn_c64": 2, "two_stage": 6,
              "two_stage_wg": 6}
LAUNCHES_PER_CALL = {
    "gopro": {**_GOPRO, **_NONE},
    "gopro_t1_fhr": {"ffn": 51, "ffn_wg": 43, "ffn_c64": 8, "qkv_stats": 37,
                     "qkv_wg": 37,
                     "split_proj": 2, "split_wg": 2, "split_c64": 0,
                     "conv3x3": 8, "chm_stats": 0, "chm_wg": 0, "sab": 0,
                     "sab_wg": 0,
                     "lattice_merge": 0, "lattice_split": 0, **_NONE},
    "gopro_enc3_ffw": {**_GOPRO, **_NONE, "ffn_no_dw": 10, "ffn_pw": 10,
                       "ffn_wg": 33},
    "gopro_fused": {**_GOPRO, **_NONE, "ffn": 18, "ffn_wg": 10, "qkv_stats": 1,
                    "qkv_wg": 1,
                    "lattice_merge": 0, "attn_v_merge": 3, "level_run": 4,
                    "level_wg": 4},
    "gopro_two_stage": {**_GOPRO, **_NONE, **_TWO_STAGE},
    "derain": {**_DERAIN, **_NONE},
    "derain_two_stage": {**_DERAIN, **_NONE, **_TWO_STAGE},
    "sr": {**_GOPRO, **_NONE},
    "sr_two_stage": {**_GOPRO, **_NONE, **_TWO_STAGE},
}
# float32 serving (InferenceEngine(dtype=torch.float32), --dtype float32):
# the same calls a model call, every one of rows 1, 3, 4, 5 and 6 on its
# float32 body (csrc/ffn_f32.cu, qkv_f32.cu, split_f32.cu, conv_f32.cu,
# chm_f32.cu: kernels/ffn.py _ffn_plan, _qkv_plan, _split_plan, _conv_plan,
# _chm_plan), under the full plan row 11 on csrc/attn_v_f32.cu
# (kernels/sab.py _attn_v_plan), row 7 on csrc/sab_f32.cu at a whole frame
# (its grid of at least one block an SM; kernels/sab.py _sab_plan) and on
# sab.cu at the harness's 256 x 256 and the train step's 192 x 192 (`_small`:
# at most 24 blocks), and under the fused plans row 14 on level.cu (widened
# to C = 256 and 512) and row 13 on chain2.cu: the Hopper bodies take bf16
# only
BF16_ONLY = ("ffn_wg", "ffn_c64", "ffn_pw", "qkv_wg", "chm_wg", "split_wg",
             "split_c64", "sab_wg", "level_wg", "two_stage_wg")
# every fused plan at once: the runs (row 14), attention @ v with the merge
# (row 11) and the conv-only levels' two stages (row 13). On `gopro` the 33
# Channel blocks' statistics and FFN launches are 4 runs, the 12 FFN launches
# of the conv-only levels 6 two-stage ones, the 3 lattice merges are in
# attention @ v
FULL_PLAN = ("channel_runs", "attn_v_merge", "two_stage")
LAUNCHES_PER_CALL_F32 = {
    config: {**LAUNCHES_PER_CALL[config], **dict.fromkeys(BF16_ONLY, 0),
             "ffn_f32": LAUNCHES_PER_CALL[config]["ffn"],
             "qkv_f32": LAUNCHES_PER_CALL[config]["qkv_stats"],
             "conv3x3_f32": LAUNCHES_PER_CALL[config]["conv3x3"],
             "split_f32": LAUNCHES_PER_CALL[config]["split_proj"],
             "chm_f32": LAUNCHES_PER_CALL[config]["chm_stats"]}
    for config in ("gopro", "derain")}
LAUNCHES_PER_CALL_F32["gopro_small"] = dict(LAUNCHES_PER_CALL_F32["gopro"])
LAUNCHES_PER_CALL_F32["gopro"]["sab_f32"] = 3
LAUNCHES_PER_CALL_F32["gopro_fused"] = {
    **LAUNCHES_PER_CALL_F32["gopro"], "ffn": 6, "qkv_stats": 1, "ffn_f32": 6,
    "qkv_f32": 1,
    "level_run": 4, "attn_v_merge": 3, "attn_v_f32": 3, "lattice_merge": 0,
    "two_stage": 6}
# the float32 paths: `gopro` whole-frame (4 frames: the 3-frame rings
# wrap), the same under the full plan, `derain` tiled through cli.infer.main
# at its preset (24 tiles, 3 frames), cli.bench.main --dtype float32 at 256
# x 256, the train step in float32 at the GoPro recipe (2 steps)
F32_PATHS = ("gopro_f32", "gopro_f32_fused", "derain_tiled_f32",
             "bench_gopro_f32", "train_gopro_f32", "gopro_f32_1080")
F32_FRAMES = {"gopro_f32": 4, "gopro_f32_fused": 4, "derain_tiled_f32": 3}
TRAIN_F32_STEPS = 2
BENCH_F32_ITERS = 5
# tiled `gopro`: dec1's probabilities on 20 x 20 tokens stay on sab.cu
# (kernels/sab.py _sab_plan), whole frames take the wgmma body
TILED_LAUNCHES = {"gopro": {"sab_wg": 2}}
# the frame-sizes phase: frames other than 1280x720, each path (config,
# mode, type, (width, height), frames; 4 frames wrap the 3-frame rings):
# GoPro's full 1920x1080 frames (the model pads them to 1088 x 1920: 68 x
# 120 window tokens, 8160 keys, at every CHM level) whole-frame in bf16
# (row 7 on sab_wg.cu) and in float32 (row 7 on csrc/sab_f32.cu), tiled at
# the deblur preset (98 tiles of 320 / 192: six chunks of 15 and one of 8),
# and the denoise preset (Turtle_Denoise_Davis.yml, sigma-50 noise from the
# preset) at DAVIS's 854x480 frames (reflect-padded to 856: 8 tiles of 320
# / 128, one chunk)
SIZE_1080, SIZE_DAVIS = (1920, 1080), (854, 480)
FRAME_SIZE_PATHS = {
    "gopro_1080": ("gopro", "whole", torch.bfloat16, SIZE_1080, 4),
    "gopro_f32_1080": ("gopro", "whole", torch.float32, SIZE_1080, 4),
    "deblur_tiled_1080": ("gopro", "tiled", torch.bfloat16, SIZE_1080, 4),
    "denoise_tiled_480": ("denoise", "tiled", torch.bfloat16, SIZE_DAVIS, 4),
}
# their exact launches a model call, which tests/test_torch_port_frame_sizes.py
# derives from the plans: whole frames as at 720p (float32: row 7 on
# sab_f32.cu at every CHM level, where sab.cu's block cannot hold the rows),
# the tiles of 320 as at 720p (dec1's row 7 on sab.cu) whatever the chunk
LAUNCHES_FRAME_SIZES = {
    "gopro_1080": LAUNCHES_PER_CALL["gopro"],
    "gopro_f32_1080": LAUNCHES_PER_CALL_F32["gopro"],
    "deblur_tiled_1080": {**LAUNCHES_PER_CALL["gopro"], "sab_wg": 2},
    "denoise_tiled_480": {**LAUNCHES_PER_CALL["gopro"], "sab_wg": 2},
}
FRAMES_PER_RUN = 4  # whole-frame and tiled streams: the 3-frame rings wrap
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

# the train phase: (configuration, fused plan, steps) at the training
# recipe of each option file (datasets.train: batch_size_per_gpu 2, gt_size
# 192; n_sequence 5; the file's AdamW and schedule); the first run is the
# main one (a warm-up step, then the timed ones), the others one step each
TRAIN_RUNS = (("gopro", (), 4), ("gopro", TWO_STAGE, 1),
              ("gopro", FUSED_PLAN, 1), ("derain", (), 1), ("sr", (), 1))
# the train-cli phase: turtlevsr_tpu_torch.cli.train.main on a copy of the
# GoPro option file that changes only the data folders and these keys (the
# frequencies, so that a short run logs, saves and validates); frames of the
# synthetic train and val folders (one video each, the frame size of the
# run); the calls: (max_iters, whether it resumes), then --export_pth
TRAIN_CLI_KEYS = {("logger", "print_freq"): 1,
                  ("logger", "save_checkpoint_freq"): 3,
                  ("val", "val_freq"): 3}
TRAIN_CLI_FRAMES = {"train": 8, "val": 5}
TRAIN_CLI_CALLS = ((6, False), (8, True))
# the validation PSNR of the kernel route against the plain versions', the
# same masters (dB): bf16 roundings in another order through 41 blocks, on
# pictures of about 20 dB
TRAIN_CLI_PSNR_TOL = 0.05
# the train-dist phase: the iterations of each child run; the shards of the
# tiled deblur grid split over the card (45 tiles: three shards of 15, the
# single-device engine's three chunks of 15); a child launch's limit in
# seconds (it is killed, and the phase fails, past it)
TRAIN_DIST_ITERS = 3
SPLIT_SHARDS = 3
CHILD_SECONDS = 420
# the app phase: frames of the synthetic mp4; the tile of its tiled run (the
# engine's overlap 128: 24 tiles of a 1280x720 frame, two model calls)
APP_FRAMES = 4
APP_TILE = 320
# the bench phase: turtlevsr_tpu_torch.cli.bench.main as its users call it,
# at the reference harness's input of 256 x 256 (the SR model's
# low-resolution input: 1024 x 1024 out), BENCH_ITERS timed calls after the
# default 5 (the harness's default is 100: cut for the script's time); the
# train step timed over this many steps after one warm-up step; the tiled
# numerics' frame side, tile and overlap (2 x 2 tiles of 128, so that the
# overlap-add is covered, two model calls a frame in chunks of 3; their
# float32 plain versions run on the host's CPU, which 2 x 2 tiles of 320
# kept busy for some 100 s); the traced run's timed calls
BENCH_SIZE = 256
BENCH_RUNS = (("gopro", ()), ("derain", ()), ("sr", ()), ("gopro", TWO_STAGE))
# the MACs of one call at BENCH_SIZE, as the model's shapes gave them block
# by block when the harness was ported (tests/test_torch_port_bench.py holds
# gopro's on the CPU)
BENCH_MACS = {"gopro": 201_636_184_064, "derain": 190_003_281_920,
              "sr": 4_823_780_163_584}
BENCH_ITERS = 30
BENCH_TRAIN_ITERS = 2
BENCH_TILED = (192, 128, 64)
BENCH_TRACE_ITERS = 5
# two ranks of one clip each against one process's step on both clips (the
# first step, from the same masters): the same bf16 kernels on each clip;
# the loss's float32 means, and the backward's reductions over the batch,
# in another order. Relative, on the group's mean loss
TRAIN_DIST_LOSS_REL_TOL = 1e-3
# the gradient of the kernel route (bf16, kernels forward) against float32
# plain versions may be at most this factor of the bf16 plain route's error
# plus this slack (relative, L2 over every parameter): top-5 ties in bf16
# may select other keys in the kernel than in the plain version, so the
# two bf16 routes are each held to the float32 one, not to each other
GRAD_REL_FACTOR, GRAD_REL_SLACK = 1.5, 1e-3
# the float32 step (kernels forward in float32) against the float32 plain
# versions: float32 sums in another order; the limits of the card test of
# the tiny float32 step (tests/test_torch_port_cuda.py), relative L2 over
# every parameter, and the loss relative
TRAIN_F32_GRAD_REL_TOL, TRAIN_F32_LOSS_REL_TOL = 1e-4, 1e-5

# published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# tensor-core rate of its type (bf16)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores (FMA)

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
# float32 unit vectors: a support flips only where two scores of a row's
# fifth and sixth place lie within a float32 rounding of each other (the
# card tests' limit)
SAB_F32_FLIP_SHARE = 0.02
# float32 (the kernels' FMA in full fp32, the plain versions' products
# with TF32 off): fp32 sums in another order, values to ~10; the absolute
# limit of tests/test_torch_port_cuda.py (KERNEL_TOL), the Grams and norms
# divided by their pixels as there
F32_KERNEL_TOL = 3e-5
# float32: a run of N blocks against the split kernels whose float32 tile
# code it runs (only the softmax's exp and divide differ), a limit a block;
# attention @ v against its plain version (absolute); the limits of the card
# tests (tests/test_torch_port_cuda.py)
F32_RUN_SPLIT_TOL = 1e-5
F32_ATTN_V_TOL = 1e-5
# the slice: 41 blocks deep, rounding flips feed forward through every later
# block; PSNR of the kernel path against the plain path on the card, on
# pictures in [0, 1]
SLICE_MIN_PSNR = 40.0
# float32 paths of the frame-sizes phase: the float32 kernels against the
# float32 plain versions (TF32 off), sums in another order (the 720p
# float32 paths read 95.8-144.1 dB)
F32_MIN_PSNR = 80.0
# attention @ v: fp32 sums of exact products in another order, one rounding
ATTN_V_REL_TOL = 2.0 ** -7
# a run of N blocks against its plain version: a flip of one block feeds the
# next (KERNEL_REL_TOL a block); against the split kernels whose device code
# and rounding points it shares (row 3 on qkv_stats.cu, whose tile code
# level.cu runs), only the exp and the divide of the small softmax differ:
# one limit whatever the length of the run. Against the split route the
# model takes (row 3 on the wgmma body, whose Grams sum in another order) a
# run is held to its plain version's limit. level_wg.cu runs that route's
# bodies on the same partition, so it is held to the one limit against that
# route (the softmax's exp and divide and the sum order of po' differ) and
# to the plain limit against the route on qkv_stats.cu.
RUN_SPLIT_REL_TOL = 2.0 ** -7
# two chained stages against their plain version: KERNEL_REL_TOL a stage
TWO_STAGE_REL_TOL = 2 * KERNEL_REL_TOL
# the sparse softmax on given scores: both versions keep the same entries;
# the values differ by the fp32 sum order and expf, one bf16 rounding of
# values <= 1
SPARSE_TOL = 2.0 ** -7

KERNEL_INFO = {
    # row 1 has three bodies chosen by shape (kernels/ffn.py _ffn_plan): the
    # wgmma body takes the depthwise calls at C >= 128 (single maps, the CHM
    # lists, the chained FFW), the C = 64 body those at C = 64, ffn.cu the
    # rest; "ffn" launches are those of ffn.cu's dw branch
    "ffn": ("turtlevsr_tpu_torch/kernels/csrc/ffn.cu",
            "turtlevsr_tpu/kernels/ffn.py:2024"),
    "ffn_wg": ("turtlevsr_tpu_torch/kernels/csrc/ffn_wg.cu",
               "turtlevsr_tpu/kernels/ffn.py:2024"),
    "ffn_c64": ("turtlevsr_tpu_torch/kernels/csrc/ffn_c64.cu",
                "turtlevsr_tpu/kernels/ffn.py:2024"),
    # row 2, the branch without a depthwise stage: ffn_pw.cu takes its bf16
    # pointwise FFW at C = 128, 256 (every call of the paths), ffn.cu the
    # rest; "ffn_no_dw" launches are those of ffn.cu's branch
    "ffn_pw": ("turtlevsr_tpu_torch/kernels/csrc/ffn_pw.cu",
               "turtlevsr_tpu/kernels/ffn.py:1843"),
    # rows 3 and 6 have two bodies each, chosen by shape (kernels/ffn.py
    # _qkv_plan, _chm_plan): the wgmma bodies of qkv_wg.cu and chm_wg.cu
    # (stats_wg.cuh) take the bf16 calls with 64 channels a head, every call
    # of the paths; qkv_stats.cu and chm_stats.cu the rest (float32, biases,
    # other head widths); "qkv_stats" and "chm_stats" launches are those of
    # the mma.sync bodies
    "qkv_stats": ("turtlevsr_tpu_torch/kernels/csrc/qkv_stats.cu",
                  "turtlevsr_tpu/kernels/ffn.py:985"),
    "qkv_wg": ("turtlevsr_tpu_torch/kernels/csrc/qkv_wg.cu",
               "turtlevsr_tpu/kernels/ffn.py:985"),
    # rows 4 and 7 likewise (kernels/ffn.py _split_plan, kernels/sab.py
    # _sab_plan): the wgmma bodies of split_wg.cu and sab_wg.cu take the
    # bf16 calls of the paths, split_proj.cu and sab.cu the rest; "split_proj"
    # and "sab" launches are those of the mma.sync bodies
    "split_proj": ("turtlevsr_tpu_torch/kernels/csrc/split_proj.cu",
                   "turtlevsr_tpu/kernels/ffn.py:1732"),
    "split_wg": ("turtlevsr_tpu_torch/kernels/csrc/split_wg.cu",
                 "turtlevsr_tpu/kernels/ffn.py:1732"),
    # row 4 at C = 64 (dec1's SAB q, k) on a body of its own
    "split_c64": ("turtlevsr_tpu_torch/kernels/csrc/split_c64.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1732"),
    "conv3x3": ("turtlevsr_tpu_torch/kernels/csrc/conv3x3.cu",
                "turtlevsr_tpu/kernels/ffn.py:1622"),
    "chm_stats": ("turtlevsr_tpu_torch/kernels/csrc/chm_stats.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1267"),
    "chm_wg": ("turtlevsr_tpu_torch/kernels/csrc/chm_wg.cu",
               "turtlevsr_tpu/kernels/ffn.py:1267"),
    "sab": ("turtlevsr_tpu_torch/kernels/csrc/sab.cu",
            "turtlevsr_tpu/kernels/sab.py:138"),
    "sab_wg": ("turtlevsr_tpu_torch/kernels/csrc/sab_wg.cu",
               "turtlevsr_tpu/kernels/sab.py:138"),
    # row 7 in float32 on its body of csrc/sab_f32.cu (the float32 calls
    # whose row buffer sab.cu's block cannot hold: every CHM level of a
    # padded 1920x1080 frame); its launches are those of the float32 paths
    "sab_f32": ("turtlevsr_tpu_torch/kernels/csrc/sab_f32.cu",
                "turtlevsr_tpu/kernels/sab.py:138"),
    "lattice_merge": ("turtlevsr_tpu_torch/kernels/csrc/lattice.cu",
                      "turtlevsr_tpu/kernels/lattice.py:59"),
    "lattice_split": ("turtlevsr_tpu_torch/kernels/csrc/lattice.cu",
                      "turtlevsr_tpu/kernels/lattice.py:79"),
    # the FFN kernel's branch without a depthwise stage (wd absent) on ffn.cu
    "ffn_no_dw": ("turtlevsr_tpu_torch/kernels/csrc/ffn.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1843"),
    # one kernel with two epilogues and a wrapper for each (the model calls
    # sab_attn_v_merge, turtlevsr_tpu/kernels/sab.py:282, which reaches the
    # same pallas_call there): its launches are those of both wrappers
    "attn_v": ("turtlevsr_tpu_torch/kernels/csrc/attn_v.cu",
               "turtlevsr_tpu/kernels/sab.py:223"),
    # row 14 has two bodies chosen by shape (kernels/level.py _level_plan):
    # level_wg.cu takes the bf16 runs with 64 channels a head at C = 128,
    # 256, 512 (every run of the paths), level.cu the rest; "level_run"
    # launches are those of level.cu
    "level_run": ("turtlevsr_tpu_torch/kernels/csrc/level.cu",
                  "turtlevsr_tpu/kernels/level.py:315"),
    "level_wg": ("turtlevsr_tpu_torch/kernels/csrc/level_wg.cu",
                 "turtlevsr_tpu/kernels/level.py:315"),
    # rows 13 and 12 have two bodies each, chosen by shape
    # (kernels/chain2.py _two_stage_plan, kernels/sab.py _sparse_plan):
    # chain2_wg.cu takes the bf16 forms of the conv-only levels (every call
    # of the paths), sparse_wg.cu the bf16 rows of a multiple of 8 keys;
    # chain2.cu and sab.cu the rest; "two_stage" and "sab_sparse_softmax"
    # launches are those of chain2.cu and sab.cu
    "two_stage": ("turtlevsr_tpu_torch/kernels/csrc/chain2.cu",
                  "turtlevsr_tpu/kernels/chain2.py:308"),
    "two_stage_wg": ("turtlevsr_tpu_torch/kernels/csrc/chain2_wg.cu",
                     "turtlevsr_tpu/kernels/chain2.py:308"),
    "sab_sparse_softmax": ("turtlevsr_tpu_torch/kernels/csrc/sab.cu",
                           "turtlevsr_tpu/kernels/sab.py:328"),
    "sparse_wg": ("turtlevsr_tpu_torch/kernels/csrc/sparse_wg.cu",
                  "turtlevsr_tpu/kernels/sab.py:328"),
    # rows 1 and 3 in float32 on their float32 bodies (register-blocked
    # products on the CUDA cores, csrc/f32_tile.cuh): every float32 call of
    # the paths (kernels/ffn.py _ffn_plan, _qkv_plan)
    "ffn_f32": ("turtlevsr_tpu_torch/kernels/csrc/ffn_f32.cu",
                "turtlevsr_tpu/kernels/ffn.py:2024"),
    "qkv_f32": ("turtlevsr_tpu_torch/kernels/csrc/qkv_f32.cu",
                "turtlevsr_tpu/kernels/ffn.py:985"),
    # rows 5 and 11 in float32 on their float32 bodies (csrc/f32_tile.cuh's
    # hooked product: the conv as an implicit GEMM, attention @ v with the
    # merge as its store): every float32 call of the paths (kernels/ffn.py
    # _conv_plan, kernels/sab.py _attn_v_plan)
    "conv3x3_f32": ("turtlevsr_tpu_torch/kernels/csrc/conv_f32.cu",
                    "turtlevsr_tpu/kernels/ffn.py:1622"),
    "attn_v_f32": ("turtlevsr_tpu_torch/kernels/csrc/attn_v_f32.cu",
                   "turtlevsr_tpu/kernels/sab.py:223"),
    # rows 4 and 6 in float32 on their float32 bodies (f32_tile.cuh's product
    # into hidden maps, then the taps; row 6 with row 3's Gram pass,
    # csrc/gram_f32.cuh): every float32 call of the paths (kernels/ffn.py
    # _split_plan, _chm_plan)
    "split_f32": ("turtlevsr_tpu_torch/kernels/csrc/split_f32.cu",
                  "turtlevsr_tpu/kernels/ffn.py:1732"),
    "chm_f32": ("turtlevsr_tpu_torch/kernels/csrc/chm_f32.cu",
                "turtlevsr_tpu/kernels/ffn.py:1267"),
    # the float32 forms of rows 1, 3, 4, 5 and 6 on their mma.sync bodies,
    # widened to C = 256 and 512 for float32 serving (off the paths now:
    # their cases force the old body); their launches are those of the
    # float32 paths (F32_PATHS), which the rows above do not count
    "ffn_tile_f32": ("turtlevsr_tpu_torch/kernels/csrc/ffn.cu",
                     "turtlevsr_tpu/kernels/ffn.py:2024"),
    "qkv_stats_f32": ("turtlevsr_tpu_torch/kernels/csrc/qkv_stats.cu",
                      "turtlevsr_tpu/kernels/ffn.py:985"),
    "split_proj_f32": ("turtlevsr_tpu_torch/kernels/csrc/split_proj.cu",
                       "turtlevsr_tpu/kernels/ffn.py:1732"),
    "conv3x3_tile_f32": ("turtlevsr_tpu_torch/kernels/csrc/conv3x3.cu",
                         "turtlevsr_tpu/kernels/ffn.py:1622"),
    "chm_stats_f32": ("turtlevsr_tpu_torch/kernels/csrc/chm_stats.cu",
                      "turtlevsr_tpu/kernels/ffn.py:1267"),
    # rows 14, 11 and 13 in float32 (under the fused plans), on level.cu
    # (widened to C = 256 and 512), attn_v.cu's float tile (off the paths
    # now: its case forces it) and chain2.cu
    "level_run_f32": ("turtlevsr_tpu_torch/kernels/csrc/level.cu",
                      "turtlevsr_tpu/kernels/level.py:315"),
    "attn_v_tile_f32": ("turtlevsr_tpu_torch/kernels/csrc/attn_v.cu",
                        "turtlevsr_tpu/kernels/sab.py:223"),
    "two_stage_f32": ("turtlevsr_tpu_torch/kernels/csrc/chain2.cu",
                      "turtlevsr_tpu/kernels/chain2.py:308"),
}


class SmokeFailure(Exception):
    pass


# --cases: only the kernel cases whose "<kernel>: <case>" holds one of these
CASE_FILTER: tuple = ("",)


def skipped(kernel: str, name: str) -> bool:
    return not any(text in f"{kernel}: {name}" for text in CASE_FILTER)


def emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj


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


def timed_in(body, fn, iters: int) -> float:
    """cuda_ms of fn inside the context `body()` makes (a forced body)."""
    with body():
        return cuda_ms(fn, iters)


def launch_ms(fn, calls: int = 2) -> dict:
    """Device ms a call of each CUDA kernel that fn launches (torch.profiler,
    CUDA activity; the name up to its arguments): where a float32 body's
    time goes."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.split("(")[0].replace("void ", "").replace(
                "turtle::", "")
            out[name] = out.get(name, 0.0) + e.device_time_total / calls / 1e3
    return out


def bound(n_bytes: float, flops: float, dtype=torch.bfloat16
          ) -> tuple[float, str]:
    """The least time: bytes over the memory rate against operations over
    the rate of the type's units (bf16 tensor cores; float32 on the CUDA
    cores, where the float32 bodies run their FMA)."""
    rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def f32_kernel(kernel: str, x: torch.Tensor) -> str:
    """The kernels line's row of a case: the float32 calls of the widened
    bodies have rows of their own."""
    return kernel + "_f32" if x.dtype == torch.float32 else kernel


def within(err: float, rel: float, x: torch.Tensor, tol_rel: float) -> bool:
    """bf16: relative to the largest output; float32: the card tests'
    absolute limit (sums normalised by the pixels, as they are there)."""
    return err <= F32_KERNEL_TOL if x.dtype == torch.float32 else (
        rel <= tol_rel)


class Inputs:
    """Seeded normal inputs, drawn on the card (the cases at 15 tiles hold
    some 10^10 values in all) and rounded to bf16 (or kept in float32)."""

    def __init__(self, seed: int, dtype: torch.dtype = torch.bfloat16):
        self.rng = np.random.RandomState(seed)  # the integer inputs
        self.gen = torch.Generator("cuda").manual_seed(seed)
        self.dtype = dtype

    def __call__(self, *shape, scale: float = 1.0) -> torch.Tensor:
        a = torch.randn(*shape, device="cuda", generator=self.gen)
        return (a * scale).to(self.dtype)


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


OLD_PLAN = ("tile", None)  # the FFN and split plans' answer: the old body


@contextlib.contextmanager
def forced_body(mod, plan: str, answer):
    """mod.<plan> answers `answer` whatever the shape: rows 1, 4 and 7 on
    one body, the yardstick of the other on the same inputs, here only."""
    saved = getattr(mod, plan)
    setattr(mod, plan, lambda *a, **kw: answer)
    try:
        yield
    finally:
        setattr(mod, plan, saved)


def ffn_case(inp: Inputs, name, h, w, c, e, mode, *, pair=False, po=False,
             biases=False, scale=False, ffw2=False, dw=True, iters=5,
             stacked=0, batch=1, shared_po=False, tile=False):
    """Row 1 (or 2, without dw) on the body its plan gives the call (tile: on
    the mma.sync body): kernel "ffn_wg" for the wgmma body, "ffn_c64" for
    the C = 64 body, "ffn_pw" for row 2's body, "ffn_f32" for the float32
    body of csrc/ffn_f32.cu (csrc/ffn.cu's time on the same inputs beside it,
    tile_ms), else "ffn" / "ffn_no_dw" ("ffn_tile_f32": csrc/ffn.cu in
    float32)."""
    if skipped(("ffn_tile_f32" if tile else "ffn_f32")
               if inp.dtype == torch.float32 else "ffn", name):
        return None
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
        kw["po_w"] = inp(*(() if shared_po else (batch,)), c, c,
                         scale=c ** -0.5)
        if biases:
            kw["po_b"] = inp(c, scale=0.2)
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
    body = ((lambda: forced_body(K, "_ffn_plan", OLD_PLAN)) if tile
            else contextlib.nullcontext)
    wg_before = K.fused_block_ffn.launches_wg
    c64_before = K.fused_block_ffn.launches_c64
    pw_before = K.fused_block_ffn.launches_pw
    f32_before = K.fused_block_ffn.launches_f32
    with body():
        got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    on_wg = K.fused_block_ffn.launches_wg > wg_before
    on_c64 = K.fused_block_ffn.launches_c64 > c64_before
    on_pw = K.fused_block_ffn.launches_pw > pw_before
    on_f32 = K.fused_block_ffn.launches_f32 > f32_before
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
    b_ms, b_by = bound(n_bytes, flops, x.dtype)
    with body():
        ms = cuda_ms(lambda: K.fused_block_ffn(x, **kw), iters)
    tile_ms = None  # the float32 body's case: csrc/ffn.cu once beside it
    if on_f32 and (c <= 256 or n_maps <= 1):
        tile_ms = timed_in(lambda: forced_body(K, "_ffn_plan", OLD_PLAN),
                           lambda: K.fused_block_ffn(x, **kw), 2)
    launches = matmul_ms = None
    if on_f32 and batch == 1:  # where the time goes; pw1's shape on cuBLAS
        launches = launch_ms(lambda: K.fused_block_ffn(x, **kw))
        a2, w1 = x.reshape(-1, c), kw["w1"]
        matmul_ms = cuda_ms(lambda: torch.matmul(a2, w1), iters)
    kernel = ("ffn_wg" if on_wg else "ffn_c64" if on_c64 else "ffn_pw"
              if on_pw else "ffn_f32" if on_f32 else "ffn_tile_f32"
              if x.dtype == torch.float32 else "ffn" if dw else "ffn_no_dw")
    return dict(kernel=kernel,
                case=name, shape=[batch, h, w, c], hidden=ch,
                body="wg" if on_wg else "c64" if on_c64 else "pw" if on_pw
                else "f32" if on_f32 else "tile", tile_ms=tile_ms,
                launch_ms=launches, pw1_matmul_ms=matmul_ms,
                dtype=str(x.dtype), max_abs_err=err, rel_err=rel,
                tol_rel=KERNEL_REL_TOL, tol_abs_f32=F32_KERNEL_TOL,
                ok=(within(err, rel, x, KERNEL_REL_TOL)
                    and bool(torch.isfinite(got.float()).all())),
                ms=ms,
                plain_ms=cuda_ms(lambda: K.ffn_plain(x, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def chain_weights(inp: Inputs, c, ch):
    return dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
                w1=inp(c, ch, scale=c ** -0.5), wd=inp(3, 3, ch, scale=0.3))


@contextlib.contextmanager
def stats_widths(qkv: tuple, chm: tuple):
    """The widths the statistics' plans send to the wgmma body, here only:
    () to time the mma.sync bodies on the same inputs."""
    saved = K._QKV_WG_WIDTHS, K._CHM_WG_WIDTHS
    K._QKV_WG_WIDTHS, K._CHM_WG_WIDTHS = qkv, chm
    try:
        yield
    finally:
        K._QKV_WG_WIDTHS, K._CHM_WG_WIDTHS = saved


def partial_row_bytes(batch, h, w, c, heads, nf, body):
    """Bytes of the fp32 partial rows a call writes: one a tile (mma.sync
    bodies), the persistent grid's rows (wgmma bodies), or the float32
    body's G rows a batch entry."""
    ctok = c // heads
    width = (nf + 1) * heads * ctok * ctok + (nf + 2) * c
    if body == "f32":
        n_sm = K._sm_count(torch.device("cuda", 0))
        rows = (K._chm_f32_geometry(batch, h, w, c, heads, nf, n_sm)["rows"]
                if nf else K._qkv_f32_grid(batch, h, w, heads, n_sm))
        return batch * rows * width * 4
    rows = K._tiles(h, w) if body == "tile" else K._sw_rows(
        batch, K._tiles(h, w), min(batch * K._tiles(h, w),
                                   K._sm_count(torch.device("cuda", 0))))
    return batch * rows * width * 4


def qkv_case(inp: Inputs, name, h, w, c, heads, iters=5, batch=1,
             tile=False):
    """Row 3 on the body its plan gives the call (tile: on the mma.sync
    body): kernel "qkv_wg" for the wgmma body, "qkv_f32" for the float32
    body of csrc/qkv_f32.cu (csrc/qkv_stats.cu's time on the same inputs
    beside it, tile_ms), else "qkv_stats" ("qkv_stats_f32": csrc/qkv_stats.cu
    in float32)."""
    f32 = inp.dtype == torch.float32
    kernel = (("qkv_stats_f32" if tile or not K._qkv_f32_form(c, heads)
               else "qkv_f32") if f32 else "qkv_stats"
              if tile or c not in K._QKV_WG_WIDTHS else "qkv_wg")
    if skipped(kernel, name):
        return None
    x = inp(batch, h, w, c)
    kw = chain_weights(inp, c, 3 * c)
    widths = () if tile else K._QKV_WG_WIDTHS
    body = ((lambda: forced_body(K, "_qkv_plan", OLD_PLAN)) if tile and f32
            else contextlib.nullcontext)
    wg_before = K.fused_qkv_stats.launches_wg
    f32_before = K.fused_qkv_stats.launches_f32
    with stats_widths(widths, K._CHM_WG_WIDTHS), body():
        v, g, s = K.fused_qkv_stats(x, heads=heads, **kw)
        torch.cuda.synchronize()
        on_wg = K.fused_qkv_stats.launches_wg > wg_before
        on_f32 = K.fused_qkv_stats.launches_f32 > f32_before
        ms = cuda_ms(lambda: K.fused_qkv_stats(x, heads=heads, **kw), iters)
    require(on_wg == (kernel == "qkv_wg") and on_f32 == (kernel == "qkv_f32"),
            f"qkv_stats {name}: body")
    tile_ms = None  # the float32 body's case: qkv_stats.cu once beside it
    if on_f32:
        tile_ms = timed_in(lambda: forced_body(K, "_qkv_plan", OLD_PLAN),
                           lambda: K.fused_qkv_stats(x, heads=heads, **kw), 2)
    launches = matmul_ms = None
    if on_f32 and batch == 1:  # where the time goes; pw1's shape on cuBLAS
        launches = launch_ms(lambda: K.fused_qkv_stats(x, heads=heads, **kw))
        a2, w1 = x.reshape(-1, c), kw["w1"]
        matmul_ms = cuda_ms(lambda: torch.matmul(a2, w1), iters)
    wv, wg, ws = K.qkv_stats_plain(x, heads=heads, **kw)
    err_v, rel_v = rel_err(v, wv)
    err_g, rel_g = rel_err(g, wg)
    err_s, rel_s = rel_err(s, ws)
    # per pixel: pw1 C x 3C, nine taps on 3C channels, the per-head diagonal
    # blocks of the Gram (heads x ctok x ctok = C x ctok), the two norms
    px, ctok = h * w, c // heads
    flops = 2.0 * batch * px * (c * 3 * c + 9 * 3 * c + c * ctok + 2 * c)
    b_ms, b_by = bound(numel_bytes(x, v, g, s, *kw.values()), flops,
                       x.dtype)
    body = "wg" if on_wg else "f32" if on_f32 else "tile"
    err = max(err_v, err_g / px, err_s / px)
    return dict(kernel=kernel, case=name, shape=[batch, h, w, c],
                heads=heads, max_abs_err=err, dtype=str(x.dtype),
                tile_ms=tile_ms, launch_ms=launches,
                pw1_matmul_ms=matmul_ms,
                rel_err=rel_v, rel_err_gram=rel_g, rel_err_norms=rel_s,
                tol_rel=KERNEL_REL_TOL, tol_rel_stats=STATS_REL_TOL,
                tol_abs_f32=F32_KERNEL_TOL,
                ok=(err <= F32_KERNEL_TOL if x.dtype == torch.float32 else
                    rel_v <= KERNEL_REL_TOL and rel_g <= STATS_REL_TOL
                    and rel_s <= STATS_REL_TOL),
                body=body,
                partial_row_bytes=partial_row_bytes(batch, h, w, c, heads, 0,
                                                    body),
                tile_partial_row_bytes=partial_row_bytes(batch, h, w, c,
                                                         heads, 0, "tile"),
                ms=ms,
                plain_ms=cuda_ms(
                    lambda: K.qkv_stats_plain(x, heads=heads, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def split_case(inp: Inputs, name, h, w, c, n_out, iters=5, batch=1,
               tile=False):
    """Row 4 on the body its plan gives the call (tile: on the mma.sync
    body): kernel "split_wg" for the wgmma body, "split_c64" for the C = 64
    body, "split_f32" for the float32 body of csrc/split_f32.cu
    (split_proj.cu's time on the same inputs beside it, tile_ms; pw1's
    product alone on cuBLAS, pw1_matmul_ms; at one entry each CUDA launch's
    device time, launch_ms), else "split_proj" ("split_proj_f32":
    split_proj.cu in float32)."""
    body = "tile" if tile else K._split_plan(
        batch, h, w, c, c, n_out, True, False, inp.dtype,
        K._sm_count(torch.device("cuda", 0)))[0]
    kernel = {"wg": "split_wg", "c64": "split_c64", "f32": "split_f32"}.get(
        body, "split_proj_f32" if inp.dtype == torch.float32
        else "split_proj")
    if skipped(kernel, name):
        return None
    x = inp(batch, h, w, c)
    kw = chain_weights(inp, c, n_out * c)
    fn = lambda: K.fused_ln_split_proj(x, n_out=n_out, **kw)  # noqa: E731
    counters = ("launches_wg", "launches_c64", "launches_f32")
    before = [getattr(K.fused_ln_split_proj, k) for k in counters]
    with forced_body(K, "_split_plan", OLD_PLAN) if tile else contextlib.nullcontext():
        got = fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, iters)
    moved = tuple(getattr(K.fused_ln_split_proj, k) > n
                  for k, n in zip(counters, before))
    require(moved == (body == "wg", body == "c64", body == "f32"),
            f"split_proj {name}: body")
    tile_ms = launches = matmul_ms = None
    if body == "f32":  # the old body on the same inputs; pw1 on cuBLAS
        tile_ms = timed_in(lambda: forced_body(K, "_split_plan", OLD_PLAN),
                           fn, 2)
        if batch == 1:
            launches = launch_ms(fn)
        a2, w1 = x.reshape(-1, c), kw["w1"]
        matmul_ms = cuda_ms(lambda: torch.matmul(a2, w1), iters)
    want = K.split_proj_plain(x, n_out=n_out, **kw)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    flops = 2.0 * batch * h * w * (c * n_out * c + 9 * n_out * c)
    b_ms, b_by = bound(numel_bytes(x, *got, *kw.values()), flops, x.dtype)
    return dict(kernel=kernel, case=name, shape=[batch, h, w, c],
                n_out=n_out, max_abs_err=err, rel_err=rel,
                body=body, dtype=str(x.dtype), tile_ms=tile_ms,
                launch_ms=launches, pw1_matmul_ms=matmul_ms,
                tol_rel=KERNEL_REL_TOL, tol_abs_f32=F32_KERNEL_TOL,
                ok=within(err, rel, x, KERNEL_REL_TOL), ms=ms,
                plain_ms=cuda_ms(
                    lambda: K.split_proj_plain(x, n_out=n_out, **kw), 2, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def conv_case(inp: Inputs, name, h, w, cin, cout, bias, iters=5, ln=False,
              batch=1, tile=False):
    """Row 5 at one shape: in float32 on the body its plan gives
    (csrc/conv_f32.cu, kernel "conv3x3_f32", conv3x3.cu's float tile's time
    on the same inputs beside it, tile_ms) or forced onto conv3x3.cu's
    float tile (tile: kernel "conv3x3_tile_f32"); in bf16 on conv3x3.cu."""
    f32 = inp.dtype == torch.float32
    kernel = ("conv3x3_tile_f32" if tile else "conv3x3_f32") if f32 \
        else "conv3x3"
    if skipped(kernel, name):
        return None
    x = inp(batch, h, w, cin)
    wt = inp(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = inp(cout, scale=0.2) if bias else None
    lnk = dict(ln_w=1.0 + inp(cin, scale=0.2),
               ln_b=inp(cin, scale=0.2)) if ln else {}
    old = (lambda: forced_body(K, "_conv_plan", OLD_PLAN)) if tile else (
        contextlib.nullcontext)
    f32_before = K.fused_conv3x3.launches_f32
    with old():
        got = K.fused_conv3x3(x, wt, bb, **lnk)
    torch.cuda.synchronize()
    require((K.fused_conv3x3.launches_f32 > f32_before) == (
        f32 and not tile), f"{kernel}: {name} ran on another body")
    want = K.conv3x3_plain(x, wt, bb, **lnk)
    err, rel = rel_err(got, want)
    del want
    fn = lambda: K.fused_conv3x3(x, wt, bb, **lnk)  # noqa: E731
    extra = {}
    if f32 and not tile:  # the old body on the same inputs
        extra = dict(tile_ms=timed_in(
            lambda: forced_body(K, "_conv_plan", OLD_PLAN), fn, 2))
    # the library's call for the same function: cuDNN through F.conv2d on
    # the same NHWC memory (channels_last), in the map's type (float32: TF32
    # off, as the script sets); timed here, used nowhere. With the LayerNorm
    # in front no single call computes the function: F.conv2d of the conv
    # alone is timed beside it (conv_only_library_ms)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    conv_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bb, padding=1), iters)
    lib = None if ln else conv_ms
    b_ms, b_by = bound(numel_bytes(x, wt, bb, got, *lnk.values()),
                       2.0 * batch * h * w * (9 * cin * cout
                                              + (8 * cin if ln else 0)),
                       x.dtype)
    return dict(kernel=kernel, case=name, shape=[batch, h, w, cin],
                cout=cout, dtype=str(x.dtype),
                conv_only_library_ms=conv_ms if ln else None,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                tol_abs_f32=F32_KERNEL_TOL,
                ok=within(err, rel, x, KERNEL_REL_TOL),
                ms=timed_in(old, fn, iters),
                plain_ms=cuda_ms(lambda: K.conv3x3_plain(x, wt, bb, **lnk),
                                 2, 1),
                library_ms=lib, bound_ms=b_ms, bound_by=b_by, **extra)


def chm_case(inp: Inputs, name, h, w, c, heads, nf, iters=3, batch=1,
             tile=False):
    """Row 6 on the body its plan gives the call (tile: on the mma.sync
    body): kernel "chm_wg" for the wgmma body, "chm_f32" for the float32
    body of csrc/chm_f32.cu (chm_stats.cu's time on the same inputs beside
    it, tile_ms; the two pw1 products alone on cuBLAS, pw1_matmul_ms; at one
    entry each CUDA launch's device time, launch_ms), else "chm_stats"
    ("chm_stats_f32": chm_stats.cu in float32)."""
    f32 = inp.dtype == torch.float32
    kernel = (("chm_stats_f32" if tile or not K._chm_f32_form(c, heads)
               else "chm_f32") if f32 else "chm_stats"
              if tile or c not in K._CHM_WG_WIDTHS else "chm_wg")
    if skipped(kernel, name):
        return None
    x, x_sp = inp(batch, h, w, c), inp(batch, nf, h, w, c)
    kw = dict(ln_w=1.0 + inp(c, scale=0.2), ln_b=inp(c, scale=0.2),
              w_qkv=inp(c, 3 * c, scale=c ** -0.5),
              wd_qkv=inp(3, 3, 3 * c, scale=0.3),
              w_kv=inp(c, 2 * c, scale=c ** -0.5),
              wd_kv=inp(3, 3, 2 * c, scale=0.3), heads=heads)
    fn = lambda: K.fused_chm_stats(x, x_sp, **kw)  # noqa: E731
    old = (lambda: forced_body(K, "_chm_plan", OLD_PLAN)) if tile and f32 \
        else contextlib.nullcontext
    wg_before = K.fused_chm_stats.launches_wg
    f32_before = K.fused_chm_stats.launches_f32
    with stats_widths(K._QKV_WG_WIDTHS, () if tile else K._CHM_WG_WIDTHS), \
            old():
        got = fn()
        torch.cuda.synchronize()
        on_wg = K.fused_chm_stats.launches_wg > wg_before
        on_f32 = K.fused_chm_stats.launches_f32 > f32_before
        ms = cuda_ms(fn, iters)
    require(on_wg == (kernel == "chm_wg") and on_f32 == (kernel == "chm_f32"),
            f"chm_stats {name}: body")
    tile_ms = launches = matmul_ms = None
    if on_f32:  # the old body on the same inputs; pw1 on cuBLAS
        tile_ms = timed_in(lambda: forced_body(K, "_chm_plan", OLD_PLAN), fn,
                           2)
        if batch == 1:
            launches = launch_ms(fn)
        a2, f2 = x.reshape(-1, c), x_sp.reshape(-1, c)
        matmul_ms = cuda_ms(lambda: (torch.matmul(a2, kw["w_qkv"]),
                                     torch.matmul(f2, kw["w_kv"])), iters)
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
    b_ms, b_by = bound(numel_bytes(x, x_sp, *got, *tensors), flops, x.dtype)
    body = "wg" if on_wg else "f32" if on_f32 else "tile"
    err = max(err_v, err_vh, err_stats / px)
    return dict(kernel=kernel, case=name, shape=[batch, nf, h, w, c],
                body=body, dtype=str(x.dtype), tile_ms=tile_ms,
                launch_ms=launches, pw1_matmul_ms=matmul_ms,
                partial_row_bytes=partial_row_bytes(batch, h, w, c, heads, nf,
                                                    body),
                tile_partial_row_bytes=partial_row_bytes(batch, h, w, c,
                                                         heads, nf, "tile"),
                heads=heads, max_abs_err=err,
                rel_err=max(rel_v, rel_vh), rel_err_stats=rel_stats,
                tol_rel=KERNEL_REL_TOL, tol_rel_stats=STATS_REL_TOL,
                tol_abs_f32=F32_KERNEL_TOL,
                ok=(err <= F32_KERNEL_TOL if x.dtype == torch.float32 else
                    max(rel_v, rel_vh) <= KERNEL_REL_TOL
                    and rel_stats <= STATS_REL_TOL),
                ms=ms,
                plain_ms=cuda_ms(lambda: K.chm_stats_plain(x, x_sp, **kw),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sab_inputs(inp: Inputs, nf, hw, d, exact: bool, batch: int = 1,
               dtype: torch.dtype = torch.bfloat16):
    """Unit vectors, or (exact) small integers over 8 with a temperature of
    one half: every score is then exact in fp32 whatever the order of the
    sum, and rows tie many times."""
    if exact:
        q = torch.from_numpy(inp.rng.randint(-2, 3, (batch, hw, d)) / 8.0)
        k = torch.from_numpy(inp.rng.randint(-2, 3, (batch, nf, hw, d)) / 8.0)
        temp = torch.tensor([0.5], device="cuda")
        return q.to("cuda", dtype), k.to("cuda", dtype), temp
    q, k = inp(batch, hw, d).float(), inp(batch, nf, hw, d).float()
    q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
    k = (k / k.norm(dim=-1, keepdim=True)).to(dtype)
    return q, k, torch.tensor([1.7], device="cuda")


def sab_compare(got, want):
    """(share of rows whose support differs, largest error on the others)."""
    same = ((got != 0) == (want != 0)).all(dim=-1)
    err = ((got.float() - want.float()).abs().amax(dim=-1) * same).max().item()
    return 1.0 - same.float().mean().item(), err


def sab_case(inp: Inputs, name, hq, wq, d, nf, iters=10, batch=1,
             tile=False):
    """Row 7 on the body its plan gives the call (tile: on the mma.sync
    body): kernel "sab_wg" for the wgmma body, else "sab" (where the plan
    chose it, timed also on the wgmma body, wg_ms)."""
    hw = hq * wq
    on_wg = not tile and S._sab_plan(batch, nf, hw, d, torch.bfloat16, 4,
                                     wq) == "wg"
    kernel = "sab_wg" if on_wg else "sab"
    if skipped(kernel, name):
        return None
    with (forced_body(S, "_sab_plan", "tile") if tile
          else contextlib.nullcontext()):
        return _sab_case(inp, name, hq, wq, d, nf, iters, batch, on_wg,
                         kernel, time_wg=not (on_wg or tile))


def _sab_case(inp, name, hq, wq, d, nf, iters, batch, on_wg, kernel,
              time_wg):
    hw = hq * wq
    fv = torch.ones(nf, device="cuda")
    # (a) exact scores: the same support, bit for bit
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True, batch=batch)
    wg_before = S.sab_attn_probs.launches_wg
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    require(on_wg == (S.sab_attn_probs.launches_wg > wg_before),
            f"sab {name}: body")
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
    timed = lambda: S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)  # noqa: E731
    wg_ms = None
    if time_wg:
        with forced_body(S, "_sab_plan", "wg"):
            wg_ms = cuda_ms(timed, iters)
    return dict(kernel=kernel, case=name, shape=[batch, nf, hw, d],
                grid=[hq, wq], body="wg" if on_wg else "tile", wg_ms=wg_ms,
                max_abs_err=max(err, exact_err), rel_err=err,
                exact_inputs_same_support=exact_same,
                exact_inputs_max_abs_err=exact_err, tol_exact=SAB_EXACT_TOL,
                rows_support_differs_share=share,
                max_flip_share=SAB_MAX_FLIP_SHARE, tol=SAB_TOL,
                ok=(exact_same and exact_err <= SAB_EXACT_TOL and rows_ok
                    and share <= SAB_MAX_FLIP_SHARE and err <= SAB_TOL),
                ms=cuda_ms(timed, iters),
                plain_ms=cuda_ms(lambda: S.sab_attn_probs_plain(
                    q, k, temp, fv, grid_wq=wq), 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sab_f32_case(inp: Inputs, name, hq, wq, d, nf, iters=3, batch=1):
    """Row 7 in float32 on the body its plan gives the call: kernel
    "sab_f32" for csrc/sab_f32.cu, else "sab". Exact inputs (the support
    bit for bit), then unit vectors with the second frame invalid (the rows
    whose support agrees within the float32 limit, at most SAB_F32_FLIP_SHARE
    of them flipped), both against the plain version in float32 (TF32 off);
    where sab.cu's block holds the rows the other body on the same inputs
    too: its time (tile_ms or f32_ms) and whether the two agree bit for
    bit."""
    hw = hq * wq
    body = S._sab_plan(batch, nf, hw, d, torch.float32, 4, wq)
    kernel = "sab_f32" if body == "f32" else "sab"
    if skipped(kernel, name):
        return None
    fits = S._tile_smem(hw, d, 8, False) <= K._SMEM_LIMIT
    fv = torch.ones(nf, device="cuda")
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True, batch=batch,
                            dtype=torch.float32)
    before = S.sab_attn_probs.launches_f32
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    require((S.sab_attn_probs.launches_f32 > before) == (body == "f32"),
            f"sab float32 {name}: body")
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    exact_same = bool(torch.equal(got != 0, want != 0))
    exact_err = (got - want).abs().max().item()
    del got, want
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=False, batch=batch,
                            dtype=torch.float32)
    if nf > 1:
        fv[1] = 0.0
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    share, err = sab_compare(got, want)
    rows_ok = bool(((got.sum(-1) - fv[None, :, None]).abs() <= 1e-4).all())
    del want
    timed = lambda: S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)  # noqa: E731
    other_ms = bit_equal = None
    if fits:  # the other body on the same inputs
        with forced_body(S, "_sab_plan", "tile" if body == "f32" else "f32"):
            other = timed()
            torch.cuda.synchronize()
            bit_equal = bool(torch.equal(got, other))
            del other
            other_ms = cuda_ms(timed, iters)
    b_ms, b_by = bound(numel_bytes(q, k, got),
                       2.0 * batch * nf * hw * hw * d, torch.float32)
    return dict(kernel=kernel, case=name, shape=[batch, nf, hw, d],
                grid=[hq, wq], body=body, dtype="float32",
                tile_ms=other_ms if body == "f32" else None,
                f32_ms=other_ms if body == "tile" else None,
                bit_equal_to_sab_cu=bit_equal if body == "f32" else None,
                max_abs_err=max(err, exact_err), rel_err=err,
                exact_inputs_same_support=exact_same,
                exact_inputs_max_abs_err=exact_err,
                rows_support_differs_share=share,
                max_flip_share=SAB_F32_FLIP_SHARE, tol=F32_KERNEL_TOL,
                ok=(exact_same and exact_err <= F32_KERNEL_TOL and rows_ok
                    and share <= SAB_F32_FLIP_SHARE and err <= F32_KERNEL_TOL
                    and bit_equal is not False),
                ms=cuda_ms(timed, iters),
                plain_ms=cuda_ms(lambda: S.sab_attn_probs_plain(
                    q, k, temp, fv, grid_wq=wq), 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, whose replays run the launches back to back, without the host
    between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 3, 0) / reps
    del graph
    return ms


def host_ms(fn, calls: int = 50) -> float:
    """The host's time a call of ``fn`` (the launches are queued, not
    waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def lattice_case(inp: Inputs, name, h, w, c, ws, n, merge: bool, iters=5):
    if skipped("lattice_merge" if merge else "lattice_split", name):
        return None
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
    # the copies are short enough for the wrapper's host time to pace the
    # events' clock: also the device's own time (graph_ms) and the host's a
    # call (host_ms)
    return dict(kernel="lattice_merge" if merge else "lattice_split",
                case=name, shape=list(src.shape), window=ws,
                max_abs_err=err, rel_err=err, tol_rel=0.0, ok=exact,
                ms=cuda_ms(fn, iters), plain_ms=plain_ms,
                library_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                graph_ms=graph_ms(fn), host_ms=host_ms(fn))


def attn_v_case(inp: Inputs, name, b, nf, hq, wq, ws, c, merge=True, iters=5,
                tile=False):
    """Attention @ v at the shape a CHM block gives it: nf - 1 ring positions
    (views of one buffer, as the cache stores them) and the current frame's
    values. library: torch.matmul per position and, for the merge, the
    library's permuted copy. float32: on csrc/attn_v_f32.cu (attn_v.cu's
    float tile's time on the same inputs beside it, tile_ms), or forced onto
    attn_v.cu (tile: kernel "attn_v_tile_f32")."""
    f32 = inp.dtype == torch.float32
    kernel = ("attn_v_tile_f32" if tile else "attn_v_f32") if f32 \
        else "attn_v"
    if skipped(kernel, name):
        return None
    hw, d, h, w = hq * wq, ws * ws * c, hq * ws, wq * ws
    a = torch.rand(b * nf, hw, hw, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(hw + d))
    a = a * (a > 0.88)  # some 48 of 400 entries a row, as the softmax leaves
    a = (a / a.sum(-1, keepdim=True).clamp_min(1e-6)).to(inp.dtype)
    ring = inp(b, max(nf - 1, 1), hw, d)
    vs = [ring[:, i] for i in range(nf - 1)] + [inp(b, hw, d)]
    if merge:
        fn = lambda: S.sab_attn_v_merge(a, vs, ws, h, w)  # noqa: E731
        plain = lambda: S.attn_v_merge_plain(a, vs, ws, h, w)  # noqa: E731
    else:
        fn = lambda: S.sab_attn_v_slots(a, vs, c)  # noqa: E731
        plain = lambda: S.attn_v_slots_plain(a, vs, c)  # noqa: E731
    old = (lambda: forced_body(S, "_attn_v_plan", OLD_PLAN)) if tile else (
        contextlib.nullcontext)
    f32_before = S.sab_attn_v_merge.launches_f32 + \
        S.sab_attn_v_slots.launches_f32
    with old():
        got = fn()
    torch.cuda.synchronize()
    require((S.sab_attn_v_merge.launches_f32 + S.sab_attn_v_slots.launches_f32
             > f32_before) == (f32 and not tile),
            f"{kernel}: {name} ran on another body")
    want = plain()
    err, rel = rel_err(got, want)
    del want
    extra = {}
    if f32 and not tile:  # the old body on the same inputs
        extra = dict(tile_ms=timed_in(
            lambda: forced_body(S, "_attn_v_plan", OLD_PLAN), fn, 1))
    a4 = a.reshape(b, nf, hw, hw)
    tok = torch.empty(b, nf, hw, d, device="cuda", dtype=inp.dtype)

    def library():
        for i, vi in enumerate(vs):
            torch.matmul(a4[:, i], vi, out=tok[:, i])
        if merge:
            return L.lattice_merge_plain(tok.reshape(b * nf, hw, d), ws, h, w
                                         ).contiguous()
        return tok.reshape(b * nf, hw, ws * ws, c).permute(0, 2, 1, 3
                                                           ).contiguous()

    b_ms, b_by = bound(numel_bytes(a, *vs, got), 2.0 * b * nf * hw * hw * d,
                       inp.dtype)
    ok = (err <= F32_ATTN_V_TOL if inp.dtype == torch.float32
          else rel <= ATTN_V_REL_TOL)
    return dict(kernel=kernel, case=name, epilogue="merge" if merge
                else "slots", shape=[b * nf, hw, hw, d], window=ws,
                dtype=str(inp.dtype).replace("torch.", ""),
                max_abs_err=err,
                rel_err=rel, tol_rel=ATTN_V_REL_TOL,
                ok=ok and bool(torch.isfinite(got.float()).all()),
                ms=timed_in(old, fn, iters), plain_ms=cuda_ms(plain, 1, 0),
                library_ms=cuda_ms(library, iters), bound_ms=b_ms,
                bound_by=b_by, **extra)


def run_inputs(inp: Inputs, b, h, w, c, heads, n_blocks):
    """The map and the blocks' weights of a run at a level's shape (E = 2.5
    C, LayerNorm biases, no conv biases)."""
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
    return x, blocks


def run_case(inp: Inputs, name, b, h, w, c, heads, n_blocks, iters=3,
             tile=False):
    """A run of Channel+GFFW blocks on the body its plan gives it (tile: on
    level.cu): kernel "level_wg" for csrc/level_wg.cu, else "level_run";
    against its plain version, against the 2 N split launches it replaces
    (the model's split route, row 3 on qkv_wg.cu: their time is split_ms, no
    library call computes the run) and against the same launches with row 3 on
    qkv_stats.cu, the tile code level.cu shares. float32 (kernel
    "level_run_f32"): on level.cu, whose float32 tile code the split route
    runs too (one split route), at the card tests' float32 limits."""
    f32 = inp.dtype == torch.float32
    tile = tile or f32
    kernel = "level_run_f32" if f32 else "level_run" if tile else "level_wg"
    if skipped(kernel, name):
        return None
    x, blocks = run_inputs(inp, b, h, w, c, heads, n_blocks)
    e = blocks[0]["w2"].shape[0]

    def fused():
        return LV.fused_channel_gffw_run(x, blocks, heads)

    def on_level_cu():
        with forced_body(LV, "_level_plan", OLD_PLAN):
            return fused()

    body = on_level_cu if tile else fused
    before = LV.fused_channel_gffw_run.launches_wg
    got = body()
    torch.cuda.synchronize()
    require(LV.fused_channel_gffw_run.launches_wg - before
            == (0 if tile else -(-n_blocks // LV.MAX_RUN)),
            f"{kernel} {name}: not on the body its plan gives it")
    with stats_widths((), K._CHM_WG_WIDTHS):
        split = LV.channel_gffw_run_split(x, blocks, heads)
    err_s, rel_s = rel_err(got, split)
    if not f32:  # float32: the model's split route is that one
        split = LV.channel_gffw_run_split(x, blocks, heads)
    err_m, rel_m = rel_err(got, split)
    bit_equal = bool(torch.equal(got, split))
    del split
    want = LV.channel_gffw_run_plain(x, blocks, heads)
    err, rel = rel_err(got, want)
    del want
    tol = KERNEL_REL_TOL * n_blocks
    # level.cu shares qkv_stats.cu's tile code (the tight limit against the
    # split route on it), level_wg.cu the model's split route's bodies
    rel_tight, rel_loose = (rel_s, rel_m) if tile else (rel_m, rel_s)
    # one map read, one map written, the weights; per pixel and block the
    # three chains, the head blocks of the Gram, the norms, v @ po', the
    # gate chains and pw2
    px, ctok = b * h * w, c // heads
    flops = 2.0 * n_blocks * px * (c * 3 * c + 27 * c + c * ctok + 2 * c
                                   + c * c + c * 2 * e + 18 * e + e * c)
    weights = [v for blk in blocks for v in blk.values()]
    b_ms, b_by = bound(numel_bytes(x, got, *weights), flops, inp.dtype)
    if f32:
        ok = (err <= F32_KERNEL_TOL * n_blocks
              and err_s <= F32_RUN_SPLIT_TOL * n_blocks)
    else:
        ok = (rel <= tol and rel_tight <= RUN_SPLIT_REL_TOL
              and rel_loose <= tol)
    return dict(kernel=kernel, case=name, shape=[b, h, w, c],
                dtype=str(inp.dtype).replace("torch.", ""),
                heads=heads, blocks=n_blocks, max_abs_err=err, rel_err=rel,
                tol_rel=tol, max_abs_err_vs_split=err_s,
                rel_err_vs_split=rel_s, max_abs_err_vs_model_split=err_m,
                rel_err_vs_model_split=rel_m,
                bit_equal_to_model_split=bit_equal,
                tol_rel_vs_tight_split=RUN_SPLIT_REL_TOL,
                ok=ok and bool(torch.isfinite(got.float()).all()),
                ms=cuda_ms(body, iters, 1),
                split_ms=cuda_ms(
                    lambda: LV.channel_gffw_run_split(x, blocks, heads),
                    iters, 1),
                plain_ms=cuda_ms(
                    lambda: LV.channel_gffw_run_plain(x, blocks, heads), 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def level_phase_cases(seed: int, h: int, w: int) -> list[dict]:
    """Row 14's Hopper body with each of its phases left out in turn (builds
    of csrc/level_wg.cu with LV_PHASES = 6, 5, 3: without (a) the
    statistics, (b) the softmax and po', (c) the FFN), beside the whole body,
    its split route and that route's two kernels alone (N launches of row 3,
    N of row 1 on the run's map), at the runs of the paths: what each phase
    costs. A build without a phase gives wrong outputs; only its time is
    read."""
    inp = Inputs(seed)
    whole = build.load("level_wg")
    parts = dict(zip(("without_a_ms", "without_b_ms", "without_c_ms"),
                     build.load_variants("level_wg", [
                         ("-DLV_PHASES=6",), ("-DLV_PHASES=5",),
                         ("-DLV_PHASES=3",)])))
    tb, tl = MAX_TILE_BATCH, TILE
    shapes = [(f"{lvl} x{n}, {tb} tiles", tb, tl // s_, tl // s_, c, heads, n)
              for lvl, (s_, c, heads, n) in RUN_LEVELS.items()]
    shapes.append(("latent x9, whole frame", 1, h // 8, w // 8, 512, 8, 9))
    out = []
    for name, b, hh, ww, c, heads, n in shapes:
        x, blocks = run_inputs(inp, b, hh, ww, c, heads, n)

        def run():
            return LV.fused_channel_gffw_run(x, blocks, heads)

        res = dict(phase="level_phases", case=name, shape=[b, hh, ww, c],
                   blocks=n, ms=cuda_ms(run, 3, 1))
        for key, lib in parts.items():
            build._libs["level_wg"] = lib
            try:
                res[key] = cuda_ms(run, 3, 1)
            finally:
                build._libs["level_wg"] = whole
        res["split_ms"] = cuda_ms(
            lambda: LV.channel_gffw_run_split(x, blocks, heads), 3, 1)
        stats = [dict(ln_w=blk["ln1_w"], ln_b=blk["ln1_b"], w1=blk["w_qkv"],
                      wd=blk["wd_qkv"], heads=heads) for blk in blocks]
        v, gram, st = K.fused_qkv_stats(x, **stats[0])
        po = LV.channel_po(gram, st, blocks[0]["temp"], blocks[0]["wpo"],
                           heads, x.dtype)
        ffns = [dict(x2=v, po_w=po, ln_w=blk["ln2_w"], ln_b=blk["ln2_b"],
                     w1=blk["w1"], wd=blk["wd"], w2=blk["w2"], mode="gate")
                for blk in blocks]
        res["split_stats_ms"] = cuda_ms(
            lambda: [K.fused_qkv_stats(x, **kw) for kw in stats], 3, 1)
        res["split_ffn_ms"] = cuda_ms(
            lambda: [K.fused_block_ffn(x, **kw) for kw in ffns], 3, 1)
        emit(res)
        out.append(res)
        torch.cuda.empty_cache()
    return out


def two_stage_inputs(inp: Inputs, kind, b, h, w, c, e1, e2):
    """(x, st1, st2, {ffw1, ffw2}) of row 13: a pair of ReducedAttn+FFW
    blocks (kind "pair") or a ReducedAttn+GFFW block ("ra_gffw")."""
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
    return x, st1, st2, dict(ffw1=ffw1, ffw2=ffw2)


def two_stage_phase_cases(seed: int) -> list[dict]:
    """Row 13's Hopper bodies with each of their phases left out in turn
    (builds of csrc/chain2_wg.cu with C2_PHASES = 14, 13, 11, 7: without the
    taps, stage 2, the chained FFW, the products; the last three at C = 64
    only), beside the whole body, its split route, the route's first launch
    alone and chain2.cu, at the 15-tile shapes of the paths: what each phase
    costs. A build without a phase gives wrong outputs; only its time is
    read."""
    inp = Inputs(seed)
    whole = build.load("chain2_wg")
    parts = dict(zip(("without_taps_ms", "without_stage2_ms",
                      "without_ffw_ms", "without_products_ms"),
                     build.load_variants("chain2_wg", [
                         ("-DC2_PHASES=14",), ("-DC2_PHASES=13",),
                         ("-DC2_PHASES=11",), ("-DC2_PHASES=7",)])))
    tb, tl = MAX_TILE_BATCH, TILE
    out = []
    for name, kind, hh, c, e1, e2 in (
            (f"enc1 pair, {tb} tiles", "pair", tl, 64, 128, 128),
            (f"enc2 pair, {tb} tiles", "pair", tl // 2, 128, 256, 256),
            (f"refinement RA+GFFW, {tb} tiles", "ra_gffw", tl, 64, 128, 160)):
        x, st1, st2, kw = two_stage_inputs(inp, kind, tb, hh, hh, c, e1, e2)

        def run():
            return C2.fused_two_stage(x, st1, st2, **kw)

        def split():
            y = K.fused_block_ffn(x, ffw2=kw["ffw1"], **st1)
            return K.fused_block_ffn(y, ffw2=kw["ffw2"], **st2)

        res = dict(phase="two_stage_phases", case=name, shape=[tb, hh, hh, c],
                   ms=cuda_ms(run, 3, 1))
        for key, lib in parts.items():
            if c == 128 and key not in ("without_taps_ms",):
                continue
            build._libs["chain2_wg"] = lib
            try:
                res[key] = cuda_ms(run, 3, 1)
            finally:
                build._libs["chain2_wg"] = whole
        res["split_ms"] = cuda_ms(split, 3, 1)
        res["split_stage1_ms"] = cuda_ms(
            lambda: K.fused_block_ffn(x, ffw2=kw["ffw1"], **st1), 3, 1)
        with forced_body(C2, "_two_stage_plan", OLD_PLAN):
            res["chain2_cu_ms"] = cuda_ms(run, 3, 1)
        emit(res)
        out.append(res)
        torch.cuda.empty_cache()
    return out


def two_stage_case(inp: Inputs, name, kind, b, h, w, c, e1, e2, iters=3,
                   tile=False):
    """Row 13 at the shape a conv-only level gives it: a pair of
    ReducedAttn+FFW blocks (kind "pair") or a ReducedAttn+GFFW block
    ("ra_gffw"), on the body its plan gives it (kernel "two_stage_wg" for
    the Hopper bodies of chain2_wg.cu, else "two_stage"; tile: on
    chain2.cu), against its plain version and
    against the split route it replaces (two FFN launches; their time is
    split_ms, no library call computes the chain)."""
    if skipped("two_stage", name):
        return None
    x, st1, st2, kw = two_stage_inputs(inp, kind, b, h, w, c, e1, e2)
    ffw1, ffw2 = kw["ffw1"], kw["ffw2"]
    body = ((lambda: forced_body(C2, "_two_stage_plan", OLD_PLAN)) if tile
            else contextlib.nullcontext)
    wg_before = C2.fused_two_stage.launches_wg
    with body():
        got = C2.fused_two_stage(x, st1, st2, **kw)
    torch.cuda.synchronize()
    on_wg = C2.fused_two_stage.launches_wg > wg_before
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
    b_ms, b_by = bound(numel_bytes(x, got, *weights), flops, inp.dtype)
    if inp.dtype == torch.float32:  # the card tests' float32 limits
        ok = err <= 2 * F32_KERNEL_TOL and err_s <= F32_KERNEL_TOL
    else:
        ok = rel <= TWO_STAGE_REL_TOL and rel_s <= TWO_STAGE_REL_TOL
    return dict(kernel=f32_kernel("two_stage_wg" if on_wg else "two_stage",
                                  x),
                case=name, shape=[b, h, w, c], body="wg" if on_wg else "tile",
                dtype=str(inp.dtype).replace("torch.", ""),
                hidden=[e1, e2], max_abs_err=err, rel_err=rel,
                tol_rel=TWO_STAGE_REL_TOL, bit_equal_to_split=bit_equal,
                max_abs_err_vs_split=err_s, rel_err_vs_split=rel_s,
                ok=ok and bool(torch.isfinite(got.float()).all()),
                ms=timed_in(body, lambda: C2.fused_two_stage(x, st1, st2, **kw),
                            iters),
                split_ms=cuda_ms(split, iters),
                plain_ms=cuda_ms(lambda: C2.two_stage_plain(x, st1, st2, **kw),
                                 1, 0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sparse_case(inp: Inputs, name, b, nf, hq, wq, d, iters=3, tile=False):
    """Row 12 on the scores of an alignment attention (B * NF entries of
    HW x HW on an (hq, wq) window grid) and the grid's local mask, on the
    body its plan gives it (kernel "sparse_wg" for the streaming body of
    sparse_wg.cu, held to sab.cu's bits; else "sab_sparse_softmax"; tile:
    on sab.cu), against its plain version
    and against row 7 on the same q, k: exact inputs make every score exact
    whatever the order of its sum, and the scores are rounded to bf16 as row
    7 rounds them, so the two agree bit for bit."""
    if skipped("sab_sparse_softmax", name):
        return None
    hw = hq * wq
    q, k, temp = sab_inputs(inp, nf, hw, d, exact=True, batch=b)
    scores = (torch.einsum("bqd,bnkd->bnqk", q.float(), k.float())
              * temp).bfloat16().reshape(b * nf, hw, hw).contiguous()
    mask = local_window_mask(hq, wq, 4, torch.bfloat16, "cuda")
    body = ((lambda: forced_body(S, "_sparse_plan", OLD_PLAN)) if tile
            else contextlib.nullcontext)
    wg_before = S.sab_sparse_softmax.launches_wg
    with body():
        got = S.sab_sparse_softmax(scores, mask)
    torch.cuda.synchronize()
    on_wg = S.sab_sparse_softmax.launches_wg > wg_before
    equal_tile = True
    if on_wg:
        with forced_body(S, "_sparse_plan", OLD_PLAN):
            equal_tile = bool(torch.equal(got, S.sab_sparse_softmax(scores,
                                                                     mask)))
    row7 = S.sab_attn_probs(q, k, temp, None, grid_wq=wq)
    equal_row7 = bool(torch.equal(got, row7.reshape(got.shape)))
    del row7
    want = S.sparse_softmax_plain(scores, mask)
    same_support = bool(torch.equal(got != 0, want != 0))
    err = (got.float() - want.float()).abs().max().item()
    del want
    b_ms, b_by = bound(numel_bytes(scores, mask, got), 0.0)
    return dict(kernel="sparse_wg" if on_wg else "sab_sparse_softmax",
                case=name, shape=[b * nf, hw, hw], body="wg" if on_wg
                else "tile", bit_equal_to_sab_cu=equal_tile,
                grid=[hq, wq], max_abs_err=err, rel_err=err, tol=SPARSE_TOL,
                same_support_as_plain=same_support,
                bit_equal_to_row_7=equal_row7,
                ok=same_support and err <= SPARSE_TOL and equal_row7
                and equal_tile,
                ms=timed_in(body, lambda: S.sab_sparse_softmax(scores, mask),
                            iters),
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
    # the branch without a depthwise stage: the FFW pass of enc3 in
    # `gopro_enc3_ffw` (whole-frame only; its v map and per-batch po, row 2's
    # body) also on a ragged batch of two, and an FFW half alone at C = 64
    # (ffn.cu; no path)
    cases += [
        lambda: ffn_case(inp, "gelu+scale+pair+po(B,C,C), no dw (FFW pass of "
                         "enc3 in gopro_enc3_ffw)", h3, w3, 256, 512, "gelu",
                         biases=True, scale=True, pair=True, po=True,
                         dw=False),
        lambda: ffn_case(inp, "ragged gelu+scale+pair+po(B,C,C)+po_b, 2 maps, "
                         "no dw C=256", h3 - 1, w3 - 5, 256, 512, "gelu",
                         biases=True, scale=True, pair=True, po=True,
                         dw=False, batch=2),
        lambda: ffn_case(inp, "gelu+scale, no dw (an FFW half alone; not on "
                         "the main path)", h, w, 64, 128, "gelu", biases=True,
                         scale=True, dw=False, iters=3),
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
    # level.cu, off the paths now (float32, other widths and head sizes), at
    # the same shape
    cases.append(lambda: run_case(inp, "latent x9, whole frame, on level.cu "
                                  "(off the paths)", 1, h4, w4, 512, 8, 9,
                                  tile=True))
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
    # the wgmma body of row 1 on maps its 8 x 8 tiles do not divide, at each
    # width it takes (a shared po, a batch of two, the gelu form, the CHM
    # lists at dec3's and dec2's widths, the chained FFW at enc2's)
    cases += [
        lambda: ffn_case(inp, "ragged gate+pair+po(B,C,C)+po_b C=512", hr, wr,
                         512, 1280, "gate", pair=True, po=True, biases=True),
        lambda: ffn_case(inp, "ragged gate+pair+po(C,C) C=256", 2 * hr + 1,
                         2 * wr + 1, 256, 640, "gate", pair=True, po=True,
                         shared_po=True),
        lambda: ffn_case(inp, "ragged gate+pair+po(B,C,C), 2 maps C=128",
                         4 * hr + 3, 4 * wr + 5, 128, 320, "gate", pair=True,
                         po=True, batch=2),
        lambda: ffn_case(inp, "ragged gelu+scale C=128", 4 * hr + 3,
                         4 * wr + 5, 128, 256, "gelu", biases=True,
                         scale=True),
        lambda: ffn_case(inp, "ragged gate + 4 stacked + 1 maps, po(B,C,C) "
                         "each C=256", 2 * hr + 1, 2 * wr + 1, 256, 640,
                         "gate", stacked=4),
        lambda: ffn_case(inp, "ragged gate + 4 stacked + 1 maps, po(B,C,C) "
                         "each C=128", 4 * hr + 3, 4 * wr + 5, 128, 320,
                         "gate", stacked=4),
        lambda: ffn_case(inp, "ragged gelu+scale+ffw2 C=128", 4 * hr + 3,
                         4 * wr + 5, 128, 256, "gelu", biases=True,
                         scale=True, ffw2=True),
    ]
    # the C = 64 body of row 1 on maps its 16 x 8 tiles do not divide, in
    # each of its forms (a batch of two with per-batch po and po_b, dec1's
    # list read in place); ffn.cu's dw branch, off the paths now, at dec1's
    # shape
    cases += [
        lambda: ffn_case(inp, "ragged gate C=64", h - 5, w - 7, 64, 160,
                         "gate", iters=3),
        lambda: ffn_case(inp, "ragged gelu+scale C=64", h - 5, w - 7, 64, 128,
                         "gelu", biases=True, scale=True, iters=3),
        lambda: ffn_case(inp, "ragged gate+pair+po(B,C,C)+po_b, 2 maps C=64",
                         h - 5, w - 7, 64, 160, "gate", pair=True, po=True,
                         biases=True, batch=2, iters=3),
        lambda: ffn_case(inp, "ragged gate + 3 stacked + 1 maps, po(B,C,C) "
                         "each C=64", h - 5, w - 7, 64, 160, "gate",
                         stacked=3, iters=3),
        lambda: ffn_case(inp, "ragged gelu+scale+ffw2 C=64", h - 5, w - 7, 64,
                         128, "gelu", biases=True, scale=True, ffw2=True,
                         iters=3),
        lambda: ffn_case(inp, "gate+pair+po(B,C,C) dec1 on the mma.sync body "
                         "(off the paths)", h, w, 64, 160, "gate", pair=True,
                         po=True, iters=3, tile=True),
    ]
    # the wgmma bodies of rows 3 and 6 on maps their 8 x 8 tiles do not
    # divide, batches of two whose entries the persistent grid splits
    # between blocks; the mma.sync bodies, off the paths now (float32,
    # biases, other head widths), at dec3's shape
    cases += [
        lambda: qkv_case(inp, "enc3/dec3 on the mma.sync body (off the "
                         "paths)", h3, w3, 256, 4, tile=True),
        lambda: chm_case(inp, "dec3 on the mma.sync body (off the paths)", h3,
                         w3, 256, 4, 4, tile=True),
        lambda: qkv_case(inp, "ragged C=512", hr, wr, 512, 8),
        lambda: qkv_case(inp, "ragged C=256, 2 maps", 2 * hr + 1, 2 * wr + 1,
                         256, 4, batch=2),
        lambda: qkv_case(inp, "ragged C=128", 4 * hr + 3, 4 * wr + 5, 128, 2),
        lambda: chm_case(inp, "ragged C=128, 2 maps", 4 * hr + 3, 4 * wr + 5,
                         128, 2, 4, batch=2),
    ]
    # the wgmma bodies of rows 4 and 7 on maps and token grids their tiles do
    # not divide (a ragged 13 x 17 grid: rows off the 16-byte grid; at 3
    # maps, 24 blocks of 128 rows, fewer than any path gives); the
    # mma.sync bodies, off the paths now (float32, biases, no LayerNorm,
    # other widths), at the latent's and dec3's shapes
    cases += [
        lambda: split_case(inp, "latent FHR q,k,v on the mma.sync body (off "
                           "the paths)", h4, w4, 512, 3, tile=True),
        lambda: sab_case(inp, "dec3 on the mma.sync body (off the paths)",
                         h3 // 4, w3 // 4, 512, 4, tile=True),
        lambda: split_case(inp, "ragged q,k,v C=512", hr, wr, 512, 3),
        lambda: split_case(inp, "ragged q,k C=128, 2 maps", 4 * hr + 3,
                           4 * wr + 5, 128, 2, batch=2),
        lambda: split_case(inp, "ragged q,k C=64", h - 5, w - 7, 64, 2,
                           iters=3),
        lambda: sab_case(inp, "ragged 13x17 grid D=256, 15 maps", 13, 17, 256,
                         4, batch=15),
        lambda: sab_case(inp, "ragged 13x17 grid D=512, 3 maps", 13, 17, 512,
                         4, batch=3),
    ]
    # row 7 at the shapes of the SR tiles (the model's maps 256 x 256: 16 x
    # 16 window tokens at every CHM level), 15 tiles a call; row 4 at dec1
    # there
    for lvl, (_, c, _, _, ring) in CHM_LEVELS.items():
        cases.append(lambda lvl=lvl, c=c, nf=ring + 1: sab_case(
            inp, f"{lvl}, {tb} SR tiles", 16, 16, 2 * c, nf, batch=tb))
    cases.append(lambda: split_case(inp, f"SAB q,k dec1, {tb} SR tiles", 256,
                                    256, 64, 2, batch=tb))
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
        # chain2.cu, off the paths now, at enc1's whole-frame shape
        lambda: two_stage_case(inp, "enc1 pair on chain2.cu", "pair", 1, h, w,
                               64, 128, 128, tile=True),
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
    # sab.cu's row body, off the paths now, at dec3's scores
    s3, c3, _, ws3, r3 = CHM_LEVELS["dec3"]
    cases.append(lambda: sparse_case(inp, "dec3 scores on sab.cu", 1, r3 + 1,
                                     h // s3 // ws3, w // s3 // ws3, 2 * c3,
                                     tile=True))
    out = run_cases(cases + frame_size_cases(seed, h, w) + f32_cases(seed, h, w))
    emit({"phase": "attention_at_v_matmul", "route": "torch.matmul",
          **attn_v_times(inp, h, w)})
    return out


def frame_size_cases(seed: int, h: int, w: int) -> list:
    """Row 7 in float32 at the CHM levels of a padded frame of (h, w) (3680
    keys at 720p: on the body its plan gives, the other one timed beside
    it), then at those of a padded 1920x1080 frame (68 x 120 window tokens,
    8160 keys, at every level): row 7 in float32 on csrc/sab_f32.cu and in
    bf16 on sab_wg.cu, rows 8 and 9 at the levels' maps in bf16 and
    float32."""
    inp, inp32 = Inputs(seed + 11), Inputs(seed + 13, torch.float32)
    h8, w8 = turtle_mod.padded_hw(
        model_config_from_options(options_of("gopro")), *SIZE_1080[::-1])
    cases = []
    # the float32 paths' other shapes too: 15 tiles of 320 (20 x 20 tokens
    # at every level), the harness's 256 x 256 (16 x 16), the train step's
    # 192 x 192 at batch 2 (12 x 12)
    for b, hh, ww, tag in ((1, h, w, ""),
                           (MAX_TILE_BATCH, TILE, TILE,
                            f", {MAX_TILE_BATCH} tiles"),
                           (1, BENCH_SIZE, BENCH_SIZE, ", 256 x 256"),
                           (2, 192, 192, ", 2 x 192 x 192")):
        for lvl, (s_, c, _, ws, ring) in CHM_LEVELS.items():
            cases.append(lambda lvl=lvl, s_=s_, c=c, ws=ws, nf=ring + 1,
                         b=b, hh=hh, ww=ww, tag=tag: sab_f32_case(
                             inp32, f"float32 {lvl}{tag}", hh // s_ // ws,
                             ww // s_ // ws, 2 * c, nf, batch=b))
    for lvl, (s_, c, _, ws, ring) in CHM_LEVELS.items():
        hl, wl, tag = h8 // s_, w8 // s_, f"{lvl}, 1920x1080 whole frame"
        cases += [
            lambda hl=hl, wl=wl, c=c, ws=ws, nf=ring + 1, tag=tag:
                sab_f32_case(inp32, "float32 " + tag, hl // ws, wl // ws,
                             2 * c, nf),
            lambda hl=hl, wl=wl, c=c, ws=ws, nf=ring + 1, tag=tag: sab_case(
                inp, tag, hl // ws, wl // ws, 2 * c, nf, iters=3),
            lambda hl=hl, wl=wl, c=c, ws=ws, nf=ring + 1, tag=tag:
                lattice_case(inp, tag, hl, wl, c, ws, nf, True, 3),
            lambda hl=hl, wl=wl, c=c, ws=ws, tag=tag: lattice_case(
                inp, tag, hl, wl, c, ws, 1, False, 3),
            # the float32 forms (gopro_f32_1080)
            lambda hl=hl, wl=wl, c=c, ws=ws, nf=ring + 1, tag=tag:
                lattice_case(inp32, "float32 " + tag, hl, wl, c, ws, nf,
                             True, 3),
            lambda hl=hl, wl=wl, c=c, ws=ws, tag=tag: lattice_case(
                inp32, "float32 " + tag, hl, wl, c, ws, 1, False, 3),
        ]
    return cases


def row5_shapes(h: int, w: int) -> list:
    """Row 5's 11 calls of a model call on a padded (h, w) map: (name, h, w,
    Cin, Cout, bias, LayerNorm) of the eight convs without LayerNorm and the
    three LayerNorm forms of the CHM blocks' v chain."""
    h2, w2, h3, w3, h4, w4 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    return [("up4_3 512->1024", h4, w4, 512, 1024, False, False),
            ("up3_2 256->512", h3, w3, 256, 512, False, False),
            ("up2_1 128->256", h2, w2, 128, 256, False, False),
            ("down3_4 256->128", h3, w3, 256, 128, False, False),
            ("down2_3 128->64", h2, w2, 128, 64, False, False),
            ("down1_2 64->32", h, w, 64, 32, False, False),
            ("input 3->64", h, w, 3, 64, False, False),
            ("ending 64->3 +bias", h, w, 64, 3, True, False),
            ("LN + composite v dec3 256->256", h3, w3, 256, 256, False, True),
            ("LN + composite v dec2 128->128", h2, w2, 128, 128, False, True),
            ("LN + composite v dec1 64->64", h, w, 64, 64, False, True)]


def f32_cases(seed: int, h: int, w: int) -> list:
    """The float32 forms of rows 1, 3 and 5 on their float32 bodies
    (csrc/ffn_f32.cu, qkv_f32.cu, conv_f32.cu; the old bodies' time beside
    each) at every width the float32 paths give them (row 5 with LayerNorm
    at dec3, dec2, dec1), rows 4 and 6 at the widths above 128 channels
    (split_proj.cu, chm_stats.cu; the LN halo in device memory at C = 512):
    whole padded frames of (h, w), then 15 tiles of 320, row 5's convs
    without LayerNorm first; then csrc/ffn.cu, csrc/qkv_stats.cu and
    conv3x3.cu's float tile in float32, forced, and the fused plans' rows
    14, 11 (csrc/attn_v_f32.cu, attn_v.cu's float tile forced) and 13. The
    first case of each row is the one the row reports."""
    inp = Inputs(seed + 7, torch.float32)
    # row 5's convs without LayerNorm at the padded frame (8 of its 11
    # launches a frame) on csrc/conv_f32.cu, first: the row reports up4_3
    cases = [lambda a=a: conv_case(inp, "float32 " + a[0], *a[1:-1], iters=3)
             for a in row5_shapes(h, w) if not a[-1]]
    for b, hh, ww, tag in ((1, h, w, ""),
                           (MAX_TILE_BATCH, TILE, TILE,
                            f", {MAX_TILE_BATCH} tiles")):
        h2, w2 = hh // 2, ww // 2
        h3, w3, h4, w4 = hh // 4, ww // 4, hh // 8, ww // 8
        kw = dict(batch=b, iters=3)
        # rows 1 and 3 at C = 128 and 64 (dec2, enc2; dec1, enc1, the
        # refinement): their forms on the float32 bodies
        narrow = [
            lambda h2=h2, w2=w2, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate+pair+po(B,C,C) dec2" + tag, h2, w2, 128,
                320, "gate", pair=True, po=True, **kw),
            lambda h2=h2, w2=w2, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate + 4 stacked + 1 maps, po(B,C,C) each (CHM "
                "dec2)" + tag, h2, w2, 128, 320, "gate", stacked=4, **kw),
            lambda h2=h2, w2=w2, tag=tag, kw=kw: ffn_case(
                inp, "float32 gelu+scale+ffw2 (enc2 RA+FFW)" + tag, h2, w2,
                128, 256, "gelu", biases=True, scale=True, ffw2=True, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate+pair+po(B,C,C) dec1" + tag, hh, ww, 64, 160,
                "gate", pair=True, po=True, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate + 3 stacked + 1 maps, po(B,C,C) each (CHM "
                "dec1)" + tag, hh, ww, 64, 160, "gate", stacked=3, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate, no pair (refinement)" + tag, hh, ww, 64,
                160, "gate", **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: ffn_case(
                inp, "float32 gelu+scale (refinement RA)" + tag, hh, ww, 64,
                128, "gelu", biases=True, scale=True, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: ffn_case(
                inp, "float32 gelu+scale+ffw2 (enc1 RA+FFW)" + tag, hh, ww, 64,
                128, "gelu", biases=True, scale=True, ffw2=True, **kw),
            lambda h2=h2, w2=w2, tag=tag, kw=kw: qkv_case(
                inp, "float32 dec2" + tag, h2, w2, 128, 2, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: qkv_case(
                inp, "float32 dec1" + tag, hh, ww, 64, 1, **kw),
        ]
        cases += [
            lambda h3=h3, w3=w3, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate+pair+po(B,C,C) dec3/enc3" + tag, h3, w3,
                256, 640, "gate", pair=True, po=True, **kw),
            lambda h4=h4, w4=w4, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate+pair+po(B,C,C) latent (halo in device "
                "memory)" + tag, h4, w4, 512, 1280, "gate", pair=True,
                po=True, **kw),
            lambda h4=h4, w4=w4, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate+pair, no po (FHR) latent" + tag, h4, w4,
                512, 1280, "gate", pair=True, **kw),
            lambda h3=h3, w3=w3, tag=tag, kw=kw: ffn_case(
                inp, "float32 gate + 4 stacked + 1 maps, po(B,C,C) each (CHM "
                "dec3)" + tag, h3, w3, 256, 640, "gate", stacked=4, **kw),
            lambda h3=h3, w3=w3, tag=tag, kw=kw: qkv_case(
                inp, "float32 enc3/dec3" + tag, h3, w3, 256, 4, **kw),
            lambda h4=h4, w4=w4, tag=tag, kw=kw: qkv_case(
                inp, "float32 latent (halo in device memory)" + tag, h4, w4,
                512, 8, **kw),
            lambda h4=h4, w4=w4, tag=tag, kw=kw: split_case(
                inp, "float32 latent FHR q,k,v" + tag, h4, w4, 512, 3, **kw),
            lambda h3=h3, w3=w3, tag=tag, kw=kw: split_case(
                inp, "float32 SAB q,k dec3" + tag, h3, w3, 256, 2, **kw),
            lambda h2=h2, w2=w2, tag=tag, kw=kw: split_case(
                inp, "float32 SAB q,k dec2" + tag, h2, w2, 128, 2, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: split_case(
                inp, "float32 SAB q,k dec1" + tag, hh, ww, 64, 2, **kw),
            lambda h3=h3, w3=w3, tag=tag, kw=kw: conv_case(
                inp, "float32 LN + composite v dec3 256->256" + tag, h3, w3,
                256, 256, False, ln=True, **kw),
            lambda h2=h2, w2=w2, tag=tag, kw=kw: conv_case(
                inp, "float32 LN + composite v dec2 128->128" + tag, h2, w2,
                128, 128, False, ln=True, **kw),
            lambda hh=hh, ww=ww, tag=tag, kw=kw: conv_case(
                inp, "float32 LN + composite v dec1 64->64" + tag, hh, ww, 64,
                64, False, ln=True, **kw),
            lambda h3=h3, w3=w3, tag=tag, b=b: chm_case(
                inp, "float32 dec3" + tag, h3, w3, 256, 4, 4, batch=b,
                iters=2),
            lambda h2=h2, w2=w2, tag=tag, b=b: chm_case(
                inp, "float32 dec2" + tag, h2, w2, 128, 2, 4, batch=b,
                iters=2),
            lambda hh=hh, ww=ww, tag=tag, b=b: chm_case(
                inp, "float32 dec1" + tag, hh, ww, 64, 1, 3, batch=b,
                iters=2),
        ] + narrow
    # row 5 at the other shapes the float32 paths give it, each beside the
    # old tile on the same inputs (tile_ms): the derain preset's 15 tiles of
    # 320 (the LayerNorm forms are above), the harness's 256 x 256, the
    # train step's 2 x 192 x 192 and the padded 1920x1080 frame
    for b, hh, ww, tag in ((MAX_TILE_BATCH, TILE, TILE,
                            f", {MAX_TILE_BATCH} tiles"),
                           (1, 256, 256, ", 256 x 256"),
                           (2, 192, 192, ", 2 x 192 x 192"),
                           (1, 1088, 1920, ", 1080p")):
        shapes = row5_shapes(hh, ww)
        if b == MAX_TILE_BATCH:
            shapes = [a for a in shapes if not a[-1]]
        cases += [lambda a=a, b=b, tag=tag: conv_case(
            inp, "float32 " + a[0] + tag, *a[1:-1], ln=a[-1], batch=b,
            iters=2) for a in shapes]
    # csrc/ffn.cu, csrc/qkv_stats.cu, split_proj.cu, chm_stats.cu and
    # conv3x3.cu's float tile in float32, forced (off the paths now; their
    # checks against the plain versions stay), at the padded frame
    h2, w2, h3, w3, h4, w4 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    cases += [
        lambda: ffn_case(inp, "float32 gate+pair+po(B,C,C) dec3/enc3 on "
                         "ffn.cu", h3, w3, 256, 640, "gate", pair=True,
                         po=True, iters=2, tile=True),
        lambda: qkv_case(inp, "float32 enc3/dec3 on qkv_stats.cu", h3, w3,
                         256, 4, iters=2, tile=True),
        lambda: split_case(inp, "float32 latent FHR q,k,v on split_proj.cu "
                           "(halo in device memory)", h4, w4, 512, 3, iters=2,
                           tile=True),
        lambda: chm_case(inp, "float32 dec3 on chm_stats.cu", h3, w3, 256, 4,
                         4, iters=2, tile=True),
        lambda: conv_case(inp, "float32 LN + composite v dec3 256->256 on "
                          "conv3x3.cu", h3, w3, 256, 256, False, ln=True,
                          iters=2, tile=True),
    ]
    # under the fused plans: row 14 on level.cu at C = 256 and 512 (a
    # whole-frame run of each width, the latent's also at 15 tiles: the
    # halo's scratch of 49.9 and 78.0 MB), also against its split route;
    # row 11 at dec3's, dec2's and dec1's whole frame on csrc/attn_v_f32.cu
    # and at dec3's on attn_v.cu's float tile (forced); row 13 at the enc1
    # and enc2 pairs' whole frame, also against its split route
    tb, tl = MAX_TILE_BATCH, TILE
    (s3, c3, heads3, n3), (s4, c4, heads4, n4) = (RUN_LEVELS["enc3"],
                                                  RUN_LEVELS["latent"])
    cases += [
        lambda: run_case(inp, f"float32 enc3 x{n3}, whole frame", 1, h // s3,
                         w // s3, c3, heads3, n3, iters=1),
        lambda: run_case(inp, f"float32 latent x{n4}, whole frame (halo in "
                         "device memory)", 1, h // s4, w // s4, c4, heads4, n4,
                         iters=1),
        lambda: run_case(inp, f"float32 latent x{n4}, {tb} tiles (halo in "
                         "device memory)", tb, tl // s4, tl // s4, c4, heads4,
                         n4, iters=1),
        lambda: attn_v_case(inp, "float32 merge dec3, whole frame", 1, 4,
                            h // 16, w // 16, 4, 256, iters=3),
        lambda: attn_v_case(inp, "float32 merge dec2, whole frame", 1, 4,
                            h // 16, w // 16, 8, 128, iters=2),
        lambda: attn_v_case(inp, "float32 merge dec1, whole frame", 1, 3,
                            h // 16, w // 16, 16, 64, iters=2),
        lambda: attn_v_case(inp, "float32 merge dec3, whole frame on "
                            "attn_v.cu", 1, 4, h // 16, w // 16, 4, 256,
                            iters=2, tile=True),
        lambda: two_stage_case(inp, "float32 enc1 pair", "pair", 1, h, w, 64,
                               128, 128, iters=2),
        lambda: two_stage_case(inp, "float32 enc2 pair", "pair", 1, h // 2,
                               w // 2, 128, 256, 256, iters=2),
    ]
    return cases


def run_cases(cases: list) -> list[dict]:
    out = []
    for make in cases:
        t0 = time.perf_counter()
        res = make()
        if res is None:  # left out by --cases
            continue
        res["case_seconds"] = time.perf_counter() - t0
        emit({"phase": "kernel_case", **res})
        out.append(res)
        torch.cuda.empty_cache()
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


def slice_tag(config: str, fuse: tuple, dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return config + "_f32" + ("_fused" if fuse else "")
    return config + ("_two_stage" if fuse else "")


def run_slice(config: str, seed: int, n_frames: int, width: int,
              height: int, trace: bool = False, fuse: tuple = (),
              dtype: torch.dtype = torch.bfloat16, keep: list | None = None,
              against: list | None = None, table: dict | None = None,
              tag: str | None = None) -> dict:
    """Stream the frames through InferenceEngine.step; ``keep``: a list the
    outputs are appended to; ``against``: the outputs of the same seed,
    frames and type under another fused plan, which computes the same
    function (PSNR at least SLICE_MIN_PSNR a frame); ``table``, ``tag``: the
    launches a frame and the path's name where they are not those of the
    720p paths."""
    opt = options_of(config)
    model = build_model(opt, device="cuda", fuse=fuse,
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    cfg = model.cfg
    scale = cfg.sr_scale if cfg.variant == "sr" else 1  # HR frames in and out
    engine = InferenceEngine(model, mode="whole", dtype=dtype)
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
    if table is None:
        table = (LAUNCHES_PER_CALL_F32[config + ("_fused" if fuse else "")]
                 if dtype == torch.float32
                 else LAUNCHES_PER_CALL[slice_tag(config, fuse, dtype)])
    tag = tag or slice_tag(config, fuse, dtype)
    for name, per_frame in table.items():
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
    other = {}
    if against is not None:
        require(len(against) == n_frames, "nothing to compare with")
        other = dict(
            psnr_vs_fuse_none_db=[psnr(a, b) for a, b in zip(outs, against)],
            max_abs_err_vs_fuse_none=max(float(np.abs(a - b).max())
                                         for a, b in zip(outs, against)))
    if keep is not None:
        keep.extend(outs)
    res = dict(
        phase="slice", path=tag, config=config, plan=list(fuse),
        variant=cfg.variant,
        option_file=os.path.relpath(CONFIGS[config][0], ROOT),
        frame=[height, width, 3],
        padded=list(turtle_mod.padded_hw(cfg, height // scale, width // scale)),
        dtype=str(dtype).replace("torch.", ""),
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
        peak_memory_gib=peak_gb, **other)
    emit(res)
    if trace:
        profile_frames(engine, frames[:3], res["ms_per_frame_after_warmup"],
                       config, plan=list(fuse))
    require(min(psnrs) >= SLICE_MIN_PSNR,
            f"kernel path and plain path disagree: PSNR {psnrs}")
    if other:
        require(min(other["psnr_vs_fuse_none_db"]) >= SLICE_MIN_PSNR,
                f"the plan {fuse} and fuse=() disagree: PSNR "
                f"{other['psnr_vs_fuse_none_db']}")
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


def plan_suffix(fuse: tuple) -> str:
    return {(): "", FUSED_PLAN: "_fused", TWO_STAGE: "_two_stage"}[tuple(fuse)]


def tiled_tag(config: str, plan: tuple) -> str:
    name = "tiled" + plan_suffix(plan)
    return name if config == "gopro" else f"{config}_{name}"


def run_tiled(config: str, seed: int, width: int, height: int,
              trace: bool, plans: tuple = None, n: int = FRAMES_PER_RUN,
              dtype: torch.dtype = torch.bfloat16, table: dict | None = None,
              name: str | None = None) -> dict:
    """One configuration tiled at its task's preset through cli.infer.main,
    under each of its plans (TILED_PLANS by default), against the plain
    versions on the card, in bf16 or (--dtype float32) float32. The
    weights are a state_dict file written from the seed (scales drawn), the
    frames a folder of PNGs (the high-resolution ones for SR); main builds
    the model, the tiled engine and the loop itself. ``table``, ``name``:
    the launches a model call and the path's name (one plan) where they are
    not those of the 720p paths."""
    from PIL import Image

    plans = TILED_PLANS[config] if plans is None else plans
    f32 = dtype == torch.float32
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
            if f32:
                argv += ["--dtype", "float32"]
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
        for fuse in plans:
            tag = name or tiled_tag(config, fuse) + (
                "_f32" if f32 else "")
            res = cli(tag, fuse)
            require(res["frames"] == n, f"{tag}: {res['frames']} frames")
            # an output's copy to the host is queued behind the next frame's
            # kernels (one stream), so fetch i returns when frame i + 1 is
            # done and the last two fetches come together: the times of
            # frames 2 .. n - 1 are the differences but the last
            # the gaps between fetches while the writer's queue (2 deep)
            # fills: a transient, not the app's rate
            clock = res["fetch_clock"]
            ms = [(b - a) * 1e3 for a, b in zip(clock, clock[1:])]
            psnrs = [psnr(a, b) for a, b in zip(res["outs"], plain["outs"])]
            for i, out in enumerate(res["outs"]):
                require(out.shape == (height, width, 3),
                        f"{tag} frame {i}: output shape {out.shape}")
            per_calls = table or {
                k: v if f32 else TILED_LAUNCHES.get(config, {}).get(k, v)
                for k, v in (LAUNCHES_PER_CALL_F32[config] if f32 else
                             LAUNCHES_PER_CALL[config + plan_suffix(fuse)]
                             ).items()}  # the bf16 sab.cu calls at 15 tiles
            for kernel, per_call in per_calls.items():
                require(res["launches"][kernel] == per_call * calls * n,
                        f"{tag} {kernel}: {res['launches'][kernel]} launches "
                        f"over {n} frames of {calls} model calls, expected "
                        f"{per_call} per call")
            out = dict(
                phase="tiled", path=tag, config=config, variant=cfg.variant,
                task=task, plan=list(fuse),
                entry="turtlevsr_tpu_torch.cli.infer.main",
                frame=[height, width, 3], tile=t,
                tile_overlap=preset["tile_overlap"], tiles=n_tiles,
                model_tile=t // scale, max_tile_batch=MAX_TILE_BATCH,
                model_calls_per_frame=calls,
                dtype="float32" if f32 else "bfloat16", frames=n,
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
            for fuse in plans:
                tag = name or tiled_tag(config, fuse) + (
                    "_f32" if f32 else "")
                model = build_model(options_of(config), device="cuda",
                                    fuse=fuse)
                model.load_state_dict(torch.load(weights, weights_only=True))
                engine = InferenceEngine(
                    model, mode="tiled", tile=preset["tile"],
                    tile_overlap=preset["tile_overlap"],
                    max_tile_batch=MAX_TILE_BATCH, dtype=dtype)
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
# the app: turtlevsr_tpu_torch.app on a video file
# ---------------------------------------------------------------------------


def decoded_video(path: str) -> dict:
    """Frame count and size of an mp4, decoded by cv2."""
    import cv2

    cap = cv2.VideoCapture(path)
    n, shape = 0, None
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        n, shape = n + 1, fr.shape
    cap.release()
    return {"frames": n, "height": shape and shape[0],
            "width": shape and shape[1]}


def run_app(seed: int, width: int, height: int) -> dict:
    """``app.restore_video`` for "Video Deblurring (GoPro)" as the web app
    calls it, on an mp4 of APP_FRAMES synthetic frames written by cv2, the
    shipped option file and reference-format weights from the seed as
    ``custom_model_path``: whole frames (tile 0) and tiled (APP_TILE, the
    engine's overlap), then ``restore_image`` once. Each is held bit for bit
    to an InferenceEngine run of the same weights, grid and decoded frames
    (PNGs and launches a frame), and within SLICE_MIN_PSNR to the same app
    under the plain versions; the four videos' frame counts and sizes."""
    import cv2
    from PIL import Image

    from turtlevsr_tpu_torch import app as app_mod

    task = "Video Deblurring (GoPro)"
    n = APP_FRAMES
    work = tempfile.mkdtemp(prefix="chip_smoke_app_")
    dirs = []  # the app's job folders
    out = {}
    try:
        model = build_model(options_of("gopro"), device="cuda",
                            generator=torch.Generator().manual_seed(seed))
        randomise_scales(model, seed + 1)
        weights = os.path.join(work, "weights.pth")
        torch.save({"params": model.state_dict()}, weights)  # the published form
        del model  # the peaks below are the app's

        def engine_model():
            m = build_model(options_of("gopro"), device="cuda")
            m.load_state_dict(torch.load(weights, weights_only=True)["params"])
            return m

        video = os.path.join(work, "in.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (width, height))
        for fr in make_frames(seed + 2, n, height, width):
            vw.write((fr[..., ::-1] * 255.0).round().astype(np.uint8))
        vw.release()
        kw = dict(ckpt_dir=work, options_dir=os.path.join(ROOT, "options"),
                  custom_model_path=weights)

        def app_run(tile: int) -> dict:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels_pkg.reset_launch_counts()
            t0 = time.perf_counter()
            res = app_mod.restore_video(video, task, tile=tile, **kw)
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = kernels_pkg.launch_counts()
            res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            dirs.append(res["work"])
            require(res["status"] == "ok", f"app tile={tile}: {res['status']}")
            res["outs"] = [np.asarray(Image.open(os.path.join(res["frames"], f)))
                           for f in sorted(os.listdir(res["frames"]))]
            torch.cuda.empty_cache()
            return res

        for tile in (0, APP_TILE):
            tag = "app_tiled" if tile else "app_whole"
            res = app_run(tile)
            files = sorted(os.listdir(res["input_frames"]))
            require(len(files) == n and len(res["outs"]) == n,
                    f"{tag}: {len(files)} frames decoded, {len(res['outs'])} "
                    f"restored, expected {n}")
            # the same weights, grid and decoded frames straight through the
            # engine (the route of cli.infer and the slice phase)
            eng = (InferenceEngine(engine_model(), mode="tiled", tile=tile)
                   if tile else InferenceEngine(engine_model()))
            torch.cuda.synchronize()
            kernels_pkg.reset_launch_counts()
            direct = [img_from_float(eng.step(read_rgb(os.path.join(
                res["input_frames"], f)))) for f in files]
            direct_launches = kernels_pkg.launch_counts()
            _, _, _, his, wis = eng.tile_plan(height, width)
            tiles = len(his) * len(wis) if tile else 1
            del eng
            torch.cuda.empty_cache()
            bits = all(np.array_equal(a, b) for a, b in zip(res["outs"], direct))
            require(bits, f"{tag}: the app's PNGs differ from the engine's")
            require(res["launches"] == direct_launches,
                    f"{tag}: launches {res['launches']} against the engine's "
                    f"{direct_launches}")
            if not tile:
                want = {k: v * n for k, v in LAUNCHES_PER_CALL["gopro"].items()}
                require(all(res["launches"][k] == v for k, v in want.items()),
                        f"{tag}: launches {res['launches']}, expected {want}")
            with plain_versions():
                plain = app_run(tile)
            require(not any(plain["launches"].values()),
                    "the plain run must launch no kernel")
            psnrs = [psnr(a / 255.0, b / 255.0)
                     for a, b in zip(res["outs"], plain["outs"])]
            videos = {k: decoded_video(res[k]) for k in
                      ("video", "comparison", "side_by_side", "slider")}
            for k, v in videos.items():
                require(v == {"frames": n, "height": height, "width": (
                    2 * width if k == "side_by_side" else width)},
                        f"{tag}: {k} video {v}")
            # the gaps between fetches while the writer's queue (2 deep)
            # fills: a transient, not the app's rate
            clock = res["fetch_clock"]
            ms = [(b - a) * 1e3 for a, b in zip(clock, clock[1:])]
            # the host's share of a frame: one PNG decoded (main thread) and
            # one written (the writer thread), alone
            png_in = os.path.join(res["input_frames"], files[0])
            t0 = time.perf_counter()
            for _ in range(3):
                read_rgb(png_in)
            decode_ms = (time.perf_counter() - t0) * 1e3 / 3
            t0 = time.perf_counter()
            for _ in range(3):
                Image.fromarray(res["outs"][0]).save(
                    os.path.join(work, "probe.png"))
            encode_ms = (time.perf_counter() - t0) * 1e3 / 3
            out[tag] = emit(dict(
                phase="app", entry="turtlevsr_tpu_torch.app.restore_video",
                task=task, frame=[height, width, 3], frames=n, tile=tile,
                tile_overlap=128 if tile else None, tiles=tiles,
                dtype="bfloat16", seconds=res["seconds"], fps=res["fps"],
                ms_per_frame=1e3 / res["fps"], ms_between_fetches=ms,
                launches=res["launches"], launches_per_frame={
                    k: v / n for k, v in res["launches"].items()},
                bit_equal_to_engine=bits,
                launches_equal_to_engine=res["launches"] == direct_launches,
                psnr_vs_plain_db=psnrs, min_psnr_db=SLICE_MIN_PSNR,
                plain_fps=plain["fps"], videos=videos,
                host_png_decode_ms=decode_ms, host_png_encode_ms=encode_ms,
                peak_memory_gib=res["peak_memory_gib"]))
            require(min(psnrs) >= SLICE_MIN_PSNR,
                    f"{tag}: the app's kernel path and plain path disagree: "
                    f"PSNR {psnrs}")
        # one image through restore_image: the first decoded frame, against a
        # fresh whole-frame engine's first step on it
        first = os.path.join(dirs[0], "frames",
                             sorted(os.listdir(os.path.join(dirs[0],
                                                            "frames")))[0])
        kernels_pkg.reset_launch_counts()
        img = app_mod.restore_image(first, task, **kw)
        img_launches = kernels_pkg.launch_counts()
        dirs.append(img["work"])
        got = np.asarray(Image.open(img["image"]))
        sbs = np.asarray(Image.open(img["side_by_side"]))
        want = img_from_float(InferenceEngine(engine_model()).step(
            read_rgb(first)))
        require(np.array_equal(got, want),
                "restore_image: its PNG differs from the engine's")
        require(sbs.shape == (height, 2 * width, 3),
                f"restore_image: side by side {sbs.shape}")
        require(all(img_launches[k] == v for k, v in
                    LAUNCHES_PER_CALL["gopro"].items()),
                f"restore_image: launches {img_launches}")
        out["app_image"] = emit(dict(
            phase="app", entry="turtlevsr_tpu_torch.app.restore_image",
            task=task, image=list(got.shape), side_by_side=list(sbs.shape),
            bit_equal_to_engine=True, launches=img_launches))
    finally:
        for d in [work, *dirs]:
            shutil.rmtree(d, ignore_errors=True)
    return out


def read_rgb(path: str) -> np.ndarray:
    """A frame as the app reads it: RGB, float32 in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


# ---------------------------------------------------------------------------
# the complexity and speed harness, as its users call it
# ---------------------------------------------------------------------------


def trace_busy(events: list, calls: int) -> dict:
    """Device busy a model call (the union of the card's kernel intervals)
    and the card's idle share of the traced window (from the first host
    operation to the last kernel's end), from a Chrome trace's events."""
    kern = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "kernel")
    busy, end = 0.0, -1.0
    for a, b in kern:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    start = min(e["ts"] for e in events if e.get("cat") in ("cpu_op",
                                                           "kernel"))
    window = end - start
    return {"device_busy_ms_per_call": busy / 1e3 / calls,
            "window_ms_per_call": window / 1e3 / calls,
            "idle_share": 1.0 - busy / window}


def require_launches(what: str, counts: dict, per_call: dict,
                     calls: int) -> None:
    for name, n in per_call.items():
        require(counts[name] == n * calls,
                f"{what}: {name}: {counts[name]} launches over {calls} "
                f"model calls, expected {n} per call")


def bench_main(argv: list) -> tuple[dict, dict, float]:
    """(cli.bench.main's result, the launches of its run, its seconds): the
    counts set to 0 just before and read just after."""
    kernels_pkg.reset_launch_counts()
    t0 = time.perf_counter()
    res = bench_cli.main(argv)
    seconds = time.perf_counter() - t0
    return res, kernels_pkg.launch_counts(), seconds


def bench_first_call_vs_plain(argv: list, fuse: tuple, first: np.ndarray,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> tuple[float, float]:
    """(PSNR, max |difference|) of the first model call of an inference
    run of cli.bench.main against the same call under plain_versions() on
    the card: the harness's own model (its seed-0 weights, its type, the
    plan), input and fresh cache."""
    args = bench_cli.parse_args(argv)
    h, w = args.size
    model = build_model(load_options(args.opt, is_train=False),
                        device="cuda", dtype=dtype, fuse=fuse)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 2, h, w, 3)).to(
        "cuda", dtype)
    with torch.inference_mode(), plain_versions():
        out, _ = model(x, model.init_cache(1, h, w, dtype))
    plain = out.float().cpu().numpy()
    del model, out
    torch.cuda.empty_cache()
    require(plain.shape == first.shape, f"plain {plain.shape}, kernels "
            f"{first.shape}")
    return psnr(first, plain), float(np.abs(first - plain).max())


def run_bench(slice_params: dict) -> dict:
    """cli.bench.main's modes on the card: inference of `gopro`, `derain`
    and `sr` and of `gopro` under ("two_stage",), a traced run, the train
    step and the numerics whole-frame and tiled; each run's parameters and
    MACs against the model's, its launches a model call against the slice
    phase's, an inference run's first output against the plain versions',
    its result line. Returns the launches of each run."""
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    size = ["--size", str(BENCH_SIZE), str(BENCH_SIZE)]
    try:
        for config, fuse in BENCH_RUNS:
            tag = "bench_" + config + plan_suffix(fuse)
            opt = options_of(config)
            cfg = model_config_from_options(opt)
            argv = ["-opt", CONFIGS[config][0], *size, "--iters",
                    str(BENCH_ITERS)]
            if fuse:
                argv += ["--fuse", *fuse]
            res, counts, seconds = bench_main(argv)
            with torch.device("meta"):
                params = sum(p.numel() for p in turtle_mod.Turtle(
                    cfg).parameters())
            side = BENCH_SIZE * (cfg.sr_scale if cfg.variant == "sr" else 1)
            require(res["params"] == slice_params.get(config, params)
                    == params, f"{tag}: {res['params']} parameters")
            require(res["macs"] == BENCH_MACS[config],
                    f"{tag}: MACs {res['macs']}, expected "
                    f"{BENCH_MACS[config]}")
            require(res["finite"] and res["out_shape"] == [1, side, side, 3],
                    f"{tag}: output {res['out_shape']}, finite "
                    f"{res['finite']}")
            require_launches(tag, counts, LAUNCHES_PER_CALL[
                config + plan_suffix(fuse)], res["model_calls"])
            db, err = bench_first_call_vs_plain(argv, fuse,
                                                res["first_output"])
            require(kernels_pkg.launch_counts() == counts,
                    f"{tag}: the plain call must launch no kernel")
            emit(dict(
                phase="bench", run=tag, entry="turtlevsr_tpu_torch.cli.bench",
                argv=argv, option_file=os.path.relpath(CONFIGS[config][0],
                                                       ROOT),
                plan=list(fuse), input=[1, 2, BENCH_SIZE, BENCH_SIZE, 3],
                output=res["out_shape"], params=res["params"],
                params_m=round(res["params"] / 1e6, 2), macs=res["macs"],
                gmacs=res["macs"] / 1e9, fps=res["fps"],
                ms_per_image=res["ms_per_image"], iters=res["iters"],
                model_calls=res["model_calls"],
                warmup_seconds=res["warmup_seconds"],
                model_tflop_per_s=2 * res["macs"] * res["fps"] / 1e12,
                launches_per_call={k: v / res["model_calls"]
                                   for k, v in counts.items()},
                first_call_psnr_vs_plain_db=db, min_psnr_db=SLICE_MIN_PSNR,
                first_call_max_abs_err_vs_plain=err, seconds=seconds))
            require(db >= SLICE_MIN_PSNR, f"{tag}: the first call's output "
                    f"and the plain versions' disagree: PSNR {db} dB")
            out[tag] = counts

        # --trace_dir: a torch.profiler trace of the timed calls, with the
        # card's kernels in it
        logdir = os.path.join(work, "trace")
        argv = ["-opt", CONFIGS["gopro"][0], *size, "--iters",
                str(BENCH_TRACE_ITERS), "--warmup", "1", "--trace_dir",
                logdir]
        res, counts, seconds = bench_main(argv)
        traces = [f for f in os.listdir(logdir) if f.startswith("trace_")
                  and f.endswith(".json")]
        require(len(traces) == 1, f"--trace_dir wrote {traces}")
        with open(os.path.join(logdir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        on_card = sum(1 for e in events if e.get("cat") == "kernel")
        require(on_card > 0, "the trace holds no kernel of the card")
        require_launches("bench_gopro_trace", counts,
                         LAUNCHES_PER_CALL["gopro"], res["model_calls"])
        emit(dict(phase="bench", run="bench_gopro_trace", argv=argv,
                  trace_file=traces[0], trace_bytes=os.path.getsize(
                      os.path.join(logdir, traces[0])),
                  trace_events=len(events), card_kernel_events=on_card,
                  card_kernels_per_call=on_card / res["iters"],
                  port_launches_per_call=sum(  # one count a wrapper
                      counts[k] for k in kernels_pkg._counted())
                  / res["model_calls"],
                  **trace_busy(events, res["iters"]),
                  fps=res["fps"], model_calls=res["model_calls"],
                  seconds=seconds))
        out["bench_gopro_trace"] = counts

        # --train_step at the GoPro recipe
        argv = ["-opt", CONFIGS["gopro"][0], "--train_step", "--iters",
                str(BENCH_TRAIN_ITERS), "--warmup", "1"]
        res, counts, seconds = bench_main(argv)
        per_step = train_launches("gopro", (), res["frames"])
        require_launches("bench_train_gopro", counts, per_step, res["steps"])
        require(res["value"] > 0, f"train step: {res['value']} ms")
        emit(dict(phase="bench", run="bench_train_gopro", argv=argv,
                  metric=res["metric"], ms_per_step=res["ms"],
                  value=res["value"], iters_per_day=res["iters_per_day"],
                  batch=res["batch"], frames=res["frames"],
                  patch=res["patch"], steps=res["steps"],
                  warmup_seconds=res["warmup_seconds"],
                  launches_per_step={k: v / res["steps"]
                                     for k, v in counts.items()},
                  seconds=seconds))
        out["bench_train_gopro"] = counts

        # --numerics whole-frame, then tiled, into one artifact in the
        # scratch folder (never the repository's NUMERICS.json)
        artifact = os.path.join(work, "numerics.json")
        side, tile, overlap = BENCH_TILED
        # tiles of 128: dec1's 8 x 8 window tokens take row 7's wgmma body
        # (only the 20 x 20 grid of a 320 tile stays on sab.cu), as whole
        # frames do
        tiled_call = LAUNCHES_PER_CALL["gopro"]
        for i, (tag, argv, per_call, frames_calls) in enumerate((
                ("bench_numerics", [*size, "--numerics"],
                 LAUNCHES_PER_CALL["gopro"], bench_cli.NUMERICS_FRAMES),
                ("bench_numerics_tiled",
                 ["--size", str(side), str(side), "--numerics_tile",
                  str(tile), "--numerics_overlap", str(overlap)], tiled_call,
                 None))):
            argv = ["-opt", CONFIGS["gopro"][0], *argv, "--numerics_json",
                    artifact]
            art, counts, seconds = bench_main(argv)
            if frames_calls is None:  # chunks of 3 tiles a frame
                frames_calls = bench_cli.NUMERICS_TILED_FRAMES * -(
                    -art["tiles"] // bench_cli.NUMERICS_TILE_BATCH)
                require(art["tiles"] == 4, f"{tag}: {art['tiles']} tiles")
            require_launches(tag, counts, per_call, frames_calls)
            require(min(art["per_frame_db"]) >= SLICE_MIN_PSNR,
                    f"{tag}: PSNR {art['per_frame_db']}")
            with open(artifact) as f:
                merged = json.load(f)
            require(merged[-1] == art and len(merged) == i + 1,
                    f"{tag}: the artifact holds {len(merged)} entries")
            emit(dict(phase="bench", run=tag, argv=argv,
                      metric=art["metric"], per_frame_db=art["per_frame_db"],
                      min_db=art["min_db"], limit_db=SLICE_MIN_PSNR,
                      model_calls=frames_calls, artifact_entries=len(merged),
                      seconds=seconds))
            out[tag] = counts
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def run_bench_f32() -> dict:
    """cli.bench.main --dtype float32 on `gopro` at 256 x 256: the model's
    calls in float32 on the widened mma.sync bodies, its launches a model
    call, its first call against the same call under the plain versions in
    float32 on the card (TF32 off), its result line."""
    tag = "bench_gopro_f32"
    argv = ["-opt", CONFIGS["gopro"][0], "--size", str(BENCH_SIZE),
            str(BENCH_SIZE), "--iters", str(BENCH_F32_ITERS), "--dtype",
            "float32"]
    res, counts, seconds = bench_main(argv)
    require(res["finite"] and res["out_shape"] == [1, BENCH_SIZE, BENCH_SIZE,
                                                   3],
            f"{tag}: output {res['out_shape']}, finite {res['finite']}")
    require(res["macs"] == BENCH_MACS["gopro"], f"{tag}: MACs {res['macs']}")
    require_launches(tag, counts, LAUNCHES_PER_CALL_F32["gopro_small"],
                     res["model_calls"])
    db, err = bench_first_call_vs_plain(argv, (), res["first_output"],
                                        torch.float32)
    require(kernels_pkg.launch_counts() == counts,
            f"{tag}: the plain call must launch no kernel")
    emit(dict(
        phase="bench", run=tag, entry="turtlevsr_tpu_torch.cli.bench",
        argv=argv, option_file=os.path.relpath(CONFIGS["gopro"][0], ROOT),
        dtype="float32", input=[1, 2, BENCH_SIZE, BENCH_SIZE, 3],
        output=res["out_shape"], params=res["params"], macs=res["macs"],
        fps=res["fps"], ms_per_image=res["ms_per_image"], iters=res["iters"],
        model_calls=res["model_calls"], warmup_seconds=res["warmup_seconds"],
        model_tflop_per_s=2 * res["macs"] * res["fps"] / 1e12,
        launches_per_call={k: v / res["model_calls"]
                           for k, v in counts.items()},
        first_call_psnr_vs_plain_db=db, min_psnr_db=SLICE_MIN_PSNR,
        first_call_max_abs_err_vs_plain=err, seconds=seconds))
    require(db >= SLICE_MIN_PSNR, f"{tag}: the first call's output and the "
            f"plain versions' disagree: PSNR {db} dB")
    return {tag: counts}


def run_f32_paths(seed: int, width: int, height: int, trace: bool) -> dict:
    """The float32 serving paths: `gopro` whole-frame through
    InferenceEngine(dtype=torch.float32), then the same under the full plan
    (rows 14, 11 and 13 in float32; its frames also held against the first
    path's), `derain` tiled through cli.infer.main --dtype float32,
    cli.bench.main --dtype float32; each against the plain versions in
    float32 on the card. Returns the launches of each."""
    out, seconds, fuse_none = {}, {}, []
    t0 = time.perf_counter()
    res = run_slice("gopro", seed, F32_FRAMES["gopro_f32"], width, height,
                    trace=trace, dtype=torch.float32, keep=fuse_none)
    out["gopro_f32"] = res["launches"]
    seconds["gopro_f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_slice("gopro", seed, F32_FRAMES["gopro_f32_fused"], width,
                    height, trace=trace, fuse=FULL_PLAN, dtype=torch.float32,
                    against=fuse_none)
    out["gopro_f32_fused"] = res["launches"]
    seconds["gopro_f32_fused"] = time.perf_counter() - t0
    del fuse_none
    t0 = time.perf_counter()
    out.update({tag: r["launches"] for tag, r in run_tiled(
        "derain", seed, width, height, trace, plans=((),),
        n=F32_FRAMES["derain_tiled_f32"], dtype=torch.float32).items()})
    seconds["derain_tiled_f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(run_bench_f32())
    seconds["bench_gopro_f32"] = time.perf_counter() - t0
    emit({"phase": "f32_paths_done", "seconds": seconds})
    return out


def run_frame_sizes(seed: int, smi_line: str) -> dict:
    """The frame-sizes phase (FRAME_SIZE_PATHS): 1920x1080 whole-frame in
    bf16 and float32 through InferenceEngine, the deblur preset tiled at
    1920x1080 and the denoise preset at 854x480 through cli.infer.main;
    each against the same frames through the plain versions on the card
    (40 dB in bf16, 80 in float32), its exact launches a model call
    (LAUNCHES_FRAME_SIZES), ms a frame and peak memory, beside the card's
    name and power limit. Returns the launches of each."""
    out, summary = {}, {}
    for tag, (config, mode, dtype, (width, height), n) in (
            FRAME_SIZE_PATHS.items()):
        t0 = time.perf_counter()
        if mode == "whole":
            res = run_slice(config, seed, n, width, height, dtype=dtype,
                            table=LAUNCHES_FRAME_SIZES[tag], tag=tag)
        else:
            res = run_tiled(config, seed, width, height, False, plans=((),),
                            n=n, dtype=dtype, table=LAUNCHES_FRAME_SIZES[tag],
                            name=tag)[tag]
        min_db = SLICE_MIN_PSNR if dtype == torch.bfloat16 else F32_MIN_PSNR
        require(min(res["psnr_vs_plain_db"]) >= min_db,
                f"{tag}: PSNR to the plain path {res['psnr_vs_plain_db']} "
                f"below {min_db} dB")
        out[tag] = res["launches"]
        summary[tag] = dict(
            frame=res["frame"], dtype=str(dtype).replace("torch.", ""),
            mode=mode, ms_per_frame=res["ms_per_frame_after_warmup"],
            min_psnr_vs_plain_db=min(res["psnr_vs_plain_db"]),
            min_psnr_db=min_db, peak_memory_gib=res["peak_memory_gib"],
            launches_per_frame=res["launches_per_frame"],
            seconds=time.perf_counter() - t0)
    emit({"phase": "frame_sizes", "nvidia_smi_name_power_limit": smi_line,
          "paths": summary})
    return out


# ---------------------------------------------------------------------------
# training: the BPTT train step over a clip
# ---------------------------------------------------------------------------


def train_launches(config: str, fuse: tuple, frames: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """Exact launches of one train step, from the launches of one model
    call: each frame launches its kernels twice, in the forward and in the
    per-frame checkpoint's recompute (the non-reentrant checkpoint stops its
    recompute once every saved tensor is back; the last one is the loss's,
    after the frame's last kernel, so every kernel launches again); the
    backward adds one launch of the other lattice kernel per lattice call
    (each permutation is the other's gradient) and no other kernel (the
    other Functions' backward is autograd through the plain versions).
    float32: the float32 paths' launches a model call at the step's small
    maps (none on a bf16-only body)."""
    per = (LAUNCHES_PER_CALL_F32[config + "_small" * (config == "gopro")]
           if dtype == torch.float32 and not fuse
           else LAUNCHES_PER_CALL[config + plan_suffix(fuse)])
    out = {k: 2 * frames * v for k, v in per.items()}
    out["lattice_split"] += frames * per["lattice_merge"]
    out["lattice_merge"] += frames * per["lattice_split"]
    return out


def train_clips(seed: int, b: int, t: int, size: int, scale: int):
    """gt: b clips of t frames of make_frames' drifting pattern (one seed a
    clip), size x size; lq: the same with noise (for SR box-averaged to size
    / scale first). (B, T, H, W, 3) float32 in [0, 1]."""
    gt = np.stack([np.stack(make_frames(seed + i, t, size, size))
                   for i in range(b)])
    lq = gt
    if scale > 1:
        lq = gt.reshape(b, t, size // scale, scale, size // scale, scale,
                        3).mean(axis=(3, 5))
    noise = np.random.RandomState(seed + b).standard_normal(lq.shape)
    return np.clip(lq + 0.1 * noise, 0.0, 1.0).astype(np.float32), gt


def grad_rel(got: dict, want: dict) -> float:
    """|got - want| / |want|, L2 over every tensor of ``want``."""
    num = sum(float((got[n].float() - w.float()).square().sum())
              for n, w in want.items())
    den = sum(float(w.float().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def profile_train(step, state, lq, gt, untraced_ms: float,
                  config: str) -> None:
    """Device time by kernel name over one more train step, from
    torch.profiler: the share of the port's kernels (names with "turtle";
    the lattice ones, the only kernels of the backward, apart) and the
    device's idle share against the untraced step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, lq, gt)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    own = sum(ms for k, ms, _ in rows if "turtle" in k)
    lattice = sum(ms for k, ms, _ in rows if "turtle" in k and "lattice" in k)
    emit({"phase": "train_profile", "config": config, "steps": 1,
          "own_kernels_ms_per_step": own,
          "lattice_kernels_ms_per_step": lattice,
          "device_busy_ms_per_step": busy if rows else "not measured",
          "ms_per_step_untraced": untraced_ms,
          "own_kernels_share_of_busy": own / busy if rows else None,
          "device_idle_share": max(0.0, 1.0 - busy / untraced_ms) if rows
          else "not measured",
          "top_device_ms_per_step": [
              {"name": k[:80], "ms": ms, "calls": n} for k, ms, n in rows[:30]]})


def run_train(config: str, seed: int, fuse: tuple, steps: int,
              trace: bool, dtype: torch.dtype = torch.bfloat16,
              fp32_ref: dict | None = None) -> dict:
    """``make_train_step`` on the card at the option file's training recipe
    (full width and depth, bf16 compute from float32 masters, BPTT over the
    clip, each frame checkpointed), seeded weights with the scales drawn,
    synthetic clips from the seed: ms per step, the losses, peak memory,
    the exact launches a step; then the gradient at the initial weights of
    the kernel route (the first step's) and of the plain versions on the
    card in bf16 and in float32, each held to the float32 one. ``fp32_ref``:
    a dict the float32 plain loss and gradient are put into.

    dtype float32 (``compute_dtype=torch.float32``; fuse=() only): the
    kernels' float32 bodies forward, and the first step's loss and gradient
    held to ``fp32_ref``'s, the plain versions' in float32 on the same
    seed, weights and clips (computed once, by the bf16 run)."""
    f32 = dtype == torch.float32
    require(not f32 or (not fuse and fp32_ref),
            "the float32 step needs the float32 plain gradient of `fuse=()`")
    path, overrides = CONFIGS[config]
    opt = load_options(path, is_train=True)
    opt.update(overrides)
    train_opt, ds = opt["train"], opt["datasets"]["train"]
    b, t = int(ds["batch_size_per_gpu"]), int(opt["n_sequence"])
    size = int(ds["gt_size"])
    model = build_model(opt, device="cuda", fuse=fuse,
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    cfg = model.cfg
    scale = cfg.sr_scale if cfg.variant == "sr" else 1
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    lq_np, gt_np = train_clips(seed + 2, b, t, size, scale)
    lq, gt = torch.from_numpy(lq_np).cuda(), torch.from_numpy(gt_np).cuda()
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    state = TrainState.create(init, tx)
    # each frame remat; bf16 from the float32 masters, or float32
    step = make_train_step(cfg, tx, compute_dtype=dtype, fuse=fuse)

    # main path: counts set to 0 just before, read just after; the peak of
    # device memory counts what earlier phases left allocated, given beside
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    kernels_pkg.reset_launch_counts()
    times, losses, g_k = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = step(state, lq, gt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["l_pix"]))
        if i == 0:  # the gradient at the initial weights, kernels forward
            g_k = {n: p.grad.detach().clone()
                   for n, p in state.params.items()}
    counts = kernels_pkg.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = train_launches(config, fuse, t, dtype)
    common = dict(
        phase="train", config=config, plan=list(fuse), variant=cfg.variant,
        option_file=os.path.relpath(path, ROOT),
        params=sum(p.numel() for p in init.values()), batch=b, frames=t,
        gt_size=size, lq_size=size // scale,
        compute_dtype=str(dtype).replace("torch.", ""),
        masters="float32", remat="each frame, policy nothing",
        optimizer=dict(type="AdamW", betas=list(tx.betas), eps=tx.eps,
                       weight_decay=tx.weight_decay),
        lr_of_steps=[tx.schedule(i) for i in range(steps)],
        steps=steps, ms_per_step=times,
        ms_per_step_median_after_first=float(np.median(times[1:]))
        if steps > 1 else None,
        losses=losses, peak_memory_gib=peak_gb,
        memory_allocated_before_gib=before_gb, launches=counts,
        launches_per_step={k: v / steps for k, v in counts.items()},
        nonzero_grad_share=sum(bool(g.any()) for g in g_k.values())
        / len(g_k))

    def require_step():
        for name, n in want.items():
            require(counts[name] == n * steps,
                    f"train {config}{plan_suffix(fuse)} {name}: "
                    f"{counts[name]} launches over {steps} steps, expected "
                    f"{n} a step")
        require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        require(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
                "non-finite gradient")
        if steps > 2:  # over the timed steps (the first update overshoots)
            require(losses[-1] < losses[1],
                    f"the loss did not fall over the timed steps: {losses}")

    if f32:  # against the float32 plain gradient of the bf16 run
        g_ref, l_ref = fp32_ref["grads"], fp32_ref["loss"]
        err_k = grad_rel(g_k, g_ref)
        loss_k = abs(losses[0] - l_ref) / abs(l_ref)
        worst_err, worst = max(
            (grad_rel({n: g_k[n]}, {n: w}), n) for n, w in g_ref.items()
            if float(w.float().square().sum()) > 0)
        res = dict(common, grad_rel_err_kernels_vs_fp32_plain=err_k,
                   grad_rel_err_limit=TRAIN_F32_GRAD_REL_TOL,
                   loss_rel_err_kernels_vs_fp32_plain=loss_k,
                   loss_rel_err_limit=TRAIN_F32_LOSS_REL_TOL,
                   worst_tensor=dict(name=worst, rel_err_kernels=worst_err))
        emit(res)
        require_step()
        require(err_k <= TRAIN_F32_GRAD_REL_TOL,
                f"float32 gradient of the kernel route off: {err_k} against "
                f"{TRAIN_F32_GRAD_REL_TOL} (worst tensor {worst})")
        require(loss_k <= TRAIN_F32_LOSS_REL_TOL,
                f"float32 loss of the kernel route off: {loss_k} against "
                f"{TRAIN_F32_LOSS_REL_TOL}")
        del state, step, g_k, init
        torch.cuda.empty_cache()
        return res

    def clip_grads(dtype):
        params = {n: p.clone().requires_grad_() for n, p in init.items()}
        loss = clip_loss_fn(params, cfg, lq, gt, compute_dtype=dtype,
                            fuse=fuse)
        loss.backward()
        return float(loss.detach()), {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.items()}

    kernels_pkg.reset_launch_counts()
    with plain_versions():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_p, g_p = clip_grads(torch.bfloat16)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        l_ref, g_ref = clip_grads(torch.float32)
    plain_counts = kernels_pkg.launch_counts()
    err_k, err_p = grad_rel(g_k, g_ref), grad_rel(g_p, g_ref)
    loss_k, loss_p = (abs(l - l_ref) / abs(l_ref) for l in (losses[0], l_p))
    per_tensor = sorted(
        ((grad_rel({n: g_k[n]}, {n: w}), n) for n, w in g_ref.items()
         if float(w.float().square().sum()) > 0), reverse=True)
    worst_err, worst = per_tensor[0]
    if fp32_ref is not None:  # kept for the float32 step
        fp32_ref.update(loss=l_ref, grads=g_ref)
    res = dict(
        common, plain_bf16_ms_per_loss_and_grad=plain_ms,
        grad_rel_err_kernels_vs_fp32_plain=err_k,
        grad_rel_err_bf16_plain_vs_fp32_plain=err_p,
        grad_rel_err_limit=GRAD_REL_FACTOR * err_p + GRAD_REL_SLACK,
        loss_rel_err_kernels_vs_fp32_plain=loss_k,
        loss_rel_err_bf16_plain_vs_fp32_plain=loss_p,
        loss_rel_err_limit=GRAD_REL_FACTOR * loss_p + GRAD_REL_SLACK,
        worst_tensor=dict(name=worst, rel_err_kernels=worst_err,
                          rel_err_bf16_plain=grad_rel({worst: g_p[worst]},
                                                      {worst: g_ref[worst]})),
        plain_launches=sum(plain_counts.values()))
    emit(res)
    if trace:
        profile_train(step, state, lq, gt,
                      res["ms_per_step_median_after_first"], config)
    require_step()
    require(not any(plain_counts.values()),
            "the plain steps must launch no kernel")
    require(err_k <= res["grad_rel_err_limit"],
            f"gradient of the kernel route off: {err_k} against "
            f"{res['grad_rel_err_limit']} (worst tensor {worst})")
    require(loss_k <= res["loss_rel_err_limit"],
            f"loss of the kernel route off: {loss_k} against "
            f"{res['loss_rel_err_limit']}")
    del state, step, g_k, g_p, g_ref, init
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the training command line
# ---------------------------------------------------------------------------


def write_video(root: str, seed: int, n: int, width: int, height: int) -> None:
    """root/{gt,blur}/video0/%05d.png: make_frames' pattern as the gt, the
    blur side the same with noise, uint8."""
    from PIL import Image

    gts = make_frames(seed, n, height, width)
    rng = np.random.RandomState(seed + 1)
    for sub in ("gt", "blur"):
        os.makedirs(os.path.join(root, sub, "video0"))
    for i, gt in enumerate(gts):
        blur = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0.0, 1.0)
        for sub, fr in (("gt", gt), ("blur", blur)):
            Image.fromarray((fr * 255.0).round().astype(np.uint8)).save(
                os.path.join(root, sub, "video0", f"{i:05d}.png"))


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


ITER_LINE = re.compile(
    r"iter:\s*([\d,]+), lr:\(([^,]+),\)\] \[eta: [^,]+(?:, [^,]+)?, "
    r"time \(data\): ([\d.]+) \(([\d.]+)\)\] l_pix: (\S+) $")


def write_train_data(root: str, seed: int, width: int,
                     height: int) -> tuple[str, float]:
    """The synthetic train and val folders under ``root`` (one video each,
    written from the seed at the run's frame size) and the copy of the
    GoPro option file that reads them, with TRAIN_CLI_KEYS: (the copy's
    path, the seconds the PNG writes took). The train-cli and train-dist
    phases share them."""
    import yaml

    t0 = time.perf_counter()
    write_video(os.path.join(root, "train"), seed + 3,
                TRAIN_CLI_FRAMES["train"], width, height)
    write_video(os.path.join(root, "val"), seed + 5, TRAIN_CLI_FRAMES["val"],
                width, height)
    write_s = time.perf_counter() - t0
    with open(OPTION_FILE) as f:
        opt = yaml.safe_load(f)
    opt["dir_data"] = [os.path.join(root, "train")]
    opt["datasets"]["val"]["dir_data"] = [os.path.join(root, "val")]
    for (sec, key), v in TRAIN_CLI_KEYS.items():
        opt[sec][key] = v
    yml = os.path.join(root, "gopro.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml, write_s


def run_train_cli(yml: str, write_s: float, width: int, height: int,
                  step_ms: float | None) -> dict:
    """turtlevsr_tpu_torch.cli.train.main as a user runs it, on the copy of
    the GoPro option file of ``write_train_data`` (full width and depth, bs
    2, 5 frames, 192 x 192 patches, AdamW, TrueCosine, save_img,
    use_tb_logger; only the data folders and TRAIN_CLI_KEYS changed): six
    iterations (saves and validations at 3 and 6), then two more resumed
    from 6, then --export_pth. Holds the log's losses and rates, the files,
    the export, the exact launches (the train steps' and the validated
    frames'), and the validation PSNR against the same masters through the
    plain versions on the card. ``step_ms``: the train phase's ms per step
    at this recipe, when it ran."""
    from turtlevsr_tpu_torch.data import create_dataset
    from turtlevsr_tpu_torch.io import load_state_dict_file
    from turtlevsr_tpu_torch.utils.logger import LOGGER_NAME

    work = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    old_cwd = os.getcwd()
    handler = LogLines()
    logger = logging.getLogger(LOGGER_NAME)
    logger.addHandler(handler)
    try:
        os.chdir(work)
        opt = load_options(yml, is_train=True)
        exp = os.path.join("experiments", opt["name"])
        schedule = build_schedule(opt["train"])
        t_frames = int(opt["n_sequence"])
        per_step = train_launches("gopro", (), t_frames)
        per_frame = LAUNCHES_PER_CALL["gopro"]
        # frames a validation streams: the val clips' frames
        val_frames = len(create_dataset(opt, "val")) * t_frames

        calls, counts_total = [], {}
        for max_iters, resumes in TRAIN_CLI_CALLS:
            handler.lines.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels_pkg.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_cli.main(["-opt", yml, "--max_iters", str(max_iters)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels_pkg.launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            for k, v in counts.items():
                counts_total[k] = counts_total.get(k, 0) + v
            lines = [m for m in handler.lines if ITER_LINE.search(m)]
            parsed = [ITER_LINE.search(m).groups() for m in lines]
            steps = res["iter"] - res["start_iter"]
            require(len(parsed) == steps == len(res["logs"]),
                    f"train-cli: {len(parsed)} iteration lines for {steps} "
                    f"steps")
            for (it, lr, _, _, loss), log in zip(parsed, res["logs"]):
                it = int(it.replace(",", ""))
                require(it == log["iter"], f"train-cli: line of iter {it}")
                require(lr == f"{schedule(it - 1):.3e}"
                        and log["lr"] == schedule(it - 1),
                        f"train-cli iter {it}: lr {lr}, {log['lr']} against "
                        f"the schedule's {schedule(it - 1)}")
                require(np.isfinite(float(loss))
                        and np.isfinite(log["l_pix"]),
                        f"train-cli iter {it}: l_pix {loss}")
            require(("Resuming training from iter "
                     f"{TRAIN_CLI_CALLS[0][0]}" in handler.lines) == resumes,
                    f"train-cli --max_iters {max_iters}: resume line")
            validated = len(res["val"]) * val_frames
            want = {k: steps * per_step.get(k, 0) + validated * per_frame[k]
                    for k in per_frame}
            for name, n in want.items():
                require(counts[name] == n,
                        f"train-cli --max_iters {max_iters} {name}: "
                        f"{counts[name]} launches, expected {n} ({steps} "
                        f"steps, {validated} validated frames)")
            times = [log["time"] for log in res["logs"][1:]]
            data = [log["data_time"] for log in res["logs"][1:]]
            calls.append(emit(dict(
                phase="train_cli", call=len(calls) + 1,
                argv=["--max_iters", str(max_iters)], resumed=resumes,
                start_iter=res["start_iter"], iter=res["iter"],
                seconds=seconds, loop_seconds=res["seconds"],
                iter_time_s=[log["time"] for log in res["logs"]],
                data_time_s=[log["data_time"] for log in res["logs"]],
                losses=[log["l_pix"] for log in res["logs"]],
                median_iter_time_s_from_step_2=float(np.median(times))
                if times else None,
                median_data_time_s_from_step_2=float(np.median(data))
                if data else None,
                train_phase_ms_per_step=step_ms,
                peak_memory_gib=peak_gb, val=res["val"],
                validated_frames=validated, frame=[height, width, 3],
                write_frames_s=write_s, launches=counts)))

        # validation against the plain versions, the masters of iteration 6
        last_val = max(calls[0]["val"])
        vopt = dict(opt, val={**opt["val"], "save_img": False})
        validate = train_cli.build_validation(
            model_config_from_options(opt), vopt, device="cuda")
        masters = load_state_dict_file(os.path.join(
            exp, "models", f"net_g_{last_val}.pth"))
        kernels_pkg.reset_launch_counts()
        with plain_versions():
            plain = validate(masters, create_dataset(opt, "val"))
        require(not any(kernels_pkg.launch_counts().values()),
                "the plain validation must launch no kernel")
        psnr_k = calls[0]["val"][last_val]["psnr"]
        psnr_p = plain["psnr"]
        emit({"phase": "train_cli_validation", "iter": last_val,
              "frames": val_frames, "val_psnr": psnr_k,
              "plain_val_psnr": psnr_p, "tol_db": TRAIN_CLI_PSNR_TOL})

        # the export: the newest masters as a reference .pth
        handler.lines.clear()
        export = os.path.join(work, "export.pth")
        kernels_pkg.reset_launch_counts()
        t0 = time.perf_counter()
        train_cli.main(["-opt", yml, "--export_pth", export])
        calls.append(emit(dict(
            phase="train_cli", call=3, argv=["--export_pth", "FILE"],
            seconds=time.perf_counter() - t0,
            launches=sum(kernels_pkg.launch_counts().values()))))
        last = TRAIN_CLI_CALLS[-1][0]
        got, want = (load_state_dict_file(export), load_state_dict_file(
            os.path.join(exp, "models", f"net_g_{last}.pth")))
        model = build_model(opt, device="cuda")
        model.load_state_dict(got, strict=True)
        del model
        require(calls[-1]["launches"] == 0, "the export launched kernels")
        require(set(got) == set(want)
                and all(torch.equal(got[k], want[k]) for k in want),
                "the export is not the newest net_g bit for bit")
        for it in (3, 6, 8):
            for path in (os.path.join(exp, "models", f"net_g_{it}.pth"),
                         os.path.join(exp, "training_states", f"{it}.state")):
                require(os.path.isfile(path), f"train-cli: no {path}")
        require(calls[1]["val"] == {}, "the resumed run validated")
        require(np.isfinite(psnr_k) and np.isfinite(psnr_p),
                f"validation PSNR {psnr_k}, plain {psnr_p}")
        require(abs(psnr_k - psnr_p) <= TRAIN_CLI_PSNR_TOL,
                f"validation PSNR {psnr_k} against the plain versions' "
                f"{psnr_p}")
        pngs = [f for _, _, fs in os.walk(os.path.join(exp, "visualization"))
                for f in fs if f.endswith(".png")]
        require(len(pngs) == 3 * val_frames,
                f"train-cli: {len(pngs)} validation PNGs")
    finally:
        os.chdir(old_cwd)
        logger.removeHandler(handler)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts_total


# ---------------------------------------------------------------------------
# data parallelism: the command line under a launcher, two ranks of the
# train step, the tiled grid split over shards
# ---------------------------------------------------------------------------


_PORTS_GIVEN = set()


def free_port() -> int:
    """A free local port, never one given before (launches run side by
    side)."""
    while True:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if port not in _PORTS_GIVEN:
            _PORTS_GIVEN.add(port)
            return port


def torchrun(nproc: int) -> list:
    """torch.distributed.run's command line for ``nproc`` processes on this
    host, its store at a free local port; the script and its arguments
    follow."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
            str(nproc), "--master_addr", "127.0.0.1", "--master_port",
            str(free_port())]


def run_launches(launches: list) -> list:
    """Run launches, each ``(cmd, cwd, what)`` (a launcher and its ranks, or
    one process), side by side, each the leader of a new process group: the
    seconds each took. Past CHILD_SECONDS every process of every launch is
    killed and the phase fails; so does a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs, seconds = [], {}
    try:
        for cmd, cwd, what in launches:
            log = tempfile.TemporaryFile(mode="w+")  # no pipe to fill
            procs.append((subprocess.Popen(
                cmd, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True, start_new_session=True), log, what))
        while len(seconds) < len(procs):
            for i, (proc, log, what) in enumerate(procs):
                if i in seconds or proc.poll() is None:
                    continue
                seconds[i] = time.perf_counter() - t0
                if proc.returncode != 0:
                    log.seek(0)
                    print(log.read()[-6000:], file=sys.stderr)
                require(proc.returncode == 0,
                        f"{what}: exit code {proc.returncode}")
            late = [what for i, (_, _, what) in enumerate(procs)
                    if i not in seconds]
            require(not late or time.perf_counter() - t0 < CHILD_SECONDS,
                    f"{', '.join(late)}: no end within {CHILD_SECONDS} s, "
                    f"killed")
            time.sleep(0.1)
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()
    return [seconds[i] for i in range(len(procs))]


def child_command(kind: str, out: str, *args) -> list:
    return [os.path.abspath(__file__), "--child", kind, out, *args]


def dist_step_inputs(yml: str, seed: int):
    """The train step's inputs of the train-dist ranks and of the process
    they are held to: the option file, the model's config, its masters
    (seeded, the scales drawn), AdamW, two clips at the file's recipe."""
    opt = load_options(yml, is_train=True)
    train_opt, ds = opt["train"], opt["datasets"]["train"]
    model = build_model(opt, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = model.cfg
    del model
    lq, gt = train_clips(seed + 2, 2, int(opt["n_sequence"]),
                         int(ds["gt_size"]), 1)
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    return opt, cfg, init, tx, lq, gt


def masters_hash(params: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(params[n].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_child(kind: str, out: str, args: list) -> int:
    """A rank started by the train-dist phase (``chip_smoke.py --child KIND
    OUT ARGS``), on the card; writes what it measured as JSON.

    train-cli: ``cli.train.main(ARGS)`` with the launch counts and the peak
    memory of the run (OUT, by rank 0). train-step: ARGS = option file,
    seed; the group of ``--launcher pytorch`` over the file's
    ``dist_params.backend``, TRAIN_DIST_ITERS steps of
    ``make_train_step(group=...)`` on this rank's clip of
    ``dist_step_inputs``, then the time of the gradients' all-reduce, the
    hash of the masters (OUT.RANK)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    kernels_pkg.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if kind == "train-cli":
        res = train_cli.main(args)
        res.update(launches=kernels_pkg.launch_counts(),
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if res["rank"] == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        return 0
    yml, seed = args[0], int(args[1])
    backend = load_options(yml, is_train=True)["dist_params"]["backend"]
    rank, world = parallel.init_dist("pytorch", backend)
    try:
        opt, cfg, init, tx, lq, gt = dist_step_inputs(yml, seed)
        b = parallel.per_process_batch_size(
            opt["datasets"]["train"]["batch_size_per_gpu"])
        lq = torch.from_numpy(lq[rank * b:(rank + 1) * b]).cuda()
        gt = torch.from_numpy(gt[rank * b:(rank + 1) * b]).cuda()
        state = TrainState.create(init, tx)
        parallel.broadcast_params(state.params)
        step = make_train_step(cfg, tx, group=parallel.default_group())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_pkg.reset_launch_counts()
        losses, ms = [], []
        for _ in range(TRAIN_DIST_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logs = step(state, lq, gt)
            losses.append(float(logs["l_pix"]))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernels_pkg.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        grads = {n: p.grad for n, p in state.params.items()}
        reduce_ms = []
        for _ in range(3):  # the step's all-reduce alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.all_reduce_mean_(grads)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        with open(f"{out}.{rank}", "w") as f:
            json.dump({"rank": rank, "world_size": world, "backend": backend,
                       "batch": b, "losses": losses, "ms_per_step": ms,
                       "launches": counts, "peak_memory_gib": peak,
                       "allreduce_ms": reduce_ms,
                       "allreduce_bytes": sum(g.numel() * g.element_size()
                                              for g in grads.values()),
                       "masters_sha256": masters_hash(state.params)}, f)
    finally:
        parallel.close_dist()
    return 0


def nccl_world1_allreduce_ms(cfg) -> list:
    """One all-reduce of gradients shaped like the model's parameters
    (float32) over an NCCL group of one process, as the train step makes
    it (the flat buffer, the sum, the division, the copies back), in this
    process: ms of three calls after one more."""
    import torch.distributed as dist

    with torch.device("meta"):
        shapes = {n: p.shape for n, p in turtle_mod.Turtle(cfg)
                  .named_parameters()}
    grads = {n: torch.randn(s, device="cuda") for n, s in shapes.items()}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.all_reduce_mean_(grads)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    del grads
    torch.cuda.empty_cache()
    return ms[1:]


def state_equal(a, b) -> bool:
    """Two loaded checkpoints (nested dicts, lists, tensors, numbers)
    equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(state_equal, a, b))
    return a == b


def run_tiled_split(seed: int, width: int, height: int) -> dict:
    """The tiled deblur stream (the task's preset: 45 tiles of a 1280 x 720
    frame) through InferenceEngine with the grid split into SPLIT_SHARDS
    shards on this card, against the single-device engine on the same
    model and frames, in turns (single, split, split, single): the frames
    and the launches a frame bit for bit, ms a frame of each."""
    preset = infer_cli.TASK_PRESETS["deblur"]
    model = build_model(options_of("gopro"), device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    frames = make_frames(seed + 2, FRAMES_PER_RUN, height, width)
    kw = dict(mode="tiled", tile=preset["tile"],
              tile_overlap=preset["tile_overlap"],
              max_tile_batch=MAX_TILE_BATCH, dtype=torch.bfloat16)
    engines = {"single": InferenceEngine(model, **kw),
               "split": InferenceEngine(model, devices=("cuda:0",)
                                        * SPLIT_SHARDS, **kw)}
    _, _, _, his, wis = engines["single"].tile_plan(height, width)
    n_tiles = len(his) * len(wis)
    shards = parallel.shard_devices(engines["split"].devices, n_tiles)
    runs = {"single": [], "split": []}
    for name in ("single", "split", "split", "single"):
        eng = engines[name]
        eng.reset()
        torch.cuda.synchronize()
        kernels_pkg.reset_launch_counts()
        outs, ms = [], []
        for fr in frames:
            t0 = time.perf_counter()
            outs.append(eng.step(fr))  # fetched: waits for the frame
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name].append((outs, ms, kernels_pkg.launch_counts()))
    (single, s_ms, s_counts), (split, p_ms, p_counts) = (runs["single"][0],
                                                        runs["split"][0])
    calls = -(-n_tiles // MAX_TILE_BATCH)
    want = {k: TILED_LAUNCHES["gopro"].get(k, v) * calls * len(frames)
            for k, v in LAUNCHES_PER_CALL["gopro"].items()}
    res = emit(dict(
        phase="train_dist", part="tiled_split", config="gopro",
        task="deblur", frame=[height, width, 3], tiles=n_tiles,
        shards=[[str(d), a, b] for d, a, b in shards],
        max_tile_batch=MAX_TILE_BATCH, frames=len(frames),
        bit_equal_frames=all(np.array_equal(a, b)
                             for a, b in zip(single, split)),
        launches=p_counts, launches_equal=p_counts == s_counts,
        order=["single", "split", "split", "single"],
        ms_per_frame_after_first={
            name: [float(np.median(r[1][1:])) for r in rs]
            for name, rs in runs.items()}))
    require(len(shards) == SPLIT_SHARDS and all(
        b - a == n_tiles // SPLIT_SHARDS for _, a, b in shards),
        f"tiled split: shards {shards}")
    require(res["bit_equal_frames"],
            "tiled split: frames differ from the single-device engine's")
    require(res["launches_equal"] and all(
        p_counts[k] == n for k, n in want.items()),
        f"tiled split: launches {p_counts}, single {s_counts}")
    del engines, model
    torch.cuda.empty_cache()
    return p_counts


def run_train_dist(yml: str, seed: int, width: int, height: int) -> dict:
    """Data parallelism on the one card, at the GoPro recipe (full width
    and depth) on the train-cli phase's synthetic folders:

    (a) ``torch.distributed.run --nproc_per_node 1`` of ``cli.train.main
        --launcher pytorch`` (NCCL, the file's dist_params) and the same
        TRAIN_DIST_ITERS iterations with ``--launcher none``, each in a
        process of its own, on a copy of the file with one loader thread
        and the final save only: the losses, the validation, net_g and the
        training state (masters, AdamW's moments) bit for bit, the exact
        launches; then the time of one all-reduce of the gradients over an
        NCCL group of one, in this process;
    (b) two ranks over gloo on this card, launched beside (a)'s two
        processes (a copy of the file with dist_params.backend gloo and
        batch_size_per_gpu 1), TRAIN_DIST_ITERS steps of
        ``make_train_step(group=...)``, each rank one of two clips: the
        ranks' masters bit for bit, the group's step-1 loss
        against one process's step on both clips (TRAIN_DIST_LOSS_REL_TOL),
        the exact launches, the all-reduce's time, each rank's peak memory;
    (c) ``run_tiled_split``.

    Every kernel is built before the first child starts: the children load
    the libraries. Returns the launches of each path."""
    import yaml

    from turtlevsr_tpu_torch.data import create_dataset

    opt = load_options(yml, is_train=True)
    frames_per_clip = int(opt["n_sequence"])
    per_step = train_launches("gopro", (), frames_per_clip)
    per_frame = LAUNCHES_PER_CALL["gopro"]
    val_frames = len(create_dataset(opt, "val")) * frames_per_clip
    work = tempfile.mkdtemp(prefix="chip_smoke_train_dist_")
    paths = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the children share the card with this process
    try:
        # (a) the launcher at world size 1 against no launcher. The loader's
        # threads share one generator (the JAX package's, kept), so with
        # several the crops of a batch follow the threads' timing; with one
        # they follow the seed alone, and two runs compare bit for bit
        with open(yml) as f:
            one = yaml.safe_load(f)
        one["datasets"]["train"]["num_worker_per_gpu"] = 1
        one["logger"]["save_checkpoint_freq"] = 0  # the final save only
        one_yml = os.path.join(work, "one_worker.yml")
        with open(one_yml, "w") as f:
            yaml.safe_dump(one, f, sort_keys=False)
        # (b)'s file: two ranks over gloo on the one card
        gloo = copy.deepcopy(one)
        gloo["dist_params"]["backend"] = "gloo"
        gloo["datasets"]["train"]["batch_size_per_gpu"] = 1
        gloo_yml = os.path.join(work, "gloo.yml")
        with open(gloo_yml, "w") as f:
            yaml.safe_dump(gloo, f, sort_keys=False)
        gloo_out = os.path.join(work, "gloo_rank")
        # the three launches side by side: each one's checks hold whatever
        # the timing, and their times include the others' load on the card
        # and the host
        launches = []
        for launcher in ("pytorch", "none"):
            cwd = os.path.join(work, launcher)
            os.makedirs(cwd)
            cmd = ((torchrun(1) if launcher == "pytorch" else [sys.executable])
                   + child_command("train-cli",
                                   os.path.join(cwd, "result.json"), "-opt",
                                   one_yml, "--max_iters",
                                   str(TRAIN_DIST_ITERS), "--launcher",
                                   launcher))
            launches.append((cmd, cwd, f"train-dist --launcher {launcher}"))
        launches.append((torchrun(2) + child_command(
            "train-step", gloo_out, gloo_yml, str(seed)), work,
            "train-dist two gloo ranks"))
        *a_seconds, gloo_seconds = run_launches(launches)
        runs = {}
        for launcher, seconds in zip(("pytorch", "none"), a_seconds):
            with open(os.path.join(work, launcher, "result.json")) as f:
                runs[launcher] = dict(json.load(f), launch_seconds=seconds)
        exp = os.path.join("experiments", opt["name"])
        files = {}
        for name in (f"models/net_g_{TRAIN_DIST_ITERS}.pth",
                     f"training_states/{TRAIN_DIST_ITERS}.state"):
            a, b = (torch.load(os.path.join(work, launcher, exp, name),
                               weights_only=True)
                    for launcher in ("pytorch", "none"))
            files[name] = state_equal(a, b)
        nccl, none = runs["pytorch"], runs["none"]
        validated = len(nccl["val"]) * val_frames
        want = {k: TRAIN_DIST_ITERS * per_step.get(k, 0)
                + validated * per_frame[k] for k in per_frame}
        reduce_ms = nccl_world1_allreduce_ms(model_config_from_options(opt))
        emit(dict(
            phase="train_dist", part="nccl_world_1",
            launch="torch.distributed.run --nproc_per_node 1, "
                   "cli.train.main --launcher pytorch",
            backend=opt["dist_params"]["backend"], iters=TRAIN_DIST_ITERS,
            world_size=nccl["world_size"],
            losses=[r["l_pix"] for r in nccl["logs"]],
            losses_none=[r["l_pix"] for r in none["logs"]],
            val=nccl["val"], val_none=none["val"],
            bit_equal_files=files,
            iter_time_s=[r["time"] for r in nccl["logs"]],
            iter_time_s_none=[r["time"] for r in none["logs"]],
            data_time_s=[r["data_time"] for r in nccl["logs"]],
            peak_memory_gib=nccl["peak_memory_gib"],
            peak_memory_gib_none=none["peak_memory_gib"],
            launch_seconds=nccl["launch_seconds"],
            launch_seconds_none=none["launch_seconds"],
            allreduce_ms_nccl_world_1=reduce_ms,
            launches=nccl["launches"], validated_frames=validated))
        require(nccl["world_size"] == 1 and none["world_size"] == 1,
                "train-dist (a): world sizes")
        require(nccl["logs"] == [dict(r, time=n["time"],
                                      data_time=n["data_time"])
                                 for r, n in zip(none["logs"], nccl["logs"])]
                and len(nccl["logs"]) == TRAIN_DIST_ITERS,
                "train-dist (a): the losses differ from --launcher none's")
        require(nccl["val"] == none["val"] and validated > 0,
                "train-dist (a): the validation differs")
        require(all(files.values()),
                f"train-dist (a): files differ bit for bit: {files}")
        for name, n in want.items():
            require(nccl["launches"][name] == n == none["launches"][name],
                    f"train-dist (a) {name}: {nccl['launches'][name]} and "
                    f"{none['launches'][name]} launches, expected {n}")
        paths["train_dist_nccl"] = nccl["launches"]

        # (b) two ranks over gloo on the one card
        ranks = []
        for r in range(2):
            with open(f"{gloo_out}.{r}") as f:
                ranks.append(json.load(f))
        _, cfg, init, tx, lq, gt = dist_step_inputs(gloo_yml, seed)
        state = TrainState.create(init, tx)
        _, logs = make_train_step(cfg, tx)(state, torch.from_numpy(lq).cuda(),
                                           torch.from_numpy(gt).cuda())
        one = float(logs["l_pix"])
        del state, init, logs
        torch.cuda.empty_cache()
        rel = abs(ranks[0]["losses"][0] - one) / abs(one)
        emit(dict(phase="train_dist", part="gloo_two_ranks",
                  launch="torch.distributed.run --nproc_per_node 2, "
                         "make_train_step(group=...)",
                  launch_seconds=gloo_seconds, ranks=ranks,
                  one_process_step1_loss_batch_2=one,
                  step1_loss_rel_err=rel,
                  loss_rel_tol=TRAIN_DIST_LOSS_REL_TOL))
        a, b = ranks
        require(a["world_size"] == 2 and b["world_size"] == 2 and
                a["backend"] == "gloo" and a["batch"] == 1,
                "train-dist (b): group")
        require(a["masters_sha256"] == b["masters_sha256"]
                and a["losses"] == b["losses"],
                "train-dist (b): the ranks' masters or losses differ")
        require(rel <= TRAIN_DIST_LOSS_REL_TOL,
                f"train-dist (b): the group's loss {a['losses'][0]} against "
                f"one process's {one}")
        for name, n in per_step.items():
            for rk in ranks:
                require(rk["launches"][name] == TRAIN_DIST_ITERS * n,
                        f"train-dist (b) rank {rk['rank']} {name}: "
                        f"{rk['launches'][name]} launches, expected "
                        f"{TRAIN_DIST_ITERS * n}")
        paths["train_dist_gloo"] = a["launches"]

        # (c) the tiled grid split over shards on the card
        paths["tiled_split"] = run_tiled_split(seed, width, height)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------


# the kernels line's float32 rows of the widened bodies: the row whose
# counters they read on the float32 paths (every float32 launch of rows 13
# and 14 is on the body widened for float32; rows 1, 3, 4, 5, 6 and 11 on
# csrc/ffn.cu, qkv_stats.cu, split_proj.cu, conv3x3.cu, chm_stats.cu and
# attn_v.cu are those not on their float32 bodies, none on the paths; row
# 1's calls there all have a depthwise stage)
F32_NEW_BODY = {"ffn": "ffn_f32", "qkv_stats": "qkv_f32",
                "split_proj": "split_f32", "conv3x3": "conv3x3_f32",
                "chm_stats": "chm_f32", "attn_v": "attn_v_f32"}
F32_ROWS = {"ffn_tile_f32": "ffn", "qkv_stats_f32": "qkv_stats",
            "split_proj_f32": "split_proj", "conv3x3_tile_f32": "conv3x3",
            "chm_stats_f32": "chm_stats", "level_run_f32": "level_run",
            "attn_v_tile_f32": "attn_v", "two_stage_f32": "two_stage"}


def kernel_rows(cases: list[dict], by_path: dict) -> list[dict]:
    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]
        base = F32_ROWS.get(name, name)  # float32: the float32 paths' launches
        counters = ("attn_v_merge", "attn_v_slots") if base == "attn_v" else (
            base,)
        per_path = {p: sum(c[k] for k in counters) for p, c in by_path.items()}
        if name in F32_ROWS:
            per_path = {p: (n - by_path[p].get(F32_NEW_BODY.get(base), 0)
                            if p in F32_PATHS else 0)
                        for p, n in per_path.items()}
        if name == "ffn":  # ffn.cu's dw branch: not the wgmma or C = 64 body, dw
            per_path = {p: c["ffn"] - c["ffn_wg"] - c["ffn_c64"]
                        - c["ffn_no_dw"] for p, c in by_path.items()}
        if name in ("qkv_stats", "chm_stats", "split_proj", "sab"):
            wg = name.split("_")[0] + "_wg"  # the mma.sync bodies
            other = {"split_proj": "split_c64", "sab": "sab_f32"}.get(name)
            per_path = {p: c[name] - c[wg] - c.get(other, 0)
                        for p, c in by_path.items()}
        if name == "level_run":  # level.cu: not the Hopper body
            per_path = {p: c["level_run"] - c["level_wg"]
                        for p, c in by_path.items()}
        if name == "ffn_no_dw":  # ffn.cu's branch without a depthwise stage
            per_path = {p: c["ffn_no_dw"] - c["ffn_pw"]
                        for p, c in by_path.items()}
        if name in ("two_stage", "sab_sparse_softmax"):  # chain2.cu, sab.cu
            wg = "two_stage_wg" if name == "two_stage" else "sparse_wg"
            per_path = {p: c[name] - c[wg] for p, c in by_path.items()}
        if name in F32_ROWS.values():  # the float32 paths count in *_f32
            per_path = {p: 0 if p in F32_PATHS else n
                        for p, n in per_path.items()}
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
                                      "body", "tile_ms", "partial_row_bytes",
                                      "tile_partial_row_bytes",
                                      "rel_err_vs_split", "bit_equal_to_split",
                                      "rel_err_vs_model_split",
                                      "bit_equal_to_model_split",
                                      "bit_equal_to_row_7",
                                      "bit_equal_to_sab_cu", "graph_ms",
                                      "f32_ms", "launch_ms", "pw1_matmul_ms",
                                      "host_ms", "dtype",
                                      "conv_only_library_ms") if k in c}
                   for c in mine]))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:  # a rank that the train-dist phase started
        try:
            return run_child(argv[1], argv[2], argv[3:])
        except SmokeFailure as exc:
            print(f"chip_smoke --child: FAILED: {exc}", file=sys.stderr)
            return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES_PER_RUN,
                    help="frames of the whole-frame streams but "
                         "`gopro_enc3_ffw`")
    ap.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", default="all",
                    choices=("all", "build", "kernels", "slice", "tiled",
                             "app", "bench", "train", "train-cli",
                             "train-dist", "float32", "frame-sizes",
                             "level-phases",
                             "two-stage-phases"),
                    help="level-phases, two-stage-phases: row 14's or row "
                         "13's Hopper body with each of its phases left out "
                         "in turn (not part of all; no result line, no ok "
                         "line)")
    ap.add_argument("--profile", action="store_true",
                    help="after each whole-frame stream and each tiled "
                         "stream under each plan, trace a few more frames "
                         "with torch.profiler: device time by kernel, idle "
                         "share")
    ap.add_argument("--cases", action="append", default=[],
                    help="--phase kernels (or float32: its kernel cases "
                         "alone, no paths): only the cases whose "
                         "'<kernel>: <case>' holds this text (no result "
                         "lines, no ok line)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and shared-memory report")
    args = ap.parse_args(argv)
    global CASE_FILTER
    CASE_FILTER = tuple(args.cases) or ("",)
    if args.cases and args.phase not in ("kernels", "float32"):
        ap.error("--cases takes --phase kernels or float32")
    width, height = (int(v) for v in args.size.lower().split("x"))
    t_script = time.perf_counter()

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
    data_root = None  # the train phases' synthetic folders
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
        cases, by_path, step_ms, slice_params = [], {}, None, {}
        phase_s, clock = {}, [time.perf_counter()]

        def done(name):  # the seconds since the previous phase ended
            now = time.perf_counter()
            phase_s[name] = now - clock[0]
            clock[0] = now
        if args.phase == "level-phases":
            level_phase_cases(args.seed, hp, wp)
            return 0
        if args.phase == "two-stage-phases":
            two_stage_phase_cases(args.seed)
            return 0
        if args.phase in ("all", "kernels"):
            cases = kernel_cases(args.seed, hp, wp)
            bad = [c["case"] for c in cases if not c["ok"]]
            require(not bad, f"kernels disagree with their plain versions: "
                             f"{bad}")
            done("kernels")
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
                res = run_slice(config, args.seed, n, width, height,
                                fuse=fuse, trace=args.profile)
                by_path[tag] = res["launches"]
                slice_params[config] = res["params"]
            done("slice")
        if args.phase in ("all", "tiled"):
            # the command line's tiled streams, each under its plans
            for config in TILED_PLANS:
                for tag, res in run_tiled(config, args.seed, width, height,
                                          args.profile).items():
                    by_path[tag] = res["launches"]
            done("tiled")
        if args.phase in ("all", "app"):
            # the web app's entry points on a video file, whole and tiled
            by_path.update({tag: res["launches"] for tag, res in run_app(
                args.seed, width, height).items() if tag != "app_image"})
            done("app")
        if args.phase in ("all", "train"):
            # the train step at each option file's training recipe, then
            # `gopro`'s in float32, held to the float32 plain gradient that
            # its bf16 run computed
            fp32_ref = {}
            for config, fuse, steps in TRAIN_RUNS:
                res = run_train(config, args.seed, fuse, steps,
                                args.profile and steps > 1,
                                fp32_ref=fp32_ref if (config, fuse) == (
                                    "gopro", ()) else None)
                by_path["train_" + config + plan_suffix(fuse)] = res["launches"]
                if (config, fuse) == ("gopro", ()):
                    step_ms = res["ms_per_step_median_after_first"]
            t0 = time.perf_counter()
            res = run_train("gopro", args.seed, (), TRAIN_F32_STEPS, False,
                            dtype=torch.float32, fp32_ref=fp32_ref)
            by_path["train_gopro_f32"] = res["launches"]
            phase_s["train_gopro_f32"] = time.perf_counter() - t0
            del fp32_ref
            done("train")
        if args.phase in ("all", "train-cli", "train-dist"):
            data_root = tempfile.mkdtemp(prefix="chip_smoke_train_data_")
            yml, write_s = write_train_data(data_root, args.seed, width,
                                            height)
        if args.phase in ("all", "train-cli"):
            # the training command line at the GoPro recipe
            by_path["train_cli_gopro"] = run_train_cli(yml, write_s, width,
                                                       height, step_ms)
            done("train-cli")
        if args.phase in ("all", "train-dist"):
            # data parallelism: a launcher, two ranks, the split tiled grid
            by_path.update(run_train_dist(yml, args.seed, width, height))
            done("train-dist")
        if args.phase in ("all", "bench"):
            # the complexity and speed harness's modes
            by_path.update(run_bench(slice_params))
            done("bench")
        if args.phase == "float32":  # its kernel cases (part of kernels)
            cases = run_cases(f32_cases(args.seed, hp, wp))
            bad = [c["case"] for c in cases if not c["ok"]]
            require(not bad, f"kernels disagree with their plain versions: "
                             f"{bad}")
            done("float32 kernel cases")
        if args.phase in ("all", "float32") and not args.cases:
            # float32 serving: whole-frame (under fuse=() and the full
            # plan), tiled through the command line, the harness
            by_path.update(run_f32_paths(args.seed, width, height,
                                         args.profile))
            done("float32")
        if args.phase in ("all", "frame-sizes"):
            # frames other than 1280x720: 1080p whole-frame in bf16 and
            # float32, the deblur preset tiled at 1080p, the denoise preset
            # at DAVIS's 854x480
            by_path.update(run_frame_sizes(args.seed, smi_line))
            done("frame-sizes")
        if args.phase == "all":
            # every path launched the kernels that lie on it (the exact
            # counts were held above); attn_v_slots is the second epilogue of
            # the kernel that attn_v_merge launches and has no caller of its
            # own in the model, nor has sab_sparse_softmax (row 12)
            t0_chm = ("ffn", "ffn_wg", "ffn_c64", "qkv_wg", "split_wg",
                      "conv3x3", "chm_wg", "lattice_merge", "lattice_split")
            t1_chm = t0_chm + ("sab_wg", "split_c64")
            f32_t0 = ("ffn", "ffn_f32", "qkv_stats", "qkv_f32", "split_proj",
                      "split_f32", "conv3x3", "conv3x3_f32", "chm_stats",
                      "chm_f32", "lattice_merge", "lattice_split")
            f32_t1 = f32_t0 + ("sab",)  # sab.cu at 256 x 256 and 192 x 192
            on_path = {
                "gopro_t1_fhr": ("ffn", "ffn_wg", "ffn_c64", "qkv_wg",
                                 "split_wg", "conv3x3"),
                "gopro": t1_chm, "gopro_enc3_ffw": t1_chm + ("ffn_pw",),
                "derain": t0_chm, "sr": t1_chm,
                "gopro_two_stage": t1_chm + ("two_stage", "two_stage_wg"),
                "tiled": t1_chm,
                "tiled_fused": ("ffn", "ffn_wg", "ffn_c64", "qkv_wg",
                                "split_wg", "split_c64", "conv3x3", "chm_wg",
                                "sab_wg", "lattice_split", "attn_v_merge",
                                "level_run", "level_wg"),
                "tiled_two_stage": t1_chm + ("two_stage", "two_stage_wg"),
                "derain_tiled": t0_chm,
                "derain_tiled_two_stage": t0_chm + ("two_stage",
                                                    "two_stage_wg"),
                "sr_tiled": t1_chm, "sr_tiled_two_stage": t1_chm + (
                    "two_stage", "two_stage_wg"),
                # the train steps: the forward's kernels, and the lattice
                # pair in the backward too
                "train_gopro": t1_chm, "train_derain": t0_chm,
                "train_cli_gopro": t1_chm,
                "train_sr": t1_chm,
                # data parallelism: the command line under torchrun (NCCL),
                # a rank of two over gloo, the grid split into shards
                "train_dist_nccl": t1_chm, "train_dist_gloo": t1_chm,
                "tiled_split": t1_chm,
                # the app: restore_video whole-frame and tiled
                "app_whole": t1_chm, "app_tiled": t1_chm,
                # the harness: inference, a traced run, the train step, the
                # numerics whole-frame and tiled
                "bench_gopro": t1_chm, "bench_derain": t0_chm,
                "bench_sr": t1_chm, "bench_gopro_two_stage": t1_chm + (
                    "two_stage", "two_stage_wg"),
                "bench_gopro_trace": t1_chm, "bench_train_gopro": t1_chm,
                "bench_numerics": t1_chm, "bench_numerics_tiled": t1_chm,
                "train_gopro_two_stage": t1_chm + ("two_stage",
                                                   "two_stage_wg"),
                "train_gopro_fused": ("ffn", "ffn_wg", "ffn_c64", "qkv_wg",
                                      "split_wg", "split_c64", "conv3x3",
                                      "chm_wg", "sab_wg", "lattice_split",
                                      "lattice_merge", "attn_v_merge",
                                      "level_run", "level_wg"),
                # float32 serving: the float32 bodies of rows 1, 3, 4, 5 and
                # 6, row 7
                # (`gopro`: sab_f32.cu at whole frames, sab.cu at 256 x 256
                # and 192 x 192) and the lattice pair; under the full plan
                # also level.cu, attn_v_f32.cu and chain2.cu
                # (and no lattice merge); the float32 train step, its forward
                **dict.fromkeys(("bench_gopro_f32", "train_gopro_f32"),
                                f32_t1),
                "gopro_f32": f32_t1 + ("sab_f32",),
                "gopro_f32_fused": ("ffn", "ffn_f32", "qkv_stats", "qkv_f32",
                                    "split_proj", "split_f32", "conv3x3",
                                    "conv3x3_f32", "chm_stats", "chm_f32",
                                    "lattice_split",
                                    "sab", "sab_f32", "attn_v_merge",
                                    "attn_v_f32", "level_run", "two_stage"),
                "derain_tiled_f32": f32_t0,
                # frames other than 1280x720: as `gopro` and the tiled
                # deblur stream; float32 with row 7 on sab_f32.cu
                "gopro_1080": t1_chm, "deblur_tiled_1080": t1_chm,
                "denoise_tiled_480": t1_chm,
                "gopro_f32_1080": f32_t0 + ("sab", "sab_f32"),
            }
            require(set(by_path) == set(on_path),
                    f"paths run: {sorted(by_path)}")
            for path, names in on_path.items():
                for name in names:
                    require(by_path[path][name] > 0,
                            f"the {path} path never launched {name}")
            for path in ("tiled_fused", "gopro_f32_fused"):
                require(by_path[path]["lattice_merge"] == 0,
                        f"the fused plan still launched lattice_merge on "
                        f"{path}")
            # every launch of rows 1, 2, 4, 13 and 14 runs on a body designed
            # for the card: none on the mma.sync bodies of ffn.cu and
            # split_proj.cu, none on level.cu or chain2.cu. The float32
            # paths are exempt from these checks by name: the Hopper bodies
            # (level_wg.cu and chain2_wg.cu among them) take bf16 only, so
            # every float32 call of rows 1, 3, 4, 5, 6 and 11 is on its
            # float32 body, of rows 7, 13 and 14 on the body widened for it,
            # and none launches a bf16-only body
            for path, c in by_path.items():
                if path in F32_PATHS:
                    require(not any(c[k] for k in BF16_ONLY),
                            f"the {path} path launched a bf16-only body")
                    require(c["ffn"] == c["ffn_f32"]
                            and c["qkv_stats"] == c["qkv_f32"]
                            and c["split_proj"] == c["split_f32"]
                            and c["conv3x3"] == c["conv3x3_f32"]
                            and c["chm_stats"] == c["chm_f32"]
                            and c["attn_v_merge"] + c["attn_v_slots"]
                            == c["attn_v_f32"],
                            f"the {path} path launched ffn.cu, qkv_stats.cu, "
                            "split_proj.cu, conv3x3.cu, chm_stats.cu or "
                            "attn_v.cu in float32")
                    continue
                require(not any(c[k] for k in ("ffn_f32", "qkv_f32",
                                               "split_f32", "conv3x3_f32",
                                               "chm_f32", "attn_v_f32")),
                        f"the {path} path launched a float32 body")
                require(c["ffn"] == c["ffn_wg"] + c["ffn_c64"]
                        + c["ffn_pw"] and c["split_proj"]
                        == c["split_wg"] + c["split_c64"],
                        f"the {path} path launched ffn.cu or split_proj.cu")
                require(c["level_run"] == c["level_wg"],
                        f"the {path} path launched level.cu")
                require(c["two_stage"] == c["two_stage_wg"],
                        f"the {path} path launched chain2.cu")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if data_root is not None:
            shutil.rmtree(data_root, ignore_errors=True)
    if args.cases:  # a filtered run proves nothing about the whole
        return 0
    emit({"phase": "phase_seconds", "seconds": phase_s})
    emit({"phase": "done", "script_seconds": time.perf_counter() - t_script})
    if cases and len(by_path) == 41:  # launches are those of this run's paths
        emit({"kernels": kernel_rows(cases, by_path)})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
