#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--frames 6] [--size 1280x720] [--phase all]
                          [--profile] [--ptxas]

Phases, one JSON object per line on standard output:

  device   the card's name and power limit as nvidia-smi gives them
  build    nvcc builds the four kernels of turtlevsr_tpu_torch/kernels/csrc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the shapes the 720p serving path gives it (bf16): errors
           beside the stated tolerance, the kernel's time, the plain
           version's, a PyTorch library call's where one computes the same
           function, and the least time the card could take (bound)
  slice    the `gopro_t1_fhr` configuration (options/Turtle_Deblur_Gopro.yml
           with the last block of each decoder level set to Channel) at full
           width and depth, seeded random weights, frames streamed through
           InferenceEngine.step: shape, finiteness, kernel launches per
           frame (51 / 37 / 2 / 8), agreement with the same frames run
           through the plain versions on the card, ms per frame

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
from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.models import blocks as blocks_mod
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as turtle_mod

ROOT = os.path.dirname(os.path.abspath(__file__))
OPTION_FILE = os.path.join(ROOT, "options", "Turtle_Deblur_Gopro.yml")
# gopro_t1_fhr: the shipped GoPro model with the CHM blocks (not ported yet)
# replaced by Channel blocks; applied by the caller, the file is unchanged
GOPRO_T1_FHR = {"decoder1_attn_type2": "Channel",
                "decoder2_attn_type2": "Channel",
                "decoder3_attn_type2": "Channel"}
LAUNCHES_PER_FRAME = {"ffn": 51, "qkv_stats": 37, "split_proj": 2,
                      "conv3x3": 8}

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
             biases=False, scale=False, ffw2=False, dw=True, iters=5):
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
                        + (c * c if po else 0) + (2 * c * f if ffw2 else 0))
    weights = [v for v in kw.values() if torch.is_tensor(v) and v.dim() < 4]
    weights += list(kw.get("ffw2", {}).values())
    n_bytes = numel_bytes(x, kw.get("x2"), got, *weights)
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


def conv_case(inp: Inputs, name, h, w, cin, cout, bias, iters=5):
    x = inp(1, h, w, cin)
    wt = inp(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = inp(cout, scale=0.2) if bias else None
    got = K.fused_conv3x3(x, wt, bb)
    torch.cuda.synchronize()
    want = K.conv3x3_plain(x, wt, bb)
    err, rel = rel_err(got, want)
    # the library's call for the same function: cuDNN through F.conv2d on
    # the same NHWC memory (channels_last), bf16; timed here, used nowhere
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bb, padding=1), iters)
    b_ms, b_by = bound(numel_bytes(x, wt, bb, got),
                       2.0 * h * w * 9 * cin * cout)
    return dict(kernel="conv3x3", case=name, shape=[1, h, w, cin], cout=cout,
                max_abs_err=err, rel_err=rel, tol_rel=KERNEL_REL_TOL,
                ok=rel <= KERNEL_REL_TOL,
                ms=cuda_ms(lambda: K.fused_conv3x3(x, wt, bb), iters),
                plain_ms=cuda_ms(lambda: K.conv3x3_plain(x, wt, bb), 2, 1),
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


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
    out = []
    for make in cases:
        res = make()
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
    saved = (blocks_mod.fused_block_ffn, blocks_mod.fused_qkv_stats,
             blocks_mod.fused_ln_split_proj, turtle_mod.fused_conv3x3)
    blocks_mod.fused_block_ffn = K.ffn_plain
    blocks_mod.fused_qkv_stats = K.qkv_stats_plain
    blocks_mod.fused_ln_split_proj = K.split_proj_plain
    turtle_mod.fused_conv3x3 = K.conv3x3_plain
    try:
        yield
    finally:
        (blocks_mod.fused_block_ffn, blocks_mod.fused_qkv_stats,
         blocks_mod.fused_ln_split_proj, turtle_mod.fused_conv3x3) = saved


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


def gopro_t1_fhr_options() -> dict:
    opt = load_options(OPTION_FILE, is_train=False)
    opt.update(GOPRO_T1_FHR)
    return opt


def profile_frames(engine: InferenceEngine, frames: list,
                   untraced_ms: float) -> None:
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
    emit({"phase": "profile", "frames": len(frames),
          "wall_ms_per_frame_traced": wall_ms,
          "device_busy_ms_per_frame": busy if rows else "not measured",
          "ms_per_frame_untraced": untraced_ms,
          "device_idle_share": max(0.0, 1.0 - busy / untraced_ms) if rows
          else "not measured",
          "top_device_ms_per_frame": [
              {"name": k[:80], "ms": ms, "calls_per_frame": n / len(frames)}
              for k, ms, n in rows[:24]]})


def run_slice(opt: dict, seed: int, n_frames: int, width: int,
              height: int, trace: bool = False) -> dict:
    model = build_model(opt, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    randomise_scales(model, seed + 1)
    cfg = model.cfg
    engine = InferenceEngine(model, mode="whole", dtype=torch.bfloat16)
    frames = make_frames(seed + 2, n_frames, height, width)
    ring = cfg.latent.num_frames_tocache
    require(n_frames > ring, f"need more than {ring} frames to wrap the ring")

    # main path: counts set to 0 just before, read just after; the peak of
    # device memory is that of the stream, not of the phases before it
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    outs, times = [], []
    for fr in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.step(fr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, out in enumerate(outs):
        require(out.shape == (height, width, 3),
                f"frame {i}: output shape {out.shape}")
        require(bool(np.isfinite(out).all()), f"frame {i}: non-finite output")
    for name, per_frame in LAUNCHES_PER_FRAME.items():
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
    require(K.launch_counts() == counts,
            "the plain run must launch no kernel")
    psnrs = [psnr(a, b) for a, b in zip(outs, plain_outs)]
    max_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    change = [float(np.abs(o - f).mean()) for o, f in zip(outs, frames)]
    res = dict(
        phase="slice", config="gopro_t1_fhr", frame=[height, width, 3],
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
        profile_frames(engine, frames[:3], res["ms_per_frame_after_warmup"])
    require(min(psnrs) >= SLICE_MIN_PSNR,
            f"kernel path and plain path disagree: PSNR {psnrs}")
    require(min(change) > 0, "the model returned its input unchanged")
    return res


# ---------------------------------------------------------------------------


def kernel_rows(cases: list[dict], counts: dict) -> list[dict]:
    rows = []
    for name, (source, replaces) in KERNEL_INFO.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
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
    ap.add_argument("--frames", type=int, default=6)
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
        opt = gopro_t1_fhr_options()
        hp, wp = turtle_mod.padded_hw(model_config_from_options(opt), height,
                                      width)
        cases, counts = [], {}
        if args.phase in ("all", "kernels"):
            cases = kernel_cases(args.seed, hp, wp)
            bad = [c["case"] for c in cases if not c["ok"]]
            require(not bad, f"kernels disagree with their plain versions: "
                             f"{bad}")
        if args.phase in ("all", "slice"):
            counts = run_slice(opt, args.seed, args.frames, width, height,
                               trace=args.profile)["launches"]
        if args.phase == "all":
            for name in KERNEL_INFO:
                require(counts.get(name, 0) > 0,
                        f"the main path never launched {name}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if cases and counts:  # launches are those of this run's main path
        emit({"kernels": kernel_rows(cases, counts)})
    print(smi_line, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
