"""Complexity and speed harness: the reference's
``python basicsr/models/archs/turtle_arch.py`` benchmark (turtle_arch.py:
1065-1127: ptflops MACs, parameters and a warmed, steady-state FPS on a
(2, 3, 256, 256) input), and the counterpart of ``turtlevsr_tpu.cli.bench``
in the JAX package.

    python -m turtlevsr_tpu_torch.cli.bench -opt options/Turtle_Deblur_Gopro.yml \\
        [--size 256 256] [--iters 100] [--fuse two_stage] [--device cpu]
    python -m turtlevsr_tpu_torch.cli.bench -opt ... --train_step
    python -m turtlevsr_tpu_torch.cli.bench -opt ... --numerics \\
        [--numerics_tile 320 --numerics_overlap 192] [--numerics_json FILE]

Modes:
  * inference (the default): ``Params:``, ``MACs/frame:`` and the timed
    loop's ``Overall fps:``; the cache is threaded through every call and
    each sync is ``torch.cuda.synchronize()``; ``--trace_dir`` traces the
    timed calls with ``utils.profiling.trace``;
  * ``--train_step``: one optimizer step at the option file's training
    recipe (batch_size_per_gpu, n_sequence, patch_size), one JSON line
    ``train_step_ms_1chip``;
  * ``--numerics``: per-frame PSNR of the model on the card in bfloat16 on
    the hand-written kernels (weights cast from the float32 model) against
    the same float32 weights on the CPU, on the plain versions; 4 frames
    whole, or with ``--numerics_tile`` 3 frames through two tiled engines
    over the same grid; merged into the JSON list ``--numerics_json``.

The MAC count is that of one model call at ``--size`` (padded as the model
pads), taken from a run of the plain versions on fake tensors
(``count_macs``): every multiply-accumulate of a product: pointwise and dense
convolutions, depthwise taps, Grams and token norms, the attention and
history products and the SR upsampler. LayerNorm, softmax and other
elementwise work is not counted, as ptflops does not count it. It is the
same whatever ``--device``, ``--dtype`` or ``--fuse``: a fused plan chooses
between kernels of the same function. The count follows what the port
computes, which folds some of the reference's chains (a channel attention
applies ``blockdiag(attn^T) @ W_po`` as one product; the SAB's v chain is
one dense 3x3 convolution).

What differs from the JAX package's harness:
  * --device cuda|cpu (default cuda; without a card it raises, it never
    carries on on the CPU by itself) and --fuse (names out of
    ``models.blocks.FUSE_PLANS``, empty by default) take the place of
    --kernels; the artifacts are stamped with the plan and the device;
  * the MACs are counted from the plain versions' products
    (``count_macs``), not by XLA's cost analysis, and ``--traffic_json``
    has no bytes: the card offers no counterpart of XLA's "bytes
    accessed";
  * the numerics artifact is ``NUMERICS_torch.json`` by default (the JAX
    package's is ``NUMERICS.json``);
  * the numerics metrics are named after what they compare and at what
    size;
  * no persistent compile cache: the kernels build at first use
    (``kernels/build.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import time

import numpy as np

# the JAX module's fallback recipe (readme.md:115 of the reference)
DEFAULT_TRAIN_OPT = {
    "optim_g": {"lr": 4e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
    "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 200000,
                  "eta_min": 1e-7},
    "total_iter": 200000, "warmup_iter": -1}
NUMERICS_FRAMES = 4
NUMERICS_TILED_FRAMES = 3
NUMERICS_TILE_BATCH = 3


# ---------------------------------------------------------------------------
# complexity
# ---------------------------------------------------------------------------


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


@functools.lru_cache(maxsize=None)
def count_macs(cfg, height: int, width: int) -> int:
    """Multiply-accumulates of one model call on a [previous, current] pair
    of (height, width) frames, batch 1 (the low-resolution size for the SR
    variant), as the port computes it: a run of the plain versions on fake
    CPU tensors (shapes only: no memory, no arithmetic), FlopCounterMode's
    matrix products and convolutions / 2 plus the depthwise taps, which the
    plain versions do as nine shifted multiply-adds that the counter does
    not see (``kernels.ffn._dw_acc.macs``). The kernel-layout weights are
    made before the counted call. Meta tensors will not do: a kernel's
    wrapper has a plain version for CPU tensors only. Kept for each
    (config, size): the run takes seconds at full width."""
    import warnings

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from turtlevsr_tpu_torch.kernels import ffn
    from turtlevsr_tpu_torch.models.blocks import KernelWeights
    from turtlevsr_tpu_torch.models.turtle import Turtle

    with torch.device("meta"):
        model = Turtle(cfg).eval()
    counter = FlopCounterMode(display=False)
    with (FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad(),
          warnings.catch_warnings()):
        # the weight cache's key reads data_ptr(), which a fake tensor
        # warns of
        warnings.filterwarnings("ignore", "Accessing the data pointer")
        model.to_empty(device="cpu")
        for m in model.modules():
            if isinstance(m, KernelWeights):
                m.kernel_weights()
        x = torch.zeros(1, 2, height, width, 3)
        cache = model.init_cache(1, height, width)
        taps = ffn._dw_acc.macs
        with counter:
            model(x, cache)
        taps = ffn._dw_acc.macs - taps
    return counter.get_total_flops() // 2 + taps


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------


def _torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _plan(args) -> dict:
    """What a measurement ran on: stamped into the artifacts so that a run
    under another plan or on the CPU cannot pass for the default one."""
    return {"fuse": list(args.fuse), "device": args.device}


def bench_train_step(args, opt, cfg) -> dict:
    """Time one optimizer step at the option file's training recipe
    (readme.md:115 / options/*.yml: bs 2 a card, n_sequence 5, patch 192)
    and print a train_step_ms JSON line; the reference's 8-GPU recipe does
    200k iterations, iterations a day on one card is the comparable
    capacity number."""
    import torch

    from turtlevsr_tpu_torch.models import build_model
    from turtlevsr_tpu_torch.train.lr_schedule import build_schedule
    from turtlevsr_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    train_opt = opt.get("train") or DEFAULT_TRAIN_OPT
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    step = make_train_step(cfg, tx, compute_dtype=_torch_dtype(args.dtype),
                           remat=True, remat_policy=args.remat_policy,
                           fuse=tuple(args.fuse), device=args.device)
    model = build_model(opt, device="cpu")  # the masters go to the device
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device=args.device)
    del model

    ds_opt = (opt.get("datasets") or {}).get("train") or {}
    b = int(ds_opt.get("batch_size_per_gpu", 2))
    t = int(opt.get("n_sequence", 5))
    ps = int(opt.get("patch_size", 192))
    rng = np.random.RandomState(0)
    lq = torch.from_numpy(rng.rand(b, t, ps, ps, 3).astype(np.float32))
    gt = torch.from_numpy(rng.rand(b, t, ps, ps, 3).astype(np.float32))
    lq, gt = lq.to(args.device), gt.to(args.device)
    print(f"train step: bs {b}/chip, T={t}, {ps}x{ps}, "
          f"fuse={','.join(args.fuse) or 'none'}, device={args.device}, "
          f"remat={args.remat_policy}", flush=True)

    t_warm = time.perf_counter()
    state, logs = step(state, lq, gt)
    for _ in range(max(args.warmup - 1, 0)):
        state, logs = step(state, lq, gt)
    float(logs["l_pix"])  # waits for the device
    warm_s = time.perf_counter() - t_warm

    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, logs = step(state, lq, gt)
    float(logs["l_pix"])
    ms = (time.perf_counter() - t0) / args.iters * 1000
    res = {"metric": "train_step_ms_1chip",
           "remat_policy": args.remat_policy,
           "value": round(ms, 1),
           "unit": "ms/iter",
           "iters_per_day": int(86400 / (ms / 1000))}
    print(json.dumps(res))
    return {**res, "ms": ms, "steps": max(args.warmup, 1) + args.iters,
            "warmup_seconds": warm_s, "batch": b, "frames": t, "patch": ps,
            **_plan(args)}


def _psnr(a, b) -> float:
    """PSNR of two [0, 1] outputs in float64, as the JAX module rounds it
    (mse floored at 1e-30)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return round(10 * np.log10(1.0 / max(mse, 1e-30)), 2)


def _numerics_models(args, opt):
    """(float32 model on the CPU, bfloat16 model on the card with its
    weights cast from it)."""
    import torch

    from turtlevsr_tpu_torch.models import build_model

    model32 = build_model(opt, device="cpu")
    model16 = build_model(opt, device=args.device, dtype=torch.bfloat16,
                          fuse=tuple(args.fuse))
    model16.load_state_dict(model32.state_dict())
    return model32, model16


def bench_numerics(args, opt, cfg) -> dict:
    """Deployment-precision numerics: a synthetic clip through the model on
    the card (bf16, the hand-written kernels) and through the same float32
    weights on the CPU (the plain versions), the cache threaded through
    both; per-frame PSNR between the two outputs."""
    import torch

    h, w = args.size
    model32, model16 = _numerics_models(args, opt)
    frames = np.random.RandomState(0).rand(
        NUMERICS_FRAMES, 1, h, w, 3).astype(np.float32)
    cache32 = model32.init_cache(1, h, w)
    cache16 = model16.init_cache(1, h, w)
    psnrs = []
    prev = frames[0]
    with torch.inference_mode():
        for t in range(NUMERICS_FRAMES):
            pair = torch.from_numpy(np.stack([prev, frames[t]], axis=1))
            out32, cache32 = model32(pair, cache32)
            out16, cache16 = model16(
                pair.to(args.device, torch.bfloat16), cache16)
            psnrs.append(_psnr(out32.numpy(), out16.float().cpu().numpy()))
            print(f"frame {t}: PSNR(bf16 kernels vs fp32 plain) = "
                  f"{psnrs[-1]} dB", flush=True)
            prev = frames[t]
    art = {
        "metric": f"psnr_bf16_kernels_vs_fp32_plain_{h}x{w}",
        "per_frame_db": psnrs,
        "min_db": min(psnrs),
        "size": [h, w],
        "opt": os.path.basename(args.opt),
        "note": "synthetic random clip (worst-case high-frequency input), "
                "seeded random weights; PSNR of the model in bfloat16 on "
                "the hand-written kernels on the card against the same "
                "float32 weights through the plain versions on the CPU, "
                "streaming cache threaded through both",
    }
    return _finish_numerics_artifact(args, art)


def bench_numerics_tiled(args, opt, cfg) -> dict:
    """The same comparison at the reference's own eval geometry (tile 320 /
    overlap 192, inference.py:172-246): a short clip through two tiled
    engines over the same tile grid and per-tile caches."""
    import torch

    from turtlevsr_tpu_torch.eval.engine import InferenceEngine

    h, w = args.size
    tile, overlap = args.numerics_tile, args.numerics_overlap
    model32, model16 = _numerics_models(args, opt)
    eng32 = InferenceEngine(model32, mode="tiled", tile=tile,
                            tile_overlap=overlap, dtype=torch.float32,
                            max_tile_batch=NUMERICS_TILE_BATCH, device="cpu")
    eng16 = InferenceEngine(model16, mode="tiled", tile=tile,
                            tile_overlap=overlap, dtype=torch.bfloat16,
                            max_tile_batch=NUMERICS_TILE_BATCH,
                            device=args.device)
    _, _, _, rows, cols = eng16.tile_plan(h, w)
    rng = np.random.RandomState(0)
    psnrs = []
    for t in range(NUMERICS_TILED_FRAMES):
        fr = rng.rand(h, w, 3).astype(np.float32)
        psnrs.append(_psnr(eng32.step(fr), eng16.step(fr)))
        print(f"frame {t}: tiled PSNR(bf16 kernels vs fp32 plain) = "
              f"{psnrs[-1]} dB", flush=True)
    art = {
        "metric": f"psnr_bf16_kernels_vs_fp32_plain_{h}x{w}_tiled{tile}",
        "per_frame_db": psnrs,
        "min_db": min(psnrs),
        "size": [h, w],
        "tile": tile, "overlap": overlap,
        "tiles": len(rows) * len(cols),
        "opt": os.path.basename(args.opt),
        "note": "reference tiled eval geometry, same tile grid and "
                "per-tile caches through both engines; synthetic random "
                "frames and seeded random weights (trained weights saturate "
                "softmaxes differently; no published checkpoint is read)",
    }
    return _finish_numerics_artifact(args, art)


def _commit() -> str | None:
    """The short commit of the checkout holding this package ("" outside a
    git repository, None without git)."""
    if shutil.which("git") is None:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=root,
                          capture_output=True, text=True,
                          timeout=10).stdout.strip()


def _finish_numerics_artifact(args, art: dict) -> dict:
    """Stamp the plan, the commit and the date, and merge the entry into
    the JSON list at ``args.numerics_json``, keyed by (opt, size, metric)
    (a single object there, the JAX package's older schema, is read as a
    list of one)."""
    art.update(_plan(args))
    art["commit"] = _commit()
    art["date"] = time.strftime("%Y-%m-%d")

    def key(e):
        return (e.get("opt", "?"), tuple(e.get("size", ())),
                e.get("metric", "?"))

    entries = []
    if os.path.exists(args.numerics_json):
        with open(args.numerics_json) as f:
            old = json.load(f)
        entries = old if isinstance(old, list) else [old]
    merged = {key(e): e for e in entries}
    merged[key(art)] = art
    with open(args.numerics_json, "w") as f:
        json.dump(list(merged.values()), f, indent=1)
    print(json.dumps({"metric": art["metric"], "opt": art["opt"],
                      "value": art["min_db"], "unit": "dB"}))
    return art


def bench_inference(args, opt, cfg) -> dict:
    """Parameters, MACs a frame and the warmed, steady-state rate of model
    calls on one (1, 2, H, W, 3) input, the cache threaded through. The
    result holds the first call's output (float32, on the host) besides
    the printed figures, for a caller to check."""
    import torch

    from turtlevsr_tpu_torch.models import build_model
    from turtlevsr_tpu_torch.utils.profiling import device_sync, trace

    dtype = _torch_dtype(args.dtype)
    model = build_model(opt, device=args.device, dtype=dtype,
                        fuse=tuple(args.fuse))
    n_params = count_params(model)
    print(f"Params: {n_params / 1e6:.2f} M")

    h, w = args.size
    macs = count_macs(cfg, h, w)
    print(f"MACs/frame: {macs / 1e9:.2f} G ({2 * macs / 1e9:.2f} GFLOP)")
    if args.traffic_json:
        art = {"metric": "macs_per_frame",
               "opt": os.path.basename(args.opt),
               "size": list(args.size),
               "dtype": args.dtype,
               "macs": macs,
               "flops_g": round(2 * macs / 1e9, 2),
               **_plan(args)}
        with open(args.traffic_json, "w") as f:
            json.dump(art, f, indent=1)

    x = torch.from_numpy(np.random.RandomState(0).rand(1, 2, h, w, 3)).to(
        args.device, dtype)
    with torch.inference_mode():
        c = model.init_cache(1, h, w, dtype)
        t_warm = time.perf_counter()
        out, c = model(x, c)
        first = out.clone()
        for _ in range(args.warmup - 1):
            out, c = model(x, c)
        device_sync(out)
        warm_s = time.perf_counter() - t_warm

        tracing = (trace(args.trace_dir) if args.trace_dir
                   else contextlib.nullcontext())
        with tracing:
            t0 = time.perf_counter()
            for i in range(args.iters):
                out, c = model(x, c)
                if (i + 1) % 50 == 0:
                    device_sync(out)
                    fps = (i + 1) / (time.perf_counter() - t0)
                    print(f"Done image [{i + 1:<3}/ {args.iters}], "
                          f"fps: {fps:.1f} img / s, "
                          f"times per image: {1000 / fps:.1f} ms / img",
                          flush=True)
            device_sync(out)
            dt = time.perf_counter() - t0
    if args.trace_dir:
        print(f"Profiler trace written to {args.trace_dir}")
    fps = args.iters / dt
    print(f"Overall fps: {fps:.1f} img / s, "
          f"times per image: {1000 / fps:.1f} ms / img")
    return {"params": n_params, "macs": macs, "fps": fps,
            "ms_per_image": 1000 / fps, "seconds": dt, "iters": args.iters,
            "model_calls": max(args.warmup, 1) + args.iters,
            "warmup_seconds": warm_s, "out_shape": list(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "first_output": first.float().cpu().numpy(), **_plan(args)}


def parse_args(argv=None):
    from turtlevsr_tpu_torch.models.blocks import FUSE_PLANS
    from turtlevsr_tpu_torch.train.step import REMAT_POLICIES

    p = argparse.ArgumentParser(
        prog="python -m turtlevsr_tpu_torch.cli.bench",
        description="Parameters, MACs and speed of a Turtle model.")
    p.add_argument("-opt", "--opt", required=True)
    p.add_argument("--size", type=int, nargs=2, default=[256, 256],
                   metavar=("H", "W"))
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fuse", nargs="*", default=[], choices=FUSE_PLANS,
                   help="the fused plan: which blocks go to the fused "
                        "kernels (default: none)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--remat_policy", default="nothing",
                   choices=sorted(REMAT_POLICIES),
                   help="checkpoint policy of the train-step benchmark")
    p.add_argument("--train_step", action="store_true",
                   help="benchmark the TRAINING step at the option file's "
                        "recipe (batch_size_per_gpu, n_sequence, "
                        "patch_size) instead of inference; prints a "
                        "train_step_ms JSON line")
    p.add_argument("--traffic_json", default=None,
                   help="write the MAC count (and FLOPs = 2 x MACs) per "
                        "frame to this JSON file")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler trace of the timed "
                        "inference calls (view in Perfetto)")
    p.add_argument("--numerics_tile", type=int, default=0,
                   help="with --numerics_overlap: write the TILED-geometry "
                        "numerics line (the reference's own eval protocol) "
                        "instead of whole-frame, e.g. --numerics_tile 320 "
                        "--numerics_overlap 192")
    p.add_argument("--numerics_overlap", type=int, default=192)
    p.add_argument("--numerics_json", default="NUMERICS_torch.json",
                   help="output path of the --numerics artifact (default: "
                        "./NUMERICS_torch.json in the working directory; "
                        "the JAX package's harness writes NUMERICS.json)")
    p.add_argument("--numerics", action="store_true",
                   help="per-frame PSNR of the model in bf16 on the "
                        "hand-written kernels against the float32 plain "
                        "versions on the CPU, at --size")
    args = p.parse_args(argv)
    if args.numerics or args.numerics_tile:
        # the numerics artifact is DEFINED as bf16 on the card's kernels
        # against float32 on the plain versions; other flags would
        # mislabel it
        if args.device != "cuda" or args.dtype != "bfloat16":
            p.error("--numerics always compares bf16 on the card's kernels "
                    "with fp32 on the CPU's plain versions; --device cpu "
                    "and --dtype float32 have no meaning in this mode")
    return args


def main(argv=None) -> dict:
    """Run the harness; returns what it printed (and the exact counts) as a
    dict."""
    args = parse_args(argv)

    from turtlevsr_tpu_torch.config.options import (
        load_options,
        model_config_from_options,
    )
    from turtlevsr_tpu_torch.models import require_device

    require_device(args.device)
    opt = load_options(args.opt, is_train=args.train_step)
    cfg = model_config_from_options(opt)
    if args.train_step:
        return bench_train_step(args, opt, cfg)
    if args.numerics_tile:
        return bench_numerics_tiled(args, opt, cfg)
    if args.numerics:
        return bench_numerics(args, opt, cfg)
    return bench_inference(args, opt, cfg)


if __name__ == "__main__":
    main()
