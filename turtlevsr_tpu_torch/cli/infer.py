"""Inference / evaluation CLI: the counterpart of basicsr/inference.py and
inference_no_ground_truth.py of the reference, and of
``turtlevsr_tpu.cli.infer`` in the JAX package.

With ground truth (per-video PSNR/SSIM, the eval scripts' metric variants):

    python -m turtlevsr_tpu_torch.cli.infer -opt options/Turtle_Deblur_Gopro.yml \\
        --model_path weights.pth --data_dir /data/GoPro/test/blur \\
        --tile 320 --tile_overlap 192 --save_path results/

Without ground truth (any folder of frame folders, FPS report):

    python -m turtlevsr_tpu_torch.cli.infer --task deblur --data_dir DIR --no_gt

Protocol (inference.py:260-370 of the reference):
  * frames stream per video in sorted order, the causal history threaded,
  * --tile turns on the sliding-window protocol with one cache per tile;
    0 runs whole frames; every --task preset is tiled,
  * denoising: gaussian noise of sigma = --noise_sigma / 255 is put on the
    ground-truth frames, sampled once per video from a fixed seed into .npy
    files that later runs reuse (inference.py:115-124),
  * super-resolution (--task sr): the frames of --data_dir are the
    high-resolution ones; the engine resizes each frame (or each tile of the
    grid planned on it) bicubic /4 on the device before the model, and the
    x4 output is compared with the high-resolution ground truth,
  * metrics are the eval scripts' (255-range PSNR, scipy-gaussian SSIM,
    optionally on the Y channel), not the validation loop's,
  * the device runs one frame ahead of the fetch of the previous output;
    metrics and PNG writes ride a worker thread. "FPS:" is end-to-end wall
    time, "Device-loop FPS:" stops the clock at the last output fetch.

What differs from the JAX package's CLI:
  * --device cuda|cpu (default cuda; without a card it raises, it never
    carries on on the CPU by itself);
  * --fuse takes names out of ``models.blocks.FUSE_PLANS`` (channel_runs,
    attn_v_merge, two_stage): the fused plan of ``build_model`` (which
    hand-written kernels serve runs of channel blocks, attention @ v and the
    conv-only levels); there is no --kernels, the port has one route;
  * --model_path is a PyTorch ``.pth`` file: the reference's published
    ``{'params': state_dict}`` files, copies saved from a DDP-wrapped model
    (keys prefixed ``module.``) and a bare ``state_dict`` all load
    (``io.load_state_dict_file``, then ``load_state_dict(strict=True)``:
    the parameter names and shapes are the reference's); orbax checkpoint
    folders are not read;
  * no persistent compile cache: nothing is compiled per shape.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from statistics import mean

import numpy as np

# per-task eval presets of the reference's __main__ blocks
# (inference.py:483-639): option file, tiling, metric flavour, noise
TASK_PRESETS = {
    "deblur": dict(opt="options/Turtle_Deblur_Gopro.yml", tile=320,
                   tile_overlap=192),
    "denoise": dict(opt="options/Turtle_Denoise_Davis.yml", tile=320,
                    tile_overlap=128, noise_sigma=50.0),
    "derain": dict(opt="options/Turtle_Derain.yml", tile=320,
                   tile_overlap=128, y_channel=True),
    "raindrop": dict(opt="options/Turtle_Derain_VRDS.yml", tile=320,
                     tile_overlap=128),
    "desnow": dict(opt="options/Turtle_Desnow.yml", tile=320,
                   tile_overlap=128),
    "sr": dict(opt="options/Turtle_SR_MVSR.yml", tile=256, tile_overlap=64),
}


def stable_video_seed(seed: int, video_name: str) -> int:
    """A per-video noise seed that is the same in every run and process
    (the reference relies on its first run's unseeded .npy files staying on
    disk, inference.py:115-124)."""
    return (seed * 1000003 + zlib.crc32(video_name.encode())) % (2 ** 31)


def prepare_noisy_frames(frames, video_name: str, noise_sigma: float,
                         noisy_root: str, dataset_name: str = "Set8",
                         seed: int = 0):
    """The reference's denoising protocol (inference.py:88-141): the noisy
    frames of a video are sampled once into .npy files and read back by
    every later run, so that scores compare across runs. Gaussian noise of
    sigma / 255 per frame on the [0, 1] ground truth. Returns the sorted
    paths of the .npy files. Seed 0 keeps the reference's folder layout
    ({video}_{sigma}); another seed gets a folder of its own."""
    suffix = "" if seed == 0 else f"_s{seed}"
    folder = os.path.join(noisy_root, dataset_name,
                          f"{video_name}_{int(noise_sigma)}{suffix}")
    os.makedirs(folder, exist_ok=True)
    existing = sorted(glob.glob(os.path.join(folder, "*.npy")))
    if len(existing) == len(frames):
        print(f"reusing pre-sampled noisy frames in {folder}")
        return existing
    rng = np.random.RandomState(stable_video_seed(seed, video_name))
    paths = []
    for i, frame in enumerate(frames):
        noisy = frame + rng.normal(0.0, noise_sigma / 255.0,
                                   frame.shape).astype(np.float32)
        path = os.path.join(folder, f"{i:08d}.npy")
        np.save(path, noisy.astype(np.float32))
        paths.append(path)
    return paths


def save_eval_artifacts(save_path: str, model_name: str, video_name: str,
                        ix: int, inp_u8, pred_u8, gt_u8, psnr: float,
                        ssim: float) -> None:
    """The reference's output layout (inference.py:329-363): per frame
    Frame_{ix+1}_Input/Pred/GT.png and, where matplotlib is installed, a
    triptych Frame_{ix+1}.png, under {save_path}/{model_name}/{video_name}."""
    from turtlevsr_tpu_torch.utils.img import imwrite

    base = os.path.join(save_path, model_name, video_name)
    os.makedirs(base, exist_ok=True)
    imwrite(pred_u8, os.path.join(base, f"Frame_{ix + 1}_Pred.png"))
    imwrite(inp_u8, os.path.join(base, f"Frame_{ix + 1}_Input.png"))
    imwrite(gt_u8, os.path.join(base, f"Frame_{ix + 1}_GT.png"))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # the triptych is optional, the PNGs are written
        return
    fig, axs = plt.subplots(1, 3, figsize=(10, 10))
    axs[0].imshow(inp_u8)
    axs[1].imshow(pred_u8)
    axs[2].imshow(gt_u8)
    axs[0].set_title("Input")
    axs[1].set_title(f"Pred {psnr:.2f}/{ssim:.2f}")
    axs[2].set_title(f"GT Frame {ix}")
    plt.tight_layout()
    fig.savefig(os.path.join(base, f"Frame_{ix + 1}.png"),
                bbox_inches="tight")
    plt.close(fig)


def parse_args(argv=None):
    from turtlevsr_tpu_torch.models.blocks import FUSE_PLANS

    p = argparse.ArgumentParser(
        prog="python -m turtlevsr_tpu_torch.cli.infer",
        description="Stream video folders through a Turtle model.")
    p.add_argument("--task", choices=sorted(TASK_PRESETS),
                   help="fill option file, tiling, metric and noise defaults "
                        "for a task")
    p.add_argument("-opt", "--opt", default=None)
    p.add_argument("--model_path", default=None,
                   help="a .pth file: {'params': state_dict} as the "
                        "reference publishes it (keys may carry DDP's "
                        "'module.') or a bare state_dict; random weights if "
                        "omitted (smoke testing)")
    p.add_argument("--data_dir", required=True,
                   help="folder of video folders (the degraded side)")
    p.add_argument("--gt_dir", default=None,
                   help="ground-truth folder; default: data_dir with 'blur' "
                        "replaced by 'gt'")
    p.add_argument("--save_path", default=None)
    p.add_argument("--tile", type=int, default=None,
                   help="tile size (0 = whole frame; default: the task's "
                        "preset, else 0)")
    p.add_argument("--tile_overlap", type=int, default=None)
    p.add_argument("--no_gt", action="store_true")
    p.add_argument("--y_channel", action="store_true")
    p.add_argument("--noise_sigma", type=float, default=None,
                   help="denoising: make noisy inputs at sigma / 255")
    p.add_argument("--noisy_dir", default=None,
                   help="root of the pre-sampled noisy .npy frames (default: "
                        "<save_path or .>/noisy_data); reused when present")
    p.add_argument("--dataset_name", default="Set8",
                   help="dataset label in the noisy-frame folder layout")
    p.add_argument("--model_name", default="model",
                   help="subfolder of the saved eval artifacts")
    p.add_argument("--seed", type=int, default=0,
                   help="base seed of the per-video noise")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fuse", nargs="*", default=[], choices=FUSE_PLANS,
                   help="the fused plan: which blocks go to the fused "
                        "kernels (default: none)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--max_frames", type=int, default=0)
    args = p.parse_args(argv)
    preset = TASK_PRESETS.get(args.task, {})
    if args.opt is None:
        args.opt = preset.get("opt")
    if args.tile is None:  # a tile given by hand keeps its own overlap
        args.tile = preset.get("tile", 0)
        if args.tile_overlap is None:
            args.tile_overlap = preset.get("tile_overlap")
    if args.tile_overlap is None:
        args.tile_overlap = 128
    if args.noise_sigma is None:
        args.noise_sigma = preset.get("noise_sigma")
    args.y_channel = args.y_channel or preset.get("y_channel", False)
    if args.opt is None:
        p.error("either --task or -opt is required")
    return args


def main(argv=None) -> dict:
    """Run the CLI; returns what it measured: frames, seconds of the whole
    loop and of the device loop, the host's clock at every output fetch,
    and the metrics."""
    args = parse_args(argv)

    import torch

    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.data.loader import prefetch_iter
    from turtlevsr_tpu_torch.eval.engine import InferenceEngine, VideoFrames
    from turtlevsr_tpu_torch.io import load_state_dict_file
    from turtlevsr_tpu_torch.metrics import bgr2ycbcr, psnr_255, ssim_gaussian
    from turtlevsr_tpu_torch.models import build_model
    from turtlevsr_tpu_torch.utils.img import img_from_float, imwrite

    opt = load_options(args.opt, is_train=False)
    model = build_model(opt, device=args.device, fuse=tuple(args.fuse))
    if args.model_path:
        model.load_state_dict(load_state_dict_file(args.model_path),
                              strict=True)
        print(f"> Loaded Model. ({args.model_path})")
    else:
        print("> WARNING: random init (no --model_path)")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    engine = InferenceEngine(
        model, mode="tiled" if args.tile else "whole",
        tile=args.tile or 320, tile_overlap=args.tile_overlap, dtype=dtype,
        device=args.device)

    videos = sorted(d for d in glob.glob(os.path.join(args.data_dir, "*"))
                    if os.path.isdir(d))
    if not videos:
        raise FileNotFoundError(f"no video folders under {args.data_dir}")

    all_psnr, all_ssim, fetch_clock = [], [], []
    total_frames, total_time, device_time = 0, 0.0, 0.0
    for vdir in videos:
        vname = os.path.basename(vdir)
        frames = VideoFrames(vdir)
        gt_frames = None
        if not args.no_gt and args.noise_sigma is None:
            gt_dir = args.gt_dir or args.data_dir.replace("blur", "gt")
            gt_frames = VideoFrames(os.path.join(gt_dir, vname))
        print(f"> # of Frames in {vname}: {len(frames)}")

        noisy_paths = None
        if args.noise_sigma is not None:
            noisy_root = args.noisy_dir or os.path.join(
                args.save_path or ".", "noisy_data")
            noisy_paths = prepare_noisy_frames(
                list(frames), vname, args.noise_sigma, noisy_root,
                dataset_name=args.dataset_name, seed=args.seed)
        engine.reset()
        v_psnr, v_ssim = [], []
        gt_iter = prefetch_iter(gt_frames) if gt_frames else None

        def postprocess(ix, frame, gt, out):
            # on the one postprocess worker, in the order of submission,
            # while the device computes the next frame; `out` is a host
            # array already (fetched on the main thread)
            out_u8 = img_from_float(out)
            ps = ss = float("nan")
            if gt is not None and not args.no_gt:
                gt_u8 = img_from_float(gt)
                if args.y_channel:
                    a = bgr2ycbcr(out_u8[:, :, ::-1])
                    b_ = bgr2ycbcr(gt_u8[:, :, ::-1])
                else:
                    a, b_ = out_u8, gt_u8
                ps = psnr_255(a, b_)
                ss = ssim_gaussian(a, b_)
                v_psnr.append(ps)
                v_ssim.append(ss)
                print(f"PSNR for Frame: {ix} -- {ps}")
            if args.save_path:
                if gt is not None and not args.no_gt:
                    save_eval_artifacts(
                        args.save_path, args.model_name, vname, ix,
                        img_from_float(np.clip(frame, 0.0, 1.0)), out_u8,
                        img_from_float(gt), ps, ss)
                else:
                    imwrite(out_u8, os.path.join(args.save_path, vname,
                                                 f"Frame_{ix + 1}_Pred.png"))

        def fetch(pending, post, futs):
            p_ix, p_frame, p_gt, p_dev = pending
            out = p_dev.float().cpu().numpy()  # waits for the device
            fetch_clock.append(time.perf_counter())
            futs.append(post.submit(postprocess, p_ix, p_frame, p_gt, out))

        # decoding rides the prefetch thread, the device runs one frame
        # ahead of the main thread's fetch, metrics and PNG writes ride the
        # postprocess worker. The fetch stays on the main thread so that
        # the device-loop clock is not bent by slow postprocessing.
        t_loop = time.perf_counter()
        n_vid = 0
        futs = deque()
        pending = None  # (ix, frame, gt, device tensor) awaiting its fetch
        frame_iter = prefetch_iter(frames)
        try:
            with ThreadPoolExecutor(1) as post:
                for ix, frame in enumerate(frame_iter):
                    if args.max_frames and ix >= args.max_frames:
                        break
                    gt = next(gt_iter) if gt_iter else None
                    if noisy_paths is not None:
                        gt = frame
                        frame = np.load(noisy_paths[ix]).astype(np.float32)
                    out_dev = engine.step_async(frame)
                    if pending is not None:
                        fetch(pending, post, futs)
                        while len(futs) > 2:
                            futs.popleft().result()
                    pending = (ix, frame, gt, out_dev)
                    n_vid += 1
                if pending is not None:
                    fetch(pending, post, futs)
                device_time += time.perf_counter() - t_loop
                while futs:
                    futs.popleft().result()
        finally:
            # stop the prefetch producers at once (after an early
            # --max_frames break they would otherwise wait for a collection)
            frame_iter.close()
            if gt_iter is not None:
                gt_iter.close()
        total_time += time.perf_counter() - t_loop
        total_frames += n_vid

        if v_psnr:
            print(f"PSNR for {vname}: {mean(v_psnr)}")
            print(f"SSIM for {vname} is {mean(v_ssim)}")
            all_psnr += v_psnr
            all_ssim += v_ssim

    if total_frames:
        print(f"FPS: {total_frames / total_time:.3f} "
              f"({total_frames} frames in {total_time:.1f}s)")
        if device_time > 0:
            print(f"Device-loop FPS: {total_frames / device_time:.3f}")
    if all_psnr:
        print(f"Overall PSNR: {mean(all_psnr)}")
        print(f"Overall SSIM: {mean(all_ssim)}")
    return {"frames": total_frames, "seconds": total_time,
            "device_loop_seconds": device_time, "fetch_clock": fetch_clock,
            "psnr": all_psnr, "ssim": all_ssim}


if __name__ == "__main__":
    main()
