"""Gradio web app: the reference's app.py (video and image restoration
tabs, result, wipe, side-by-side and slider comparison outputs, a custom
checkpoint and option file, cancellable jobs), the counterpart of the JAX
package's ``turtlevsr_tpu.app``, on the port's engine and kernels.

Requires ``gradio`` (imported only by :func:`create_ui` and :func:`main`):

    python -m turtlevsr_tpu_torch.app --ckpt-dir checkpoints/

Jobs run in gradio's worker threads with a cooperative cancel
(``threading.Event``) checked between frames, instead of the reference's
SystemExit injected into threads through ctypes (app.py:66-87); each task's
checkpoint is looked up under ``--ckpt-dir`` as ``<name>.pth`` (the
reference's format: ``{'params': state_dict}``, ``module.`` keys or a bare
state dict) instead of a hard-coded path. Without one, the weights are
drawn from ``torch.Generator().manual_seed(0)``. ``restore_video`` and
``restore_image`` run on the card (``device="cuda"``, bfloat16) and raise
without one; ``device="cpu"`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

import numpy as np
import torch

# task -> (option file, checkpoint name); checkpoints resolve under ckpt_dir
SUPPORTED_TASKS = {
    "Video Deblurring (GoPro)": ("Turtle_Deblur_Gopro.yml", "GoPro_Deblur"),
    "Video Deraining (NightRain)": ("Turtle_Derain.yml", "NightRain"),
    "Rain Drop Removal (VRDS)": ("Turtle_Derain_VRDS.yml", "RainDrop"),
    "Video Desnowing (RSVD)": ("Turtle_Desnow.yml", "Desnow"),
    "Video Denoising (DAVIS/Set8)": ("Turtle_Denoise_Davis.yml", "Denoise"),
    "Video Super-Resolution x4 (MVSR)": ("Turtle_SR_MVSR.yml", "SR"),
}

MAX_DIM = 3840  # 4K guard (app.py:413)


class Job:
    """A restoration job: ``cancel`` is checked before each frame;
    ``progress`` runs from 0 to 0.8 over the frame loop."""

    def __init__(self):
        self.cancel = threading.Event()
        self.progress = 0.0


def _build_task_model(task: str, ckpt_dir: str, options_dir: str,
                      custom_model_path: str = "",
                      custom_config_path: str = "",
                      device: torch.device | str = "cuda"):
    """The task's model on ``device``, honouring a custom checkpoint and
    option file (app.py:493-500): the checkpoint is ``custom_model_path``,
    else ``<ckpt_dir>/<name>.pth`` when it exists, else none (weights from
    the seed 0)."""
    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.io.checkpoint import restore_params
    from turtlevsr_tpu_torch.models import build_model, require_device

    device = require_device(device)
    yml, ckpt_name = SUPPORTED_TASKS[task]
    opt = load_options(custom_config_path or os.path.join(options_dir, yml),
                       is_train=False)
    ckpt = custom_model_path or None
    if not ckpt:
        cand = os.path.join(ckpt_dir, ckpt_name + ".pth")
        ckpt = cand if os.path.isfile(cand) else None
    model = build_model(opt, device=device,
                        generator=torch.Generator().manual_seed(0))
    if ckpt:
        model.load_state_dict(restore_params(ckpt), strict=True)
    return model


def _engine(model, tile: int, device):
    from turtlevsr_tpu_torch.eval.engine import InferenceEngine

    if tile:  # the engine's own overlap (128), as the JAX app keeps its
        return InferenceEngine(model, mode="tiled", tile=tile, device=device)
    return InferenceEngine(model, mode="whole", device=device)


def restore_video(video_path: str, task: str, ckpt_dir: str,
                  options_dir: str, tile: int = 0, max_frames: int = 0,
                  job: Job | None = None, progress_cb=None,
                  custom_model_path: str = "",
                  custom_config_path: str = "",
                  device: torch.device | str = "cuda") -> dict:
    """Extract the frames, restore them as a stream, assemble the restored
    video and the comparisons (wipe, side-by-side, slider; app.py:93-384).

    Returns {"status": "ok", "video", "comparison", "side_by_side",
    "slider": mp4 paths, "fps", "frames": the restored PNGs' folder,
    "input_frames": the extracted frames' folder, "fetch_clock": the host's
    clock (perf_counter) at each output fetch, "work": the job's folder}, or
    {"status": "cancelled"} when ``job.cancel`` was set before a frame."""
    from PIL import Image

    from turtlevsr_tpu_torch.models import require_device
    from turtlevsr_tpu_torch.utils.img import (
        float_from_img,
        img_from_float,
        imwrite,
    )
    from turtlevsr_tpu_torch.utils.video_io import (
        comparison_slider_video,
        comparison_wipe_video,
        extract_frames,
        frames_to_video,
        side_by_side_video,
    )

    device = require_device(device)
    job = job or Job()
    model = _build_task_model(task, ckpt_dir, options_dir, custom_model_path,
                              custom_config_path, device)

    work = tempfile.mkdtemp(prefix="turtle_app_")
    frames_dir = os.path.join(work, "frames")
    out_dir = os.path.join(work, "restored")
    os.makedirs(out_dir, exist_ok=True)
    n = extract_frames(video_path, frames_dir)
    if max_frames:
        n = min(n, max_frames)

    files = sorted(os.listdir(frames_dir))[:n]
    first = Image.open(os.path.join(frames_dir, files[0]))
    if max(first.size) > MAX_DIM:
        raise ValueError(f"video exceeds {MAX_DIM}px limit")

    engine = _engine(model, tile, device)
    # one-frame-lag pipeline (as cli/infer.py): frame i is queued on the
    # device before frame i-1's output is fetched, so the host's PNG decode
    # and encode overlap the device's work; one writer thread keeps the
    # writes in order
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    pending = None  # (index, file name, device output) awaiting its fetch
    futs = deque()
    fetch_clock = []

    def write_out(fname, out_np, i):
        imwrite(img_from_float(out_np), os.path.join(out_dir, fname))
        job.progress = 0.3 + 0.5 * (i + 1) / len(files)
        if progress_cb:
            progress_cb(job.progress)

    def fetch(post, i, fname, dev):
        out = dev.float().cpu().numpy()  # waits for the device
        fetch_clock.append(time.perf_counter())
        futs.append(post.submit(write_out, fname, out, i))

    with ThreadPoolExecutor(1) as post:
        for i, f in enumerate(files):
            if job.cancel.is_set():
                return {"status": "cancelled"}
            img = float_from_img(np.asarray(
                Image.open(os.path.join(frames_dir, f)).convert("RGB")))
            out_dev = engine.step_async(img)
            if pending is not None:
                fetch(post, *pending)
                while len(futs) > 2:
                    futs.popleft().result()
            pending = (i, f, out_dev)
        if pending is not None:
            fetch(post, *pending)
        while futs:
            futs.popleft().result()
    fps = len(files) / (time.time() - t0)

    result = os.path.join(work, "restored.mp4")
    frames_to_video(out_dir, result)
    wipe = os.path.join(work, "comparison.mp4")
    comparison_wipe_video(frames_dir, out_dir, wipe)
    sbs = os.path.join(work, "side_by_side.mp4")
    side_by_side_video(frames_dir, out_dir, sbs)
    slider = os.path.join(work, "slider.mp4")
    comparison_slider_video(frames_dir, out_dir, slider)
    return {"status": "ok", "video": result, "comparison": wipe,
            "side_by_side": sbs, "slider": slider, "fps": fps,
            "frames": out_dir, "input_frames": frames_dir,
            "fetch_clock": fetch_clock, "work": work}


def restore_image(image_path: str, task: str, ckpt_dir: str,
                  options_dir: str, tile: int = 0,
                  custom_model_path: str = "",
                  custom_config_path: str = "",
                  device: torch.device | str = "cuda") -> dict:
    """One image through the same engine as a one-frame video (the
    reference's image tab, app.py:667-811); returns the restored PNG and an
    input | restored PNG (the input resized to the output's size first,
    as SR needs)."""
    from PIL import Image

    from turtlevsr_tpu_torch.models import require_device
    from turtlevsr_tpu_torch.utils.img import (
        float_from_img,
        img_from_float,
        imwrite,
    )

    device = require_device(device)
    img = Image.open(image_path).convert("RGB")
    if max(img.size) > MAX_DIM:
        raise ValueError(f"image exceeds {MAX_DIM}px limit")
    model = _build_task_model(task, ckpt_dir, options_dir, custom_model_path,
                              custom_config_path, device)
    engine = _engine(model, tile, device)
    out = engine.step(float_from_img(np.asarray(img)))
    work = tempfile.mkdtemp(prefix="turtle_img_")
    out_path = os.path.join(work, "restored.png")
    out8 = img_from_float(out)
    imwrite(out8, out_path)
    inp8 = np.asarray(img)
    if out8.shape[:2] != inp8.shape[:2]:  # SR: upscale input for comparison
        inp8 = np.asarray(img.resize((out8.shape[1], out8.shape[0])))
    sbs_path = os.path.join(work, "side_by_side.png")
    imwrite(np.hstack((inp8, out8)), sbs_path)
    return {"status": "ok", "image": out_path, "side_by_side": sbs_path,
            "work": work}


def create_ui(ckpt_dir: str, options_dir: str,
              device: torch.device | str = "cuda"):
    import gradio as gr

    jobs: dict = {}

    def process(video, task, tile, use_custom, custom_ckpt, custom_yml):
        job = Job()
        jobs[id(job)] = job
        try:
            res = restore_video(
                video, task, ckpt_dir, options_dir,
                tile=int(tile) if tile else 0, job=job,
                custom_model_path=custom_ckpt if use_custom else "",
                custom_config_path=custom_yml if use_custom else "",
                device=device)
        except Exception as e:  # shown in the UI's status box
            return None, None, None, None, f"Error: {e}"
        if res["status"] != "ok":
            return None, None, None, None, res["status"]
        return (res["video"], res["comparison"], res["side_by_side"],
                res["slider"], f"done ({res['fps']:.2f} frames/s)")

    def process_image(image, task, tile, use_custom, custom_ckpt,
                      custom_yml):
        try:
            res = restore_image(
                image, task, ckpt_dir, options_dir,
                tile=int(tile) if tile else 0,
                custom_model_path=custom_ckpt if use_custom else "",
                custom_config_path=custom_yml if use_custom else "",
                device=device)
        except Exception as e:
            return None, None, f"Error: {e}"
        return res["image"], res["side_by_side"], "done"

    with gr.Blocks(title="Turtle Video Restoration (CUDA)") as demo:
        gr.Markdown("# Turtle Video Restoration — CUDA")
        with gr.Accordion("Custom model", open=False):
            use_custom = gr.Checkbox(label="Use custom checkpoint/config",
                                     value=False)
            custom_ckpt = gr.Textbox(label="Checkpoint path (.pth)")
            custom_yml = gr.Textbox(label="Option file path (.yml)")
        with gr.Tab("Video Restoration"):
            with gr.Row():
                with gr.Column():
                    vid = gr.Video(label="Input video")
                    task = gr.Dropdown(list(SUPPORTED_TASKS), label="Task",
                                       value=list(SUPPORTED_TASKS)[0])
                    tile = gr.Number(label="Tile size (0 = whole frame)",
                                     value=0)
                    btn = gr.Button("Restore")
                with gr.Column():
                    out_v = gr.Video(label="Restored")
                    out_c = gr.Video(label="Comparison (wipe)")
                    out_s = gr.Video(label="Side by side")
                    out_sl = gr.Video(label="Slider comparison")
                    status = gr.Textbox(label="Status")
            btn.click(process,
                      [vid, task, tile, use_custom, custom_ckpt, custom_yml],
                      [out_v, out_c, out_s, out_sl, status])
        with gr.Tab("Image Restoration"):
            with gr.Row():
                with gr.Column():
                    img = gr.Image(label="Input image", type="filepath")
                    itask = gr.Dropdown(list(SUPPORTED_TASKS), label="Task",
                                        value=list(SUPPORTED_TASKS)[0])
                    itile = gr.Number(label="Tile size (0 = whole frame)",
                                      value=0)
                    ibtn = gr.Button("Restore image")
                with gr.Column():
                    iout = gr.Image(label="Restored")
                    isbs = gr.Image(label="Side by side")
                    istatus = gr.Textbox(label="Status")
            ibtn.click(process_image,
                       [img, itask, itile, use_custom, custom_ckpt,
                        custom_yml],
                       [iout, isbs, istatus])
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--options-dir", default="options")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="cpu runs the plain versions (a dry run)")
    args = p.parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit("gradio is not installed; the inference CLI "
                         "(python -m turtlevsr_tpu_torch.cli.infer) provides "
                         "the same pipeline headless")
    from turtlevsr_tpu_torch.models import require_device

    demo = create_ui(args.ckpt_dir, args.options_dir,
                     require_device(args.device))
    demo.launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
