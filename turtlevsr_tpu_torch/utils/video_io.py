"""Video <-> frame-folder tools: the reference's video_to_frames.py and
make_video.py, and the comparison videos of its app (app.py:93-230); the
counterpart of ``turtlevsr_tpu.utils.video_io`` in the JAX package, the
same files frame for frame. cv2 is imported inside each function, so the
package imports without it."""

from __future__ import annotations

import glob
import os
from typing import Optional


def extract_frames(video_path: str, output_dir: str,
                   target_fps: Optional[float] = None,
                   img_format: str = "png") -> int:
    """mp4 -> numbered frames with dynamic zero-padding and optional fps
    down-sampling (video_to_frames.py:6-90)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {video_path}")
    os.makedirs(output_dir, exist_ok=True)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    step = 1
    if target_fps and target_fps < src_fps:
        step = max(1, round(src_fps / target_fps))
    kept = (total + step - 1) // step if total else 0
    pad = max(5, len(str(kept)))

    n_in = n_out = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if n_in % step == 0:
            cv2.imwrite(os.path.join(output_dir,
                                     f"{n_out:0{pad}d}.{img_format}"), frame)
            n_out += 1
        n_in += 1
    cap.release()
    return n_out


def frames_to_video(frames_dir: str, output_path: str, fps: float = 30.0,
                    pattern: str = "*.*") -> int:
    """Frame folder -> mp4."""
    import cv2

    files = sorted(glob.glob(os.path.join(frames_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no frames in {frames_dir}")
    first = cv2.imread(files[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in files:
        vw.write(cv2.imread(f))
    vw.release()
    return len(files)


def _imread_checked(cv2, path: str):
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cv2.imread failed to decode frame: {path}")
    return img


def side_by_side_video(input_dir: str, pred_dir: str, output_path: str,
                       fps: float = 20.0) -> int:
    """Input | prediction horizontally stacked per frame (app.py:93-147)."""
    import cv2
    import numpy as np

    in_files = sorted(glob.glob(os.path.join(input_dir, "*.*")))
    pr_files = sorted(glob.glob(os.path.join(pred_dir, "*.*")))
    n = min(len(in_files), len(pr_files))
    if n == 0:
        raise FileNotFoundError("no frame pairs")
    # the prediction's resolution is canonical (SR outputs are larger than
    # the input): the INPUT is upscaled to match, like restore_image
    first = _imread_checked(cv2, pr_files[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w * 2, h))
    for i in range(n):
        a = _imread_checked(cv2, in_files[i])
        b = _imread_checked(cv2, pr_files[i])
        if a.shape[:2] != (h, w):
            a = cv2.resize(a, (w, h))
        if b.shape[:2] != (h, w):
            b = cv2.resize(b, (w, h))
        vw.write(np.hstack((a, b)))
    vw.release()
    return n


def comparison_slider_video(input_dir: str, pred_dir: str, output_path: str,
                            fps: float = 20.0, line_width: int = 4) -> int:
    """Sliding before/after comparison: the split position sweeps back and
    forth (triangle wave) with a drawn handle (app.py:149-230)."""
    import cv2
    import numpy as np

    in_files = sorted(glob.glob(os.path.join(input_dir, "*.*")))
    pr_files = sorted(glob.glob(os.path.join(pred_dir, "*.*")))
    n = min(len(in_files), len(pr_files))
    if n == 0:
        raise FileNotFoundError("no frame pairs")
    first = _imread_checked(cv2, pr_files[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    period = max(n, 2)
    for i in range(n):
        a = _imread_checked(cv2, in_files[i])
        b = _imread_checked(cv2, pr_files[i])
        if a.shape[:2] != (h, w):
            a = cv2.resize(a, (w, h))
        if b.shape[:2] != (h, w):
            b = cv2.resize(b, (w, h))
        # triangle wave 0 -> 1 -> 0 across the clip
        t = (2.0 * i / period) % 2.0
        frac = t if t <= 1.0 else 2.0 - t
        split = int(np.clip(frac * w, 1, w - 1))
        frame = np.concatenate([a[:, :split], b[:, split:]], axis=1)
        frame[:, max(split - line_width // 2, 0):split + line_width // 2] = \
            (255, 255, 255)
        cv2.circle(frame, (split, h // 2), max(8, line_width * 3),
                   (255, 255, 255), -1)
        cv2.circle(frame, (split, h // 2), max(8, line_width * 3),
                   (64, 64, 64), 2)
        vw.write(frame)
    vw.release()
    return n


def comparison_wipe_video(input_dir: str, pred_dir: str, output_path: str,
                          fps: float = 30.0, line_width: int = 4) -> int:
    """Input-vs-prediction mp4 with a moving vertical wipe line
    (make_video.py:27-60)."""
    import cv2
    import numpy as np

    in_files = sorted(glob.glob(os.path.join(input_dir, "*.*")))
    pr_files = sorted(glob.glob(os.path.join(pred_dir, "*.*")))
    n = min(len(in_files), len(pr_files))
    if n == 0:
        raise FileNotFoundError("no frame pairs")
    first = cv2.imread(in_files[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for i in range(n):
        a = cv2.imread(in_files[i])
        b = cv2.imread(pr_files[i])
        if b.shape[:2] != (h, w):
            b = cv2.resize(b, (w, h))
        split = int(w * (i + 1) / n)
        frame = np.concatenate([a[:, :split], b[:, split:]], axis=1)
        frame[:, max(split - line_width // 2, 0):split + line_width // 2] = \
            (255, 255, 255)
        vw.write(frame)
    vw.release()
    return n
