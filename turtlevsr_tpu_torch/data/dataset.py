"""Frame-folder video datasets of training (host side, numpy).

Own copy of the JAX package's ``data/dataset.py``, after the reference's
video_image_dataset.py and video_super_image_dataset.py: the layout
``root/{gt,blur}/video/frame``, sliding windows of ``n_sequence`` frames,
one joint random crop, size_must_mode trim and 8-mode augmentation per clip
(in training), gaussian noise made on the fly for paths that hold "DAVIS"
(sigma ~ U[20, 50] / 255 per frame in training, 50 / 255 in validation:
video_image_dataset.py:89-112), and for SR the LQ made at load time by a
bicubic / 4 (video_super_image_dataset.py:128-134).

Frames are read with PIL. The SR / 4 is the port's ``resize_bicubic`` (a =
-0.75, cv2's INTER_CUBIC) in float64, rounded and saturated to uint8; cv2
computes it in fixed point, so this LQ may differ from cv2's by one level of
255 at some pixels.

Items are dicts of NHWC float32 clips scaled by rgb_range (``lq``, ``gt``)
and the frames' ``key``; the loader stacks them to (B, T, H, W, C). Two
quirks of the JAX package are kept: ``manual_seed`` 0 gives an unseeded
generator, and the loader's worker threads share one generator.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from turtlevsr_tpu_torch.data.transforms import get_patch, random_augmentation


def _imread(path: str) -> np.ndarray:
    """uint8 HWC RGB (a grey frame repeated over three channels)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGB")
        img = np.asarray(im)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def _bicubic_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 HWC resized bicubic (a = -0.75, half-pixel centres, border
    taps replicated, no antialias) in float64, rounded and saturated."""
    import torch

    from turtlevsr_tpu_torch.ops.resize import resize_bicubic

    x = torch.from_numpy(img.astype(np.float64))[None]
    y = resize_bicubic(x, out_h, out_w)[0].numpy()
    return np.clip(np.round(y), 0, 255).astype(np.uint8)


class _FrameFolderBase:
    def __init__(self, opt: dict, phase: str):
        self.opt = opt
        self.phase = phase
        self.n_seq = int(opt["n_sequence"])
        self.n_colors = int(opt.get("n_colors", 3))
        self.rgb_range = float(opt.get("rgb_range", 1))
        self.patch_size = int(opt.get("patch_size", 192))
        self.no_augment = bool(opt.get("no_augment", False))
        self.size_must_mode = int(opt.get("size_must_mode", 1))

        if phase == "train":
            roots = opt["dir_data"]
        else:
            roots = opt["datasets"]["val"]["dir_data"]
        if not isinstance(roots, (list, tuple)):
            roots = [roots]

        self.images_gt: List[List[str]] = []
        self.images_input: List[List[str]] = []
        self.n_frames_video: List[int] = []
        for root in roots:
            gt_videos = sorted(glob.glob(os.path.join(root, "gt", "*")))
            in_videos = sorted(glob.glob(os.path.join(root, self._lq_dir(),
                                                      "*")))
            assert len(gt_videos) == len(in_videos), (
                f"gt/{self._lq_dir()} video count mismatch under {root}")
            for gv, iv in zip(gt_videos, in_videos):
                g = sorted(glob.glob(os.path.join(gv, "*")))
                i = sorted(glob.glob(os.path.join(iv, "*")))
                self.images_gt.append(g)
                self.images_input.append(i)
                self.n_frames_video.append(len(g))
        self.num_video = len(self.images_gt)
        self.num_frame = (sum(self.n_frames_video)
                          - (self.n_seq - 1) * len(self.n_frames_video))
        self._rng = np.random.RandomState(
            int(opt.get("manual_seed", 0)) or None)

    def _lq_dir(self) -> str:
        return "blur"

    def __len__(self):
        return self.num_frame

    def _locate(self, idx: int):
        idx = idx % self.num_frame
        for v, n in enumerate(self.n_frames_video):
            poss = n - self.n_seq + 1
            if idx < poss:
                return v, idx
            idx -= poss
        raise IndexError


def _keys(paths: List[str]) -> List[str]:
    return [os.path.split(os.path.dirname(p))[-1] + "."
            + os.path.splitext(os.path.basename(p))[0] for p in paths]


class VideoImageDataset(_FrameFolderBase):
    """Deblurring, deraining, desnowing and denoising clips
    (video_image_dataset.py:9-186)."""

    def _add_noise(self, img_255: np.ndarray) -> np.ndarray:
        if self.phase == "train":
            r1, r2 = 20.0 / 255.0, 50.0 / 255.0
            stdn = self._rng.rand() * (r2 - r1) + r1
        else:
            stdn = 50.0 / 255.0
        noise = self._rng.normal(0.0, stdn, img_255.shape)
        return (noise + img_255 / 255.0) * 255.0

    def __getitem__(self, idx: int) -> dict:
        v, f = self._locate(idx)
        gt_paths = self.images_gt[v][f:f + self.n_seq]
        in_paths = self.images_input[v][f:f + self.n_seq]
        gts = [_imread(p).astype(np.float64) for p in gt_paths]
        lqs = [_imread(p).astype(np.float64) for p in in_paths]

        # one joint crop over the clip, its frames concatenated on the
        # channels as in the reference (video_image_dataset.py:114-122)
        if self.phase == "train":
            lq_cat = np.concatenate(lqs, axis=2)
            gt_cat = np.concatenate(gts, axis=2)
            lq_cat, gt_cat = get_patch(self._rng, lq_cat, gt_cat,
                                       patch_size=self.patch_size)
            m = self.size_must_mode
            h, w = lq_cat.shape[:2]
            lq_cat = lq_cat[: h - h % m, : w - w % m]
            gt_cat = gt_cat[: h - h % m, : w - w % m]
            if not self.no_augment:
                lq_cat, gt_cat = random_augmentation(self._rng, lq_cat, gt_cat)
            c = self.n_colors
            lqs = [lq_cat[..., i * c:(i + 1) * c] for i in range(self.n_seq)]
            gts = [gt_cat[..., i * c:(i + 1) * c] for i in range(self.n_seq)]

        out_lq = [self._add_noise(img) if "DAVIS" in path else img
                  for path, img in zip(in_paths, lqs)]
        scale = self.rgb_range / 255.0
        lq = np.stack(out_lq).astype(np.float32) * scale
        gt = np.stack(gts).astype(np.float32) * scale
        return {"lq": lq, "gt": gt, "key": _keys(gt_paths)}


class VideoSuperImageDataset(_FrameFolderBase):
    """x4 SR clips: GT at full resolution, the LQ its bicubic / 4 made at
    load time (video_super_image_dataset.py)."""

    SCALE = 4

    def __getitem__(self, idx: int) -> dict:
        v, f = self._locate(idx)
        gt_paths = self.images_gt[v][f:f + self.n_seq]
        in_paths = self.images_input[v][f:f + self.n_seq]
        gts = [_imread(p) for p in gt_paths]
        lqs = []
        for p in in_paths:
            img = _imread(p)
            h, w = img.shape[:2]
            lqs.append(_bicubic_u8(img, h // self.SCALE, w // self.SCALE))

        lq_seq = np.stack([a.astype(np.float64) for a in lqs])
        gt_seq = np.stack([a.astype(np.float64) for a in gts])

        if self.phase == "train":
            # one joint (LR patch, x4 HR patch) crop and augmentation
            # (video_super_image_dataset.py:152-164); LR patch = patch // 4
            ps = self.patch_size // self.SCALE
            t, ih, iw, c = lq_seq.shape
            lr_flat = lq_seq.transpose(1, 2, 0, 3).reshape(ih, iw, t * c)
            hh, hw = gt_seq.shape[1:3]
            hr_flat = gt_seq.transpose(1, 2, 0, 3).reshape(hh, hw, t * c)
            lr_flat, hr_flat = get_patch(self._rng, lr_flat, hr_flat,
                                         patch_size=ps, scale=self.SCALE)
            if not self.no_augment:
                lr_flat, hr_flat = random_augmentation(self._rng, lr_flat,
                                                       hr_flat)
            lq_seq = lr_flat.reshape(ps, ps, t, c).transpose(2, 0, 1, 3)
            hp = ps * self.SCALE
            gt_seq = hr_flat.reshape(hp, hp, t, c).transpose(2, 0, 1, 3)

        scale = self.rgb_range / 255.0
        return {"lq": lq_seq.astype(np.float32) * scale,
                "gt": gt_seq.astype(np.float32) * scale,
                "key": _keys(gt_paths)}


def create_dataset(opt: dict, phase: str):
    """The dataset of an option file's task: the reference picks the SR one
    by swapping an import in train.py:24-28 (readme.md:106-112); here the
    option file's ``model`` / ``type`` decide."""
    model = str(opt.get("model", "")).lower()
    task = str(opt.get("type", "")).lower()
    if "super" in model or "superresolution" in task:
        return VideoSuperImageDataset(opt, phase)
    return VideoImageDataset(opt, phase)
