"""Image I/O helpers (img_util.py of the reference, for NHWC float data)."""

from __future__ import annotations

import os

import numpy as np


def img_from_float(img: np.ndarray) -> np.ndarray:
    """[0, 1] float HWC RGB -> uint8 with tensor2img's clamp and round
    (img_util.py:42-105, without the BGR flip: files are written RGB)."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (x * 255.0).round().astype(np.uint8)


def float_from_img(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1]."""
    return np.asarray(img, np.float32) / 255.0


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> None:
    """img_util.py:147-169; takes uint8 HWC RGB, or float in [0, 1]."""
    from PIL import Image

    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    if img.dtype != np.uint8:
        img = img_from_float(img)
    Image.fromarray(img).save(file_path)
