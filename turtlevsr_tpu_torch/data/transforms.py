"""Geometric augmentations and patch cropping for the training clips.

Own copy of the JAX package's ``data/transforms.py``: the reference's
8-mode flip/rot90 augmentation (basicsr/data/transforms.py:179-236: half the
time the identity, else one of modes 1-7) and its joint random crop
(data_util.py:17-35), with the same ``np.random.RandomState`` draws in the
same order, so that a seed gives the same crops and modes.
"""

from __future__ import annotations

import numpy as np


def data_augmentation(image: np.ndarray, mode: int) -> np.ndarray:
    if mode == 0:
        return image
    if mode == 1:
        return np.flipud(image)
    if mode == 2:
        return np.rot90(image)
    if mode == 3:
        return np.flipud(np.rot90(image))
    if mode == 4:
        return np.rot90(image, k=2)
    if mode == 5:
        return np.flipud(np.rot90(image, k=2))
    if mode == 6:
        return np.rot90(image, k=3)
    if mode == 7:
        return np.flipud(np.rot90(image, k=3))
    raise ValueError(f"invalid augmentation mode {mode}")


def random_augmentation(rng: np.random.RandomState, *arrays):
    """transforms.py:226-236: a coin flip for the identity, else one of
    modes 1-7 applied to every array alike."""
    if rng.randint(0, 2) == 1:
        mode = rng.randint(1, 8)
        return [np.ascontiguousarray(data_augmentation(a, mode))
                for a in arrays]
    return list(arrays)


def get_patch(rng: np.random.RandomState, *arrays, patch_size: int,
              scale: int = 1):
    """data_util.py:17-35: one random (patch, scale * patch) crop of all
    arrays; the first is cropped at the low resolution, the rest at scale
    times it."""
    ih, iw = arrays[0].shape[:2]
    ip = patch_size
    tp = scale * ip
    ix = rng.randint(0, iw - ip + 1)
    iy = rng.randint(0, ih - ip + 1)
    tx, ty = scale * ix, scale * iy
    return [arrays[0][iy:iy + ip, ix:ix + ip, ...]] + [
        a[ty:ty + tp, tx:tx + tp, ...] for a in arrays[1:]]


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """transforms.py:10-27: trim H and W down to multiples of ``scale``."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]
