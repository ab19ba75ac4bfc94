"""The metrics of the inference/eval protocol, on the host with numpy and
scipy: 255-range PSNR, the eval scripts' scipy-gaussian SSIM and the MATLAB
Y channel (inference.py:33-84 of the reference). The validation loop's
variants belong to training and are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np


def bgr2ycbcr(img: np.ndarray, y_only: bool = True) -> np.ndarray:
    """BGR -> YCbCr, MATLAB convention (matlab_functions.py:179-230 /
    inference.py:63-84). uint8 input in [0, 255] gives a rounded uint8
    output; float input in [0, 1] a float output in [0, 1]."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    if y_only:
        out = x @ np.array([24.966, 128.553, 65.481]) / 255.0 + 16.0
    else:
        out = x @ np.array([[24.966, 112.0, -18.214],
                            [128.553, -74.203, -93.786],
                            [65.481, -37.797, 112.0]]) / 255.0 \
            + np.array([16, 128, 128])
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def psnr_255(img1: np.ndarray, img2: np.ndarray) -> float:
    """inference.py:52-61 calc_PSNR: inputs in [0, 255], fp64 MSE."""
    diff = img1.astype(np.float64) - img2.astype(np.float64)
    mse = np.mean(diff ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * math.log10(255.0 / math.sqrt(mse))


def ssim_gaussian(img1: np.ndarray, img2: np.ndarray, sd: float = 1.5,
                  c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> float:
    """Eval-script SSIM (inference.py:33-50): scipy's gaussian_filter over
    the whole (H, W, C) array (the channel axis is smoothed too, as the
    reference does), inputs in [0, 255]."""
    from scipy.ndimage import gaussian_filter

    img1 = np.asarray(img1, np.float32) / 255.0
    img2 = np.asarray(img2, np.float32) / 255.0
    mu1 = gaussian_filter(img1, sd)
    mu2 = gaussian_filter(img2, sd)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = gaussian_filter(img1 * img1, sd) - mu1_sq
    sigma2_sq = gaussian_filter(img2 * img2, sd) - mu2_sq
    sigma12 = gaussian_filter(img1 * img2, sd) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(np.mean(ssim_map))
