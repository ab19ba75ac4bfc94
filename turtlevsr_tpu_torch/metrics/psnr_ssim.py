"""Restoration metrics on the host, with numpy and scipy.

The reference has SSIMs that disagree slightly (SURVEY.md section 2.5): the
validation loop's ``calculate_ssim`` (a 3-D gaussian window,
metrics/psnr_ssim.py:149-186, or MATLAB's 2-D one on the Y channel,
:188-226) and the eval scripts' scipy variant (inference.py:33-50). Both are
here, as in the JAX package: ``calculate_psnr`` / ``calculate_ssim`` for the
validation loop of training, ``psnr_255`` / ``ssim_gaussian`` and the MATLAB
Y channel for the inference/eval protocol. The 3-D window is applied
separably.
"""

from __future__ import annotations

import math

import numpy as np


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel's window."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


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


def _to_hwc(img, input_order: str):
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
        if input_order == "HWC" and img.shape[0] in (1, 3):
            # a squeezed torch-style tensor is CHW
            return img.transpose(1, 2, 0)
    if img.ndim == 2:
        img = img[..., None]
    elif input_order == "CHW":
        img = img.transpose(1, 2, 0)
    return img


def _to_y(img_255: np.ndarray) -> np.ndarray:
    """metric_util.to_y_channel:41-53 with matlab_functions.bgr2ycbcr:
    y_255 = dot(img / 255, [24.966, 128.553, 65.481]) + 16 (float32 math,
    not rounded)."""
    x = img_255.astype(np.float32) / 255.0
    if x.ndim == 3 and x.shape[2] == 3:
        y = x @ np.array([24.966, 128.553, 65.481], np.float32) + np.float32(16.0)
        return y[..., None].astype(np.float32)
    return (x * 255.0).astype(np.float32)


def _crop(img1, img2, crop_border: int):
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    return img1, img2


def calculate_psnr(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    """basicsr/metrics/psnr_ssim.py:13-67: PSNR of the float64 MSE; the peak
    is taken from the data (1.0 when the first image is at most 1, else
    255)."""
    img1 = _to_hwc(img1, input_order).astype(np.float64)
    img2 = _to_hwc(img2, input_order).astype(np.float64)
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1, img2 = _crop(img1, img2, crop_border)
    if test_y_channel:
        img1, img2 = _to_y(img1), _to_y(img2)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return 20.0 * math.log10(max_value / math.sqrt(mse))


def _filter_replicate(x: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable correlation with replicated borders on every axis."""
    from scipy.ndimage import correlate1d

    out = x
    for ax in range(x.ndim):
        out = correlate1d(out, k1d, axis=ax, mode="nearest")
    return out


def _ssim_windowed(img1, img2, k1d, c1, c2):
    mu1 = _filter_replicate(img1, k1d)
    mu2 = _filter_replicate(img2, k1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_replicate(img1 ** 2, k1d) - mu1_sq
    sigma2_sq = _filter_replicate(img2 ** 2, k1d) - mu2_sq
    sigma12 = _filter_replicate(img1 * img2, k1d) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1, img2, crop_border: int = 0, input_order: str = "HWC",
                   test_y_channel: bool = False) -> float:
    """The validation loop's SSIM (psnr_ssim.py:229-292). In colour: an
    11^3 gaussian window with replicated borders over the (H, W, C) volume
    (:149-186, ``_ssim_3d``; separable here). On the Y channel: MATLAB's 2-D
    window (:188-226, ``_ssim_cly``)."""
    img1 = _to_hwc(img1, input_order).astype(np.float64)
    img2 = _to_hwc(img2, input_order).astype(np.float64)
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1, img2 = _crop(img1, img2, crop_border)
    k1d = _gaussian_kernel_1d(11, 1.5)
    if test_y_channel:
        img1 = _to_y(img1)[..., 0]
        img2 = _to_y(img2)[..., 0]
        c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
        return _ssim_windowed(img1, img2, k1d, c1, c2)
    max_value = 1.0 if img1.max() <= 1 else 255.0
    c1, c2 = (0.01 * max_value) ** 2, (0.03 * max_value) ** 2
    return _ssim_windowed(img1, img2, k1d, c1, c2)


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
