"""The port's validation metrics (``calculate_psnr``, ``calculate_ssim``)
against the JAX package's, on the CPU: both are float64 numpy and scipy, so
they agree at rtol 1e-12, over HWC and CHW layouts, a border crop, the Y
channel, floats in [0, 1] and uint8 in [0, 255]."""

import numpy as np
import pytest

from turtlevsr_tpu.metrics import psnr_ssim as J
from turtlevsr_tpu_torch.metrics import (
    calculate_psnr,
    calculate_ssim,
    psnr_ssim as T,
)
from turtlevsr_tpu_torch.utils.img import float_from_img


def _pair(kind, order, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(23, 31, 3)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    if kind == "uint8":
        a, b = (np.round(x * 255).astype(np.uint8) for x in (a, b))
    else:
        a, b = a.astype(np.float32), b.astype(np.float32)
    if order == "CHW":
        a, b = a.transpose(2, 0, 1), b.transpose(2, 0, 1)
    return a, b


CASES = [(kind, order, crop, y) for kind in ("float", "uint8")
         for order in ("HWC", "CHW") for crop in (0, 4) for y in (False, True)]


@pytest.mark.parametrize("kind,order,crop,y", CASES,
                         ids=lambda v: str(v))
def test_calculate_psnr_and_ssim_equal_jax(kind, order, crop, y):
    a, b = _pair(kind, order)
    kw = dict(crop_border=crop, input_order=order, test_y_channel=y)
    for got_fn, want_fn in ((calculate_psnr, J.calculate_psnr),
                            (calculate_ssim, J.calculate_ssim)):
        got, want = got_fn(a, b, **kw), want_fn(a, b, **kw)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_metrics_of_equal_images_and_batched_tensors_equal_jax():
    a, _ = _pair("float", "HWC")
    assert calculate_psnr(a, a) == J.calculate_psnr(a, a) == float("inf")
    np.testing.assert_allclose(calculate_ssim(a, a), 1.0, rtol=1e-12)
    # a squeezed (1, C, H, W) tensor given as HWC, a (1, H, W) grey map
    t = a.transpose(2, 0, 1)[None]
    g = a[None, ..., 0]
    for x, y in ((t, t * 0.9), (g, g * 0.8)):
        for fn, jfn in ((calculate_psnr, J.calculate_psnr),
                        (calculate_ssim, J.calculate_ssim)):
            np.testing.assert_allclose(fn(x, y), jfn(x, y), rtol=1e-12)


def test_helpers_equal_jax():
    np.testing.assert_array_equal(T._gaussian_kernel_1d(11, 1.5),
                                  J._gaussian_kernel_1d(11, 1.5))
    x = np.random.RandomState(4).rand(9, 8, 3) * 255
    np.testing.assert_array_equal(T._to_y(x), J._to_y(x))
    np.testing.assert_array_equal(T._filter_replicate(x, T._gaussian_kernel_1d()),
                                  J._filter_replicate(x, J._gaussian_kernel_1d()))
    u8 = (x).astype(np.uint8)
    from turtlevsr_tpu.utils.img import float_from_img as j_float

    np.testing.assert_array_equal(float_from_img(u8), j_float(u8))
    assert float_from_img(u8).dtype == np.float32
