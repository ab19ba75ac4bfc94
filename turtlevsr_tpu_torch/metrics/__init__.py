from turtlevsr_tpu_torch.metrics.psnr_ssim import (  # noqa: F401
    bgr2ycbcr,
    psnr_255,
    ssim_gaussian,
)
