from turtlevsr_tpu_torch.metrics.psnr_ssim import (  # noqa: F401
    bgr2ycbcr,
    calculate_psnr,
    calculate_ssim,
    psnr_255,
    ssim_gaussian,
)
