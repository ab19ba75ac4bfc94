"""Training losses.

The reference hardwires L1 (loss/__init__.py:8-17, used at
video_restoration_model.py:38,94) and also defines a PSNR loss
(loss/__init__.py:20-41). Losses compute in float32 whatever the forward's
type, as the JAX package's do.
"""

from __future__ import annotations

import math

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def psnr_loss(pred: torch.Tensor, target: torch.Tensor,
              toy: bool = False) -> torch.Tensor:
    """-PSNR/10 style loss (scale folded like the BasicSR PSNRLoss)."""
    mse = (pred.float() - target.float()).square().mean(dim=(-3, -2, -1))
    scale = 10.0 / math.log(10.0)
    return (scale * torch.log(mse + 1e-8)).mean()


LOSSES = {"L1Loss": l1_loss, "L1BaseLoss": l1_loss, "PSNRLoss": psnr_loss}
