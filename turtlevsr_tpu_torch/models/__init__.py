"""Model construction from option dicts."""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.config.options import (  # noqa: F401
    ModelConfig,
    model_config_from_options,
)
from turtlevsr_tpu_torch.models.turtle import (  # noqa: F401
    Turtle,
    init_cache,
    init_params,
    padded_hw,
)


def require_device(device) -> torch.device:
    """The device an entry point was asked for; CUDA without a card raises
    (an entry point never carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "turtlevsr_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU")
    return device


def build_model(opt: dict, device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                fuse=()) -> Turtle:
    """Build the model an option dict describes, with freshly initialised
    parameters, in eval mode on ``device``. ``model.cfg`` is the frozen
    ModelConfig; ``model.init_cache(batch, h, w)`` makes the empty history;
    ``model(x_pair, cache)`` is one frame step. ``fuse``: the fused plan, a
    tuple out of ``("channel_runs", "attn_v_merge")``, empty by default: it
    chooses between hand-written kernels (see ``models/blocks.py``) and
    changes no parameter."""
    device = require_device(device)
    cfg = model_config_from_options(opt)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_params(cfg, generator, device, dtype, fuse).eval()
