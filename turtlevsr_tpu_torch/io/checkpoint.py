"""Read the reference's ``.pth`` checkpoints into a ``state_dict``.

The published files are ``{'params': state_dict}`` (the reference's
``base_model.py`` saves them so); copies saved from a DDP-wrapped model carry
a leading ``module.`` on every key. The counterpart of the JAX package's
``load_torch_checkpoint`` together with the ``module.`` strip of its
``params_from_torch_state_dict``; the result goes to
``model.load_state_dict(..., strict=True)`` as it is.
"""

from __future__ import annotations

from typing import Dict

import torch

_DDP_PREFIX = "module."


def load_state_dict_file(path: str,
                         param_key: str = "params") -> Dict[str, torch.Tensor]:
    """The state dict held by the file at ``path``: ``blob[param_key]`` when
    the file holds a dict with that key, else the blob itself, with one
    leading ``module.`` stripped from every key. Loaded on the CPU with
    ``weights_only=True``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and param_key in blob:
        blob = blob[param_key]
    return {(k[len(_DDP_PREFIX):] if k.startswith(_DDP_PREFIX) else k): v
            for k, v in blob.items()}
