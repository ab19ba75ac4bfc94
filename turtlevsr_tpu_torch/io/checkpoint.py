"""The reference's ``.pth`` checkpoints: reading them, and training's saving
and auto-resume in the reference's own format.

The published files are ``{'params': state_dict}`` (the reference's
``base_model.py`` saves them so); copies saved from a DDP-wrapped model carry
a leading ``module.`` on every key. ``load_state_dict_file`` is the
counterpart of the JAX package's ``load_torch_checkpoint`` together with the
``module.`` strip of its ``params_from_torch_state_dict``; the result goes
to ``model.load_state_dict(..., strict=True)`` as it is.

Training saves what the reference saves at each checkpoint (base_model.py
:193-224 and :288-311), where the JAX package saves orbax directories:

  experiments/{name}/models/net_g_{iter}.pth          {'params': masters}
  experiments/{name}/training_states/{iter}.state     {'epoch', 'iter',
      'optimizers': [AdamW's state_dict], 'schedulers': []}

The masters are float32 under the model's parameter names, which are the
reference's, so ``net_g_{iter}.pth`` is a reference state dict as it is.
The schedules are pure functions of the step, so no scheduler state is
kept. Each file is written under a temporary name and renamed into place: a
run cut while saving leaves no half file for auto-resume to pick.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

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


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _save_atomic(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def net_path(exp_root: str, step: int) -> str:
    return os.path.join(exp_root, "models", f"net_g_{step}.pth")


def state_path(exp_root: str, step: int) -> str:
    return os.path.join(exp_root, "training_states", f"{step}.state")


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """``{'params': state_dict}`` of ``params`` (name -> tensor) on the CPU,
    written atomically."""
    _save_atomic({"params": _to_cpu(dict(params))}, path)


def save_checkpoint(exp_root: str, step: int, state, epoch: int = 0) -> None:
    """``models/net_g_{step}.pth`` and ``training_states/{step}.state`` of a
    ``TrainState``; the network first, so that every state file has its
    network."""
    save_params(net_path(exp_root, step), state.params)
    _save_atomic({"epoch": int(epoch), "iter": int(step),
                  "optimizers": [_to_cpu(state.opt_state.state_dict())],
                  "schedulers": []}, state_path(exp_root, step))


def latest_checkpoint_step(exp_root: str) -> Optional[int]:
    """The newest saved iteration: the largest ``{iter}.state`` (the
    reference's auto-resume scan, train.py:147-158)."""
    d = os.path.join(exp_root, "training_states")
    if not os.path.isdir(d):
        return None
    steps = [int(m.group(1)) for f in os.listdir(d)
             if (m := re.fullmatch(r"(\d+)\.state", f))]
    return max(steps) if steps else None


def restore_checkpoint(exp_root: str, step: int, state):
    """The ``TrainState`` saved at ``step``, restored into ``state`` (made by
    ``TrainState.create`` for the same model and optimizer): the masters,
    AdamW's moments and step counts, bit for bit, and the step."""
    params = load_state_dict_file(net_path(exp_root, step))
    if set(params) != set(state.params):
        raise KeyError(f"{net_path(exp_root, step)} does not hold the "
                       f"model's parameters: "
                       f"{sorted(set(params) ^ set(state.params))[:5]}")
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(params[name])
    blob = torch.load(state_path(exp_root, step), map_location="cpu",
                      weights_only=True)
    state.opt_state.load_state_dict(blob["optimizers"][0])
    return type(state)(step=int(blob["iter"]), params=state.params,
                       opt_state=state.opt_state)


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """The parameters of a ``.pth`` file (``net_g_{iter}.pth``, a published
    checkpoint), as ``load_state_dict_file`` reads them."""
    return load_state_dict_file(path)
