"""Carry parameters between the JAX package's tree and the port's modules.

The JAX package keeps parameters as nested dicts (and lists under
``transformer_blocks``) whose names are the reference's module names, with
  * conv weights HWIO (kh, kw, cin // groups, cout),
  * ``gamma``/``beta`` flat (C,),
  * LN weight/bias, conv bias and ``temperature`` (heads, 1, 1) as they are.
The port's modules hold the reference's own shapes (conv weights OIHW,
``gamma``/``beta`` (1, C, 1, 1)), so a reference ``.pth`` state dict loads
with ``load_state_dict`` directly and the JAX tree needs only these two
layout rules. Trees cross as numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(node, prefix: str, flat: Dict[str, np.ndarray]) -> None:
    if isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            _flatten(item, f"{prefix}.{i}", flat)
    elif isinstance(node, dict):
        for name, item in node.items():
            _flatten(item, f"{prefix}.{name}" if prefix else name, flat)
    else:
        flat[prefix] = np.asarray(node)


def _to_module_layout(key: str, arr: np.ndarray) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("gamma", "beta"):
        return arr.reshape(1, -1, 1, 1)
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return arr


def _to_tree_layout(key: str, arr: np.ndarray) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("gamma", "beta"):
        return arr.reshape(-1)
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return arr


def load_jax_params(model: torch.nn.Module, tree) -> None:
    """Fill ``model`` from a JAX-package parameter tree of numpy arrays.
    Strict: every leaf must name a parameter of the model, every parameter
    must be filled and every shape must fit, else ``ValueError``. Values are
    cast to each parameter's type and device."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    target = model.state_dict()
    extra = sorted(set(flat) - set(target))
    missing = sorted(set(target) - set(flat))
    if extra or missing:
        raise ValueError(
            f"parameter tree does not match the model: {len(extra)} leaves "
            f"without a parameter (e.g. {extra[:3]}), {len(missing)} "
            f"parameters without a leaf (e.g. {missing[:3]})")
    state = {}
    for key, arr in flat.items():
        arr = _to_module_layout(key, arr)
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{key}: tree gives shape {tuple(arr.shape)}, the model "
                f"holds {tuple(target[key].shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=target[key].dtype, device=target[key].device)
    model.load_state_dict(state, strict=True)


def jax_tree_from_model(model: torch.nn.Module) -> dict:
    """Inverse of :func:`load_jax_params`: the model's parameters as the JAX
    package's nested tree of numpy arrays (bfloat16 is widened to float32,
    numpy has no such type)."""
    root: dict = {}
    for key, value in model.state_dict().items():
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = _to_tree_layout(key, t.numpy())
        parts = key.split(".")
        node = root
        for i, p in enumerate(parts[:-1]):
            if isinstance(node, list):
                idx = int(p)
                while len(node) <= idx:
                    node.append({})
                node = node[idx]
            else:
                if p not in node:
                    node[p] = [] if p == "transformer_blocks" else {}
                node = node[p]
        node[parts[-1]] = np.array(arr, copy=True)
    return root
