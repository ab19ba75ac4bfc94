"""Small helpers of training (basicsr/utils/misc.py): seeding, time
stamps, the experiment directories, directory scans, sizes."""

from __future__ import annotations

import os
import random
import time
from os import path as osp

import numpy as np


def set_random_seed(seed: int) -> None:
    """misc.py:18-25: Python's, numpy's and torch's generators (torch's on
    the CPU and on every card)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """Make ``path``; one that exists is first renamed with a time stamp
    (misc.py:31-41)."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """The experiment's (training) or results' (testing) directories
    (misc.py:44-56)."""
    path_opt = dict(opt.get("path") or {})
    if opt.get("is_train"):
        mkdir_and_rename(path_opt.pop("experiments_root"))
    else:
        mkdir_and_rename(path_opt.pop("results_root"))
    for key, p in path_opt.items():
        if isinstance(p, str) and ("strict_load" not in key
                                   and "pretrain_network" not in key
                                   and "resume" not in key):
            os.makedirs(p, exist_ok=True)


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False):
    """The files under ``dir_path`` (misc.py:59-101), hidden ones left out;
    paths relative to it unless ``full_path``."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                return_path = (entry.path if full_path
                               else osp.relpath(entry.path, root))
                if suffix is None or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix, recursive)

    return _scandir(dir_path, suffix, recursive)


def sizeof_fmt(size: float, suffix: str = "B") -> str:
    """misc.py:172-186."""
    for unit in ["", "K", "M", "G", "T", "P", "E", "Z"]:
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"
