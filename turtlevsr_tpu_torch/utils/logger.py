"""Logging of training (basicsr/utils/logger.py): the root logger of rank 0
on the console and in a file, the iteration message, TensorBoard and W&B,
the environment.

TensorBoard and W&B are optional, as in the JAX package for W&B: without
the package a warning is logged and training goes on.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

LOGGER_NAME = "turtlevsr_tpu_torch"
_FMT = "%(asctime)s %(levelname)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def get_root_logger(logger_name: str = LOGGER_NAME, log_level=logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """logger.py:119-155: the console on every rank, ranks but 0 at ERROR;
    on rank 0 also ``log_file`` (appended to). A later call with another
    ``log_file`` moves the file handler there, so one process can run
    several experiments."""
    logger = logging.getLogger(logger_name)
    if not getattr(logger, "_turtle_init", False):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(sh)
        logger.propagate = False
        logger._turtle_init = True
    if _rank() != 0:
        logger.setLevel(logging.ERROR)  # silence every rank but 0
        return logger
    logger.setLevel(log_level)
    if log_file is not None:
        path = os.path.abspath(log_file)
        old = [h for h in logger.handlers
               if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in old] != [path]:
            for h in old:
                logger.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path, "a")
            fh.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
            logger.addHandler(fh)
    return logger


class MessageLogger:
    """The iteration message with lr, ETA and times, and the scalars to
    TensorBoard (logger.py:14-82)."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt.get("logger") or {}
        self.interval = int(logger_opt.get("print_freq", 100))
        self.start_iter = start_iter
        self.max_iters = int(opt["train"]["total_iter"])
        self.use_tb_logger = bool(logger_opt.get("use_tb_logger", False))
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", [])

        # the reference's line exactly (logger.py:55-59): the name cut to 5
        # characters, a comma after each lr inside the tuple
        message = (f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        for v in lrs:
            message += f"{v:.3e},"
        message += ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1,
                                            1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += (f"[eta: {eta_str}, time (data): "
                        f"{iter_time:.3f} ({data_time:.3f})] ")

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            # 'debug' experiments skip TensorBoard (logger.py:77)
            if (self.use_tb_logger and self.tb_logger is not None
                    and "debug" not in self.exp_name):
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A TensorBoard SummaryWriter, or None (and a warning) when the
    tensorboard package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        get_root_logger().warning("tensorboard is not installed; training "
                                  "goes on without TensorBoard logging")
        return None
    return SummaryWriter(log_dir=log_dir)


def init_wandb_logger(opt: dict):
    """W&B synced to TensorBoard (logger.py:92-116), when wandb is installed
    and ``logger.wandb.project`` is set."""
    try:
        import wandb
    except ImportError:
        get_root_logger().warning("wandb is not installed; skipping "
                                  "(TensorBoard logging is unaffected)")
        return None
    logger_opt = (opt.get("logger") or {}).get("wandb") or {}
    project = logger_opt.get("project")
    if not project:
        return None
    resume_id = logger_opt.get("resume_id")
    kwargs = dict(id=resume_id, resume="allow") if resume_id else {}
    wandb.init(project=project, name=opt["name"], config=opt,
               sync_tensorboard=True, **kwargs)
    return wandb


def get_env_info() -> str:
    """The versions and the device (logger.py:158-183)."""
    import torch

    import turtlevsr_tpu_torch

    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
              else "no CUDA device")
    return ("\nVersion Information:"
            f"\n\tturtlevsr_tpu_torch: {turtlevsr_tpu_torch.__version__}"
            f"\n\tPyTorch: {torch.__version__}"
            f"\n\tCUDA: {torch.version.cuda}"
            f"\n\tDevice: {device}")
