"""Learning-rate schedules as pure ``step -> lr`` functions on Python
numbers.

The reference's scheduler zoo (basicsr/models/lr_scheduler.py and the
TrueCosineAnnealingLR alias for torch's CosineAnnealingLR,
base_model.py:82-113) plus the linear warmup override (base_model.py:163-
185), in the closed forms of the JAX package's ``train/lr_schedule.py``.
Schedulers step once per iteration: step 0 is the first update, as optax
counts, and torch's ``last_epoch`` equals it.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def true_cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    """torch.optim.lr_scheduler.CosineAnnealingLR closed form."""

    def sched(step):
        s = min(step, t_max)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * s / t_max))

    return sched


def cosine_annealing_restart(base_lr: float, periods: Sequence[int],
                             restart_weights: Sequence[float] = (1.0,),
                             eta_min: float = 0.0):
    """lr_scheduler.CosineAnnealingRestartLR:141-189: piecewise cosine
    cycles; the cycle whose cumulative period first covers the step wins."""
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def sched(step):
        out, prev_cum = base_lr, 0
        for i, (period, cum, w) in enumerate(zip(periods, cumulative,
                                                 restart_weights)):
            if i == 0 or step > prev_cum:
                out = eta_min + w * 0.5 * (base_lr - eta_min) * (
                    1.0 + math.cos(math.pi * (step - prev_cum) / period))
            prev_cum = cum
        return out

    return sched


def multistep_restart(base_lr: float, milestones: Sequence[int],
                      gamma: float = 0.1, restarts: Sequence[int] = (0,),
                      restart_weights: Sequence[float] = (1.0,)):
    """lr_scheduler.MultiStepRestartLR:12-52 in closed form: lr = weight of
    the last restart * base * gamma^(milestones passed since that
    restart)."""
    milestones = sorted(milestones)
    restarts = list(restarts)

    def sched(step):
        w = restart_weights[0] if restarts and restarts[0] == 0 else 1.0
        for r, rw in zip(restarts, restart_weights):
            if step >= r:
                w = rw
        count = sum(1 for m in milestones if step >= m
                    and all(m > r or step < r for r in restarts))
        return base_lr * w * gamma ** count

    return sched


def linear_lr(base_lr: float, total_iter: int):
    """lr_scheduler.LinearLR:54-75."""

    def sched(step):
        return base_lr * (1.0 - step / total_iter)

    return sched


def vibrate_lr(base_lr: float, total_iter: int):
    """lr_scheduler.VibrateLR:77-118: a decaying sawtooth."""
    t = total_iter // 80
    th = t // 2

    def sched(step):
        process = step / total_iter
        f = (1 - process * 8 / 3 if process < 3 / 8
             else 0.2 if process < 5 / 8 else 0.1)
        ti = step % t
        f2 = ti / th
        if ti >= th:
            f2 = 2 - f2
        weight = f * f2
        if step < th:
            weight = max(weight, 0.1)
        return base_lr * weight

    return sched


def with_warmup(sched: Callable, base_lr: float, warmup_iter: int):
    """Linear warmup over the first warmup_iter iterations
    (base_model.py:163-185; warmup_iter <= 0 disables it)."""
    if warmup_iter is None or warmup_iter <= 0:
        return sched

    def warmed(step):
        if step + 1 < warmup_iter:
            return base_lr / warmup_iter * (step + 1)
        return sched(step)

    return warmed


def build_schedule(train_opt: dict) -> Callable:
    """The iteration schedule of an option file's ``train:`` section (keys
    as in options/*.yml: optim_g.lr, scheduler.type, ...)."""
    base_lr = float(train_opt["optim_g"]["lr"])
    sch = dict(train_opt.get("scheduler") or {"type": "TrueCosineAnnealingLR",
                                              "T_max": train_opt["total_iter"],
                                              "eta_min": 0})
    stype = sch.pop("type")
    total_iter = int(train_opt.get("total_iter", 0))
    if stype == "TrueCosineAnnealingLR":
        fn = true_cosine_annealing(base_lr, int(sch["T_max"]),
                                   float(sch.get("eta_min", 0)))
    elif stype == "CosineAnnealingRestartLR":
        fn = cosine_annealing_restart(
            base_lr, [int(p) for p in sch["periods"]],
            [float(w) for w in sch.get("restart_weights", [1.0])],
            float(sch.get("eta_min", 0)))
    elif stype in ("MultiStepLR", "MultiStepRestartLR"):
        fn = multistep_restart(
            base_lr, [int(m) for m in sch["milestones"]],
            float(sch.get("gamma", 0.1)),
            [int(r) for r in sch.get("restarts", [0])],
            [float(w) for w in sch.get("restart_weights", [1.0])])
    elif stype == "LinearLR":
        fn = linear_lr(base_lr, total_iter)
    elif stype == "VibrateLR":
        fn = vibrate_lr(base_lr, total_iter)
    else:
        raise NotImplementedError(f"Scheduler {stype} is not implemented")
    return with_warmup(fn, base_lr, int(train_opt.get("warmup_iter", -1)))
