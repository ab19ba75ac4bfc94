"""Profiling and tracing hooks.

The reference has only wall-clock timers (SURVEY.md section 5). Here, as in
the JAX package, device traces too:

  * ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is a card, of CUDA, written into ``logdir`` as a Chrome trace
    (view it in Perfetto or chrome://tracing),
  * ``annotate(name)``: a named span in that trace,
  * ``device_sync(x)``: wait for the card's work on ``x``,
  * ``Timer``: the train loop's wall-clock lap timer.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    from turtlevsr_tpu_torch.utils.misc import get_time_str

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{get_time_str()}_{os.getpid()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def device_sync(x) -> None:
    """Wait for the card's queued work on ``x``: a tensor, or a dict of them
    (its first one decides the device); a CPU tensor needs no wait."""
    if isinstance(x, dict):
        x = next(iter(x.values()))
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class Timer:
    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt
