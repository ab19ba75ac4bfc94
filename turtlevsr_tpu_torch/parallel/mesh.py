"""Data parallelism: the process group, the gradient all-reduce, the tile
grid's split over cards.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference runs
one process a card under DDP over NCCL, launched by ``torch.distributed``'s
launcher or by slurm (dist_util.py:15-88, train.py:46-60); the JAX package
has one process a host and a ``Mesh`` over its chips. The port follows the
reference: one process a card, each with its own per-card batch, the
gradients averaged over the group after the backward (``all_reduce_mean_``),
the masters broadcast from rank 0 once at the start (``broadcast_params``,
what DDP's wrap does). Without a group every function here is the
single-process one: rank 0 of a world of 1.

The launchers' rendezvous variables (``LAUNCHER_VARIABLES``) are the
protocol of ``torch.distributed.run`` and of slurm, read only by
``init_dist``; the backend and the slurm port come from the option file's
``dist_params``.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from turtlevsr_tpu_torch.models import require_device

LAUNCHERS = ("none", "pytorch", "slurm")
# the environment init_dist reads: torch.distributed.run's, then slurm's
LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
                      "SLURM_NODELIST")
# the reference's process-group timeout (train.py:52-53): a validation on
# rank 0 may keep the others waiting at the next collective that long
TIMEOUT = datetime.timedelta(seconds=5400)


def _launcher_env(name: str, default: Optional[str] = None) -> str:
    """A rendezvous variable of the launcher; unset and no default: the
    launcher did not start this process."""
    if name not in LAUNCHER_VARIABLES:
        raise KeyError(name)
    value = os.environ.get(name, default)
    if value is None:
        raise RuntimeError(f"{name} is not set: the launcher did not start "
                           "this process")
    return value


def init_dist(launcher: str, backend: Optional[str], port=None, *,
              device: torch.device | str = "cuda",
              local_rank: int = 0) -> tuple[int, int]:
    """Set up the process group of ``launcher`` and return (rank, world
    size).

    none: nothing is set up, (0, 1). pytorch: the ``RANK`` / ``WORLD_SIZE``
    / ``LOCAL_RANK`` / ``MASTER_*`` environment of ``torch.distributed.run``
    (``LOCAL_RANK`` unset: ``local_rank``, the ``--local_rank`` of the old
    launcher). slurm: ``SLURM_PROCID``, ``SLURM_NTASKS``, the first host of
    ``scontrol show hostname $SLURM_NODELIST`` at ``port`` (the option
    file's ``dist_params.port``, else 29500, as the reference), the local
    rank ``SLURM_PROCID`` modulo the cards (dist_util.py:40-63). On a card
    the process takes ``cuda:(local rank % cards)`` before anything is
    allocated. ``backend`` is the option file's ``dist_params.backend``;
    NCCL with two ranks on one card raises."""
    if launcher not in LAUNCHERS:
        raise ValueError(f"unknown launcher {launcher!r}: choose out of "
                         f"{LAUNCHERS}")
    if launcher == "none":
        return 0, 1
    if not dist.is_available():
        raise RuntimeError(f"--launcher {launcher} needs torch.distributed, "
                           "which this build of torch lacks")
    if not backend:
        raise ValueError(f"--launcher {launcher} needs dist_params.backend "
                         "in the option file")
    device = require_device(device)
    if launcher == "pytorch":
        rank = int(_launcher_env("RANK"))
        world = int(_launcher_env("WORLD_SIZE"))
        local = int(_launcher_env("LOCAL_RANK", str(local_rank)))
        init_method = "env://"
    else:
        rank = int(_launcher_env("SLURM_PROCID"))
        world = int(_launcher_env("SLURM_NTASKS"))
        local = rank % (torch.cuda.device_count()
                        if device.type == "cuda" else 1)
        out = subprocess.run(
            ["scontrol", "show", "hostname", _launcher_env("SLURM_NODELIST")],
            capture_output=True, text=True, check=True)
        addr = out.stdout.split()[0]
        init_method = f"tcp://{addr}:{int(port or 29500)}"
    if device.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT)
    if backend == "nccl" and world > 1:
        try:
            check_distinct_cards(_gather_cards())
        except ValueError:
            dist.destroy_process_group()
            raise
    return rank, world


def _gather_cards() -> list:
    """(host, card) of every rank, over a gloo group beside the NCCL one
    (which would open its communicator, and fail, at its first
    collective)."""
    side = dist.new_group(backend="gloo")
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(
        cards, (socket.gethostname(), torch.cuda.current_device()),
        group=side)
    dist.destroy_process_group(side)
    return cards


def check_distinct_cards(cards: Sequence) -> None:
    """NCCL takes one rank a card: raise ``ValueError`` when two ranks map
    to one (host, card)."""
    seen = {}
    for rank, card in enumerate(map(tuple, cards)):
        if card in seen:
            raise ValueError(
                f"ranks {seen[card]} and {rank} both run on card {card[1]} "
                f"of {card[0]}: NCCL takes one rank a card (start at most "
                "as many processes a host as it has cards)")
        seen[card] = rank


def close_dist() -> None:
    """Leave the process group, if one is set up."""
    if _group_up():
        dist.destroy_process_group()


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _group_up() else 0


def world_size() -> int:
    return dist.get_world_size() if _group_up() else 1


def process_is_primary() -> bool:
    """Rank 0 (the reference's @master_only, dist_util.py:78-88)."""
    return rank() == 0


def default_group():
    """The group a train step averages its gradients over: the world, when
    a process group is set up (also of one rank), else None."""
    return dist.group.WORLD if _group_up() else None


def barrier() -> None:
    """Wait for every rank (NCCL on this process's card)."""
    if not _group_up():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def per_process_batch_size(batch_per_gpu: int) -> int:
    """The batch each process loads: ``batch_per_gpu``, one process a card
    as in the reference; the global batch is that times the world size.
    (The JAX package's is the per-device batch times the process's local
    devices, one process a host driving all its chips.)"""
    return int(batch_per_gpu)


def _in_flat_buffer(tensors: dict, collective) -> None:
    """Run ``collective`` on one flat buffer of the tensors (name -> tensor,
    one dtype), in the order of the names, and copy the result back."""
    names = sorted(tensors)
    dtypes = {tensors[n].dtype for n in names}
    if len(dtypes) != 1:
        raise TypeError(f"one flat buffer takes one dtype, got {dtypes}")
    with torch.no_grad():
        flat = torch.cat([tensors[n].detach().reshape(-1) for n in names])
        collective(flat)
        offset = 0
        for n in names:
            t = tensors[n]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_params(params: dict, src: int = 0) -> None:
    """Copy rank ``src``'s tensors (name -> tensor, one dtype) into every
    rank's, in place, as DDP's wrap does once at the start."""
    if _group_up():
        _in_flat_buffer(params, lambda flat: dist.broadcast(flat, src=src))


def all_reduce_mean_(tensors: dict, group=None) -> None:
    """Average the tensors (name -> tensor, one dtype: the gradients'
    float32 on the card, float64 in the CPU tests) over ``group`` (the
    world by default), in place: their sum over one flat buffer in the
    order of the names, then divided by the group's size (exact at one
    rank)."""
    if not _group_up():
        return

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group))

    _in_flat_buffer(tensors, mean)


def all_reduce_sums(values: Sequence[float]) -> list:
    """Float sums over every rank (validation's counts and metric sums),
    in float64; the values themselves without a group."""
    if not _group_up():
        return [float(v) for v in values]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().tolist()


def shard_devices(devices: Sequence, n_tiles: int) -> list:
    """The tile grid split over ``devices`` (the JAX engine's mesh): equal
    contiguous shards ``(device, first tile, end)``, one a device, in the
    single-device order. Entries may repeat (several shards on one card).
    ``n_tiles`` must divide over the devices (engine.py:275-277)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to shard over")
    if n_tiles % len(devices):
        raise ValueError(f"{n_tiles} tiles do not divide over "
                         f"{len(devices)} devices")
    per = n_tiles // len(devices)
    return [(d, i * per, (i + 1) * per) for i, d in enumerate(devices)]
