"""One rank of a process group, started by the port's parallel tests as

    python torch_port_dist_worker.py step OUT INIT_FILE RANK WORLD DEVICE DTYPE
    python torch_port_dist_worker.py cli OUT ARGV...

step: the tiny t1 model of ``seeded_model`` (weights drawn from a seed with
numpy) and its train step over a gloo group set up through INIT_FILE
(``file://``, no port), ``STEPS`` steps of ``make_train_step(group=...)``,
each on clip RANK of the batch of ``batches``; the masters, the first step's
averaged gradients and the losses are saved with ``torch.save`` into OUT.
DEVICE is ``cpu`` (DTYPE float64: the masters and the compute) or ``cuda``
(DTYPE bfloat16 from float32 masters, the kernels forward).

cli: ``turtlevsr_tpu_torch.cli.train.main(ARGV)`` in the launcher's
environment that the test gave the process; its result as JSON in OUT.

Imports torch and the port only, so that it also runs where JAX is absent.
"""

import json
import sys

import numpy as np
import torch

from reference_oracle import tiny_opt

STEPS = 2
# powers of two: exact in float32 and float64 alike. The rate bounds how
# far two AdamW steps carry the packages' float32-level gradient
# differences (the loss's cotangent enters in float32 in both) into the
# masters: Adam's eps turns a difference at an entry far below it into
# lr * dg / eps, and the second step's gradient is taken at masters that
# already differ so, which grows about with the square of the rate. On
# this model and these clips 2^-13 keeps the two packages within the 1e-9
# of tests/test_torch_port_parallel.py; 2^-11 and 2^-12 do not
TRAIN_OPT = {"optim_g": {"type": "Adam", "lr": 2.0 ** -13,
                         "weight_decay": 2.0 ** -6, "betas": [0.9, 0.99]},
             "scheduler": {"type": "MultiStepLR", "milestones": [1],
                           "gamma": 0.5},
             "total_iter": 4, "warmup_iter": -1}


def seeded_model(device="cpu", dim=8, seed=3):
    """The tiny t1 model (CHM blocks), float64 on the CPU, every parameter
    drawn from ``seed`` with numpy (the scales too, so that every branch
    takes part)."""
    from turtlevsr_tpu_torch.models import build_model

    model = build_model(tiny_opt(dim=dim), device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf, shape = name.rsplit(".", 1)[-1], tuple(p.shape)
            if leaf == "temperature":
                a = 0.5 + rng.rand(*shape)
            elif leaf == "weight" and len(shape) == 1:
                a = 1.0 + 0.2 * rng.standard_normal(shape)
            elif leaf == "weight":
                a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            else:
                a = 0.3 * rng.standard_normal(shape)
            p.copy_(torch.from_numpy(a))
    return model


def batches(side=32, frames=2, seed=4):
    """STEPS batches of two clips (lq, gt), float64 numpy, (2, T, H, W, 3)."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(2, frames, side, side, 3),
             rng.rand(2, frames, side, side, 3)) for _ in range(STEPS)]


def make_step(model, device, dtype, group=None):
    """(step, state) of the train step at TRAIN_OPT: float64 on the CPU,
    bf16 from float32 masters on the card."""
    from turtlevsr_tpu_torch.train import (
        TrainState,
        build_schedule,
        make_optimizer,
        make_train_step,
    )

    tx = make_optimizer(TRAIN_OPT, build_schedule(TRAIN_OPT))
    compute = getattr(torch, dtype)
    masters = torch.float64 if compute == torch.float64 else torch.float32
    step = make_train_step(model.cfg, tx, compute_dtype=compute,
                           device=device, group=group)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device=device, dtype=masters)
    return step, state


def run_steps(step, state, clips, device):
    """The steps on ``clips`` (one (lq, gt) a step): the losses, the first
    step's gradients (on the CPU; averaged over the group, with one), the
    final state."""
    losses, first = [], None
    for lq, gt in clips:
        state, logs = step(state, torch.as_tensor(lq, device=device),
                           torch.as_tensor(gt, device=device))
        losses.append(float(logs["l_pix"]))
        if first is None:
            first = {n: p.grad.detach().cpu().clone()
                     for n, p in state.params.items()}
    return losses, first, state


def _step(out, init_file, rank, world, device, dtype):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        dim = 16 if device == "cuda" else 8  # the narrowest the kernels take
        step, state = make_step(seeded_model(dim=dim), device, dtype,
                                group=dist.group.WORLD)
        clips = [(lq[rank:rank + 1], gt[rank:rank + 1])
                 for lq, gt in batches()]
        losses, grads, state = run_steps(step, state, clips, device)
        torch.save({"losses": losses, "grads": grads,
                    "params": {n: p.detach().cpu()
                               for n, p in state.params.items()}}, out)
    finally:
        dist.destroy_process_group()


def main(argv):
    mode, out = argv[0], argv[1]
    if mode == "step":
        init_file, rank, world, device, dtype = argv[2:7]
        _step(out, init_file, int(rank), int(world), device, dtype)
    elif mode == "cli":
        from turtlevsr_tpu_torch.cli import train

        res = train.main(argv[2:])
        with open(out, "w") as f:
            json.dump(res, f)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1:])
