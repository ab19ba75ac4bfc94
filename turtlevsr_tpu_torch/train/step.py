"""The training step: BPTT over a clip.

The reference trains with a Python loop over the clip's frames, BPTT
through the whole clip (the history cache is never detached), under fp16
autocast (video_restoration_model.py:78-108). The JAX package scans the
frames with the cache as carry, checkpoints each frame and computes in bf16
from float32 masters. Here:

  * the frame loop is a Python loop with the cache tuple threaded through
    it; the rings are written out of place while autograd records
    (core/cache.py), so the backward reaches every frame's history,
  * each frame is checkpointed with ``torch.utils.checkpoint`` (non-
    reentrant), under one of ``REMAT_POLICIES``: its forward, kernels and
    all, runs again in the backward,
  * the parameters are float32 masters, cast to the compute type inside the
    graph (``torch.func.functional_call`` on a parameterless copy of the
    model), so the gradients arrive in float32; AdamW keeps its state in
    float32,
  * the kernels run forward through ``kernels/vjp.py``, whose backward is
    autograd through their plain versions,
  * with a process group (``parallel/mesh.py``), each rank takes the loss
    of its own batch and the gradients are averaged over the group after
    the backward, before AdamW: the gradient of the mean loss over the
    global batch, since every rank takes a batch of the same size (the
    JAX package's ``mesh=`` step).

Inputs are NHWC clips (B, T, H, W, C) in [0, 1], as in the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from turtlevsr_tpu_torch.config.options import ModelConfig
from turtlevsr_tpu_torch.models import require_device
from turtlevsr_tpu_torch.models.turtle import Turtle, init_cache
from turtlevsr_tpu_torch.parallel.mesh import all_reduce_mean_
from turtlevsr_tpu_torch.train.losses import l1_loss


@dataclass(frozen=True)
class AdamW:
    """The optimizer as a transformation, as optax gives one: ``init``
    makes a ``torch.optim.AdamW`` over the masters, ``update`` sets the
    learning rate of the step from the schedule and applies the update."""

    schedule: Callable[[int], float]
    betas: tuple
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            list(params.values()), lr=self.schedule(0), betas=self.betas,
            eps=self.eps, weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.Optimizer, step: int) -> None:
        lr = self.schedule(step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def make_optimizer(train_opt: dict, schedule: Callable) -> AdamW:
    """AdamW whatever the YAML's ``optim_g.type`` says: the reference pops
    ``type`` and always builds AdamW (video_restoration_model.py:67-69,
    SURVEY.md Q5)."""
    og = dict(train_opt["optim_g"])
    betas = og.get("betas", [0.9, 0.999])
    return AdamW(schedule=schedule, betas=(float(betas[0]), float(betas[1])),
                 eps=1e-8, weight_decay=float(og.get("weight_decay", 0.0)))


@dataclass
class TrainState:
    """step: the updates made so far; params: the master parameters by the
    model's parameter names (leaves that require grad); opt_state: the
    optimizer over them. A step updates them in place and returns the
    state with the step counted."""

    step: int
    params: dict
    opt_state: torch.optim.Optimizer

    @classmethod
    def create(cls, params: dict, tx: AdamW,
               device: torch.device | str = "cuda",
               dtype: torch.dtype = torch.float32) -> "TrainState":
        """Masters copied from ``params`` (name -> tensor, e.g.
        ``dict(model.named_parameters())``) onto ``device`` in ``dtype``
        (float32)."""
        device = require_device(device)
        masters = {n: p.detach().to(device=device, dtype=dtype).clone()
                   .requires_grad_() for n, p in params.items()}
        return cls(step=0, params=masters, opt_state=tx.init(masters))


def _dots_policy(batch: bool):
    """Save the outputs of the matrix products (with ``batch``, also those
    with a batch dimension of more than one), recompute everything else:
    JAX's ``dots_saveable`` / ``dots_with_no_batch_dims_saveable``. The
    kernels launch outside aten and are recomputed under every policy."""
    aten = torch.ops.aten
    plain = {aten.mm.default, aten.addmm.default}
    batched = {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        if op in plain or (op in batched and (batch or args[0].shape[0] == 1)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


REMAT_POLICIES = {
    # everything recomputed in the backward: least memory, most work
    "nothing": None,
    # keep the outputs of the weight-side products (no batch dimension)
    "dots_no_batch": _dots_policy(batch=False),
    # keep every product's output: most memory, least recompute
    "dots": _dots_policy(batch=True),
}


@functools.lru_cache(maxsize=None)
def _skeleton(cfg: ModelConfig, fuse: tuple) -> Turtle:
    """The model without storage (meta tensors): functional_call gives it
    the parameters of each call."""
    with torch.device("meta"):
        return Turtle(cfg, fuse)


def clip_loss_fn(params: dict, cfg: ModelConfig, lq: torch.Tensor,
                 gt: torch.Tensor, *, compute_dtype=torch.bfloat16,
                 remat: bool = True, remat_policy: str = "nothing",
                 loss_fn=l1_loss, fuse=()) -> torch.Tensor:
    """Mean per-frame loss over one clip, the cache threaded through it.

    params: name -> tensor (the masters); lq, gt: (B, T, H, W, C) in [0, 1]
    on the params' device. The frame pairing is the reference's: previous
    = frame j - 1 (j itself for j = 0) (video_restoration_model.py:86-91).
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}: choose out "
                         f"of {sorted(REMAT_POLICIES)}")
    b, t, h, w, _ = lq.shape
    model = _skeleton(cfg, tuple(fuse))
    params_c = {n: p.to(compute_dtype) if p.is_floating_point() else p
                for n, p in params.items()}
    lq_c = lq.to(compute_dtype)
    cache = init_cache(cfg, b, h, w, dtype=compute_dtype, device=lq.device)
    prev = torch.cat([lq_c[:, :1], lq_c[:, :-1]], dim=1)

    def frame_step(params_c, cache, p, cur, g):
        out, cache = torch.func.functional_call(
            model, params_c, (torch.stack([p, cur], dim=1), cache))
        return cache, loss_fn(out, g)

    context = REMAT_POLICIES[remat_policy]
    losses = []
    for j in range(t):
        args = (params_c, cache, prev[:, j], lq_c[:, j], gt[:, j])
        if remat:
            kw = {} if context is None else {"context_fn": context}
            cache, loss = checkpoint(frame_step, *args, use_reentrant=False,
                                     preserve_rng_state=False, **kw)
        else:
            cache, loss = frame_step(*args)
        losses.append(loss)
    return torch.stack(losses).mean()


def make_train_step(cfg: ModelConfig, tx: AdamW, *,
                    compute_dtype=torch.bfloat16, remat: bool = True,
                    remat_policy: str = "nothing", fuse=(),
                    device: torch.device | str = "cuda", group=None):
    """The train step ``step(state, lq, gt) -> (state, {"l_pix": loss})``:
    the clip's loss and its gradient into the masters, then one AdamW
    update at the schedule's rate of ``state.step``. ``device`` is where
    the state lives (the card unless the caller asks for the CPU).

    ``group``: a process group (``parallel.mesh.default_group()``); each
    rank passes its own batch, the gradients and the logged loss are
    averaged over the group (the reference's DDP all-reduce and
    ``reduce_loss_dict``), and every rank makes the same update."""
    require_device(device)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}: choose out "
                         f"of {sorted(REMAT_POLICIES)}")

    def step(state: TrainState, lq, gt):
        dev = next(iter(state.params.values())).device
        lq, gt = torch.as_tensor(lq, device=dev), torch.as_tensor(gt,
                                                                  device=dev)
        for p in state.params.values():
            p.grad = None
        loss = clip_loss_fn(state.params, cfg, lq, gt,
                            compute_dtype=compute_dtype, remat=remat,
                            remat_policy=remat_policy, fuse=fuse)
        loss.backward()
        for p in state.params.values():
            # a parameter the clip does not reach (the t0 SAB's dead q, k
            # chain) gets a zero gradient, as in the JAX package: AdamW
            # then decays it like every other, and every rank of a group
            # averages the same tensors
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if group is not None:
            all_reduce_mean_({n: p.grad for n, p in state.params.items()},
                             group)
            all_reduce_mean_({"l_pix": loss.reshape(1)}, group)
        tx.update(state.opt_state, state.step)
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=state.opt_state),
                {"l_pix": loss})

    return step
