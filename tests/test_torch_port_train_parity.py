"""Port vs JAX package: BPTT over a clip and the train step, float64 on the
CPU, where the port's kernels run their plain versions through the
Functions of kernels/vjp.py.

The loss and every parameter's gradient of ``clip_loss_fn`` against
``jax.value_and_grad`` of the JAX package's ``clip_loss_fn`` (kernels='xla')
for the t1 family with CHM blocks, the t0 family and the SR family, over
clips long enough that the 2-frame rings of the tiny model wrap; then two
``make_train_step`` steps against the JAX package's; then one float32 step
(``compute_dtype=torch.float32``) against the JAX package's float32 loss and
gradient (relative, 1e-5 on the loss and 1e-4 L2 on the gradient).

Tolerances: gradients atol 1e-9 and rtol 1e-7 (the loss is float32 in both
packages: its cotangent 1/N enters in float32, alike on both sides); the
loss itself rtol 1e-6 (a float32 mean, summed in another order). After two
AdamW steps atol 1e-5 of the learning rate: Adam's step is lr * m / (sqrt(v)
+ 1e-8), which for an entry whose gradient is far below 1e-8 is lr * g /
1e-8, so a float64 sum-order difference of the gradient (up to 2e-15 here)
moves such a parameter by up to 2e-7 lr a step, and the second step's
gradient starts from parameters that differ so (measured: 6e-11 after one
step, 1.1e-9 after two, at lr 4.9e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import numpy_tree_like, t, to_jnp
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu.train import lr_schedule as JLR
from turtlevsr_tpu.train import step as JS
from turtlevsr_tpu_torch.io.torch_convert import (
    jax_tree_from_model,
    load_jax_params,
)
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.train import lr_schedule as TLR
from turtlevsr_tpu_torch.train import step as TS

torch.set_num_threads(1)
MODELS = {"t1": "Turtle_t1_arch", "t0": "Turtle_arch",
          "sr": "Turtlesuper_t1_arch"}
# input sides: the SR model takes low-resolution frames (x4 inside)
SIDES = {"t1": 32, "t0": 32, "sr": 8}


def _models(variant, seed=0):
    opt = tiny_opt(model=MODELS[variant])
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(seed))
    model = build_model(opt, device="cpu", dtype=torch.float64)
    load_jax_params(model, tree)
    return jcfg, tree, model


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_tree(model, tensors: dict) -> dict:
    """Tensors named like the model's parameters, as the JAX package's tree
    (its layouts), flattened by path."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(tensors[n])
    return _flat(jax_tree_from_model(holder))


@pytest.mark.parametrize("variant", ["t1", "t0", "sr"])
def test_clip_loss_and_gradients_match_jax(variant):
    jcfg, tree, model = _models(variant)
    side, frames = SIDES[variant], 3  # the third append wraps the rings
    rng = np.random.RandomState(1)
    lq = rng.rand(1, frames, side, side, 3)
    s = 4 if variant == "sr" else 1
    gt = rng.rand(1, frames, s * side, s * side, 3)
    jloss, jgrads = jax.value_and_grad(JS.clip_loss_fn)(
        to_jnp(tree, jnp.float64), jcfg, jnp.asarray(lq), jnp.asarray(gt),
        compute_dtype=jnp.float64, remat=False)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    loss = TS.clip_loss_fn(params, model.cfg, t(lq), t(gt),
                           compute_dtype=torch.float64)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    got = _as_tree(model, {n: p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for n, p in params.items()})
    want = _flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=1e-7,
                                   err_msg=k)
    # the gradients reach the history: most parameters move (t0: the dead
    # q, k chain of its SAB has none, in both packages)
    nonzero = sum(bool(np.any(g != 0)) for g in got.values())
    assert nonzero > (0.8 if variant == "t0" else 0.95) * len(got)


def test_two_train_steps_match_jax():
    """Two make_train_step steps (AdamW, weight decay on) from the same
    float64 parameters: the same losses and parameters. The rates and the
    decay are powers of two, exact in the float32 that the JAX schedule
    returns."""
    train_opt = {"optim_g": {"type": "Adam", "lr": 2.0 ** -11,
                             "weight_decay": 2.0 ** -6, "betas": [0.9, 0.99]},
                 "scheduler": {"type": "MultiStepLR", "milestones": [1],
                               "gamma": 0.5},
                 "total_iter": 4, "warmup_iter": -1}
    jcfg, tree, model = _models("t1", seed=3)
    rng = np.random.RandomState(4)
    batches = [(rng.rand(1, 2, 32, 32, 3), rng.rand(1, 2, 32, 32, 3))
               for _ in range(2)]
    jtx = JS.make_optimizer(train_opt, JLR.build_schedule(train_opt))
    jstep = JS.make_train_step(jcfg, jtx, compute_dtype=jnp.float64,
                               remat=True, donate=False)
    jstate = JS.TrainState.create(to_jnp(tree, jnp.float64), jtx)
    tx = TS.make_optimizer(train_opt, TLR.build_schedule(train_opt))
    step = TS.make_train_step(model.cfg, tx, compute_dtype=torch.float64,
                              device="cpu")
    state = TS.TrainState.create(dict(model.named_parameters()), tx,
                                 device="cpu", dtype=torch.float64)
    for lq, gt in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lq), jnp.asarray(gt))
        state, logs = step(state, t(lq), t(gt))
        np.testing.assert_allclose(float(logs["l_pix"]),
                                   float(jlogs["l_pix"]), rtol=1e-6)
    assert state.step == int(jstate.step) == 2
    got = _as_tree(model, state.params)
    want = _flat(jstate.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * 2.0 ** -11,
                                   rtol=0, err_msg=k)


def test_float32_train_step_matches_jax():
    """One make_train_step step with compute_dtype=torch.float32 (the compute
    in float32 from float32 masters, as cli/bench.py --train_step --dtype
    float32 runs it) against the JAX package's float32 step, from the same
    parameters: its loss and the gradient into its masters are
    jax.value_and_grad of clip_loss_fn with the step's arguments
    (turtlevsr_tpu/train/step.py, step_fn's first statement), evaluated here
    without the optimizer update, whose first step would hide the
    gradient's magnitude. The port's step's logged loss within 1e-5
    relative; its gradient, read from the masters' .grad, within 1e-4
    relative, L2 over every parameter (the limit the card holds the float32
    step to). Float32 sums in another order apart, the same function."""
    train_opt = {"optim_g": {"type": "Adam", "lr": 2.0 ** -11,
                             "weight_decay": 2.0 ** -6, "betas": [0.9, 0.99]},
                 "scheduler": {"type": "MultiStepLR", "milestones": [1],
                               "gamma": 0.5},
                 "total_iter": 4, "warmup_iter": -1}
    opt = tiny_opt(model=MODELS["t1"])
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(5))
    model = build_model(opt, device="cpu", dtype=torch.float32)
    load_jax_params(model, tree)
    rng = np.random.RandomState(6)
    # three frames: the third append wraps the tiny model's 2-frame rings
    lq, gt = (rng.rand(1, 3, 32, 32, 3).astype(np.float32) for _ in range(2))
    jloss, jgrads = jax.value_and_grad(JS.clip_loss_fn)(
        to_jnp(tree, jnp.float32), jcfg, jnp.asarray(lq), jnp.asarray(gt),
        compute_dtype=jnp.float32, remat=True, remat_policy="nothing")
    tx = TS.make_optimizer(train_opt, TLR.build_schedule(train_opt))
    step = TS.make_train_step(model.cfg, tx, compute_dtype=torch.float32,
                              device="cpu")
    state = TS.TrainState.create(dict(model.named_parameters()), tx,
                                 device="cpu", dtype=torch.float32)
    state, logs = step(state, torch.from_numpy(lq), torch.from_numpy(gt))
    assert state.step == 1
    loss, jloss = float(logs["l_pix"]), float(jloss)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    got = _as_tree(model, {n: p.grad for n, p in state.params.items()})
    want = _flat(jgrads)
    assert set(got) == set(want)
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert den > 0 and (num / den) ** 0.5 <= 1e-4
