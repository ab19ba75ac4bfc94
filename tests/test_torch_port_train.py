"""Port vs JAX package: the training layer's pieces on the CPU (schedules,
losses, AdamW), the remat policies, a few steps on a tiny model, and the
serving path that training must leave as it was.

The whole clip's gradients and two train steps against the JAX package are
in test_torch_port_train_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import t
from turtlevsr_tpu.train import losses as JLOSS
from turtlevsr_tpu.train import lr_schedule as JLR
from turtlevsr_tpu.train import step as JS
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.kernels import vjp as V
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.train import losses as TLOSS
from turtlevsr_tpu_torch.train import lr_schedule as TLR
from turtlevsr_tpu_torch.train import step as TS

torch.set_num_threads(1)

TRAIN_OPT = {
    "optim_g": {"lr": 4e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
    "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 1000,
                  "eta_min": 1e-7},
    "total_iter": 1000,
    "warmup_iter": -1,
}


def _train_opt(scheduler, total_iter=300, warmup=-1):
    return {"optim_g": {"lr": 4e-4}, "scheduler": scheduler,
            "total_iter": total_iter, "warmup_iter": warmup}


SCHEDULES = {
    "true_cosine": _train_opt({"type": "TrueCosineAnnealingLR", "T_max": 200,
                               "eta_min": 1e-7}),
    "cosine_restart": _train_opt({"type": "CosineAnnealingRestartLR",
                                  "periods": [100, 100, 100],
                                  "restart_weights": [1, 0.5, 0.25],
                                  "eta_min": 1e-7}),
    "multistep_restart": _train_opt({"type": "MultiStepRestartLR",
                                     "milestones": [50, 120, 200],
                                     "gamma": 0.5, "restarts": [0, 150],
                                     "restart_weights": [1, 0.5]}),
    "multistep": _train_opt({"type": "MultiStepLR", "milestones": [100, 250],
                             "gamma": 0.1}),
    "linear": _train_opt({"type": "LinearLR"}),
    "vibrate": _train_opt({"type": "VibrateLR"}, total_iter=800),
    "true_cosine_warmup": _train_opt({"type": "TrueCosineAnnealingLR",
                                      "T_max": 300, "eta_min": 0},
                                     warmup=30),
    "linear_warmup": _train_opt({"type": "LinearLR"}, warmup=10),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """Steps 0..300 against the JAX package's build_schedule, whose values
    are float32: rtol 1e-6, and atol 1e-7 of the base rate where a cosine
    nears -1 and float32 loses the digits of 1 + cos."""
    want_fn = JLR.build_schedule(SCHEDULES[name])
    got_fn = TLR.build_schedule(SCHEDULES[name])
    steps = np.arange(301)
    want = np.array([float(want_fn(s)) for s in steps])
    got = np.array([got_fn(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4e-4 * 1e-7)


def test_true_cosine_matches_torch_scheduler():
    """The reference's loop steps torch's CosineAnnealingLR before each
    iteration after the first (train.py:233, base_model.py:163-170)."""
    net = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(net.parameters(), lr=4e-4)
    tsched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=1000,
                                                        eta_min=1e-7)
    sched = TLR.build_schedule(TRAIN_OPT)
    for it in range(1, 50):
        if it > 1:
            tsched.step()
        np.testing.assert_allclose(sched(it - 1), opt.param_groups[0]["lr"],
                                   rtol=1e-12)


def test_unknown_scheduler_raises():
    with pytest.raises(NotImplementedError, match="Scheduler"):
        TLR.build_schedule(_train_opt({"type": "StepLR"}))


@pytest.mark.parametrize("fn", ["l1_loss", "psnr_loss"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_loss_matches_jax(fn, dtype):
    """Both compute in float32 whatever the input's type (a float32 mean
    of 1152 terms summed in another order: rtol 1e-5)."""
    rng = np.random.RandomState(0)
    pred, target = rng.rand(2, 16, 12, 3), rng.rand(2, 16, 12, 3)
    pt = t(pred).to(dtype)
    got = getattr(TLOSS, fn)(pt, t(target))
    assert got.dtype == torch.float32
    want = getattr(JLOSS, fn)(jnp.asarray(pt.double().numpy()),
                              jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(TLOSS.LOSSES) == set(JLOSS.LOSSES)


def test_adamw_matches_optax():
    """Three updates of make_optimizer's AdamW against optax.adamw from the
    JAX package's make_optimizer, float64. The learning rates and the
    weight decay are powers of two, exact in the float32 that the JAX
    schedule returns."""
    train_opt = {"optim_g": {"type": "Adam", "lr": 2.0 ** -11,
                             "weight_decay": 2.0 ** -4,
                             "betas": [0.9, 0.99]},
                 "scheduler": {"type": "MultiStepLR", "milestones": [2],
                               "gamma": 0.5},
                 "total_iter": 10}
    rng = np.random.RandomState(1)
    params = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in params.items()}
             for _ in range(3)]
    jtx = JS.make_optimizer(train_opt, JLR.build_schedule(train_opt))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = TS.make_optimizer(train_opt, TLR.build_schedule(train_opt))
    tp = {k: t(v).requires_grad_() for k, v in params.items()}
    opt = tx.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = t(v)
        tx.update(opt, i)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-12,
                                       rtol=0)
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.param_groups[0]["betas"] == (0.9, 0.99)


def _tiny(seed=0, dtype=torch.float64):
    model = build_model(tiny_opt(), device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # scales drawn: every branch takes part
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "beta"):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen,
                                          dtype=dtype))
    return model


def test_remat_on_off_and_policies_give_the_same_gradients():
    """No remat, per-frame remat under each policy: the same loss and
    gradients to the last bit (float64; the policies only choose what is
    kept and what is recomputed)."""
    model = _tiny()
    rng = np.random.RandomState(2)
    lq, gt = t(rng.rand(1, 3, 32, 32, 3)), t(rng.rand(1, 3, 32, 32, 3))
    ref = None
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots_no_batch"), (True, "dots")):
        params = {n: p.detach().clone().requires_grad_()
                  for n, p in model.named_parameters()}
        loss = TS.clip_loss_fn(params, model.cfg, lq, gt,
                               compute_dtype=torch.float64, remat=remat,
                               remat_policy=policy)
        loss.backward()
        got = (float(loss.detach()), [p.grad for p in params.values()])
        if ref is None:
            ref = got
            continue
        assert got[0] == ref[0], policy
        for a, b in zip(got[1], ref[1]):
            assert torch.equal(a, b), policy
    with pytest.raises(ValueError, match="remat policy"):
        TS.clip_loss_fn(params, model.cfg, lq, gt, remat_policy="offload")


def test_loss_falls_on_a_fixed_batch():
    """Ten steps on one batch from the default initialisation (gamma and
    beta zero), float32: the L1 loss falls at every step."""
    model = build_model(tiny_opt(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tx = TS.make_optimizer(TRAIN_OPT, TLR.build_schedule(TRAIN_OPT))
    state = TS.TrainState.create(dict(model.named_parameters()), tx,
                                   device="cpu")
    step = TS.make_train_step(model.cfg, tx, compute_dtype=torch.float32,
                              device="cpu")
    rng = np.random.RandomState(0)
    lq = rng.rand(1, 2, 32, 32, 3).astype(np.float32)
    gt = rng.rand(1, 2, 32, 32, 3).astype(np.float32)
    losses = []
    for _ in range(10):
        state, logs = step(state, torch.from_numpy(lq), torch.from_numpy(gt))
        losses.append(float(logs["l_pix"]))
    assert state.step == 10
    assert all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] - 2e-3, losses


_WRAPPERS = [(K, "fused_block_ffn"), (K, "fused_qkv_stats"),
             (K, "fused_ln_split_proj"), (K, "fused_conv3x3"),
             (K, "fused_chm_stats"), (S, "sab_attn_probs"),
             (S, "sab_attn_v_merge"), (L, "lattice_split"),
             (L, "lattice_merge"), (LV, "fused_channel_gffw_run"),
             (C2, "fused_two_stage")]
_FUNCTIONS = [V.BlockFFN, V.QKVStats, V.SplitProj, V.Conv3x3, V.CHMStats,
              V.SABProbs, V.AttnVMerge, V.SparseSoftmax, V.TwoStage,
              V.ChannelRun, L.LatticeSplit, L.LatticeMerge]


@pytest.mark.parametrize("fuse", [(), ("channel_runs", "attn_v_merge"),
                                  ("two_stage",)], ids=["none", "fused",
                                                        "two_stage"])
def test_serving_is_untouched_by_training(monkeypatch, fuse):
    """Under torch.inference_mode a frame calls each kernel's wrapper as
    many times as a training forward does (on the card: the same launches),
    applies no Function, and writes the history rings in place; a training
    forward applies the Functions and leaves the rings it was given as they
    were."""
    calls = {}
    for mod, name in _WRAPPERS:
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    applied = []
    for fn in _FUNCTIONS:
        real_apply = fn.apply

        def apply(*a, _real=real_apply, _fn=fn):
            applied.append(_fn.__name__)
            return _real(*a)

        monkeypatch.setattr(fn, "apply", apply)
    model = build_model(tiny_opt(Middle_blocks=4), device="cpu", fuse=fuse)
    x = torch.rand(1, 2, 32, 32, 3)

    cache = model.init_cache(1, 32, 32)
    bufs = [(s["k"], s["v"]) for s in cache if s is not None]
    before = [(k.clone(), v.clone()) for k, v in bufs]
    with torch.inference_mode():
        _, new = model(x, cache)
    serving = dict(calls)
    assert not applied
    for (k, v), (k0, v0), s in zip(bufs, before,
                                   [s for s in new if s is not None]):
        assert s["k"] is k and s["v"] is v  # the same buffers, written
        assert not torch.equal(v, v0)

    calls.clear()
    cache = model.init_cache(1, 32, 32)
    bufs = [(s["k"], s["v"]) for s in cache if s is not None]
    out, new = model(x, cache)
    assert out.requires_grad
    assert calls == serving
    assert applied and "LatticeSplit" in applied
    for (k, v), s in zip(bufs, [s for s in new if s is not None]):
        assert s["v"] is not v and not v.any()  # new rings, old ones zero
