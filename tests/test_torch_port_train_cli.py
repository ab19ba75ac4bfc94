"""The port's training command line (turtlevsr_tpu_torch.cli.train) on the
CPU: against the JAX package's, and on its own.

Against the JAX package: the tiny option file of tests/test_cli.py (dim 8,
3 frames, 64 x 64 patches of 64 x 64 frames, one loader worker) with
``pretrain_network_g`` set to a reference ``.pth`` written from seeded
weights, which both packages read; two iterations of each package's
``cli.train.main`` in this process (the JAX one on one CPU device), each
package's ``make_train_step`` patched to compute in float64 and its masters
made float64 (the port's ``TrainState.create``, the JAX package's
``load_torch_checkpoint`` that reads the pretrained file), as in
test_torch_port_train_parity.py. In float32 the bar cannot hold: a float32
master near 1 (a LayerNorm weight) has a spacing of 1.2e-7, 3e-4 of the
learning rate, and each AdamW step rounds the masters in another order in
each package; Adam then turns the next step's gradient difference at an
entry far below its eps into lr * dg / eps. The same clips reach both steps,
from both packages' datasets, sampler and loader.

Tolerances: each iteration's loss rtol 1e-5 (a float32 mean, summed in
another order); the final masters atol 1e-5 of the learning rate (the bar of
test_torch_port_train_parity.py); the validation PSNR
within 0.05 dB of the JAX package's ``build_validation`` on the same masters
(both in bf16, as both command lines run it: bf16 roundings of the
activations in another order).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from test_cli import TINY_YML

torch.set_num_threads(2)

NAME = "tiny_cli"  # no "debug": that would set the frequencies itself
ITERS = 2


def _write_frames(root, n=5, side=64, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("gt", "blur"):
        d = os.path.join(root, sub, "video0")
        os.makedirs(d)
        for f in range(n):
            img = (rng.rand(side, side, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{f:05d}.png"))


def _seeded_weights(model, seed):
    """Every parameter drawn from a seed (numpy), the zero-initialised
    scales and the unit temperature too, so that every branch takes part
    (the rules of torch_port_util.numpy_tree_like, in the model's
    layouts)."""
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


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _collecting(name):
    logger = logging.getLogger(name)
    handler = _Collect()
    logger.addHandler(handler)
    return logger, handler


def _in_dir(path, fn):
    old = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(old)


def _port_float64(mp):
    import turtlevsr_tpu_torch.cli.train as TC

    orig = TC.make_train_step
    mp.setattr(TC, "make_train_step", lambda cfg, tx, **kw: orig(
        cfg, tx, **{**kw, "compute_dtype": torch.float64}))
    create = TC.TrainState.create
    mp.setattr(TC.TrainState, "create", staticmethod(
        lambda params, tx, **kw: create(params, tx,
                                        **{**kw, "dtype": torch.float64})))


def _run_port(argv, cwd, float64=False):
    from turtlevsr_tpu_torch.cli import train as TC
    from turtlevsr_tpu_torch.utils.logger import LOGGER_NAME

    logger, handler = _collecting(LOGGER_NAME)
    try:
        with pytest.MonkeyPatch.context() as mp:
            if float64:
                _port_float64(mp)
            res = _in_dir(cwd, lambda: TC.main(argv))
    finally:
        logger.removeHandler(handler)
    return res, handler.lines


def _run_jax(yml, cwd):
    """The JAX package's cli.train.main in this process on one CPU device,
    its train step and masters in float64: (each iteration's l_pix, its
    final params)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import turtlevsr_tpu.io.torch_convert as JTCV
    import turtlevsr_tpu.parallel.mesh as JM
    import turtlevsr_tpu.train.step as JS
    import turtlevsr_tpu.utils.compile_cache as JCC
    from turtlevsr_tpu.cli import train as JTC

    orig = JS.make_train_step
    logs = []

    def step_f64(cfg, tx, **kw):
        step = orig(cfg, tx, **{**kw, "compute_dtype": jnp.float64})

        def wrapped(state, lq, gt):
            state, out = step(state, lq, gt)
            logs.append(float(out["l_pix"]))
            holder["params"] = state.params
            return state, out

        return wrapped

    holder = {}
    load = JTCV.load_torch_checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "make_train_step", step_f64)
        mp.setattr(JTCV, "load_torch_checkpoint",
                   lambda path, *a, **kw: load(path, dtype=jnp.float64))
        mp.setattr(JCC, "enable_persistent_cache", lambda *a, **k: None)
        mp.setattr(JM, "make_mesh", lambda *a, **k: Mesh(
            np.array(jax.devices()[:1]), ("data",)))
        mp.setattr(JM, "per_process_batch_size", lambda b: b)
        mp.setattr(sys, "argv", ["train", "-opt", yml, "--max_iters",
                                 str(ITERS)])
        _in_dir(cwd, JTC.main)
    return logs, jax.device_get(holder["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.models import build_model

    wd = tmp_path_factory.mktemp("train_cli")
    data = str(wd / "data")
    _write_frames(data)
    pth = str(wd / "pretrain.pth")
    yml = str(wd / "tiny.yml")
    text = TINY_YML.format(root=data).replace(
        "name: tiny_debug_cli", f"name: {NAME}").replace(
        "val_freq: 8", f"val_freq: {ITERS}")
    text += (f"path:\n  pretrain_network_g: {pth}\n"
             "  strict_load_g: true\n")
    with open(yml, "w") as f:
        f.write(text)
    opt = load_options(yml, is_train=True)
    model = build_model(opt, device="cpu")
    _seeded_weights(model, 11)
    torch.save({"params": model.state_dict()}, pth)

    port_dir, jax_dir = wd / "port", wd / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port, port_lines = _run_port(["-opt", yml, "--device", "cpu",
                                  "--max_iters", str(ITERS)], str(port_dir),
                                 float64=True)
    # the JAX run skips its own validation (its build_validation runs once,
    # on the port's masters, in the validation test): a copy of the option
    # file with val_freq 0
    jax_yml = str(wd / "tiny_jax.yml")
    with open(jax_yml, "w") as f:
        f.write(text.replace(f"val_freq: {ITERS}", "val_freq: 0"))
    jax_losses, jax_params = _run_jax(jax_yml, str(jax_dir))
    return dict(wd=wd, yml=yml, opt=opt, pth=pth, port_dir=str(port_dir),
                port=port, port_lines=port_lines, jax_losses=jax_losses,
                jax_params=jax_params)


def _exp(runs, *parts):
    return os.path.join(runs["port_dir"], "experiments", NAME, *parts)


def test_losses_match_jax_cli(runs):
    got = [r["l_pix"] for r in runs["port"]["logs"]]
    assert [r["iter"] for r in runs["port"]["logs"]] == [1, 2]
    assert len(got) == len(runs["jax_losses"]) == ITERS
    np.testing.assert_allclose(got, runs["jax_losses"], rtol=1e-5)


def test_final_masters_match_jax_cli(runs):
    import jax

    from turtlevsr_tpu_torch.io import jax_tree_from_model, load_state_dict_file
    from turtlevsr_tpu_torch.models import build_model

    model = build_model(runs["opt"], device="cpu", dtype=torch.float64)
    model.load_state_dict(load_state_dict_file(_exp(
        runs, "models", f"net_g_{ITERS}.pth")), strict=True)
    got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(jax_tree_from_model(model))[0]}
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(runs["jax_params"])[0]}
    assert set(got) == set(want)
    lr = 4e-4
    for k in want:
        assert want[k].dtype == np.float64, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * lr, rtol=0,
                                   err_msg=k)
    # the masters moved from the pretrained weights
    start = load_state_dict_file(runs["pth"])
    moved = sum(bool((p != start[n]).any()) for n, p in
                model.state_dict().items())
    assert moved > 0.9 * len(start)


def test_validation_psnr_matches_jax_build_validation(runs):
    import jax

    from turtlevsr_tpu.cli.train import build_validation
    from turtlevsr_tpu.config.options import (
        load_options as j_load,
        model_config_from_options as j_config,
    )
    from turtlevsr_tpu.data import create_dataset as j_dataset
    from turtlevsr_tpu.io.torch_convert import load_torch_checkpoint

    port_psnr = runs["port"]["val"][ITERS]["psnr"]
    assert np.isfinite(port_psnr)
    assert any(line.startswith("Validation,\t # psnr: ")
               for line in runs["port_lines"])
    jopt = j_load(runs["yml"], is_train=True)
    jopt["kernels"] = "xla"
    validate = build_validation(j_config(jopt), None, jopt)
    params = load_torch_checkpoint(_exp(runs, "models",
                                        f"net_g_{ITERS}.pth"))
    want = validate(jax.device_get(params), j_dataset(jopt, "val"))["psnr"]
    assert abs(port_psnr - want) <= 0.05, (port_psnr, want)


def test_checkpoint_files_are_the_reference_format(runs):
    from turtlevsr_tpu_torch.models import build_model

    blob = torch.load(_exp(runs, "training_states", f"{ITERS}.state"),
                      weights_only=True)
    assert set(blob) == {"epoch", "iter", "optimizers", "schedulers"}
    assert blob["iter"] == ITERS and blob["schedulers"] == []
    (adam,) = blob["optimizers"]
    assert set(adam) == {"state", "param_groups"}
    model = build_model(runs["opt"], device="cpu")
    n = len(list(model.parameters()))
    assert sorted(adam["state"]) == list(range(n))
    assert all(float(s["step"]) == ITERS for s in adam["state"].values())
    net = torch.load(_exp(runs, "models", f"net_g_{ITERS}.pth"),
                     weights_only=True)
    assert set(net) == {"params"}
    model.load_state_dict(net["params"], strict=True)
    # the masters' type (float64 in this run, float32 as the command line
    # makes them: test_checkpoint_round_trip_is_bit_exact)
    assert all(v.dtype == torch.float64 for v in net["params"].values())
    # validation wrote the res / gt / lq PNGs only when save_img is set
    assert not os.path.isdir(_exp(runs, "visualization")) or not any(
        fs for _, _, fs in os.walk(_exp(runs, "visualization")))


def test_net_g_reads_into_the_jax_tree_as_the_model_gives_it(runs):
    import jax

    from turtlevsr_tpu.io.torch_convert import load_torch_checkpoint
    from turtlevsr_tpu_torch.io import jax_tree_from_model, load_state_dict_file
    from turtlevsr_tpu_torch.models import build_model

    path = _exp(runs, "models", f"net_g_{ITERS}.pth")
    model = build_model(runs["opt"], device="cpu")
    model.load_state_dict(load_state_dict_file(path), strict=True)
    got = jax.tree_util.tree_flatten_with_path(
        jax.device_get(load_torch_checkpoint(path)))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax_tree_from_model(model))[0])
    assert len(got) == len(want)
    for k, v in got:
        np.testing.assert_array_equal(np.asarray(v), want[k],
                                      err_msg=jax.tree_util.keystr(k))


def test_second_call_resumes_traces_and_exports(runs):
    from turtlevsr_tpu_torch.io import load_state_dict_file

    trace = os.path.join(runs["port_dir"], "trace")
    res, lines = _run_port(["-opt", runs["yml"], "--device", "cpu",
                            "--max_iters", str(ITERS + 1), "--trace_dir",
                            trace, "--trace_iters", "1"], runs["port_dir"])
    assert f"Resuming training from iter {ITERS}" in lines
    assert res["start_iter"] == ITERS and res["iter"] == ITERS + 1
    assert [r["iter"] for r in res["logs"]] == [ITERS + 1]
    assert np.isfinite(res["logs"][0]["l_pix"])
    sizes = [os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(trace) for f in fs]
    assert sizes and min(sizes) > 0, "the trace is empty"
    out = os.path.join(runs["port_dir"], "export.pth")
    _run_port(["-opt", runs["yml"], "--device", "cpu", "--export_pth", out],
              runs["port_dir"])
    got = load_state_dict_file(out)
    want = load_state_dict_file(_exp(runs, "models",
                                     f"net_g_{ITERS + 1}.pth"))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """save, latest_checkpoint_step, restore: the masters, AdamW's moments
    and step counts bit for bit; one more step from the original state and
    from the restored one gives the same masters."""
    from reference_oracle import tiny_opt
    from turtlevsr_tpu_torch.io.checkpoint import (
        latest_checkpoint_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from turtlevsr_tpu_torch.models import build_model
    from turtlevsr_tpu_torch.train import (
        TrainState,
        build_schedule,
        make_optimizer,
        make_train_step,
    )

    train_opt = {"optim_g": {"lr": 4e-4, "weight_decay": 1e-3,
                             "betas": [0.9, 0.99]}, "total_iter": 10}
    model = build_model(tiny_opt(), device="cpu")
    _seeded_weights(model, 3)
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    step = make_train_step(model.cfg, tx, compute_dtype=torch.float32,
                           device="cpu")
    rng = np.random.RandomState(4)
    clips = [(rng.rand(1, 2, 32, 32, 3).astype(np.float32),
              rng.rand(1, 2, 32, 32, 3).astype(np.float32)) for _ in range(2)]
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device="cpu")
    state, _ = step(state, *clips[0])
    exp = str(tmp_path / "exp")
    assert latest_checkpoint_step(exp) is None
    save_checkpoint(exp, 1, state, epoch=7)
    save_checkpoint(exp, 0, state)
    assert latest_checkpoint_step(exp) == 1
    fresh = TrainState.create(dict(build_model(tiny_opt(), device="cpu")
                                   .named_parameters()), tx, device="cpu")
    restored = restore_checkpoint(exp, 1, fresh)
    assert restored.step == state.step == 1
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p), n
    sd_a = state.opt_state.state_dict()["state"]
    sd_b = restored.opt_state.state_dict()["state"]
    assert sorted(sd_a) == sorted(sd_b)
    for i in sd_a:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sd_a[i][key], sd_b[i][key]), (i, key)
    state, la = step(state, *clips[1])
    restored, lb = step(restored, *clips[1])
    assert float(la["l_pix"]) == float(lb["l_pix"])
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p), n
    assert torch.load(os.path.join(exp, "training_states", "1.state"),
                      weights_only=True)["epoch"] == 7
    net = torch.load(os.path.join(exp, "models", "net_g_1.pth"),
                     weights_only=True)["params"]
    assert all(v.dtype == torch.float32 for v in net.values())
    assert not [f for d, _, fs in os.walk(exp) for f in fs if ".tmp" in f]


def test_dict2str_and_message_line_equal_the_jax_package(monkeypatch):
    import time as time_mod

    from turtlevsr_tpu.config.options import dict2str as j_dict2str
    from turtlevsr_tpu.utils import logger as JL
    from turtlevsr_tpu_torch.config.options import dict2str
    from turtlevsr_tpu_torch.utils import logger as TL

    opt = {"name": "Final_Gaia_Gopro", "train": {"total_iter": 200000,
                                                 "optim_g": {"lr": 4e-4}},
           "logger": {"print_freq": 200, "use_tb_logger": False},
           "dir_data": ["/data/train"], "n_sequence": 5}
    assert dict2str(opt) == j_dict2str(opt)
    lines = {}
    for name, mod in (("jax", JL), ("port", TL)):
        # the logger's start, then every later read (the message's, the
        # log record's)
        clock = iter([1000.0])
        monkeypatch.setattr(time_mod, "time", lambda: next(clock, 1123.5))
        msg = mod.MessageLogger(opt, start_iter=1201)
        logger, handler = _collecting(msg.logger.name)
        try:
            msg({"iter": 1400, "epoch": 3, "lrs": [3.9e-4], "time": 0.61234,
                 "data_time": 0.0123, "l_pix": 0.0456})
        finally:
            logger.removeHandler(handler)
        lines[name] = handler.lines
    assert lines["port"] == lines["jax"]
    assert lines["port"] == [
        "[Final..][epoch:  3, iter:   1,400, lr:(3.900e-04,)] [eta: "
        "1 day, 10:03:54, time (data): 0.612 (0.012)] l_pix: 4.5600e-02 "]


def test_too_few_clips_for_a_batch_raise(tmp_path):
    """A training set that makes no whole batch raises instead of looping
    over empty epochs."""
    from turtlevsr_tpu_torch.cli import train as TC

    data = str(tmp_path / "data")
    _write_frames(data, n=3)
    yml = str(tmp_path / "tiny.yml")
    with open(yml, "w") as f:
        f.write(TINY_YML.format(root=data).replace(
            "batch_size_per_gpu: 1", "batch_size_per_gpu: 2"))
    with pytest.raises(ValueError, match="make no batch of 2"):
        _in_dir(str(tmp_path), lambda: TC.main(["-opt", yml, "--device",
                                                "cpu"]))
