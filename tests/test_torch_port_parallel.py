"""Data parallelism of the port (turtlevsr_tpu_torch.parallel,
make_train_step(group=...), cli.train --launcher pytorch|slurm,
InferenceEngine(devices=...)) on the CPU, against the JAX package's mesh
layer and against the port on one process.

Ranks are processes of a gloo group started by this file
(tests/torch_port_dist_worker.py), each with a time limit of its own: a
rank that hangs is killed and fails its test. The step's group meets
through a ``file://`` under the test's tmp_path, the command line's through
a port the system gives out.

Tolerances: the two ranks' masters after two steps (float64) against the
JAX package's ``make_train_step(mesh=make_mesh(2))`` on the whole batch and
against the port's one-process step on the whole batch, atol 1e-9 at lr
2^-13 (the gradient of the whole batch's mean loss is the mean of the two
ranks' gradients up to sums in another order; Adam's eps turns such a
difference at an entry whose gradient is far below it into lr * dg / eps,
torch_port_dist_worker.TRAIN_OPT); the averaged gradients against the
one-process step's atol 1e-12, rtol 1e-9; the ranks against each other bit
for bit. The split engine against the one-device engine bit for bit (the
same chunks), against the JAX sharded engine at
tests/test_engine_sharded.py's shapes and atol 1e-6, in float64 (the two
packages' float32 engines part by more than that there: float32 sums in
another order through the model). The validation of two ranks against one process on the same
masters 1e-9 (float64 sums of the frames' PSNR in another order), against
the JAX package's ``build_validation`` 0.05 dB (bf16 activations in another
order, test_torch_port_train_cli.py).
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from test_cli import TINY_YML
from torch_port_dist_worker import (
    TRAIN_OPT,
    batches,
    make_step,
    run_steps,
    seeded_model,
)
from turtlevsr_tpu_torch import parallel as P
from turtlevsr_tpu_torch.data import EnlargedSampler
from turtlevsr_tpu_torch.eval.engine import InferenceEngine
from turtlevsr_tpu_torch.io.torch_convert import jax_tree_from_model

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_dist_worker.py")
CHILD_SECONDS = 120  # a rank's limit; a hung rendezvous fails its test


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_", "MASTER_",
                                "SLURM_"))}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, HERE, env.get("PYTHONPATH",
                                                             "")])
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _start(args, env, cwd):
    return subprocess.Popen([sys.executable, WORKER, *args], env=env,
                            cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, seconds=CHILD_SECONDS):
    """Wait for every rank; kill all and fail on a rank that overruns or
    exits non-zero."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=seconds)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not end within {seconds} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_tree(tensors):
    """Tensors named like the model's parameters, as the JAX package's tree
    (its layouts), flattened by path."""
    holder = seeded_model()
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(tensors[n])
    return _flat(jax_tree_from_model(holder))


# ---------------------------------------------------------------------------
# the groups: the train step's two ranks, the command line's launches
# ---------------------------------------------------------------------------


NAME = "tiny_dist"
ITERS = 2


def _write_video(root, name, n, seed):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("gt", "blur"):
        d = os.path.join(root, sub, name)
        os.makedirs(d)
        for f in range(n):
            img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{f:05d}.png"))


def _launch(args, cwd, envs, out_prefix):
    procs = [_start(["cli", f"{out_prefix}{r}.json", *args], env, cwd)
             for r, env in enumerate(envs)]
    _wait(procs)
    res = []
    for r in range(len(envs)):
        with open(f"{out_prefix}{r}.json") as f:
            res.append(json.load(f))
    return res


def _cli_runs(wd):
    """Two ranks of cli.train.main under --launcher pytorch (2 iterations,
    validation at 2), then two under --launcher slurm resuming to 3."""
    data = str(wd / "data")
    _write_video(data, "video0", 5, 0)
    val = str(wd / "val")
    _write_video(val, "video0", 4, 1)
    _write_video(val, "video1", 4, 2)
    port = _free_port()
    yml = str(wd / "tiny.yml")
    text = TINY_YML.format(root=data).replace(
        "name: tiny_debug_cli", f"name: {NAME}").replace(
        "val_freq: 8", f"val_freq: {ITERS}").replace(
        f"    dir_data: ['{data}']", f"    dir_data: ['{val}']")
    text += f"dist_params:\n  backend: gloo\n  port: {port}\n"
    with open(yml, "w") as f:
        f.write(text)
    run = str(wd / "run")
    os.makedirs(run)
    argv = ["-opt", yml, "--device", "cpu", "--max_iters", str(ITERS)]
    master = _free_port()
    torchrun = [_child_env(RANK=r, WORLD_SIZE=2, LOCAL_RANK=r,
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=master)
                for r in range(2)]
    first = _launch([*argv, "--launcher", "pytorch"], run, torchrun,
                    str(wd / "pytorch"))
    # slurm: srun's variables and a stub scontrol that names the hosts
    bin_dir = wd / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "scontrol"
    stub.write_text("#!/bin/sh\n[ \"$1 $2 $3\" = \"show hostname "
                    "node[1-2]\" ] || exit 1\necho localhost\necho node2\n")
    stub.chmod(0o755)
    srun = [_child_env(SLURM_PROCID=r, SLURM_NTASKS=2,
                       SLURM_NODELIST="node[1-2]",
                       PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
            for r in range(2)]
    resumed = _launch(["-opt", yml, "--device", "cpu", "--max_iters",
                       str(ITERS + 1), "--launcher", "slurm"], run, srun,
                      str(wd / "slurm"))
    return dict(wd=wd, yml=yml, run=run, first=first, resumed=resumed)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every group of this file, started at once so that the ranks run
    while this process compiles the JAX package's functions: the two
    ranks of the train step, and (in a thread that waits for them) the
    command line's two launches."""
    wd = tmp_path_factory.mktemp("steps")
    init = str(wd / "rendezvous")
    steps = [_start(["step", str(wd / f"rank{r}.pt"), init, str(r), "2",
                     "cpu", "float64"], _child_env(), str(wd))
             for r in range(2)]
    pool = ThreadPoolExecutor(1)
    cli = pool.submit(_cli_runs, tmp_path_factory.mktemp("cli"))
    yield {"wd": wd, "steps": steps, "cli": cli}
    for p in steps:
        if p.poll() is None:
            p.kill()
    pool.shutdown()


@pytest.fixture(scope="module")
def two_rank_steps(launched):
    # the one-process steps run while the ranks do
    model = seeded_model()
    step, state = make_step(model, "cpu", "float64")
    losses, grads, state = run_steps(step, state, batches(), "cpu")
    single = {"losses": losses, "grads": grads,
              "params": {n: p.detach() for n, p in state.params.items()}}
    _wait(launched["steps"])
    ranks = [torch.load(launched["wd"] / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    return {"ranks": ranks, "single": single, "model": model}


@pytest.fixture(scope="module")
def cli_runs(launched):
    return launched["cli"].result()


def test_two_ranks_agree_bit_for_bit(two_rank_steps):
    a, b = two_rank_steps["ranks"]
    assert a["losses"] == b["losses"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
        assert torch.equal(a["grads"][n], b["grads"][n]), n


def test_two_ranks_equal_one_process_on_the_whole_batch(two_rank_steps):
    rank, single = two_rank_steps["ranks"][0], two_rank_steps["single"]
    # the logged loss is the group's mean: the whole batch's (a float32
    # mean in both)
    np.testing.assert_allclose(rank["losses"], single["losses"], rtol=1e-6)
    for n, want in single["params"].items():
        np.testing.assert_allclose(rank["params"][n].numpy(), want.numpy(),
                                   atol=1e-9, rtol=0, err_msg=n)
        # the first step's: the mean over the group, not the sum
        np.testing.assert_allclose(rank["grads"][n].numpy(),
                                   single["grads"][n].numpy(), atol=1e-12,
                                   rtol=1e-9, err_msg=n)


def test_two_ranks_equal_the_jax_mesh_step(two_rank_steps):
    """The JAX package's step on a mesh of two devices, the whole batch
    sharded over it by shard_batch, from the same float64 parameters."""
    from turtlevsr_tpu.config.options import model_config_from_options
    from turtlevsr_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from turtlevsr_tpu.train import lr_schedule as JLR
    from turtlevsr_tpu.train import step as JS

    model = two_rank_steps["model"]
    jcfg = model_config_from_options({**tiny_opt(), "kernels": "xla"})
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                        jax_tree_from_model(model))
    mesh = make_mesh(2)
    jtx = JS.make_optimizer(TRAIN_OPT, JLR.build_schedule(TRAIN_OPT))
    jstep = JS.make_train_step(jcfg, jtx, compute_dtype=jnp.float64,
                               remat=True, mesh=mesh, donate=False)
    jstate = replicate(mesh, JS.TrainState.create(tree, jtx))
    jlosses = []
    for lq, gt in batches():
        jstate, logs = jstep(jstate, *shard_batch(mesh, (lq, gt)))
        jlosses.append(float(logs["l_pix"]))
    rank = two_rank_steps["ranks"][1]
    np.testing.assert_allclose(rank["losses"], jlosses, rtol=1e-6)
    got, want = _as_tree(rank["params"]), _flat(jstate.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the helpers of parallel/mesh.py without a group
# ---------------------------------------------------------------------------


def test_per_process_batch_math():
    """One process a card: each loads batch_size_per_gpu, the global batch
    is that times the world (the JAX package's: times its local devices,
    tests/test_multihost.py)."""
    from turtlevsr_tpu.parallel.mesh import per_process_batch_size as jbatch

    assert P.per_process_batch_size(2) == 2 and P.per_process_batch_size(1) == 1
    # one JAX process a host of 8 devices loads what 8 ranks of 1 card do
    assert jbatch(2) == 8 * P.per_process_batch_size(2)
    assert (P.rank(), P.world_size(), P.process_is_primary()) == (0, 1, True)
    assert P.default_group() is None
    assert P.all_reduce_sums([3, 1.5]) == [3.0, 1.5]


@pytest.mark.parametrize("items,world,ratio", [(10, 2, 1), (7, 2, 3),
                                               (9, 4, 1), (5, 3, 2)])
def test_enlarged_sampler_partitions_the_epoch_as_jax(items, world, ratio):
    """Every rank's share as the JAX sampler's stride gives it, all of one
    length; together they are the epoch's permutation."""
    from turtlevsr_tpu.data.sampler import EnlargedSampler as JSampler

    shares = []
    for r in range(world):
        s, j = EnlargedSampler(items, world, r, ratio), JSampler(
            items, world, r, ratio)
        s.set_epoch(5)
        j.set_epoch(5)
        shares.append(list(s))
        assert shares[-1] == list(j)
        assert len(shares[-1]) == len(s) == len(shares[0])
    # rank r takes entries r, r + world, ... of the epoch's permutation
    perm = np.random.RandomState(5).permutation(len(shares[0]) * world)
    assert [shares[i % world][i // world] for i in range(len(perm))] == (
        perm % items).tolist()


def test_shard_devices_and_distinct_cards():
    assert P.shard_devices(["cpu"] * 3, 45) == [
        (torch.device("cpu"), 0, 15), (torch.device("cpu"), 15, 30),
        (torch.device("cpu"), 30, 45)]
    with pytest.raises(ValueError, match="do not divide"):
        P.shard_devices(["cpu", "cpu"], 45)
    P.check_distinct_cards([("a", 0), ("a", 1), ("b", 0)])
    with pytest.raises(ValueError, match="ranks 0 and 2 both run on card 1"):
        P.check_distinct_cards([("a", 1), ("b", 1), ("a", 1)])


def test_init_dist_refuses_what_it_cannot_set_up(monkeypatch):
    assert P.init_dist("none", None) == (0, 1)
    with pytest.raises(ValueError, match="unknown launcher"):
        P.init_dist("mpi", "gloo", device="cpu")
    with pytest.raises(ValueError, match="dist_params.backend"):
        P.init_dist("pytorch", None, device="cpu")
    for name in P.mesh.LAUNCHER_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        P.init_dist("pytorch", "gloo", device="cpu")
    with pytest.raises(RuntimeError, match="SLURM_PROCID is not set"):
        P.init_dist("slurm", "gloo", device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the tiled engine split over devices
# ---------------------------------------------------------------------------


def test_split_engine_equals_one_device_and_the_jax_sharded_engine():
    """tests/test_engine_sharded.py's case: 72 x 88 frames, tiles of 48
    overlapping by 16 (2 x 3 = 6 tiles), two devices, float64."""
    from turtlevsr_tpu.config.options import model_config_from_options
    from turtlevsr_tpu.eval.engine import InferenceEngine as JEngine
    from turtlevsr_tpu.parallel.mesh import make_mesh

    model = seeded_model(seed=7)
    tree = jax_tree_from_model(model)
    kw = dict(mode="tiled", tile=48, tile_overlap=16, dtype=torch.float64)
    # one device in chunks of 3: the same model calls as two shards of 3
    single = InferenceEngine(seeded_model(seed=7), max_tile_batch=3,
                             device="cpu", **kw)
    split = InferenceEngine(model, devices=["cpu", "cpu"], **kw)
    jcfg = model_config_from_options({**tiny_opt(), "kernels": "xla"})
    jeng = JEngine(jcfg, jax.tree.map(jnp.asarray, tree), mode="tiled",
                   tile=48, tile_overlap=16, dtype=jnp.float64,
                   mesh=make_mesh(2))
    rng = np.random.RandomState(5)
    for t in range(2):
        fr = rng.rand(72, 88, 3).astype(np.float32)
        a, b = single.step(fr), split.step(fr)
        np.testing.assert_array_equal(b, a, err_msg=f"frame {t}")
        np.testing.assert_allclose(b, jeng.step(fr), atol=1e-6,
                                   err_msg=f"frame {t}")
    assert len(split._cache) == 2
    assert [s[3]["k"].shape[0] for s in split._cache] == [3, 3]
    # a grid that does not divide over the devices
    odd = InferenceEngine(seeded_model(seed=7), devices=["cpu"] * 4, **kw)
    with pytest.raises(ValueError, match="6 tiles do not divide over 4"):
        odd.step(fr)
    with pytest.raises(ValueError, match="tiled mode only"):
        InferenceEngine(seeded_model(seed=7), devices=["cpu"], mode="whole",
                        dtype=torch.float64)


# ---------------------------------------------------------------------------
# the command line under the launchers
# ---------------------------------------------------------------------------

def _exp(runs, *parts):
    return os.path.join(runs["run"], "experiments", NAME, *parts)


def test_cli_two_ranks_rank_0_writes_the_files(cli_runs):
    a, b = cli_runs["first"]
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["world_size"] == b["world_size"] == 2
    assert [r["iter"] for r in a["logs"]] == [1, 2]
    # the logged loss is the group's: the same on both ranks
    assert [r["l_pix"] for r in a["logs"]] == [r["l_pix"] for r in b["logs"]]
    files = sorted(os.path.relpath(os.path.join(d, f), _exp(cli_runs))
                   for d, _, fs in os.walk(_exp(cli_runs)) for f in fs)
    assert files == ["models/net_g_2.pth", "models/net_g_3.pth",
                     f"train_{NAME}.log", "training_states/2.state",
                     "training_states/3.state"]
    with open(_exp(cli_runs, f"train_{NAME}.log")) as f:
        log = f.read()
    assert log.count("Start training from iter 0") == 1
    assert "global batch: 2 (1/device, 1/process)" in log
    assert "processes: 2 (pytorch)" in log


def test_cli_validation_sums_over_the_ranks(cli_runs):
    """Two ranks, each its val clips (idx % 2), summed: the one-process
    validation and the JAX package's build_validation on the same
    masters."""
    from turtlevsr_tpu.cli.train import build_validation as j_validation
    from turtlevsr_tpu.config.options import load_options as j_load
    from turtlevsr_tpu.config.options import (
        model_config_from_options as j_config,
    )
    from turtlevsr_tpu.data import create_dataset as j_dataset
    from turtlevsr_tpu.io.torch_convert import load_torch_checkpoint
    from turtlevsr_tpu_torch.cli.train import build_validation
    from turtlevsr_tpu_torch.config.options import (
        load_options,
        model_config_from_options,
    )
    from turtlevsr_tpu_torch.data import create_dataset
    from turtlevsr_tpu_torch.io import load_state_dict_file

    a, b = cli_runs["first"]
    assert a["val"] == b["val"] and list(a["val"]) == [str(ITERS)]
    got = a["val"][str(ITERS)]["psnr"]
    path = _exp(cli_runs, "models", f"net_g_{ITERS}.pth")
    opt = load_options(cli_runs["yml"], is_train=True)
    ds = create_dataset(opt, "val")
    assert len(ds) == 4  # two clips a rank
    one = build_validation(model_config_from_options(opt), opt,
                           device="cpu")(load_state_dict_file(path), ds)
    np.testing.assert_allclose(got, one["psnr"], rtol=0, atol=1e-9)
    jopt = j_load(cli_runs["yml"], is_train=True)
    jopt["kernels"] = "xla"
    want = j_validation(j_config(jopt), None, jopt)(
        jax.device_get(load_torch_checkpoint(path)), j_dataset(jopt, "val"))
    assert abs(got - want["psnr"]) <= 0.05, (got, want)


def test_cli_slurm_launcher_resumes(cli_runs):
    a, b = cli_runs["resumed"]
    assert (a["rank"], b["rank"], a["world_size"]) == (0, 1, 2)
    assert a["start_iter"] == b["start_iter"] == ITERS
    assert a["iter"] == ITERS + 1 and [r["iter"] for r in a["logs"]] == [3]
    assert np.isfinite(a["logs"][0]["l_pix"])
    assert [(r["l_pix"], r["lr"]) for r in a["logs"]] == [
        (r["l_pix"], r["lr"]) for r in b["logs"]]
    with open(_exp(cli_runs, f"train_{NAME}.log")) as f:
        log = f.read()
    assert f"Resuming training from iter {ITERS}" in log
    assert "processes: 2 (slurm)" in log
