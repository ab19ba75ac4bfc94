"""The port stands alone: no jax, nothing of the JAX package, no quiet
fallbacks from the card or the kernels."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import tiny_fhr_opt
from reference_oracle import tiny_opt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "turtlevsr_tpu_torch")

torch.set_num_threads(1)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_has_the_expected_modules():
    rel = {os.path.relpath(f, ROOT) for f in _port_sources()}
    for want in ("chip_smoke.py", "turtlevsr_tpu_torch/kernels/ffn.py",
                 "turtlevsr_tpu_torch/kernels/build.py",
                 "turtlevsr_tpu_torch/kernels/sab.py",
                 "turtlevsr_tpu_torch/kernels/lattice.py",
                 "turtlevsr_tpu_torch/kernels/level.py",
                 "turtlevsr_tpu_torch/kernels/chain2.py",
                 "turtlevsr_tpu_torch/kernels/vjp.py",
                 "turtlevsr_tpu_torch/train/losses.py",
                 "turtlevsr_tpu_torch/train/lr_schedule.py",
                 "turtlevsr_tpu_torch/train/step.py",
                 "turtlevsr_tpu_torch/ops/resize.py",
                 "turtlevsr_tpu_torch/cli/infer.py",
                 "turtlevsr_tpu_torch/cli/bench.py",
                 "turtlevsr_tpu_torch/metrics/psnr_ssim.py",
                 "turtlevsr_tpu_torch/utils/img.py",
                 "turtlevsr_tpu_torch/data/loader.py",
                 "turtlevsr_tpu_torch/data/dataset.py",
                 "turtlevsr_tpu_torch/data/sampler.py",
                 "turtlevsr_tpu_torch/data/transforms.py",
                 "turtlevsr_tpu_torch/cli/train.py",
                 "turtlevsr_tpu_torch/io/checkpoint.py",
                 "turtlevsr_tpu_torch/utils/misc.py",
                 "turtlevsr_tpu_torch/utils/logger.py",
                 "turtlevsr_tpu_torch/utils/profiling.py",
                 "turtlevsr_tpu_torch/models/blocks.py",
                 "turtlevsr_tpu_torch/models/turtle.py",
                 "turtlevsr_tpu_torch/eval/engine.py",
                 "turtlevsr_tpu_torch/parallel/mesh.py",
                 "turtlevsr_tpu_torch/io/torch_convert.py",
                 "turtlevsr_tpu_torch/core/cache.py",
                 "turtlevsr_tpu_torch/config/options.py",
                 "turtlevsr_tpu_torch/app.py",
                 "turtlevsr_tpu_torch/cli/video.py",
                 "turtlevsr_tpu_torch/utils/video_io.py",
                 "turtlevsr_tpu_torch/data/framepack.py",
                 "turtlevsr_tpu_torch/io/file_client.py",
                 "turtlevsr_tpu_torch/data/create_lmdb.py"):
        assert want in rel, want
    from turtlevsr_tpu_torch.kernels import build

    assert len(build.KERNEL_SOURCES) == 28
    assert {"conv_f32", "attn_v_f32", "split_f32", "chm_f32"} <= set(
        build.KERNEL_SOURCES)
    # the framepack reader's own copy of its C++ source (built by g++)
    assert os.path.isfile(os.path.join(PORT, "data", "framepack.cc"))
    headers = ("common.cuh", "ffn_tile.cuh", "qkv_tile.cuh", "pipe.cuh",
               "stats_wg.cuh", "c64_tile.cuh", "ffn_wg.cuh", "f32_tile.cuh",
               "gram_f32.cuh")
    for cu in (*headers, *(n + ".cu" for n in build.KERNEL_SOURCES)):
        assert os.path.isfile(os.path.join(PORT, "kernels", "csrc", cu)), cu
        assert cu in headers or cu[:-3] in build._SIGNATURES


def test_a_changed_header_changes_every_library_path(tmp_path, monkeypatch):
    """The library's name carries a hash of its source AND of every header of
    csrc/ (level.cu includes ffn_tile.cuh and qkv_tile.cuh): a stale library
    is never loaded after a header changed."""
    import shutil

    from turtlevsr_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    with open(csrc / "qkv_tile.cuh", "a") as f:
        f.write("// touched\n")
    after = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    assert all(before[n] != after[n] for n in build.KERNEL_SOURCES)
    with open(csrc / "level.cu", "a") as f:
        f.write("// touched\n")
    last = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    assert [n for n in last if last[n] != after[n]] == ["level"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "turtlevsr_tpu"), (
                f"{path} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import turtlevsr_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'turtlevsr_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("yml", ["Turtle_Deblur_Gopro.yml",
                                 "Turtle_Desnow.yml", "Turtle_Derain.yml",
                                 "Turtle_SR_MVSR.yml"])
def test_shipped_t1_configs_build_unchanged(yml):
    """The shipped option files build as they are, the t1 ones (GoPro), the
    t0 ones (desnow, derain: Turtle_arch) and the SR one: CHM blocks end
    their decoder levels; a t0 SAB slot keeps a vestigial zero K field."""
    from turtlevsr_tpu_torch.config.options import (
        load_options,
        model_config_from_options,
    )
    from turtlevsr_tpu_torch.models.blocks import CausalHistoryModel
    from turtlevsr_tpu_torch.models.turtle import Turtle

    opt = load_options(os.path.join(ROOT, "options", yml), is_train=False)
    cfg = model_config_from_options(opt)
    assert cfg.variant == {"Turtle_t1_arch": "t1", "Turtle_arch": "t0",
                           "Turtlesuper_t1_arch": "sr"}[opt["model"]]
    with torch.device("meta"):  # shapes only: 59 M parameters stay unmade
        model = Turtle(cfg)
    assert sum(p.numel() for p in model.parameters()) == 59079548
    for level in (model.decoder_level1, model.decoder_level2,
                  model.decoder_level3):
        assert isinstance(level.transformer_blocks[-1].attn,
                          CausalHistoryModel)
        assert level.transformer_blocks[-1].spec.variant == (
            "t0" if cfg.variant == "t0" else "t1")
    ws = model.decoder_level1.transformer_blocks[-1].spec.window_size
    assert ws == 16
    side = 16 if cfg.variant == "sr" else 64  # SR: the low-resolution size
    cache = model.init_cache(1, side, side, torch.bfloat16)
    assert cache[7]["v"].shape == (1, 2, 16, 16 * 16 * opt["dim"])
    # dec3: a 16 x 16 map of 4 dim channels under a window of 4
    assert cache[5]["k"].shape == (
        (1, opt["num_frames_tocache"], 8, 8) if cfg.variant == "t0" else
        (1, opt["num_frames_tocache"], 16, 8 * opt["dim"]))


def test_tiny_chm_config_builds():
    from turtlevsr_tpu_torch.models import build_model

    model = build_model(tiny_opt(), device="cpu")  # CHM in the decoder
    assert [s is None for s in model.init_cache(1, 32, 32)] == [
        True, True, True, False, False, False, False, False]


@pytest.mark.parametrize("model", ["Turtle_arch", "TurtleSuper_t1_arch"])
def test_other_variants_raise_not_implemented(model):
    """Every variant of the reference is ported: t0 and SR build (the test
    keeps the name it had while they raised); a model name the reference
    does not have raises."""
    from turtlevsr_tpu_torch.config.options import OptionsError
    from turtlevsr_tpu_torch.models import build_model

    built = build_model(tiny_fhr_opt(model=model), device="cpu")
    assert built.cfg.variant == {"turtle_arch": "t0",
                                 "turtlesuper_t1_arch": "sr"}[model.lower()]
    with pytest.raises(OptionsError, match="unknown model"):
        build_model(tiny_fhr_opt(model=model + "_v2"), device="cpu")


def test_tiled_mode_raises_not_implemented():
    """Tiled mode runs for every variant: the SR engine plans the grid on
    the high-resolution frame and gives a frame of that size. The test keeps
    the name it had while tiled mode raised, so that its record stays one
    line."""
    from turtlevsr_tpu_torch.eval.engine import InferenceEngine
    from turtlevsr_tpu_torch.models import build_model

    for model_name, n_tiles in (("Turtle_t1_arch", 4), ("Turtle_arch", 4),
                                ("TurtleSuper_t1_arch", 4)):
        model = build_model(tiny_fhr_opt(model=model_name), device="cpu")
        eng = InferenceEngine(model, mode="tiled", tile=32, tile_overlap=8,
                              dtype=torch.float32, device="cpu")
        out = eng.step(np.random.RandomState(0).rand(40, 48, 3).astype(
            np.float32))
        assert out.shape == (40, 48, 3) and np.isfinite(out).all()
        assert eng._cache[3]["k"].shape[0] == n_tiles  # 2 x 2 tiles


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    """No entry point carries on on the CPU by itself."""
    from turtlevsr_tpu_torch.eval.engine import InferenceEngine
    from turtlevsr_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_fhr_opt())
    model = build_model(tiny_fhr_opt(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    # training: the train step and its state live on the card by default
    from turtlevsr_tpu_torch.train import (
        TrainState,
        build_schedule,
        make_optimizer,
        make_train_step,
    )

    train_opt = {"optim_g": {"lr": 4e-4}, "total_iter": 10}
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model.cfg, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainState.create(dict(model.named_parameters()), tx)
    # the training command line: before it reads its option file
    from turtlevsr_tpu_torch.cli import train as train_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["-opt", "no_such_file.yml"])
    # the app: before it reads its option file or its video
    from turtlevsr_tpu_torch import app

    for fn in (app.restore_video, app.restore_image):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn("no_such_video.mp4", list(app.SUPPORTED_TASKS)[0],
               "no_such_dir", "no_such_dir")


@pytest.mark.parametrize("fn", ["ffn", "qkv_stats", "split_proj", "conv3x3",
                                "chm_stats", "sab", "lattice_split",
                                "lattice_merge", "attn_v_slots",
                                "attn_v_merge", "level_run", "two_stage",
                                "sab_sparse_softmax"])
def test_kernel_call_without_a_card_raises(fn):
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain version: the wrapper raises."""
    from turtlevsr_tpu_torch.kernels import chain2 as C2
    from turtlevsr_tpu_torch.kernels import ffn as K
    from turtlevsr_tpu_torch.kernels import lattice as L
    from turtlevsr_tpu_torch.kernels import level as LV
    from turtlevsr_tpu_torch.kernels import sab as S

    x = torch.zeros(1, 8, 8, 8, device="meta")
    w = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        if fn == "ffn":
            K.fused_block_ffn(x, ln_w=w, w1=x[0, 0], wd=x[0, :3, :3],
                              w2=x[0, 0], mode="gelu")
        elif fn == "qkv_stats":
            K.fused_qkv_stats(x, ln_w=w, w1=x[0, 0], wd=x[0, :3, :3], heads=1)
        elif fn == "split_proj":
            K.fused_ln_split_proj(x, ln_w=w, w1=x[0, 0], wd=x[0, :3, :3],
                                  n_out=1)
        elif fn == "conv3x3":
            K.fused_conv3x3(x, x[0, :3, :3].unsqueeze(-1))
        elif fn == "chm_stats":
            K.fused_chm_stats(x, x[None], ln_w=w, w_qkv=x[0, 0],
                              wd_qkv=x[0, :3, :3], w_kv=x[0, 0],
                              wd_kv=x[0, :3, :3], heads=1)
        elif fn == "sab":
            S.sab_attn_probs(x[0], x, w[:1], grid_wq=4)
        elif fn == "lattice_split":
            L.lattice_split(x, 2)
        elif fn == "lattice_merge":
            L.lattice_merge(x[0], 2, 4, 8)
        elif fn == "attn_v_slots":
            S.sab_attn_v_slots(x[0], x[0], 8)
        elif fn == "attn_v_merge":
            S.sab_attn_v_merge(x[0], x[0, :, :, :4].repeat(1, 1, 2), 1, 2, 4)
        elif fn == "level_run":
            LV.fused_channel_gffw_run(x, [{}], 1)
        elif fn == "two_stage":
            st = dict(ln_w=w, w1=x[0, 0], wd=x[0, :3, :3], w2=x[0, 0],
                      mode="gelu")
            C2.fused_two_stage(x, st, st)
        else:
            S.sab_sparse_softmax(x[0], x[0, 0])


def test_building_kernels_without_nvcc_raises():
    from turtlevsr_tpu_torch.kernels import build

    import shutil

    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this check is for a machine without the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_launch_counters_cover_every_wrapper():
    from turtlevsr_tpu_torch import kernels

    counts = kernels.launch_counts()
    assert set(counts) == {"ffn", "qkv_stats", "split_proj", "conv3x3",
                           "chm_stats", "sab", "lattice_merge",
                           "lattice_split", "attn_v_slots", "attn_v_merge",
                           "level_run", "ffn_no_dw", "ffn_wg", "ffn_c64",
                           "ffn_pw", "qkv_wg", "split_wg", "split_c64",
                           "chm_wg", "sab_wg", "level_wg", "two_stage",
                           "two_stage_wg", "sab_sparse_softmax", "sparse_wg",
                           "sab_f32", "ffn_f32", "qkv_f32", "conv3x3_f32",
                           "attn_v_f32", "split_f32", "chm_f32"}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_no_environment_switches_in_the_port():
    from turtlevsr_tpu_torch.parallel import mesh

    for path in _port_sources():
        if path.endswith("build.py") or path.endswith("chip_smoke.py"):
            continue  # build.py reads CUDA_HOME to find nvcc, nothing else
        with open(path) as f:
            src = f.read()
        if path == mesh.__file__:
            # the launchers' rendezvous variables, read in one place that
            # takes only the names of LAUNCHER_VARIABLES
            assert src.count("os.environ") == 1 and "getenv" not in src
            with pytest.raises(KeyError):
                mesh._launcher_env("TURTLE_SOMETHING", "0")
            continue
        assert "os.environ" not in src and "getenv" not in src, path
