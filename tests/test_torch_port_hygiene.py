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
                 "turtlevsr_tpu_torch/models/blocks.py",
                 "turtlevsr_tpu_torch/models/turtle.py",
                 "turtlevsr_tpu_torch/eval/engine.py",
                 "turtlevsr_tpu_torch/io/torch_convert.py",
                 "turtlevsr_tpu_torch/core/cache.py",
                 "turtlevsr_tpu_torch/config/options.py"):
        assert want in rel, want
    for cu in ("common.cuh", "ffn.cu", "qkv_stats.cu", "split_proj.cu",
               "conv3x3.cu"):
        assert os.path.isfile(os.path.join(PORT, "kernels", "csrc", cu)), cu


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


def test_chm_config_raises_not_implemented():
    from turtlevsr_tpu_torch.models import build_model

    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(tiny_opt(), device="cpu")  # the shipped CHM decoder


@pytest.mark.parametrize("model", ["Turtle_arch", "TurtleSuper_t1_arch"])
def test_other_variants_raise_not_implemented(model):
    from turtlevsr_tpu_torch.models import build_model

    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(tiny_fhr_opt(model=model), device="cpu")


def test_tiled_mode_raises_not_implemented():
    from turtlevsr_tpu_torch.eval.engine import InferenceEngine
    from turtlevsr_tpu_torch.models import build_model

    model = build_model(tiny_fhr_opt(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        InferenceEngine(model, mode="tiled", device="cpu")


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


@pytest.mark.parametrize("fn", ["ffn", "qkv_stats", "split_proj", "conv3x3"])
def test_kernel_call_without_a_card_raises(fn):
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain version: the wrapper raises."""
    from turtlevsr_tpu_torch.kernels import ffn as K

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
        else:
            K.fused_conv3x3(x, x[0, :3, :3].unsqueeze(-1))


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


def test_no_environment_switches_in_the_port():
    for path in _port_sources():
        if path.endswith("build.py") or path.endswith("chip_smoke.py"):
            continue  # build.py reads CUDA_HOME to find nvcc, nothing else
        with open(path) as f:
            src = f.read()
        assert "os.environ" not in src and "getenv" not in src, path
