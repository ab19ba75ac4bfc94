"""The port's complexity and speed harness (turtlevsr_tpu_torch/cli/bench.py)
against the JAX package's (turtlevsr_tpu/cli/bench.py), on the CPU at tiny
sizes.

  * parameters: equal to the JAX package's ``init_params`` leaves, for the
    tiny models and at the full width of three shipped option files;
  * MACs, exact in integers: ``count_macs`` (a run on fake tensors)
    against a reckoning of the plain path's run on real CPU tensors,
    ``FlopCounterMode``'s FLOPs / 2 (the matrix products and, in the biased
    route, the strided convolutions) plus the depthwise taps reckoned from
    the config's shapes, which are held equal to the taps the plain path
    executes; and a few exact integers at full width. XLA's cost analysis
    of the JAX step counts elementwise work too: 1.14 times twice the MACs
    here at 32 x 64, held between 1.0 and 1.3 times;
  * the command line: the inference smoke of ``tests/test_cli.py`` with the
    JAX CLI's ``Params:`` line, the train step's header and JSON keys, the
    numerics artifact's merge, the numerics modes run on the CPU in bf16 and
    float32, and the arguments that raise.
"""

import contextlib
import io
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from reference_oracle import tiny_opt
from test_cli import TINY_YML
from turtlevsr_tpu_torch.cli import bench as B
from turtlevsr_tpu_torch.config.options import (
    load_options,
    model_config_from_options,
)
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models.turtle import Turtle, padded_hw

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHIPPED = ("Turtle_Deblur_Gopro.yml", "Turtle_Derain.yml",
           "Turtle_SR_MVSR.yml")
VARIANTS = {
    "t1": {}, "t0": {"model": "Turtle_arch"},
    "sr": {"model": "Turtlesuper_t1_arch"},
    "t1_bias": {"bias": True}, "t0_bias": {"model": "Turtle_arch", "bias": True},
    "both_input": {"use_both_input": True},
}
SIZES = ((32, 64), (40, 52))  # 40 x 52 pads to 64 x 64

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ymls(tmp_path_factory):
    """The tiny option file of tests/test_cli.py, and for the train step a
    copy whose recipe is cut to 2 frames of 32 x 32 and whose blocks are all
    ReducedAttn: the header and the JSON keys do not depend on the blocks,
    and the JAX step of the CHM and FHR blocks takes twice as long to
    compile (the train steps of those blocks are held to the JAX package's
    in tests/test_torch_port_train_parity.py)."""
    wd = tmp_path_factory.mktemp("bench")
    tiny = wd / "tiny.yml"
    tiny.write_text(TINY_YML.format(root=wd))
    text = (TINY_YML.format(root=wd).replace("n_sequence: 3", "n_sequence: 2")
            .replace("patch_size: 64", "patch_size: 32"))
    for attn in ("Channel", "CHM", "FHR"):
        text = text.replace(f'"{attn}"', '"ReducedAttn"')
    train = wd / "train.yml"
    train.write_text(text)
    return str(tiny), str(train)


def _run(fn, *a, **kw):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    return res, buf.getvalue()


@contextlib.contextmanager
def _jax_weights_of_zeros():
    """The JAX package's ``init_params`` as zeros of its shapes while its
    command line runs: what is compared here (the parameter count, the
    header, the JSON keys) depends on the shapes only, and the eager draw of
    the weights takes longer on the CPU than the rest of this file."""
    import jax.numpy as jnp

    from turtlevsr_tpu.models import turtle as jax_turtle

    init = jax_turtle.init_params

    def zeros(key, cfg):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            jax.eval_shape(lambda k: init(k, cfg), key))

    jax_turtle.init_params = zeros
    try:
        yield
    finally:
        jax_turtle.init_params = init


def _jax_leaves(opt: dict) -> int:
    from turtlevsr_tpu.config.options import (
        model_config_from_options as jax_cfg_of,
    )
    from turtlevsr_tpu.models.turtle import init_params

    cfg = jax_cfg_of(opt)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["t1", "t0", "sr"])
def test_params_of_the_tiny_models_equal_the_jax_leaves(variant):
    opt = tiny_opt(**VARIANTS[variant])
    assert B.count_params(build_model(opt, device="cpu")) == _jax_leaves(opt)


@pytest.mark.parametrize("yml", SHIPPED)
def test_params_at_full_width_equal_the_jax_leaves(yml):
    opt = load_options(os.path.join(ROOT, "options", yml), is_train=False)
    with torch.device("meta"):  # shapes only
        model = Turtle(model_config_from_options(opt))
    n = B.count_params(model)
    assert n == _jax_leaves(opt)
    assert f"{n / 1e6:.2f}" == "59.08"


# ---------------------------------------------------------------------------
# MACs
# ---------------------------------------------------------------------------

_LEVEL_SCALE = {"encoder_level1": 0, "encoder_level2": 1, "encoder_level3": 2,
                "latent": 3, "decoder_level3": 2, "decoder_level2": 1,
                "decoder_level1": 0, "refinement": 0}


def _taps_from_shapes(model, h: int, w: int) -> int:
    """Depthwise 3x3 taps of one call, from the config's shapes: every
    stride-1 depthwise conv at its level's padded map, once a map it
    convolves: the CHM's kv embedding each aligned frame (the ring and the
    current one where the block holds a slot), none for the SAB's v taps in
    the bias-free route (folded into the dense v conv) or for the t0 SAB's
    q, k chain (its scores are dead code)."""
    cfg = model.cfg
    hp, wp = padded_hw(cfg, h, w)
    taps = 0
    for name, m in model.named_modules():
        if not (isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)
                and m.stride == (1, 1)
                and m.groups == m.in_channels == m.out_channels):
            continue
        level, _, idx, *_, leaf = name.split(".")
        s = _LEVEL_SCALE[level]
        blocks = getattr(model, level).transformer_blocks
        last = int(idx) == len(blocks) - 1
        slot = (level != "refinement" and last) or (
            level == "latent" and int(idx) == 0)
        spec = blocks[int(idx)].spec
        maps = 1
        if leaf == "kv_dwconv":
            maps = 1 + (spec.num_frames_tocache if slot else 0)
        if ".spatial_aligner." in name and (
                (leaf == "v_dwconv" and not cfg.bias)
                or (leaf == "qk_dwconv" and cfg.variant == "t0")):
            maps = 0
        taps += 9 * m.out_channels * (hp >> s) * (wp >> s) * maps
    return taps


def _plain_reckoning(model, h: int, w: int, dtype=torch.float32):
    """(FlopCounterMode's FLOPs / 2 of the second call, the taps the plain
    path executed in it, the counter's operators)."""
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 2, h, w, 3)).to(
        dtype)
    model = model.to(dtype)
    with torch.inference_mode():
        cache = model.init_cache(1, h, w, dtype)
        _, cache = model(x, cache)  # the kernel-layout weights are made
        fc = FlopCounterMode(display=False)
        taps = K._dw_acc.macs
        with fc:
            model(x, cache)
        taps = K._dw_acc.macs - taps
    ops = {str(op) for op in fc.get_flop_counts()["Global"]}
    return fc.get_total_flops() // 2, taps, ops


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_macs_equal_the_plain_paths_products_and_taps(variant, size):
    if variant == "sr":  # the low-resolution input of the same maps
        size = (size[0] // 4, size[1] // 4)
    opt = tiny_opt(**VARIANTS[variant])
    model = build_model(opt, device="cpu")
    products, executed_taps, ops = _plain_reckoning(model, *size)
    assert ops <= {"aten.mm", "aten.bmm", "aten.convolution"}, ops
    taps = _taps_from_shapes(model, *size)
    assert taps == executed_taps
    assert B.count_macs(model.cfg, *size) == products + taps


@pytest.mark.parametrize("fuse,dtype", [
    (("channel_runs", "attn_v_merge", "two_stage"), torch.float32),
    ((), torch.bfloat16)], ids=["fused_plans", "bf16"])
def test_macs_are_the_same_under_every_plan_and_type(fuse, dtype):
    opt = tiny_opt()
    model = build_model(opt, device="cpu", fuse=fuse)
    products, taps, _ = _plain_reckoning(model, 64, 64, dtype)
    assert B.count_macs(model.cfg, 64, 64) == products + taps


def test_macs_are_at_most_half_of_xlas_flops():
    """XLA's cost analysis of the JAX step counts the same products and the
    elementwise work too: at least twice the MACs, and 1.14 times that at
    this size (an undercount or a large overcount leaves the band)."""
    import dataclasses

    import jax.numpy as jnp

    from turtlevsr_tpu.config.options import (
        model_config_from_options as jax_cfg_of,
    )
    from turtlevsr_tpu.models.turtle import forward, init_cache, init_params

    h, w = SIZES[0]
    opt = tiny_opt()
    cfg = dataclasses.replace(jax_cfg_of(opt), kernels="xla")
    params = jax.tree.map(  # the shapes are all the analysis reads
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
        jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0)))
    cache = init_cache(cfg, 1, h, w, dtype=jnp.float32)
    x = jnp.zeros((1, 2, h, w, 3), jnp.float32)
    step = jax.jit(lambda p, xx, c: forward(p, cfg, xx, c))
    ca = step.lower(params, x, cache).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    macs = B.count_macs(model_config_from_options(opt), h, w)
    print(f"XLA flops / (2 x MACs) at {h}x{w}: "
          f"{ca['flops'] / (2 * macs):.3f}")
    assert 1.0 <= ca["flops"] / (2 * macs) <= 1.3


def test_macs_are_those_of_the_models_own_shapes():
    """A few hand-checked terms: the SR upsampler, a pad."""
    sr = model_config_from_options(tiny_opt(**VARIANTS["sr"]))
    t1 = model_config_from_options(tiny_opt())
    # the SR model runs at 4x the size, plus the two separable products
    up = 3 * (64 * 16 * 16 + 64 * 16 * 64)
    assert B.count_macs(sr, 16, 16) == B.count_macs(t1, 64, 64) + up
    assert B.count_macs(t1, 40, 52) == B.count_macs(t1, 64, 64)


def test_macs_at_full_width():
    """The GoPro file at the reference harness's 256 x 256, as counted from
    the model's shapes block by block when the harness was ported (the
    bench phase of chip_smoke.py holds all three shipped files to theirs)."""
    cfg = model_config_from_options(load_options(
        os.path.join(ROOT, "options", SHIPPED[0]), is_train=False))
    assert B.count_macs(cfg, 256, 256) == 201_636_184_064


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _jax_bench_main(argv, monkeypatch):
    from turtlevsr_tpu.cli import bench as jax_bench

    monkeypatch.setenv("TURTLE_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", ["bench", *argv])
    with _jax_weights_of_zeros():
        return _run(jax_bench.main)[1]


def _line(out: str, prefix: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, out
    return lines[0]


def test_inference_smoke_prints_the_jax_clis_params_line(ymls, tmp_path,
                                                         monkeypatch):
    tiny, _ = ymls
    traffic = str(tmp_path / "traffic.json")
    res, out = _run(B.main, ["-opt", tiny, "--size", "64", "64", "--iters",
                             "3", "--warmup", "1", "--device", "cpu",
                             "--dtype", "float32", "--traffic_json", traffic])
    assert "Params:" in out and "Overall fps:" in out
    assert "MACs/frame:" in out
    assert res["finite"] and res["out_shape"] == [1, 64, 64, 3]
    assert res["model_calls"] == 4 and res["iters"] == 3
    cfg = model_config_from_options(load_options(tiny, is_train=False))
    assert res["macs"] == B.count_macs(cfg, 64, 64)
    with open(traffic) as f:
        art = json.load(f)
    assert art["flops_g"] == round(2 * res["macs"] / 1e9, 2)
    assert {"metric", "opt", "size", "dtype", "flops_g", "fuse",
            "device"} <= set(art) and "hbm_gb" not in art
    assert art["fuse"] == [] and art["device"] == "cpu"
    jax_out = _jax_bench_main(["-opt", tiny, "--size", "32", "32",
                               "--iters", "1", "--warmup", "1", "--kernels",
                               "xla", "--dtype", "float32"], monkeypatch)
    assert _line(out, "Params:") == _line(jax_out, "Params:")


def test_trace_dir_writes_a_trace(ymls, tmp_path):
    tiny, _ = ymls
    logdir = tmp_path / "trace"
    _, out = _run(B.main, ["-opt", tiny, "--size", "32", "32", "--iters", "2",
                           "--warmup", "1", "--device", "cpu", "--trace_dir",
                           str(logdir)])
    traces = list(logdir.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert f"Profiler trace written to {logdir}" in out


def test_train_step_prints_the_jax_header_and_keys(ymls):
    import jax.numpy as jnp

    from turtlevsr_tpu.cli import bench as jax_bench
    from turtlevsr_tpu.config.options import (
        load_options as jax_load,
        model_config_from_options as jax_cfg_of,
    )

    _, train = ymls
    res, out = _run(B.main, ["-opt", train, "--train_step", "--device", "cpu",
                             "--dtype", "float32", "--iters", "1",
                             "--warmup", "1"])
    args = types.SimpleNamespace(remat_policy="nothing", warmup=1, iters=1)
    opt = jax_load(train, is_train=True)
    import dataclasses
    cfg = dataclasses.replace(jax_cfg_of(opt), kernels="xla")
    with _jax_weights_of_zeros():
        _, jax_out = _run(jax_bench.bench_train_step, args, opt, cfg,
                          jnp.float32)
    head, jax_head = (_line(o, "train step:").split(", ")
                      for o in (out, jax_out))
    assert head[:3] == jax_head[:3] == ["train step: bs 1/chip", "T=2",
                                        "32x32"]
    assert head[-1] == jax_head[-1] == "remat=nothing"
    got, want = (json.loads(_line(o, '{"metric": "train_step_ms_1chip"'))
                 for o in (out, jax_out))
    assert list(got) == list(want)
    assert got["metric"] == "train_step_ms_1chip" and got["value"] > 0
    assert res["steps"] == 2 and res["batch"] == 1 and res["frames"] == 2


def test_numerics_merge_matches_the_jax_modules(tmp_path, monkeypatch):
    from turtlevsr_tpu.cli import bench as jax_bench

    for k in list(os.environ):
        if k.startswith("TURTLE_"):
            monkeypatch.delenv(k)
    old = {"metric": "old", "opt": "a.yml", "size": [8, 8], "min_db": 50.0}
    writes = [
        {"metric": "m", "opt": "a.yml", "size": [4, 4], "min_db": 41.0},
        {"metric": "m", "opt": "b.yml", "size": [4, 4], "min_db": 42.0},
        {"metric": "m", "opt": "a.yml", "size": [4, 4], "min_db": 43.0},
        {"metric": "m_tiled", "opt": "a.yml", "size": [4, 8], "min_db": 44.0},
    ]
    paths = {}
    for who, fn in (("jax", jax_bench._finish_numerics_artifact),
                    ("port", B._finish_numerics_artifact)):
        path = paths[who] = str(tmp_path / f"{who}.json")
        with open(path, "w") as f:
            json.dump(old, f)  # the single-object schema of old files
        args = types.SimpleNamespace(numerics_json=path, fuse=["two_stage"],
                                     device="cuda")
        for art in writes:
            _run(fn, args, dict(art))
    with open(paths["jax"]) as f:
        want = json.load(f)
    with open(paths["port"]) as f:
        got = json.load(f)
    assert [e["min_db"] for e in want] == [50.0, 43.0, 42.0, 44.0]
    assert len(got) == len(want)
    assert got[0] == want[0] == old  # read, not stamped again
    for g, w in zip(got[1:], want[1:]):
        assert g.pop("fuse") == ["two_stage"] and g.pop("device") == "cuda"
        assert g == w


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_numerics_modes_on_the_cpu(ymls, tmp_path, tiled):
    """The numerics modes' own code on the CPU (bf16 against float32, both
    through the plain versions): the artifact, its name and its frames."""
    tiny, _ = ymls
    args = B.parse_args(["-opt", tiny, "--size", "64", "64",
                         "--numerics_json", str(tmp_path / "n.json"),
                         "--numerics_tile", "48" if tiled else "0",
                         "--numerics_overlap", "16", "--numerics"])
    args.device = "cpu"  # the command line refuses it; the function runs
    opt = load_options(tiny, is_train=False)
    fn = B.bench_numerics_tiled if tiled else B.bench_numerics
    art, out = _run(fn, args, opt, model_config_from_options(opt))
    n = B.NUMERICS_TILED_FRAMES if tiled else B.NUMERICS_FRAMES
    assert len(art["per_frame_db"]) == n and out.count("PSNR(") == n
    assert art["metric"] == ("psnr_bf16_kernels_vs_fp32_plain_64x64"
                             + ("_tiled48" if tiled else ""))
    assert art["min_db"] >= 40.0
    if tiled:
        assert art["tiles"] == 4  # 64 at stride 32: 2 x 2
    with open(args.numerics_json) as f:
        assert json.load(f) == [art]


def test_device_cuda_without_a_card_raises(ymls):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    tiny, _ = ymls
    for extra in ([], ["--train_step"], ["--numerics"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            B.main(["-opt", tiny, "--size", "32", "32", *extra])


@pytest.mark.parametrize("extra", [
    ["--numerics", "--device", "cpu"],
    ["--numerics_tile", "320", "--device", "cpu"],
    ["--numerics", "--dtype", "float32"],
    ["--kernels", "xla"]])
def test_arguments_that_raise(ymls, extra, capsys):
    tiny, _ = ymls
    with pytest.raises(SystemExit):
        B.main(["-opt", tiny, *extra])
