"""The port's inference CLI (``python -m turtlevsr_tpu_torch.cli.infer``) on a
synthetic folder with ``--device cpu``, and the host-side modules under it
(metrics, image helpers, prefetching) against the JAX package's."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from reference_oracle import tiny_opt
from turtlevsr_tpu import metrics as JM
from turtlevsr_tpu.cli import infer as JI
from turtlevsr_tpu.utils import img as JU
from turtlevsr_tpu_torch import metrics as TM
from turtlevsr_tpu_torch.cli import infer as TI
from turtlevsr_tpu_torch.data.loader import prefetch_iter
from turtlevsr_tpu_torch.eval.engine import InferenceEngine
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.utils import img as TU

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(1)
H, W, N = 40, 56, 4


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """data/{blur,gt}/video{0,1}/0000i.png and tiny.yml."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(0)
    for vid in ("video0", "video1"):
        for i in range(N):
            gt = rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
            blur = np.clip(gt.astype(np.int32) + rng.randint(-20, 21, gt.shape),
                           0, 255).astype(np.uint8)
            for side, img in (("gt", gt), ("blur", blur)):
                d = root / "data" / side / vid
                d.mkdir(parents=True, exist_ok=True)
                Image.fromarray(img).save(d / f"{i:05d}.png")
    with open(root / "tiny.yml", "w") as f:
        yaml.safe_dump(tiny_opt(), f)
    return root


def _run(capsys, workdir, *extra):
    argv = ["-opt", str(workdir / "tiny.yml"), "--data_dir",
            str(workdir / "data" / "blur"), "--device", "cpu", "--dtype",
            "float32", *extra]
    res = TI.main(argv)
    return res, capsys.readouterr().out


def _parse(out):
    fps = float(re.search(r"^FPS: ([0-9.]+) \((\d+) frames", out, re.M)[1])
    dev = float(re.search(r"^Device-loop FPS: ([0-9.]+)", out, re.M)[1])
    frames = [float(x) for x in re.findall(
        r"^PSNR for Frame: \d+ -- ([0-9.a-z]+)", out, re.M)]
    return fps, dev, frames


def test_cli_whole_frames_with_ground_truth(capsys, workdir):
    res, out = _run(capsys, workdir, "--max_frames", "3", "--save_path",
                    str(workdir / "results"))
    assert "> WARNING: random init" in out
    fps, dev, frames = _parse(out)
    assert res["frames"] == 6 and len(frames) == 6  # 2 videos x 3 frames
    assert fps > 0 and dev >= fps * 0.99
    assert all(5.0 < p < 60.0 for p in frames)
    for vid in ("video0", "video1"):
        m = re.search(rf"^PSNR for {vid}: ([0-9.]+)", out, re.M)
        assert m and 5.0 < float(m[1]) < 60.0
        assert re.search(rf"^SSIM for {vid} is ", out, re.M)
        base = workdir / "results" / "model" / vid
        for kind in ("Pred", "Input", "GT"):
            assert os.path.exists(base / f"Frame_1_{kind}.png"), kind
    overall = float(re.search(r"^Overall PSNR: ([0-9.]+)", out, re.M)[1])
    assert abs(overall - np.mean(frames)) < 1e-9
    assert len(res["fetch_clock"]) == 6 and res["psnr"] == frames
    # the saved prediction is the engine's output for that frame
    from PIL import Image

    model = build_model(tiny_opt(), device="cpu")
    eng = InferenceEngine(model, dtype=torch.float32, device="cpu")
    first = np.asarray(Image.open(
        workdir / "data" / "blur" / "video0" / "00000.png"), np.float32) / 255
    pred = np.asarray(Image.open(
        workdir / "results" / "model" / "video0" / "Frame_1_Pred.png"))
    assert np.array_equal(pred, TU.img_from_float(eng.step(first)))


def test_cli_tiled_without_ground_truth(capsys, workdir):
    res, out = _run(capsys, workdir, "--no_gt", "--tile", "32",
                    "--tile_overlap", "8", "--max_frames", "2", "--save_path",
                    str(workdir / "tiled"))
    fps, dev, frames = _parse(out)
    assert res["frames"] == 4 and frames == [] and "PSNR" not in out
    assert os.path.exists(workdir / "tiled" / "video1" / "Frame_2_Pred.png")


def test_cli_fused_plan_and_a_saved_state_dict(capsys, workdir):
    """--model_path takes a state_dict file; the fused plan gives the same
    pictures as the split one."""
    model = build_model(tiny_opt(), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "beta"):
                p.fill_(0.25)
    path = str(workdir / "weights.pth")
    torch.save(model.state_dict(), path)
    outs = {}
    for tag, fuse in (("split", []), ("fused", ["--fuse", "channel_runs",
                                                "attn_v_merge"])):
        res, out = _run(capsys, workdir, "--model_path", path, "--tile", "32",
                        "--tile_overlap", "8", "--max_frames", "3", *fuse)
        assert f"> Loaded Model. ({path})" in out
        assert "WARNING: random init" not in out
        outs[tag] = res["psnr"]
        assert len(res["psnr"]) == 6
    assert np.allclose(outs["split"], outs["fused"], atol=1e-3)
    _, out = _run(capsys, workdir, "--max_frames", "3")
    assert not np.allclose(_parse(out)[2], outs["split"], atol=1e-3)
    bad = dict(model.state_dict())
    bad.pop("ending.bias")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        _run(capsys, workdir, "--model_path", path)


def test_cli_denoise_protocol_and_y_channel(capsys, workdir):
    """--noise_sigma: the ground truth is the input folder, the noisy frames
    are sampled once from the per-video seed and reused."""
    args = ("--data_dir", str(workdir / "data" / "gt"), "--noise_sigma", "25",
            "--noisy_dir", str(workdir / "noisy"), "--y_channel",
            "--max_frames", "2")
    res1, out1 = _run(capsys, workdir, *args)
    assert "reusing" not in out1 and len(res1["psnr"]) == 4
    res2, out2 = _run(capsys, workdir, *args)
    assert "reusing pre-sampled noisy frames" in out2
    assert res1["psnr"] == res2["psnr"]
    noisy = np.load(workdir / "noisy" / "Set8" / "video0_25" / "00000000.npy")
    from PIL import Image

    gt = np.asarray(Image.open(workdir / "data" / "gt" / "video0" /
                               "00000.png"), np.float32) / 255.0
    rng = np.random.RandomState(TI.stable_video_seed(0, "video0"))
    want = gt + rng.normal(0.0, 25 / 255.0, gt.shape).astype(np.float32)
    assert np.array_equal(noisy, want.astype(np.float32))
    assert TI.stable_video_seed(3, "clip") == JI.stable_video_seed(3, "clip")


def test_cli_presets_and_arguments():
    from turtlevsr_tpu_torch.models.blocks import FUSE_PLANS

    assert TI.TASK_PRESETS == JI.TASK_PRESETS
    assert TI.FUSE_CHOICES == FUSE_PLANS
    a = TI.parse_args(["--task", "deblur", "--data_dir", "x"])
    assert (a.opt, a.tile, a.tile_overlap, a.device, a.fuse) == (
        "options/Turtle_Deblur_Gopro.yml", 320, 192, "cuda", [])
    a = TI.parse_args(["--task", "derain", "--data_dir", "x", "--tile", "0"])
    assert a.tile == 0 and a.y_channel
    a = TI.parse_args(["--task", "denoise", "--data_dir", "x", "--fuse",
                       "attn_v_merge"])
    assert a.noise_sigma == 50.0 and a.fuse == ["attn_v_merge"]
    a = TI.parse_args(["-opt", "o.yml", "--data_dir", "x"])
    assert a.tile == 0 and a.tile_overlap == 128
    for bad in (["--data_dir", "x"], ["--task", "deblur"],
                ["--task", "deblur", "--data_dir", "x", "--fuse", "all"],
                ["--task", "deblur", "--data_dir", "x", "--kernels", "xla"]):
        with pytest.raises(SystemExit):
            TI.parse_args(bad)


def test_cli_defaults_to_the_card_and_raises_without_one(workdir):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.main(["-opt", str(workdir / "tiny.yml"), "--data_dir",
                 str(workdir / "data" / "blur"), "--no_gt"])
    with pytest.raises(FileNotFoundError, match="no video folders"):
        TI.main(["-opt", str(workdir / "tiny.yml"), "--device", "cpu",
                 "--data_dir", str(workdir / "data" / "blur" / "video0")])


def test_cli_runs_as_a_module(workdir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "turtlevsr_tpu_torch.cli.infer", "-opt",
         str(workdir / "tiny.yml"), "--data_dir",
         str(workdir / "data" / "blur"), "--device", "cpu", "--no_gt",
         "--tile", "32", "--tile_overlap", "8", "--max_frames", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^FPS: ", out.stdout, re.M)


# ---------------------------------------------------------------------------
# the host-side modules under the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_packages(seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (37, 53, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-30, 31, a.shape), 0,
                255).astype(np.uint8)
    assert TM.psnr_255(a, b) == JM.psnr_255(a, b)
    assert TM.psnr_255(a, a) == float("inf")
    assert TM.ssim_gaussian(a, b) == JM.ssim_gaussian(a, b)
    assert np.array_equal(TM.bgr2ycbcr(a), JM.bgr2ycbcr(a))
    assert np.array_equal(TM.bgr2ycbcr(a, y_only=False),
                          JM.bgr2ycbcr(a, y_only=False))
    f = a.astype(np.float32) / 255.0
    assert np.array_equal(TM.bgr2ycbcr(f), JM.bgr2ycbcr(f))
    ya, yb = TM.bgr2ycbcr(a[:, :, ::-1]), TM.bgr2ycbcr(b[:, :, ::-1])
    assert TM.ssim_gaussian(ya, yb) == JM.ssim_gaussian(ya, yb)


def test_image_helpers_equal_the_jax_packages(tmp_path):
    from PIL import Image

    x = np.random.RandomState(3).rand(9, 7, 3).astype(np.float32) * 1.4 - 0.2
    assert np.array_equal(TU.img_from_float(x), JU.img_from_float(x))
    TU.imwrite(x, str(tmp_path / "a" / "b.png"))  # float in, folders made
    back = np.asarray(Image.open(tmp_path / "a" / "b.png"))
    assert np.array_equal(back, JU.img_from_float(x))


def test_prefetch_iter_keeps_order_and_passes_errors_on():
    assert list(prefetch_iter(range(20), depth=3)) == list(range(20))

    def boom():
        yield 1
        raise KeyError("decode failed")

    it = prefetch_iter(boom())
    assert next(it) == 1
    with pytest.raises(KeyError, match="decode failed"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        next(prefetch_iter(range(3), depth=0))
    early = prefetch_iter(iter(range(1000)), depth=1)
    assert next(early) == 0
    early.close()  # leaving early stops the producer
