"""The port's app (turtlevsr_tpu_torch/app.py) against the JAX package's on
the CPU: the same reference-format .pth (written here from a seed), the tiny
option file of tests/test_cli.py as the task's file, a 3-frame video and an
image, deblurring and x4 super-resolution. Both apps run float32 (each
engine's type set by the test) and the port's on ``device="cpu"``: the plain
versions of the kernels against the Pallas kernels in interpret mode.

Tolerance: the restored PNGs agree within 1 level of 255 on at least 99.9 %
of their values. float32 outputs of the two packages differ by about 2e-4
at most (the slice tests' float32 tolerance), so a value lands on the other
side of a rounding boundary of 1/255 now and then and no more."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_cli import TINY_YML  # noqa: E402
from turtlevsr_tpu_torch import app as T  # noqa: E402

torch.set_num_threads(1)

TASKS = {"deblur": "Video Deblurring (GoPro)",
         "sr": "Video Super-Resolution x4 (MVSR)"}
SIDE, FRAMES = 64, 3
LEVEL_SHARE = 0.999  # share of PNG values within 1 level of 255


def _write_task(tmp, kind):
    """The task's option file (the tiny one; the SR model for `sr`), a
    reference-format .pth of seeded weights, a 3-frame mp4 and a PNG."""
    from PIL import Image

    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.models import build_model

    options = tmp / "options"
    options.mkdir()
    text = TINY_YML.format(root=tmp)
    if kind == "sr":
        text = text.replace("model: Turtle_t1_arch",
                            "model: Turtlesuper_t1_arch")
    yml = options / T.SUPPORTED_TASKS[TASKS[kind]][0]
    yml.write_text(text)
    model = build_model(load_options(str(yml), is_train=False), device="cpu",
                        generator=torch.Generator().manual_seed(7))
    pth = str(tmp / "weights.pth")
    torch.save({"params": model.state_dict()}, pth)
    rng = np.random.RandomState(0)
    mp4 = str(tmp / "in.mp4")
    vw = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                         (SIDE, SIDE))
    for _ in range(FRAMES):
        vw.write((rng.rand(SIDE, SIDE, 3) * 255).astype(np.uint8))
    vw.release()
    png = str(tmp / "in.png")
    Image.fromarray((rng.rand(SIDE, SIDE, 3) * 255).astype(np.uint8)).save(
        png)
    return str(options), pth, mp4, png


def _pngs(folder):
    from PIL import Image

    return [np.asarray(Image.open(os.path.join(folder, f)))
            for f in sorted(os.listdir(folder))]


def _video(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


@pytest.fixture(scope="module", params=sorted(TASKS))
def both(request, tmp_path_factory):
    """Each app's restore_video and restore_image on the same files."""
    import jax.numpy as jnp

    import turtlevsr_tpu.app as J
    import turtlevsr_tpu.eval.engine as jax_engine
    import turtlevsr_tpu_torch.eval.engine as port_engine

    kind = request.param
    tmp = tmp_path_factory.mktemp("app_" + kind)
    options, pth, mp4, png = _write_task(tmp, kind)
    task = TASKS[kind]
    kw = dict(ckpt_dir=str(tmp), options_dir=options, custom_model_path=pth)
    mp = pytest.MonkeyPatch()
    mp.setattr(tempfile, "tempdir", str(tmp))  # the apps' job folders
    mp.setattr(jax_engine, "InferenceEngine", functools.partial(
        jax_engine.InferenceEngine, dtype=jnp.float32))
    mp.setattr(port_engine, "InferenceEngine", functools.partial(
        port_engine.InferenceEngine, dtype=torch.float32))
    port = dict(device="cpu")
    try:
        return {"kind": kind,
                "jax_video": J.restore_video(mp4, task, **kw),
                "jax_image": J.restore_image(png, task, **kw),
                "video": T.restore_video(mp4, task, **kw, **port),
                "image": T.restore_image(png, task, **kw, **port)}
    finally:
        mp.undo()


@pytest.fixture(autouse=True)
def _job_folders_in_tmp_path(tmp_path, monkeypatch):
    """The apps' job folders (tempfile.mkdtemp) under the test's own."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _agree(a, b):
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert (d <= 1).mean() >= LEVEL_SHARE, (d.max(), (d > 1).mean())


def test_restored_video_frames_agree_with_the_jax_app(both):
    """The PNGs of restore_video: as many, as large, within the tolerance."""
    jax_dir = os.path.join(os.path.dirname(both["jax_video"]["video"]),
                           "restored")
    want, got = _pngs(jax_dir), _pngs(both["video"]["frames"])
    assert len(got) == len(want) == FRAMES
    assert sorted(os.listdir(both["video"]["frames"])) == sorted(
        os.listdir(jax_dir))
    for a, b in zip(got, want):
        assert a.shape == (SIDE, SIDE, 3)
        _agree(a, b)
    assert len(both["video"]["fetch_clock"]) == FRAMES
    assert both["video"]["fps"] > 0


def test_restored_image_agrees_with_the_jax_app(both):
    from PIL import Image

    for key in ("image", "side_by_side"):
        a = np.asarray(Image.open(both["image"][key]))
        b = np.asarray(Image.open(both["jax_image"][key]))
        assert a.shape == ((SIDE, SIDE, 3) if key == "image"
                           else (SIDE, 2 * SIDE, 3))
        _agree(a, b)


@pytest.mark.parametrize("key", ["video", "comparison", "side_by_side",
                                 "slider"])
def test_comparison_videos_have_the_jax_apps_frames_and_sizes(both, key):
    got, want = _video(both["video"][key]), _video(both["jax_video"][key])
    assert len(got) == len(want) == FRAMES
    assert got[0].shape == want[0].shape == (
        SIDE, 2 * SIDE if key == "side_by_side" else SIDE, 3)


def test_cancel_before_the_first_frame(tmp_path):
    options, pth, mp4, _ = _write_task(tmp_path, "deblur")
    job = T.Job()
    job.cancel.set()
    res = T.restore_video(mp4, TASKS["deblur"], str(tmp_path), options,
                          job=job, custom_model_path=pth, device="cpu")
    assert res == {"status": "cancelled"}


def test_max_dim_guard(tmp_path, monkeypatch):
    options, pth, mp4, png = _write_task(tmp_path, "deblur")
    monkeypatch.setattr(T, "MAX_DIM", SIDE - 1)
    with pytest.raises(ValueError, match=f"exceeds {SIDE - 1}px"):
        T.restore_image(png, TASKS["deblur"], str(tmp_path), options,
                        device="cpu")
    with pytest.raises(ValueError, match=f"exceeds {SIDE - 1}px"):
        T.restore_video(mp4, TASKS["deblur"], str(tmp_path), options,
                        custom_model_path=pth, device="cpu")


def test_checkpoint_is_looked_up_under_the_ckpt_dir(tmp_path):
    """<ckpt_dir>/<name>.pth is the task's checkpoint; without it the
    weights are those of the seed 0."""
    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.models import build_model

    options, pth, _, _ = _write_task(tmp_path, "deblur")
    task = TASKS["deblur"]
    seed0 = T._build_task_model(task, str(tmp_path), options, device="cpu")
    yml = os.path.join(options, T.SUPPORTED_TASKS[task][0])
    want = build_model(load_options(yml, is_train=False), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    for (n, a), b in zip(seed0.state_dict().items(),
                         want.state_dict().values()):
        assert torch.equal(a, b), n
    os.replace(pth, tmp_path / (T.SUPPORTED_TASKS[task][1] + ".pth"))
    found = T._build_task_model(task, str(tmp_path), options, device="cpu")
    saved = torch.load(tmp_path / (T.SUPPORTED_TASKS[task][1] + ".pth"),
                       weights_only=True)["params"]
    for n, a in found.state_dict().items():
        assert torch.equal(a, saved[n]), n


def test_main_without_gradio():
    try:
        import gradio  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("this check is for a machine without gradio")
    with pytest.raises(SystemExit, match="gradio is not installed"):
        T.main([])
    with pytest.raises(SystemExit, match="gradio is not installed"):
        T.main(["--device", "cpu", "--port", "7861"])


def test_supported_tasks_are_the_jax_apps():
    import turtlevsr_tpu.app as J

    assert T.SUPPORTED_TASKS == J.SUPPORTED_TASKS
    assert T.MAX_DIM == J.MAX_DIM


class _FakeGradio:
    """The parts of gradio that create_ui uses: components record their
    arguments, buttons their handlers, Blocks its launch."""

    def __init__(self):
        self.clicks, self.launched = [], None
        fake = self

        class Component:
            def __init__(self, *args, **kwargs):
                self.args, self.kwargs = args, kwargs

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def click(self, fn, inputs, outputs):
                fake.clicks.append((fn, inputs, outputs))

            def launch(self, **kwargs):
                fake.launched = kwargs

        for name in ("Blocks", "Accordion", "Tab", "Row", "Column",
                     "Markdown", "Checkbox", "Textbox", "Video", "Dropdown",
                     "Number", "Button", "Image"):
            setattr(self, name, Component)


def test_the_ui_wires_its_tabs_to_the_pipeline(tmp_path, monkeypatch):
    """create_ui without gradio installed, against a stand-in: each tab's
    button runs restore_video / restore_image with the custom checkpoint and
    option file, and an error lands in the status box."""
    import sys

    options, pth, mp4, png = _write_task(tmp_path, "deblur")
    fake = _FakeGradio()
    monkeypatch.setitem(sys.modules, "gradio", fake)
    T.create_ui(str(tmp_path), options, device="cpu")
    (video_fn, video_in, video_out), (image_fn, image_in, image_out) = \
        fake.clicks
    assert (len(video_in), len(video_out), len(image_in), len(image_out)) == (
        6, 5, 6, 3)
    yml = os.path.join(options, T.SUPPORTED_TASKS[TASKS["deblur"]][0])
    res = video_fn(mp4, TASKS["deblur"], 0, True, pth, yml)
    assert res[4].startswith("done (") and all(map(os.path.isfile, res[:4]))
    res = image_fn(png, TASKS["deblur"], 0, True, pth, yml)
    assert res[2] == "done" and os.path.isfile(res[0])
    res = video_fn(str(tmp_path / "none.mp4"), TASKS["deblur"], 0, False, "",
                   "")
    assert res[:4] == (None,) * 4 and res[4].startswith("Error: ")


def test_main_launches_the_ui(tmp_path, monkeypatch):
    import sys

    options, _, _, _ = _write_task(tmp_path, "deblur")
    fake = _FakeGradio()
    monkeypatch.setitem(sys.modules, "gradio", fake)
    T.main(["--ckpt-dir", str(tmp_path), "--options-dir", options,
            "--port", "7861", "--device", "cpu"])
    assert fake.launched == {"server_name": "0.0.0.0", "server_port": 7861}
    assert len(fake.clicks) == 2
