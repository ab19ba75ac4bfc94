"""The port's video tools (turtlevsr_tpu_torch/utils/video_io.py,
turtlevsr_tpu_torch/cli/video.py) against the JAX package's on the same
frame folders and videos: the same file names, frame counts, sizes and
decoded frames."""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import turtlevsr_tpu.cli.video as jax_cli  # noqa: E402
import turtlevsr_tpu.utils.video_io as J  # noqa: E402
import turtlevsr_tpu_torch.cli.video as port_cli  # noqa: E402
import turtlevsr_tpu_torch.utils.video_io as T  # noqa: E402

H, W, N = 48, 64, 8


def _write_frames(folder, n, h, w, seed):
    os.makedirs(folder)
    rng = np.random.RandomState(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"{i:05d}.png"),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return str(folder)


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


def _same_videos(a, b):
    fa, fb = _decode(a), _decode(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        assert x.shape == y.shape
        assert np.array_equal(x, y)
    return fa


def _same_folders(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert np.array_equal(cv2.imread(os.path.join(a, f)),
                              cv2.imread(os.path.join(b, f)))
    return names


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An input frame folder, a prediction folder (and one at twice the
    size, as SR gives), and an mp4 of the input at 30 fps."""
    wd = tmp_path_factory.mktemp("video_io")
    inp = _write_frames(wd / "input", N, H, W, 0)
    pred = _write_frames(wd / "pred", N, H, W, 1)
    pred2 = _write_frames(wd / "pred_x2", N, 2 * H, 2 * W, 2)
    mp4 = str(wd / "in.mp4")
    J.frames_to_video(inp, mp4, fps=30.0)
    return wd, inp, pred, pred2, mp4


@pytest.mark.parametrize("fps", [None, 10.0, 15.0], ids=str)
def test_extract_frames_matches(clip, tmp_path, fps):
    """Numbered PNGs of the decoded video, also at a lower target fps."""
    _, _, _, _, mp4 = clip
    nj = J.extract_frames(mp4, str(tmp_path / "jax"), target_fps=fps)
    nt = T.extract_frames(mp4, str(tmp_path / "port"), target_fps=fps)
    assert nj == nt == (N if fps is None else -(-N // round(30.0 / fps)))
    names = _same_folders(tmp_path / "jax", tmp_path / "port")
    assert names[0] == "00000.png" and len(names) == nt


def test_extract_frames_raises_on_a_missing_video(tmp_path):
    with pytest.raises(IOError, match="cannot open video"):
        T.extract_frames(str(tmp_path / "none.mp4"), str(tmp_path / "out"))


@pytest.mark.parametrize("fn", ["frames_to_video", "side_by_side_video",
                                "comparison_slider_video",
                                "comparison_wipe_video"])
@pytest.mark.parametrize("pred", ["same_size", "twice_the_size"])
def test_videos_match(clip, tmp_path, fn, pred):
    wd, inp, same, twice, _ = clip
    pred_dir = same if pred == "same_size" else twice
    a, b = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    if fn == "frames_to_video":
        args = (pred_dir,)
    else:
        args = (inp, pred_dir)
    assert getattr(J, fn)(*args, a) == getattr(T, fn)(*args, b) == N
    frames = _same_videos(a, b)
    h, w = (H, W) if pred == "same_size" else (2 * H, 2 * W)
    if fn == "comparison_wipe_video":  # the input's size is canonical there
        h, w = H, W
    assert frames[0].shape == (h, 2 * w if fn == "side_by_side_video" else w,
                               3)


def test_videos_raise_without_frames(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for fn in (T.side_by_side_video, T.comparison_slider_video,
               T.comparison_wipe_video):
        with pytest.raises(FileNotFoundError):
            fn(empty, empty, str(tmp_path / "x.mp4"))
    with pytest.raises(FileNotFoundError):
        T.frames_to_video(empty, str(tmp_path / "x.mp4"))


@pytest.mark.parametrize("cmd", ["extract", "extract_fps", "assemble",
                                 "compare"])
def test_command_line_matches(clip, tmp_path, monkeypatch, capsys, cmd):
    """python -m turtlevsr_tpu_torch.cli.video against the JAX package's,
    same arguments, same files and report."""
    _, inp, pred, _, mp4 = clip

    def args(out):
        return {"extract": ["extract", mp4, out],
                "extract_fps": ["extract", mp4, out, "--fps", "15"],
                "assemble": ["assemble", pred, out, "--fps", "24"],
                "compare": ["compare", inp, pred, out]}[cmd]

    ext = "" if cmd.startswith("extract") else ".mp4"
    a, b = str(tmp_path / ("jax" + ext)), str(tmp_path / ("port" + ext))
    monkeypatch.setattr(sys, "argv", ["video", *args(a)])
    jax_cli.main()
    said_j = capsys.readouterr().out
    n = port_cli.main(args(b))
    said_t = capsys.readouterr().out
    assert said_t == said_j.replace(a, b)
    if ext:
        assert len(_same_videos(a, b)) == n
    else:
        assert len(_same_folders(a, b)) == n
