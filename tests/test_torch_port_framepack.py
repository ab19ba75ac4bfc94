"""The port's framepack reader (turtlevsr_tpu_torch/data/framepack.py and its
own framepack.cc) against the JAX package's: the same pack bytes, packs of
either package read by the other, clips, batches and dataset items exact;
the library built into the port's git-ignored build directory, and no
fallback when g++ is missing or fails."""

import os

import numpy as np
import pytest

import turtlevsr_tpu.data.framepack as J
import turtlevsr_tpu_torch.data.framepack as T
from turtlevsr_tpu_torch.kernels import build as kernel_build

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H, W, FRAMES = 40, 52, 7


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Two videos of gt and blur PNG frames, packed by each package."""
    from PIL import Image

    wd = tmp_path_factory.mktemp("framepack")
    root = wd / "data"
    rng = np.random.RandomState(0)
    frames = {}
    for side in ("gt", "blur"):
        for v in ("vid0", "vid1"):
            d = root / side / v
            d.mkdir(parents=True)
            frames[side, v] = []
            for f in range(FRAMES):
                img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
                Image.fromarray(img).save(d / f"{f:05d}.png")
                frames[side, v].append(img)
    jax_out, port_out = wd / "jax", wd / "port"
    made_j = J.pack_video_root(str(root), str(jax_out))
    made_t = T.pack_video_root(str(root), str(port_out))
    return frames, made_j, made_t


def test_packs_are_byte_for_byte_the_jax_packages(packed):
    _, made_j, made_t = packed
    assert sorted(made_j) == sorted(made_t) == ["blur", "gt"]
    for side in made_j:
        assert [os.path.basename(p) for p in made_j[side]] == [
            os.path.basename(p) for p in made_t[side]] == ["vid0.pack",
                                                          "vid1.pack"]
        for a, b in zip(made_j[side], made_t[side]):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_a_pack_of_either_package_reads_in_the_other(packed, writer, reader):
    frames, made_j, made_t = packed
    path = (made_j if writer == "jax" else made_t)["blur"][1]
    p = (J if reader == "jax" else T).FramePack(path)
    assert (p.n, p.h, p.w, p.c) == (FRAMES, H, W, 3)
    clip = p.read_clip(2, 4, 3, 5, 16, 20)
    for j in range(4):
        np.testing.assert_array_equal(clip[j],
                                      frames["blur", "vid1"][2 + j][3:19, 5:25])


@pytest.mark.parametrize("crop", [(0, 0, H, W), (7, 9, 24, 32), (1, 0, 39, 1)])
def test_read_clip_and_read_batch_equal_the_jax_reader(packed, crop):
    _, made_j, made_t = packed
    y, x, ph, pw = crop
    pj, pt = J.FramePack(made_j["gt"][0]), T.FramePack(made_t["gt"][0])
    for first, t in ((0, 3), (4, 3), (0, FRAMES)):
        np.testing.assert_array_equal(pt.read_clip(first, t, y, x, ph, pw),
                                      pj.read_clip(first, t, y, x, ph, pw))
    firsts, ys, xs = [0, 3, 4, 1], [y, 0, y, 0], [x, x, 0, 0]
    batch = pt.read_batch(firsts, 3, ys, xs, ph, pw)
    assert batch.shape == (4, 3, ph, pw, 3)
    for i in range(4):
        np.testing.assert_array_equal(
            batch[i], pj.read_clip(firsts[i], 3, ys[i], xs[i], ph, pw))


def test_out_of_range_reads_raise(packed):
    _, _, made_t = packed
    p = T.FramePack(made_t["gt"][0])
    with pytest.raises(IndexError):
        p.read_clip(FRAMES - 2, 3, 0, 0, H, W)
    with pytest.raises(IndexError):
        p.read_clip(0, 1, 1, 0, H, W)
    with pytest.raises(IndexError):
        p.read_batch([0, FRAMES], 1, [0, 0], [0, 0], H, W)
    with pytest.raises(IOError, match="TVSRPAK1"):
        T.FramePack(os.path.join(os.path.dirname(made_t["gt"][0]), "no"))


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("augment", [True, False])
def test_dataset_items_equal_the_jax_datasets(packed, phase, augment):
    _, made_j, made_t = packed
    items = {}
    for name, mod, made in (("jax", J, made_j), ("port", T, made_t)):
        root = os.path.dirname(os.path.dirname(made["gt"][0]))
        opt = {"n_sequence": 3, "patch_size": 16, "rgb_range": 1,
               "no_augment": not augment, "manual_seed": 5,
               "dir_data": [root], "datasets": {"val": {"dir_data": root}}}
        ds = mod.FramePackDataset(opt, phase)
        items[name] = (len(ds), [ds[i] for i in (0, 4, 7, 9, 3, 12)])
    (nj, want), (nt, got) = items["jax"], items["port"]
    assert nj == nt == 2 * (FRAMES - 3 + 1)
    for a, b in zip(got, want):
        assert a["key"] == b["key"]
        for k in ("lq", "gt"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["gt"].shape == ((3, 16, 16, 3) if phase == "train"
                                 else (3, H, W, 3))


def test_the_library_lands_in_the_build_directory(packed):
    path = T.build_lib()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == kernel_build.BUILD_DIR
    assert os.path.basename(path).startswith("libframepack_")
    assert T._lib()._name == path
    # the build directory is the git-ignored one of the kernels
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "turtlevsr_tpu_torch/kernels/_build/" in f.read().split()
    assert not path.startswith(os.path.join(ROOT, "native"))


def test_a_changed_source_changes_the_library_path(tmp_path, monkeypatch):
    src = tmp_path / "framepack.cc"
    src.write_bytes(open(T.SOURCE, "rb").read())
    monkeypatch.setattr(T, "SOURCE", str(src))
    before = T.lib_path()
    src.write_bytes(src.read_bytes() + b"// touched\n")
    assert T.lib_path() != before


@pytest.mark.parametrize("how", ["missing", "failing"])
def test_no_fallback_without_a_working_gxx(tmp_path, monkeypatch, how):
    """A missing g++ or a failed build raises; nothing reads the pack
    another way."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(T, "_LIB", None)
    if how == "missing":
        monkeypatch.setattr(T.shutil, "which", lambda name: None)
        match = "g[+][+] not found"
    else:
        fake = tmp_path / "g++"
        fake.write_text("#!/bin/sh\necho 'g++: fatal error' >&2\nexit 1\n")
        fake.chmod(0o755)
        monkeypatch.setattr(T.shutil, "which", lambda name: str(fake))
        match = "g[+][+] failed for framepack.cc"
    with pytest.raises(RuntimeError, match=match):
        T.build_lib()
    with pytest.raises(RuntimeError, match=match):
        T.FramePack("any.pack")
    build = tmp_path / "build"
    assert not build.exists() or not os.listdir(build)
