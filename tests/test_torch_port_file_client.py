"""The port's storage backends and LMDB recipes
(turtlevsr_tpu_torch/io/file_client.py, turtlevsr_tpu_torch/data/
create_lmdb.py) against the JAX package's: the disk backend's bytes, the
memcached client's server order and failover against the fake server of
tests/test_backends_tail.py, every recipe's (folder, lmdb path, suffix)
list, the same ImportError without lmdb, and (where lmdb is installed) the
round trip."""

import os
import socket
import zlib

import numpy as np
import pytest

import turtlevsr_tpu.data.create_lmdb as jax_recipes
import turtlevsr_tpu.io.file_client as J
import turtlevsr_tpu_torch.data.create_lmdb as port_recipes
import turtlevsr_tpu_torch.io.file_client as T
from test_backends_tail import _FakeMemcached


def test_disk_backend_reads_what_the_jax_one_reads(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "blob.bin"
    path.write_bytes(rng.bytes(4097))
    text = tmp_path / "meta_info.txt"
    text.write_text("frame_000 (16,24,3) 1\n")
    for backend in ("disk",):
        t, j = T.FileClient(backend), J.FileClient(backend)
        assert t.get(str(path)) == j.get(str(path)) == path.read_bytes()
        assert t.get_text(str(text)) == j.get_text(str(text))


def test_unknown_backend_raises_as_the_jax_one():
    with pytest.raises(ValueError) as want:
        J.FileClient("s3")
    with pytest.raises(ValueError) as got:
        T.FileClient("s3")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_servers", [1, 2, 3, 5])
def test_memcached_server_order_is_the_jax_clients(n_servers):
    """crc32 modulo the server count picks the primary; the rest follow in
    ring order, as libmemcached's default and the JAX client do."""
    servers = [f"127.0.0.1:{11211 + i}" for i in range(n_servers)]
    t = T.MemcachedBackend(servers)
    j = J.MemcachedBackend(servers)
    for key in ("/k", "/data/img.png", "GoPro/train/00001.png", "x" * 200):
        k = key.encode()
        assert t._server_order(k) == j._server_order(k)
        assert t._server_order(k)[0] == zlib.crc32(k) % n_servers


def test_memcached_get_against_the_fake_server():
    srv = _FakeMemcached({"/data/img.png": b"\x89PNG fake bytes"})
    srv.start()
    client = T.FileClient("memcached",
                          server_list_cfg=f"127.0.0.1:{srv.port}")
    assert client.get("/data/img.png") == b"\x89PNG fake bytes"
    assert client.get("/missing") is None
    with pytest.raises(ValueError, match="invalid memcached key"):
        client.get("bad key with spaces")
    with pytest.raises(NotImplementedError):
        client.get_text("/data/img.png")


def test_memcached_failover_as_the_jax_client():
    """A dead primary fails over to the next server, as the JAX client's."""
    got = {}
    for name, mod in (("jax", J), ("port", T)):
        srv = _FakeMemcached({"/k": b"payload"})
        srv.start()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()  # nothing listens here
        alive, gone = f"127.0.0.1:{srv.port}", f"127.0.0.1:{dead_port}"
        servers = ([gone, alive] if zlib.crc32(b"/k") % 2 == 0
                   else [alive, gone])
        client = mod.FileClient("memcached", server_list_cfg=servers)
        got[name] = [client.get("/k"), client.get("/k")]
    assert got["port"] == got["jax"] == [b"payload", b"payload"]


def test_memcached_server_list_file(tmp_path):
    cfg = tmp_path / "servers.conf"
    cfg.write_text("# the pool\n10.0.0.1:11211\n\n10.0.0.2:11212\n")
    assert T.MemcachedBackend(str(cfg))._servers == J.MemcachedBackend(
        str(cfg))._servers == [("10.0.0.1", 11211), ("10.0.0.2", 11212)]
    empty = tmp_path / "empty.conf"
    empty.write_text("# none\n")
    with pytest.raises(ValueError, match="empty server list"):
        T.MemcachedBackend(str(empty))


@pytest.mark.parametrize("recipe", sorted(port_recipes.RECIPES))
def test_recipes_pack_the_jax_packages_folders(tmp_path, monkeypatch,
                                               recipe):
    """Each recipe's (folder, lmdb path, suffix) calls of _pack, in order,
    and SIDD's .mat extractions, with both packages' _pack replaced."""
    calls = {}
    for name, mod in (("jax", jax_recipes), ("port", port_recipes)):
        seen = calls[name] = []
        monkeypatch.setattr(mod, "_pack", lambda folder, lmdb, suffix="png",
                            seen=seen: seen.append((folder, lmdb, suffix)))
        monkeypatch.setattr(mod, "_extract_sidd_mat", lambda *a, seen=seen:
                            seen.append(("mat",) + a))
        mod.RECIPES[recipe](str(tmp_path))
    assert calls["port"] == calls["jax"]
    assert calls["port"] and all(c[1].endswith(".lmdb")
                                 for c in calls["port"] if c[0] != "mat")


def test_the_command_line_runs_the_named_recipe(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(port_recipes, "_pack",
                        lambda folder, lmdb, suffix="png":
                        calls.append((folder, lmdb, suffix)))
    port_recipes.main(["rain13k", "--root", str(tmp_path)])
    assert calls == [(os.path.join(str(tmp_path), "Rain13k", s),
                      os.path.join(str(tmp_path), "Rain13k", s) + ".lmdb",
                      "jpg") for s in ("train/input", "train/target")]
    with pytest.raises(SystemExit):
        port_recipes.main(["imagenet"])


def test_prepare_keys_as_the_jax_package(tmp_path):
    for f in ("b.png", "a.png", "c.jpg", "d.PNG"):
        (tmp_path / f).write_bytes(b"")
    for suffix in ("png", "jpg", "PNG"):
        assert port_recipes.prepare_keys(str(tmp_path), suffix) == \
            jax_recipes.prepare_keys(str(tmp_path), suffix)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no .png images"):
        port_recipes._pack(str(empty), str(empty) + ".lmdb")


def test_without_lmdb_the_same_import_error(tmp_path):
    try:
        import lmdb  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("this check is for a machine without lmdb")
    for ctor in (lambda m: m.LmdbBackend(str(tmp_path / "x.lmdb")),
                 lambda m: m.FileClient("lmdb",
                                        db_paths=str(tmp_path / "x.lmdb"))):
        with pytest.raises(ImportError) as want:
            ctor(J)
        with pytest.raises(ImportError) as got:
            ctor(T)
        assert str(got.value) == str(want.value)
        assert "lmdb is not installed" in str(got.value)
    (tmp_path / "f").mkdir()
    with pytest.raises(ImportError) as want:
        J.make_lmdb_from_imgs(str(tmp_path / "f"), str(tmp_path / "y.lmdb"),
                              [], [])
    with pytest.raises(ImportError) as got:
        T.make_lmdb_from_imgs(str(tmp_path / "f"), str(tmp_path / "y.lmdb"),
                              [], [])
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_lmdb_round_trip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("lmdb")
    rng = np.random.RandomState(0)
    folder = tmp_path / "frames"
    folder.mkdir()
    imgs = {}
    for i in range(3):
        img = (rng.rand(16, 24, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(folder / f"frame_{i:03d}.png"), img)
        imgs[f"frame_{i:03d}"] = img
    lmdb_path = str(tmp_path / "frames.lmdb")
    port_recipes._pack(str(folder), lmdb_path)
    meta = open(os.path.join(lmdb_path, "meta_info.txt")).read()
    assert "frame_000.png (16,24,3) 1" in meta
    client = T.FileClient("lmdb", db_paths=lmdb_path)
    for key, img in imgs.items():
        buf = client.get(key, "default")
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED),
            img)
