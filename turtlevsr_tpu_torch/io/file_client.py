"""Storage backends (basicsr/utils/file_client.py:11-192; the JAX package's
``turtlevsr_tpu.io.file_client``).

The disk backend is the active path (the reference's lmdb config keys are
vestigial), but the backend surface is kept for users who packed datasets
into LMDB: ``LmdbBackend`` and ``make_lmdb_from_imgs`` import ``lmdb`` only
where they use it, and the memcached backend is a pure-socket client.
"""

from __future__ import annotations

from typing import Optional


class HardDiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, "r") as f:
            return f.read()


class LmdbBackend:
    """Multi-env LMDB reader keyed by client name (file_client.py:74-154)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("lmdb is not installed; use the disk backend "
                              "or install lmdb") from e
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"lmdb: {len(client_keys)} client keys for "
                             f"{len(db_paths)} database paths")
        self._client = {}
        for key, path in zip(client_keys, db_paths):
            self._client[key] = lmdb.open(path, readonly=readonly, lock=lock,
                                          readahead=readahead, **kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        client = self._client[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend:
    """Memcached storage backend (file_client.py:28-63) as a pure-socket
    text-protocol client — no ``mc``/``pymemcache`` dependency.

    ``server_list_cfg`` follows the reference's shape (a config file
    listing servers) but also accepts a ``host:port`` string or a list of
    them directly; ``client_cfg``/``sys_path`` are accepted for API
    compatibility and ignored (they configured the C client). Keys are the
    file paths, as in the reference. get() round-robins over the servers
    on connection failure."""

    def __init__(self, server_list_cfg, client_cfg=None, sys_path=None):
        if isinstance(server_list_cfg, (list, tuple)):
            servers = list(server_list_cfg)
        elif isinstance(server_list_cfg, str) and ":" in server_list_cfg \
                and "/" not in server_list_cfg:
            servers = [server_list_cfg]
        else:
            with open(server_list_cfg) as f:
                servers = [ln.strip() for ln in f
                           if ln.strip() and not ln.startswith("#")]
        if not servers:
            raise ValueError("memcached: empty server list")
        self._servers = []
        for s in servers:
            host, _, port = s.rpartition(":")
            self._servers.append((host or "127.0.0.1", int(port)))
        self._socks = [None] * len(self._servers)
        self._readers = [None] * len(self._servers)

    def _sock(self, i):
        import socket

        if self._socks[i] is None:
            s = socket.create_connection(self._servers[i], timeout=10)
            self._socks[i] = s
            self._readers[i] = s.makefile("rb")
        return self._socks[i], self._readers[i]

    def _server_order(self, key: bytes):
        """Primary server by key hash (crc32 modula, the libmemcached
        default), the rest as connection-failure fallbacks — a miss on the
        primary is an honest miss, not a cue to scan the cluster."""
        import zlib

        n = len(self._servers)
        first = zlib.crc32(key) % n
        return [(first + j) % n for j in range(n)]

    def _readline(self, f):
        line = f.readline()
        if not line:
            raise ConnectionError("memcached: connection closed")
        return line

    def get(self, filepath):
        key = str(filepath)
        if " " in key or "\r" in key or "\n" in key:
            raise ValueError(f"invalid memcached key: {key!r}")
        last_err = None
        for i in self._server_order(key.encode()):
            try:
                s, f = self._sock(i)
                s.sendall(b"get " + key.encode() + b"\r\n")
                line = self._readline(f)
                if line == b"END\r\n":
                    return None  # miss, like a failed mc Get
                if not line.startswith(b"VALUE "):
                    raise ConnectionError(
                        f"memcached: unexpected reply {line!r}")
                # malformed framing (short header, truncated body) leaves
                # the socket desynchronized mid-reply — treat it exactly
                # like a connection failure so the handler below drops the
                # cached socket instead of reusing a poisoned stream
                try:
                    nbytes = int(line.split()[3])
                except (IndexError, ValueError):
                    raise ConnectionError(
                        f"memcached: malformed VALUE header {line!r}")
                data = f.read(nbytes)
                f.read(2)  # trailing \r\n
                end = self._readline(f)
                if end != b"END\r\n":
                    raise ConnectionError(
                        f"memcached: bad reply terminator {end!r}")
                return data
            except (OSError, ConnectionError) as e:
                last_err = e
                if self._socks[i] is not None:
                    try:
                        self._socks[i].close()
                    except OSError:
                        pass
                self._socks[i] = None
                self._readers[i] = None
        raise ConnectionError(
            f"memcached: all servers failed ({last_err})")

    def get_text(self, filepath):
        raise NotImplementedError  # matches the reference (:62-63)


class FileClient:
    """Facade dispatching on backend name (file_client.py:156-192)."""

    _backends = {"disk": HardDiskBackend, "lmdb": LmdbBackend,
                 "memcached": MemcachedBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} is not supported. Currently supported "
                f"ones are {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key: str = "default"):
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)


def make_lmdb_from_imgs(data_path: str, lmdb_path: str, img_path_list,
                        keys, compress_level: int = 1,
                        map_size: Optional[int] = None) -> None:
    """Pack a frame folder into LMDB + meta_info.txt
    (basicsr/utils/lmdb_util.py:15-143)."""
    import os

    import cv2
    import lmdb

    if len(img_path_list) != len(keys):
        raise ValueError(f"{len(img_path_list)} images for {len(keys)} keys")
    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'")
    if map_size is None:
        img = cv2.imread(os.path.join(data_path, img_path_list[0]),
                         cv2.IMREAD_UNCHANGED)
        _, buf = cv2.imencode(".png", img,
                              [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        map_size = buf.nbytes * len(img_path_list) * 10

    env = lmdb.open(lmdb_path, map_size=map_size)
    with env.begin(write=True) as txn, \
            open(os.path.join(lmdb_path, "meta_info.txt"), "w") as meta:
        for path, key in zip(img_path_list, keys):
            img = cv2.imread(os.path.join(data_path, path),
                             cv2.IMREAD_UNCHANGED)
            h, w = img.shape[:2]
            c = img.shape[2] if img.ndim == 3 else 1
            _, buf = cv2.imencode(
                ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
            txn.put(key.encode("ascii"), buf.tobytes())
            meta.write(f"{key}.png ({h},{w},{c}) {compress_level}\n")
    env.close()
