"""FramePack: a packed-frame dataset format with a native C++ reader (the
JAX package's ``turtlevsr_tpu.data.framepack``, the same ``TVSRPAK1`` files:
a pack written by either package reads in the other).

Frames are decoded once at pack time and stored raw in one file; a training
read is a memcpy from an mmap, and a clip (gather and joint crop) or a batch
of clips is one ctypes call into ``framepack.cc`` beside this module, with
one thread a clip for a batch.

    pack_video_root(root, out_dir)                   # folder tree -> packs
    ds = FramePackDataset(opt, phase)                # the dataset

``framepack.cc`` is built by g++ at first use into the package's
git-ignored build directory (``kernels/_build/``, beside the CUDA
libraries), under a name that carries a hash of the source. Nothing stands
in for the native reader: a missing g++ or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from typing import List, Sequence

import numpy as np

from turtlevsr_tpu_torch.kernels import build as kernel_build

_MAGIC = b"TVSRPAK1"
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "framepack.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_LIB = None


def lib_path() -> str:
    """Where the built library lives: the kernels' build directory, its name
    a hash of the flags and of ``framepack.cc``."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(kernel_build.BUILD_DIR,
                        f"libframepack_{h.hexdigest()[:12]}.so")


def build_lib() -> str:
    """Build ``framepack.cc`` unless its library exists; returns its path.
    Raises RuntimeError without g++ or when the build fails."""
    out = lib_path()
    if os.path.isfile(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the framepack reader is built "
                           "from framepack.cc at first use")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for framepack.cc:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build_lib())
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.framepack_open.restype = ctypes.c_void_p
            lib.framepack_open.argtypes = [ctypes.c_char_p]
            lib.framepack_close.argtypes = [ctypes.c_void_p]
            lib.framepack_count.restype = ctypes.c_uint64
            lib.framepack_count.argtypes = [ctypes.c_void_p]
            lib.framepack_shape.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                            u32p]
            lib.framepack_read_clip.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_void_p]
            lib.framepack_read_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint32, ctypes.c_uint32, u32p, u32p,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
            _LIB = lib
        return _LIB


def pack_frames(frame_files: List[str], out_path: str) -> int:
    """Pack decoded frames (RGB uint8) into one .pack file."""
    from PIL import Image

    entries = []
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(frame_files)))
        index_pos = f.tell()
        f.write(b"\0" * (20 * len(frame_files)))
        for path in frame_files:
            img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
            h, w, c = img.shape
            entries.append((f.tell(), h, w, c))
            f.write(np.ascontiguousarray(img).tobytes())
        f.seek(index_pos)
        for off, h, w, c in entries:
            f.write(struct.pack("<QIII", off, h, w, c))
    return len(frame_files)


def pack_video_root(root: str, out_dir: str, sides=("gt", "blur")) -> dict:
    """Pack every ``root/<side>/<video>/`` folder into
    ``out_dir/<side>/<video>.pack``; returns {side: [pack paths]}."""
    result = {}
    for side in sides:
        packs = []
        for vdir in sorted(glob.glob(os.path.join(root, side, "*"))):
            files = sorted(glob.glob(os.path.join(vdir, "*")))
            out = os.path.join(out_dir, side,
                               os.path.basename(vdir) + ".pack")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            pack_frames(files, out)
            packs.append(out)
        result[side] = packs
    return result


class FramePack:
    """One pack file, read through the native reader."""

    def __init__(self, path: str):
        self.path = path
        self._lib = lib = _lib()
        self._h = lib.framepack_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} as a framepack (missing, or "
                          "not a TVSRPAK1 file)")
        self.n = int(lib.framepack_count(self._h))
        hwc = (ctypes.c_uint32 * 3)()
        lib.framepack_shape(self._h, 0, hwc)
        self.h, self.w, self.c = int(hwc[0]), int(hwc[1]), int(hwc[2])

    def read_clip(self, first: int, t: int, y: int, x: int, ph: int,
                  pw: int) -> np.ndarray:
        """Frames [first, first + t) cropped at (y, x) to (ph, pw):
        (t, ph, pw, c) uint8."""
        out = np.empty((t, ph, pw, self.c), np.uint8)
        rc = self._lib.framepack_read_clip(self._h, first, t, y, x, ph, pw,
                                           out.ctypes.data)
        if rc != 0:
            raise IndexError(f"framepack {self.path}: clip ({first}, {t}) "
                             f"crop ({y}, {x}, {ph}, {pw}) out of range "
                             f"(rc={rc})")
        return out

    def read_batch(self, firsts: Sequence[int], t: int, ys: Sequence[int],
                   xs: Sequence[int], ph: int, pw: int) -> np.ndarray:
        """A clip a start, each cropped at its own (y, x), read in one call
        with a thread a clip: (n, t, ph, pw, c) uint8."""
        n = len(firsts)
        if not len(ys) == len(xs) == n:
            raise ValueError("read_batch: firsts, ys and xs differ in length")
        out = np.empty((n, t, ph, pw, self.c), np.uint8)
        f = np.ascontiguousarray(firsts, np.uint64)
        y = np.ascontiguousarray(ys, np.uint32)
        x = np.ascontiguousarray(xs, np.uint32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        rc = self._lib.framepack_read_batch(
            self._h, f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, t,
            y.ctypes.data_as(u32p), x.ctypes.data_as(u32p), ph, pw,
            out.ctypes.data)
        if rc != 0:
            raise IndexError(f"framepack {self.path}: a clip of the batch is "
                             f"out of range (rc={rc})")
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.framepack_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class FramePackDataset:
    """VideoImageDataset's clips from .pack files laid out as
    ``root/{gt,blur}/<video>.pack`` (made by :func:`pack_video_root`):
    sliding n_sequence windows, a joint random crop, the 8-mode
    augmentation and the rgb_range scale, drawn from one RandomState seeded
    by ``manual_seed`` in the JAX package's order."""

    def __init__(self, opt: dict, phase: str):
        from turtlevsr_tpu_torch.data.transforms import random_augmentation

        self.opt = opt
        self.phase = phase
        self.n_seq = int(opt["n_sequence"])
        self.patch_size = int(opt.get("patch_size", 192))
        self.rgb_range = float(opt.get("rgb_range", 1))
        self.no_augment = bool(opt.get("no_augment", False))
        self._augment = random_augmentation
        roots = (opt["dir_data"] if phase == "train"
                 else opt["datasets"]["val"]["dir_data"])
        if not isinstance(roots, (list, tuple)):
            roots = [roots]
        self.gt_packs, self.lq_packs = [], []
        for root in roots:
            for g in sorted(glob.glob(os.path.join(root, "gt", "*.pack"))):
                b = g.replace(os.sep + "gt" + os.sep,
                              os.sep + "blur" + os.sep)
                self.gt_packs.append(FramePack(g))
                self.lq_packs.append(FramePack(b))
        self.windows = [p.n - self.n_seq + 1 for p in self.gt_packs]
        self.num_frame = sum(self.windows)
        self._rng = np.random.RandomState(int(opt.get("manual_seed", 0))
                                          or None)

    def __len__(self):
        return self.num_frame

    def __getitem__(self, idx: int) -> dict:
        idx = idx % self.num_frame
        for v, n in enumerate(self.windows):
            if idx < n:
                break
            idx -= n
        gt_p, lq_p = self.gt_packs[v], self.lq_packs[v]
        if self.phase == "train":
            ps = self.patch_size
            y = self._rng.randint(0, gt_p.h - ps + 1)
            x = self._rng.randint(0, gt_p.w - ps + 1)
        else:
            y = x = 0
            ps = None
        ph = ps or gt_p.h
        pw = ps or gt_p.w
        gt = gt_p.read_clip(idx, self.n_seq, y, x, ph, pw)
        lq = lq_p.read_clip(idx, self.n_seq, y, x, ph, pw)
        if self.phase == "train" and not self.no_augment:
            t = gt.shape[0]
            cat = np.concatenate([*gt, *lq], axis=2)
            (cat,) = self._augment(self._rng, cat)
            gt = np.stack(np.split(cat[..., :t * 3], t, axis=2))
            lq = np.stack(np.split(cat[..., t * 3:], t, axis=2))
        scale = self.rgb_range / 255.0
        return {"lq": lq.astype(np.float32) * scale,
                "gt": gt.astype(np.float32) * scale,
                "key": [f"video{v}.{idx + j:05d}" for j in range(self.n_seq)]}
