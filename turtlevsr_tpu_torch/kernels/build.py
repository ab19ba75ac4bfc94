"""Builds and loads the CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library: ``nvcc`` compiles it for ``sm_90a`` into ``_build/`` (a few
seconds per file, all files started together), and ``ctypes`` loads it.
Nothing is built when the package is imported, and nothing stands in for a
kernel that does not build: a missing compiler or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
KERNEL_SOURCES = ("ffn", "ffn_wg", "ffn_c64", "ffn_pw", "ffn_f32", "qkv_stats",
                  "qkv_wg", "qkv_f32",
                  "split_proj", "split_wg", "split_c64", "split_f32", "conv3x3", "conv_f32",
                  "chm_stats", "chm_wg", "chm_f32", "sab", "sab_wg", "sab_f32", "sparse_wg", "lattice", "level",
                  "level_wg", "attn_v", "attn_v_f32", "chain2", "chain2_wg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_VP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_LAUNCH_ARGS = [_VP, _IP, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "ffn": {"turtle_ffn_launch": (_LAUNCH_ARGS, ctypes.c_int),
            "turtle_ffn_smem": ([ctypes.c_int] * 5, ctypes.c_size_t)},
    "ffn_wg": {"turtle_ffn_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_ffn_wg_smem": ([ctypes.c_int] * 2, ctypes.c_size_t)},
    "ffn_c64": {"turtle_ffn_c64_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_ffn_c64_smem": ([ctypes.c_int] * 5, ctypes.c_size_t)},
    "ffn_pw": {"turtle_ffn_pw_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_ffn_pw_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "ffn_f32": {"turtle_ffn_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_ffn_f32_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "qkv_f32": {"turtle_qkv_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_qkv_f32_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "qkv_stats": {"turtle_qkv_stats_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_qkv_stats_smem": ([ctypes.c_int] * 3,
                                            ctypes.c_size_t),
                  "turtle_reduce_rows": ([ctypes.c_void_p, ctypes.c_void_p]
                                         + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p], ctypes.c_int)},
    "qkv_wg": {"turtle_qkv_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_qkv_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "chm_wg": {"turtle_chm_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_chm_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "split_proj": {"turtle_split_proj_launch": (_LAUNCH_ARGS, ctypes.c_int),
                   "turtle_split_proj_smem": ([ctypes.c_int] * 2,
                                              ctypes.c_size_t)},
    "split_f32": {"turtle_split_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_split_f32_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "chm_f32": {"turtle_chm_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_chm_f32_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "split_wg": {"turtle_split_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
                 "turtle_split_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "split_c64": {"turtle_split_c64_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_split_c64_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "conv3x3": {"turtle_conv3x3_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_conv3x3_smem": ([ctypes.c_int] * 2,
                                        ctypes.c_size_t)},
    "conv_f32": {"turtle_conv_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                 "turtle_conv_f32_smem": ([ctypes.c_int] * 2, ctypes.c_size_t)},
    "attn_v_f32": {"turtle_attn_v_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                   "turtle_attn_v_f32_smem": ([], ctypes.c_size_t)},
    "chm_stats": {"turtle_chm_stats_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_chm_stats_smem": ([ctypes.c_int] * 3,
                                            ctypes.c_size_t)},
    "sab": {"turtle_sab_launch": (_LAUNCH_ARGS, ctypes.c_int),
            "turtle_sab_smem": ([ctypes.c_int] * 4, ctypes.c_size_t),
            "turtle_sparse_softmax_launch": (_LAUNCH_ARGS, ctypes.c_int),
            "turtle_sparse_softmax_smem": ([ctypes.c_int] * 3,
                                           ctypes.c_size_t)},
    "sab_wg": {"turtle_sab_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_sab_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "sab_f32": {"turtle_sab_f32_launch": (_LAUNCH_ARGS, ctypes.c_int),
                "turtle_sab_f32_smem": ([], ctypes.c_size_t)},
    "sparse_wg": {"turtle_sparse_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_sparse_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "lattice": {"turtle_lattice_launch": (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p], ctypes.c_int)},
    "level": {"turtle_level_launch": (_LAUNCH_ARGS, ctypes.c_int),
              "turtle_level_smem": ([ctypes.c_int] * 3, ctypes.c_size_t)},
    "level_wg": {"turtle_level_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
                 "turtle_level_wg_smem": ([ctypes.c_int], ctypes.c_size_t)},
    "attn_v": {"turtle_attn_v_launch": (_LAUNCH_ARGS, ctypes.c_int)},
    "chain2": {"turtle_two_stage_launch": (_LAUNCH_ARGS, ctypes.c_int),
               "turtle_two_stage_smem": ([ctypes.c_int] * 2,
                                         ctypes.c_size_t)},
    "chain2_wg": {"turtle_two_stage_wg_launch": (_LAUNCH_ARGS, ctypes.c_int),
                  "turtle_two_stage_wg_smem": ([ctypes.c_int] * 7,
                                               ctypes.c_size_t)},
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of turtlevsr_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def _lib_path(name: str, flags: tuple = ()) -> str:
    """The library's path carries a hash of the flags, of ``<name>.cu`` and
    of every header of ``csrc/`` (a source may include any of them), so a
    changed source or header never meets a stale library."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fn in (name + ".cu", *headers):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set argtypes/restype of every function of library ``name``."""
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    return lib


def _compile(jobs: dict, verbose: bool) -> None:
    """Run nvcc for every job {key: (source name, library path, extra
    flags)} at once; raise with the output of those that fail."""
    nvcc = find_nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = {}
    for key, (name, path, flags) in jobs.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *flags, *extra, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[key] = (name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for key, (name, path, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu {key}:\n{out}")
            continue
        if verbose:
            print(f"[nvcc {name}.cu]\n{out}", flush=True)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source that has no library yet, in parallel.
    Returns {name: path of the shared library}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in KERNEL_SOURCES}
    _compile({n: (n, p, ()) for n, p in paths.items()
              if not os.path.isfile(p)}, verbose)
    return paths


def load_variants(name: str, flags: list) -> list:
    """Libraries of ``csrc/<name>.cu`` built with each entry of ``flags``
    (a tuple of extra nvcc flags), in parallel and loaded: measurement
    builds that change what a kernel runs (chip_smoke.py --phase
    level-phases); the port's own calls never load them."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [_lib_path(name, tuple(f)) for f in flags]
    _compile({i: (name, p, tuple(f))
              for i, (p, f) in enumerate(zip(paths, flags))
              if not os.path.isfile(p)}, False)
    return [declare(ctypes.CDLL(p), name) for p in paths]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = declare(ctypes.CDLL(p), n)
        return _libs[name]
