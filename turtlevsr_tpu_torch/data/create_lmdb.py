"""Dataset-specific LMDB packing recipes
(basicsr/utils/create_lmdb.py:28-128).

Each recipe scans the reference's fixed folder layout under ``--root``
(default ``./datasets``) and packs every split with
``make_lmdb_from_imgs`` (``io/file_client.py``) — same keys (filename
stem) and the same ``meta_info.txt`` format, so option files with ``.lmdb``
dataroots work unchanged. The SIDD recipe also extracts the validation
``.mat`` blocks to PNGs first (create_lmdb.py:101-128).

Usage: ``python -m turtlevsr_tpu_torch.data.create_lmdb gopro [--root datasets]``
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

from turtlevsr_tpu_torch.io.file_client import make_lmdb_from_imgs


def prepare_keys(folder_path: str, suffix: str = "png"):
    """Sorted image list + keys (filename stems) for one split folder
    (create_lmdb.py:11-26)."""
    print("Reading image path list ...")
    img_path_list = sorted(
        f for f in os.listdir(folder_path) if f.endswith("." + suffix))
    keys = [p[: -len(suffix) - 1] for p in img_path_list]
    return img_path_list, keys


def _pack(folder_path: str, lmdb_path: str, suffix: str = "png") -> None:
    img_path_list, keys = prepare_keys(folder_path, suffix)
    if not img_path_list:
        raise FileNotFoundError(
            f"no .{suffix} images under {folder_path}")
    make_lmdb_from_imgs(folder_path, lmdb_path, img_path_list, keys)


def create_lmdb_for_reds(root: str = "./datasets") -> None:
    """REDS splits (create_lmdb.py:28-47)."""
    for sub, suffix in (("val/sharp_300", "png"), ("val/blur_300", "jpg"),
                        ("train/train_sharp", "png"),
                        ("train/train_blur_jpeg", "jpg")):
        folder = osp.join(root, "REDS", sub)
        _pack(folder, folder + ".lmdb", suffix)


def create_lmdb_for_gopro(root: str = "./datasets") -> None:
    """GoPro crops + test pairs (create_lmdb.py:50-74)."""
    for sub in ("train/blur_crops", "train/sharp_crops", "test/target",
                "test/input"):
        folder = osp.join(root, "GoPro", sub)
        _pack(folder, folder + ".lmdb", "png")


def create_lmdb_for_rain13k(root: str = "./datasets") -> None:
    """Rain13k input/target (create_lmdb.py:76-86)."""
    for sub in ("train/input", "train/target"):
        folder = osp.join(root, "Rain13k", sub)
        _pack(folder, folder + ".lmdb", "jpg")


def _extract_sidd_mat(mat_path: str, key: str, folder_path: str) -> None:
    import cv2
    import scipy.io as scio

    os.makedirs(folder_path, exist_ok=True)
    if not osp.exists(mat_path):
        raise FileNotFoundError(mat_path)
    data = scio.loadmat(mat_path)[key]
    n, b, h, w, c = data.shape
    data = data.reshape(n * b, h, w, c)
    for i in range(n * b):
        cv2.imwrite(
            osp.join(folder_path, f"ValidationBlocksSrgb_{i}.png"),
            cv2.cvtColor(data[i], cv2.COLOR_RGB2BGR))


def create_lmdb_for_sidd(root: str = "./datasets") -> None:
    """SIDD train crops + val blocks extracted from the official .mat
    files (create_lmdb.py:88-128)."""
    for sub in ("train/input_crops", "train/gt_crops"):
        folder = osp.join(root, "SIDD", sub)
        _pack(folder, folder + ".lmdb", "PNG")

    for sub, mat, key in (
            ("val/input_crops", "ValidationNoisyBlocksSrgb.mat",
             "ValidationNoisyBlocksSrgb"),
            ("val/gt_crops", "ValidationGtBlocksSrgb.mat",
             "ValidationGtBlocksSrgb")):
        folder = osp.join(root, "SIDD", sub)
        _extract_sidd_mat(osp.join(root, "SIDD", mat), key, folder)
        _pack(folder, folder + ".lmdb", "png")


RECIPES = {
    "reds": create_lmdb_for_reds,
    "gopro": create_lmdb_for_gopro,
    "rain13k": create_lmdb_for_rain13k,
    "sidd": create_lmdb_for_sidd,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", choices=sorted(RECIPES))
    ap.add_argument("--root", default="./datasets",
                    help="datasets root (reference used ./datasets)")
    args = ap.parse_args(argv)
    RECIPES[args.dataset](args.root)


if __name__ == "__main__":
    main()
