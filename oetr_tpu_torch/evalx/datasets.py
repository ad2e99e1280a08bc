"""Benchmark dataset utilities: pair generation and result iteration
(port of ``oetr_tpu/evalx/datasets.py``, an own copy), as the reference's
generators and loaders do them:
  * IMC pair lists from the calibration h5 files and covisibility keys;
  * HPatches pair lists ('1.ppm' against '2..6.ppm' of each sequence) and
    result iteration with the H_1_x ground truth.
The h5 files are read with the port's own HDF5 subset (``utils/hdf5.py``).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import hdf5


def calib_to_matrix(calib) -> np.ndarray:
    """IMC calibration h5 group -> 4x4 world->camera pose."""
    pose = np.zeros((4, 4))
    pose[:3, :3] = np.asarray(calib["R"])
    pose[:3, 3] = np.asarray(calib["T"]).reshape(-1)
    pose[3, 3] = 1.0
    return pose


def generate_imc_pairs(scenes_path: str, datasets: str, output_path: str,
                       overlap_ratio: float = 0.1) -> int:
    """IMC pair txt from covisibility keys and per-image calibration.
    Returns the pair count."""
    n = 0
    with open(scenes_path) as f:
        scenes_info = [ln.strip().split(" ") for ln in f if ln.strip()]
    with open(output_path, "w") as out:
        for scene, suffix in scenes_info:
            keys = np.load(os.path.join(
                datasets, scene, "set_100/new-vis-pairs",
                f"keys-th-{overlap_ratio}.npy"))
            for key in keys:
                name0, name1 = key.split("-")
                with hdf5.File(os.path.join(
                        datasets, scene, "set_100/calibration",
                        f"calibration_{name0}.h5"), "r") as c0, \
                     hdf5.File(os.path.join(
                        datasets, scene, "set_100/calibration",
                        f"calibration_{name1}.h5"), "r") as c1:
                    K0 = " ".join(map(str, np.asarray(c0["K"]).reshape(-1)))
                    K1 = " ".join(map(str, np.asarray(c1["K"]).reshape(-1)))
                    rel = np.matmul(calib_to_matrix(c1),
                                    np.linalg.inv(calib_to_matrix(c0)))
                out.write(
                    f"{scene}/set_100/images/{name0}.{suffix} "
                    f"{scene}/set_100/images/{name1}.{suffix} "
                    f"{K0} {K1} {' '.join(map(str, rel.reshape(-1)))}\n")
                n += 1
    return n


def generate_hpatches_pairs(root: str, output_path: str) -> int:
    """'<seq>/1.ppm <seq>/i.ppm' lines for i in 2..6."""
    n = 0
    with open(output_path, "w") as f:
        for folder in sorted(os.listdir(root)):
            if not os.path.isdir(os.path.join(root, folder)):
                continue
            for i in range(2, 7):
                f.write(f"{folder}/1.ppm {folder}/{i}.ppm\n")
                n += 1
    return n


def iter_hpatches_results(pairs_file: str, dataset_path: str,
                          results_path: str, pairwise: bool = False):
    """Yield {'seq_name', 'H_gt', 'kpts0', 'kpts1', 'matches' [M,2]}
    records for evalx.hpatches.benchmark_results (keys are the image
    digit stems)."""
    with open(pairs_file) as f:
        pairs = [ln.split() for ln in f if ln.strip()]
    cache: dict[str, tuple] = {}
    for img0, img1 in pairs:
        seq = img0.split("/")[0]
        idx0 = os.path.basename(img0).split(".")[0]
        idx1 = os.path.basename(img1).split(".")[0]
        if seq not in cache:
            cache[seq] = (
                hdf5.File(os.path.join(results_path, seq, "keypoints.h5"),
                          "r"),
                hdf5.File(os.path.join(results_path, seq, "matches.h5"),
                          "r"))
        kf, mf = cache[seq]
        if pairwise:
            k0 = kf[f"{idx0}-{idx1}"][()]
            k1 = kf[f"{idx1}-{idx0}"][()]
        else:
            k0 = kf[idx0][()]
            k1 = kf[idx1][()]
        matches = mf[f"{idx0}-{idx1}"][()]
        H_gt = np.loadtxt(os.path.join(dataset_path, seq, f"H_1_{idx1}"))
        yield {"seq_name": seq, "H_gt": H_gt, "kpts0": k0, "kpts1": k1,
               "matches": matches.T if matches.shape[0] == 2 else matches}
    for kf, mf in cache.values():
        kf.close()
        mf.close()
