"""Per-scene h5 result files in the reference's layout (port of
``oetr_tpu/utils/h5io.py``, an own copy):

  <results>/<scene>/keypoints.h5   key = image stem (or "stem0-stem1"
                                   per pair for pairwise methods)
  <results>/<scene>/matches.h5     key = "stem0-stem1", value [2, M]
  <results>/<scene>/inparams.h5    optional [6] (sx, sy, tx, ty, rx, ry)
  <results>/<scene>/scales.h5      optional scalar overlap scale

The files are read and written with the port's own HDF5 subset
(``utils/hdf5.py``); h5py reads what it writes, and it reads h5py's.
"""
from __future__ import annotations

import os

import numpy as np

from . import hdf5


def stem(name: str) -> str:
    """Image path -> h5 key: the file name without its extension."""
    return os.path.basename(name)[:-4] if "." in os.path.basename(name) \
        else os.path.basename(name)


def pair_key(name0: str, name1: str) -> str:
    return f"{stem(name0)}-{stem(name1)}"


def save_scene_results(results_dir: str, scene: str, keypoints: dict,
                       matches: dict, inparams: dict | None = None,
                       scales: dict | None = None) -> None:
    """Write one scene's result files (overwrites)."""
    out = os.path.join(results_dir, scene)
    os.makedirs(out, exist_ok=True)
    files = [("keypoints.h5", keypoints), ("matches.h5", matches),
             ("inparams.h5", inparams), ("scales.h5", scales)]
    for name, entries in files:
        if name in ("keypoints.h5", "matches.h5") or entries:
            with hdf5.File(os.path.join(out, name), "w") as f:
                for k, v in entries.items():
                    f.create_dataset(k, data=np.asarray(v))


class SceneResults:
    """Lazy reader of one scene's h5 files."""

    def __init__(self, results_dir: str, scene: str, pairwise: bool = False):
        base = os.path.join(results_dir, scene)
        self.keypoints = hdf5.File(os.path.join(base, "keypoints.h5"), "r")
        self.matches = hdf5.File(os.path.join(base, "matches.h5"), "r")
        ip = os.path.join(base, "inparams.h5")
        self.inparams = hdf5.File(ip, "r") if os.path.exists(ip) else None
        sc = os.path.join(base, "scales.h5")
        self.scales = hdf5.File(sc, "r") if os.path.exists(sc) else None
        self.pairwise = pairwise

    def pair(self, name0: str, name1: str):
        """Returns (kpts0, kpts1, matches [2, M], inparams0, inparams1)."""
        if self.pairwise:
            k0 = self.keypoints[pair_key(name0, name1)][()]
            k1 = self.keypoints[pair_key(name1, name0)][()]
        else:
            k0 = self.keypoints[stem(name0)][()]
            k1 = self.keypoints[stem(name1)][()]
        m = self.matches[pair_key(name0, name1)][()]
        ip0 = ip1 = None
        if self.inparams is not None and len(self.inparams.keys()) > 0:
            ip0 = self.inparams[pair_key(name0, name1)][()]
            ip1 = self.inparams[pair_key(name1, name0)][()]
        return k0, k1, m, ip0, ip1

    def close(self):
        for f in (self.keypoints, self.matches, self.inparams, self.scales):
            if f is not None:
                f.close()
