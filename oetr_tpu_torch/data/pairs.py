"""Pair-list parsing (port of ``oetr_tpu/data/pairs.py``, an own copy):
the reference's MegaDepth pairs txt format.

Training lines (10 whitespace-separated fields, parsed as the reference's
megadepth_pairs dataset parses them):

  image_path1 depth_path1 K1(9 comma) pose1(16 comma) bbox1(4 comma)
  image_path2 depth_path2 K2(9 comma) pose2(16 comma) bbox2(4 comma)

Benchmark pair lists (eval) use the reference's simpler format:
  name0 name1 K0(9) K1(9) pose(16) [bbox0(4) bbox1(4)]
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PairRecord:
    image_path1: str
    depth_path1: str
    K1: np.ndarray          # [3, 3]
    pose1: np.ndarray       # [4, 4]
    overlap1: np.ndarray    # [4] xyxy
    image_path2: str
    depth_path2: str
    K2: np.ndarray
    pose2: np.ndarray
    overlap2: np.ndarray


def parse_pairs_line(line: str) -> PairRecord | None:
    """Parse one training-pairs line; None for degenerate overlap boxes
    (the reference's filter)."""
    f = line.split()
    if len(f) < 10:
        return None
    K1 = np.array(f[2].split(","), dtype=float).reshape(3, 3)
    pose1 = np.array(f[3].split(","), dtype=float).reshape(4, 4)
    bbox1 = np.array(f[4].split(","), dtype=float)
    K2 = np.array(f[7].split(","), dtype=float).reshape(3, 3)
    pose2 = np.array(f[8].split(","), dtype=float).reshape(4, 4)
    bbox2 = np.array(f[9].split(","), dtype=float)
    if (bbox1[0] >= bbox1[2] or bbox1[1] >= bbox1[3]
            or bbox2[0] >= bbox2[2] or bbox2[1] >= bbox2[3]):
        return None
    return PairRecord(f[0], f[1], K1, pose1, bbox1, f[5], f[6], K2, pose2,
                      bbox2)


def load_pairs(path: str) -> list[PairRecord]:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = parse_pairs_line(line)
            if rec is not None:
                records.append(rec)
    return records


@dataclass
class EvalPair:
    name0: str
    name1: str
    K0: np.ndarray
    K1: np.ndarray
    T_0to1: np.ndarray      # [4, 4]
    bbox0: np.ndarray | None = None
    bbox1: np.ndarray | None = None


def parse_eval_pairs_line(line: str) -> EvalPair | None:
    """Benchmark pair line.

    Name-only lines (HPatches '<seq>/1.ppm <seq>/i.ppm') get identity
    K/pose so the matching runner can drive homography benchmarks too.
    """
    f = line.split()
    if len(f) == 2:
        return EvalPair(f[0], f[1], np.eye(3), np.eye(3), np.eye(4),
                        None, None)
    if len(f) < 36:          # 2 names + K0(9) + K1(9) + pose(16)
        return None
    K0 = np.array(f[2:11], dtype=float).reshape(3, 3)
    K1 = np.array(f[11:20], dtype=float).reshape(3, 3)
    T = np.array(f[20:36], dtype=float).reshape(4, 4)
    bbox0 = bbox1 = None
    if len(f) >= 44:
        bbox0 = np.array(f[36:40], dtype=float)
        bbox1 = np.array(f[40:44], dtype=float)
    return EvalPair(f[0], f[1], K0, K1, T, bbox0, bbox1)


def load_eval_pairs(path: str) -> list[EvalPair]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            p = parse_eval_pairs_line(line)
            if p is not None:
                out.append(p)
    return out


def names_to_pair(name0: str, name1: str) -> str:
    """h5 group key for a pair (the reference's names_to_pair)."""
    return "_".join((name0.replace("/", "-"), name1.replace("/", "-")))
