"""The SfM demo's learned matchers on the port: ``python -m
oetr_tpu_torch.sfm.demo --matcher sp_sg`` (SuperPoint + SuperGlue from
``--ckpt_dir``) and ``--matcher loftr`` (``.ckpt_loftr_r5/loftr``), their
trained weights read by the port's own reader, at a small rig (4 views of
160², ``--device cpu``), against ``scripts/sfm_demo.py``.

The candidates each edge hands the two-view step are JAX's, as matched
point pairs within 1e-3 px: the script's detection and matching (its
SuperPoint, SuperGlue and LoFTR restored through orbax, its cell
quantization for LoFTR) run here on the images the port rendered. The
JSON line has the script's keys in its order and its flags' values. The
rest of the line follows the two-view step's RANSAC, whose draws come
from another generator on each side, so it is held to what
``tests/test_torch_port_sfm.py``'s demo test holds: the exports are
written and the numbers are finite.
"""
import json
import math
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from oetr_tpu_torch.sfm import demo as pdemo

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "sfm_demo.py"
ARGS = ["--n_views", "4", "--hw", "160", "--device", "cpu"]


def _script_keys():
    """The keys of the script's JSON line, in order."""
    block = SCRIPT.read_text().split("print(json.dumps({")[1].split("}))")[0]
    return re.findall(r'"(\w+)":', block)


def _jax_candidates(matcher: str, images: np.ndarray, edges, topk=1024):
    """scripts/sfm_demo.py's detection and matching on ``images``: {edge:
    (ia, ib, p0, p1)} before its 16-candidate cut."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    ck = ocp.StandardCheckpointer()
    n, hw = len(images), images.shape[1]
    gray = jnp.asarray(images, jnp.float32).mean(-1, keepdims=True) / 255
    out = {}
    if matcher == "loftr":
        from oetr_tpu.models.loftr import LoFTR
        hc = hw // 8
        lf = LoFTR(d_coarse=192, d_fine=96, coarse_layers=4,
                   max_matches=1024)
        z = jnp.zeros((1, hw, hw, 1))
        params = ck.restore(str(ROOT / ".ckpt_loftr_r5" / "loftr"),
                            jax.jit(lf.init)(jax.random.key(0), z, z))
        fwd = jax.jit(lambda a, b: lf.apply(params, a, b))
        u = np.arange(hc, dtype=np.float32) * 8 + 3.5
        gy, gx = np.meshgrid(u, u, indexing="ij")
        grid = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        for i, j in edges:
            o = fwd(gray[i:i + 1], gray[j:j + 1])
            v = np.asarray(o["valid"][0])
            ia = np.asarray(o["cells0"][0])[v]
            xy1 = np.asarray(o["mkpts1"][0])[v]
            conf = np.asarray(o["conf"][0])[v]
            cb = np.clip(np.round((xy1 - 3.5) / 8.0), 0,
                         hc - 1).astype(np.int64)
            ib = cb[:, 1] * hc + cb[:, 0]
            keep, seen = [], set()
            for idx in np.argsort(-conf):
                if int(ib[idx]) not in seen:
                    seen.add(int(ib[idx]))
                    keep.append(idx)
            keep = np.asarray(sorted(keep), np.int64)
            out[(i, j)] = (ia[keep], ib[keep], grid[ia[keep]], xy1[keep])
        return out
    from oetr_tpu.models.superglue import SuperGlue
    from oetr_tpu.models.superpoint import SuperPoint, SuperPointNet
    ckpt = ROOT / ".ckpt_matching_r5"
    net = SuperPointNet(descriptor_dim=128)
    raw = ck.restore(str(ckpt / "superpoint"), jax.jit(net.init)(
        jax.random.key(0), jnp.zeros((1, 128, 128, 1))))
    sp = SuperPoint(max_keypoints=topk, keypoint_threshold=0.0,
                    descriptor_dim=128)
    e = jax.jit(sp.apply)({"params": {"net": raw["params"]}}, gray)
    sg = SuperGlue(descriptor_dim=128)
    k = topk
    dummy = {"keypoints0": jnp.zeros((1, k, 2)),
             "keypoints1": jnp.zeros((1, k, 2)),
             "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
             "descriptors0": jnp.zeros((1, k, 128)),
             "descriptors1": jnp.zeros((1, k, 128)),
             "valid0": jnp.ones((1, k), bool),
             "valid1": jnp.ones((1, k), bool)}
    hw_t = (hw, hw)
    sgp = ck.restore(str(ckpt / "superglue"), jax.jit(
        lambda kk, dd: sg.init(kk, dict(dd, image_hw0=hw_t,
                                        image_hw1=hw_t)))(
            jax.random.key(1), dummy))
    match = jax.jit(lambda dd: sg.apply(sgp, dict(dd, image_hw0=hw_t,
                                                  image_hw1=hw_t)))
    kps = [np.asarray(e["keypoints"][i]) for i in range(n)]
    valid = np.asarray(e["valid"])
    for i, j in edges:
        m = match({f"{name}{s}": e[name][v:v + 1]
                   for name in ("keypoints", "scores", "descriptors",
                                "valid") for s, v in (("0", i), ("1", j))})
        m0 = np.asarray(m["matches0"][0])
        sel = (m0 > -1) & valid[i]
        ia, ib = np.nonzero(sel)[0], m0[sel]
        out[(i, j)] = (ia, ib, kps[i][ia], kps[j][ib])
    return out


@pytest.mark.parametrize("matcher", ["sp_sg", "loftr"])
def test_demo_learned_matcher_matches_jax_script(matcher, tmp_path, capsys,
                                                  monkeypatch):
    seen = {}
    candidates = getattr(pdemo, f"candidates_{matcher}")

    def record(images, edges, *modules):
        seen["images"], seen["edges"] = images, edges
        seen["out"] = candidates(images, edges, *modules)
        return seen["out"]

    monkeypatch.setattr(pdemo, f"candidates_{matcher}", record)
    monkeypatch.chdir(ROOT)          # the script's stores are relative
    pdemo.main(["--matcher", matcher, *ARGS, "--export", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _script_keys()
    assert (line["metric"], line["n_views"], line["hw"], line["matcher"]) \
        == ("sfm_ate", 4, 160, matcher)
    assert line["colmap_export_ok"] and line["edges_matched"] >= 3
    assert line["tracks_valid"] > 0
    assert all(math.isfinite(v) for v in line.values()
               if isinstance(v, float))
    assert os.path.exists(tmp_path / "database.db")

    want = _jax_candidates(matcher, seen["images"], seen["edges"])
    _, got = seen["out"]
    assert set(got) == set(want)
    n = 0
    for edge, (_, _, p0, p1) in got.items():
        # by position: two SuperPoint keypoints whose scores differ by
        # rounding trade slots (test_torch_port_api.py's rule)
        g = np.concatenate([p0, p1], 1)
        w = np.concatenate(want[edge][2:], 1)
        assert len(g) == len(w), edge
        near = np.abs(w[:, None] - g[None]).max(-1) <= 1e-3
        assert (near.sum(0) == 1).all() and (near.sum(1) == 1).all(), edge
        n += len(g)
    assert n >= 100
