"""Bench stage 5 with the committed trained weights: the port against the
JAX package on the CPU, in float32 (this file) and in bfloat16
(``test_torch_port_stage5_bf16.py``).

Stage 5 (``bench.py:298-400``) is the production pattern: the flagship OETR
from ``.ckpt_oetr_r5/params`` with heatmap boxes, SuperPoint (k 2048,
descriptor 128, threshold 0) and SuperGlue (descriptor 128) from
``.ckpt_matching_r5``, ``fallback_min_matches=30``, on pairs of JAX's
``make_device_generator`` with ``scale_range=(1.0, 1.6)`` and
``p_translate=0.5``. Here at ``canvas_hw = oetr_hw = 256`` (the OETR copies
are the images, scales 1) on 2 pairs of key 19: the trained OETR trims the
first pair's boxes and keeps the second's whole frame. Both sides take the
same trees, read by the port's reader (bit-equal to orbax's restore,
``test_torch_port_ocdbt.py``); the port's float32 pipeline is
``build_shipped_model("superglue", with_overlap=True)``, the same models.

float32, at the f32 parity row's bounds (PERF.md §2): boxes 5e-3 px, the
valid keypoints one to one within 1e-3 px, equal match sets, confidences
``CONF_TOL["superglue"]``; ``used_overlap`` and the pairs retried equal.
Then the retry forced with the trained weights: ``fallback_min_matches``
one above the most matches a pair reached, so that every pair that took
its crops is re-run on the full images, at the same bounds after the
retry. Each side runs its first pass once and applies its own retry rule
(``_bucketed_retry``) to it at both thresholds, as its ``__call__`` does.
SuperGlue over 2048 slots dominates the time (~15 s a pass on each side).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import oetr_tpu_torch as port
from oetr_tpu_torch.pipelines.api import shipped_tree
from test_torch_port_api import (assert_same_keypoints, assert_same_matches,
                                 match_rows)
from test_torch_port_shipped import CONF_TOL

torch.set_num_threads(2)

HW, PAIRS, KEY = 256, 2, 19
MIN_MATCHES = 30
CFG = dict(canvas_hw=(HW, HW), oetr_hw=(HW, HW),
           fallback_min_matches=MIN_MATCHES, box_source="heatmap")
BOX_TOL_PX = 5e-3


def scene_args():
    """Stage 5's pipeline arguments for PAIRS pairs of JAX's generator
    (drawn with x64 off, as the package draws outside the tests)."""
    from oetr_tpu.data.device_synth import make_device_generator

    with jax.enable_x64(False):
        raw = make_device_generator(HW, PAIRS, scale_range=(1.0, 1.6),
                                    p_translate=0.5)(jax.random.key(KEY))
        im0 = np.asarray(raw["image1"], np.float32)
        im1 = np.asarray(raw["image2"], np.float32)
    hw = np.full((PAIRS, 2), HW, np.int32)
    sc = np.ones((PAIRS, 2), np.float32)
    return (im0, im1, hw, hw, im0, im1, sc, sc)


@functools.cache
def trees():
    return {n: shipped_tree(n) for n in ("oetr", "superpoint", "superglue")}


def jax_pipeline(dtype: str):
    """bench.py's stage-5 pipeline in ``dtype`` on the committed trees."""
    from oetr_tpu.config import oetr_r50_config, replace
    from oetr_tpu.models import build_oetr
    from oetr_tpu.models.superglue import SuperGlue
    from oetr_tpu.models.superpoint import SuperPoint
    from oetr_tpu.pipelines import PipelineConfig, SparsePipeline

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    as_jax = lambda t: jax.tree.map(jnp.asarray, t)
    t = trees()
    sp = SuperPoint(max_keypoints=2048, keypoint_threshold=0.0,
                    descriptor_dim=128, dtype=jdt)
    sg = SuperGlue(descriptor_dim=128, dtype=jdt)
    sg_params = as_jax(t["superglue"])
    return SparsePipeline(sp, {"params": {"net": as_jax(
        t["superpoint"])["params"]}}, lambda d: sg.apply(sg_params, d),
                          build_oetr(replace(oetr_r50_config(), dtype=dtype)),
                          as_jax(t["oetr"]), PipelineConfig(**CFG))


def port_pipeline(dtype: str):
    """The port's stage-5 pipeline in ``dtype`` on the CPU: float32 through
    ``build_shipped_model``, bfloat16 from ``chip_smoke.stage5_models`` (no
    package entry point takes a dtype, as in JAX)."""
    cfg = port.PipelineConfig(**CFG)
    if dtype == "float32":
        return port.build_shipped_model("superglue", with_overlap=True,
                                        cfg=cfg, device="cpu")[0]
    oetr, sp, sg = chip_smoke.stage5_models(torch, port, trees(), dtype,
                                            device="cpu")
    return port.SparsePipeline(sp, sg, oetr, cfg)


def _numpy(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items() if v is not None}


def forced_threshold(first):
    """One above the most matches a pair reached in a first pass: every
    pair that took its crops is retried."""
    return int(first["num_matches"].max()) + 1


def run_jax(pipe, args, thresholds):
    """JAX's first pass, then its retry at each of ``thresholds`` (None:
    ``forced_threshold`` of this first pass). Returns (the outputs, the
    thresholds)."""
    from oetr_tpu.pipelines.matching import _bucketed_retry

    a = [jnp.asarray(x) for x in args]
    first = pipe._jit_overlap(*a)
    ms = [forced_threshold(_numpy(first)) if m is None else m
          for m in thresholds]
    return [_numpy(first)] + [_numpy(_bucketed_retry(
        pipe._jit_plain, first, *a[:4], m, pipe.cfg.retry_batch))
        for m in ms], ms


def run_port(pipe, args, thresholds):
    """The port's first pass, then its retry at each of ``thresholds``."""
    from oetr_tpu_torch.pipelines.matching import _bucketed_retry

    a = [torch.tensor(x) for x in args]
    with torch.no_grad():
        first = pipe._run(*a, use_overlap=True)
        return [_numpy(first)] + [_numpy(_bucketed_retry(
            pipe._run, first, *a[:4], m, pipe.cfg.retry_batch))
            for m in thresholds]


def pair_result(out, i):
    """Pair i of a pipeline output as ``get_matches`` returns it (canvas
    frame)."""
    m0, v0 = out["matches0"][i], out["valid0"][i]
    sel = (m0 > -1) & v0
    return {"kpts0": out["keypoints0"][i], "kpts1": out["keypoints1"][i],
            "all_valid0": v0, "all_valid1": out["valid1"][i],
            "matches": np.stack([np.nonzero(sel)[0], m0[sel]]),
            "confidence": out["matching_scores0"][i][sel]}


def retried(first, threshold):
    """The pairs a retry at ``threshold`` re-runs."""
    return (first["num_matches"] < threshold) & first["used_overlap"]


def match_agreement(a, b, px=1e-3):
    """Share of the matches (x0, y0, x1, y1) of pair results ``a`` and ``b``
    that correspond within ``px``, of the larger set."""
    (pa, _), (pb, _) = match_rows(a), match_rows(b)
    if not (len(pa) and len(pb)):
        return float(len(pa) == len(pb))
    near = np.abs(pa[:, None, :] - pb[None, :, :]).max(-1) <= px
    return float(near.any(1).sum()) / max(len(pa), len(pb))


def assert_f32_equal(got, want):
    np.testing.assert_array_equal(got["used_overlap"], want["used_overlap"])
    for key in ("bbox0", "bbox1"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=BOX_TOL_PX)
    for i in range(PAIRS):
        g, w = pair_result(got, i), pair_result(want, i)
        assert_same_keypoints(g, w)
        assert_same_matches(g, w, conf_tol=CONF_TOL["superglue"])


@pytest.fixture(scope="module")
def f32_runs():
    """(JAX's outputs, the port's: first pass, retry at 30, forced retry;
    the thresholds)."""
    args = scene_args()
    want, thresholds = run_jax(jax_pipeline("float32"), args,
                               [MIN_MATCHES, None])
    return want, run_port(port_pipeline("float32"), args, thresholds), \
        thresholds


def test_stage5_f32_matches_jax(f32_runs):
    (wfirst, want, _), (gfirst, got, _), _ = f32_runs
    # The trained OETR trims the first pair's boxes: the crops do work.
    assert (np.abs(wfirst["bbox0"][0] - [0, 0, HW, HW]) > 8).any()
    assert_f32_equal(gfirst, wfirst)
    np.testing.assert_array_equal(retried(gfirst, MIN_MATCHES),
                                  retried(wfirst, MIN_MATCHES))
    assert_f32_equal(got, want)
    assert (want["num_matches"] >= 32).all()       # trained: real matches


def test_stage5_forced_retry_matches_jax(f32_runs):
    (wfirst, _, want), (gfirst, _, got), (_, forced) = f32_runs
    need = retried(wfirst, forced)
    assert need.all(), need              # every pair took its crops
    np.testing.assert_array_equal(retried(gfirst, forced), need)
    assert not want["used_overlap"].any()
    assert_f32_equal(got, want)
    np.testing.assert_array_equal(want["bbox0"],
                                  np.tile([0, 0, HW, HW], (PAIRS, 1)))
