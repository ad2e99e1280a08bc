"""Bench stage 5 in bfloat16 with the committed trained weights: the port
against the JAX package on the CPU, on ``test_torch_port_stage5.py``'s
pairs and configuration (that file holds the same pipeline in float32, and
its forced retry).

bench.py runs stage 5 in bf16: OETR, SuperPoint and SuperGlue compute in
bf16 from float32 parameters cast per op (flax's way, and the port's). The
two frameworks round at different places, so the port is held to twice
JAX's own bf16-vs-f32 gap on the same inputs, read here
(``test_torch_port_bf16.py``'s rule): the boxes of the first pass and after
the retry at 30 within 2x JAX's box gap, and pair by pair the matches'
disagreement (1 - the share of matches whose two keypoints correspond
within MATCH_PX) within 2x JAX's own bf16-vs-f32 disagreement.
``used_overlap`` and the pairs retried are equal. SuperPoint refines its
keypoints below the pixel in the compute dtype, so a keypoint of one bf16
run lies ~1e-3-1e-2 px from its twin in another; NMS keeps keypoints 4 px
apart, so MATCH_PX = 0.5 pairs each with its twin and no other. Read when
the bound was set: disagreement 0.280 and 0.158 (port vs JAX in bf16)
against JAX's own 0.310 and 0.192.
"""
import numpy as np
import pytest

from test_torch_port_stage5 import (MIN_MATCHES, PAIRS, jax_pipeline,
                                    match_agreement, pair_result,
                                    port_pipeline, retried, run_jax,
                                    run_port, scene_args)

MATCH_PX = 0.5


@pytest.fixture(scope="module")
def bf16_runs():
    """{(side, dtype): [first pass, after the retry at 30]}."""
    args = scene_args()
    return {("jax", "float32"): run_jax(jax_pipeline("float32"), args,
                                        [MIN_MATCHES])[0],
            ("jax", "bfloat16"): run_jax(jax_pipeline("bfloat16"), args,
                                         [MIN_MATCHES])[0],
            ("port", "bfloat16"): run_port(port_pipeline("bfloat16"), args,
                                           [MIN_MATCHES])}


def _box_gap(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in ("bbox0", "bbox1"))


def test_stage5_bf16_gate_and_retry_equal(bf16_runs):
    (pfirst, got), (jfirst, want) = (bf16_runs["port", "bfloat16"],
                                     bf16_runs["jax", "bfloat16"])
    np.testing.assert_array_equal(pfirst["used_overlap"],
                                  jfirst["used_overlap"])
    np.testing.assert_array_equal(retried(pfirst, MIN_MATCHES),
                                  retried(jfirst, MIN_MATCHES))
    np.testing.assert_array_equal(got["used_overlap"], want["used_overlap"])


def test_stage5_bf16_boxes_within_jax_gap(bf16_runs):
    for stage in (0, 1):            # the first pass, after the retry
        port16, jax16, jax32 = (bf16_runs[k][stage] for k in (
            ("port", "bfloat16"), ("jax", "bfloat16"), ("jax", "float32")))
        gap = _box_gap(jax16, jax32)
        assert _box_gap(port16, jax16) <= 2 * gap, (
            stage, _box_gap(port16, jax16), gap)


def test_stage5_bf16_matches_within_jax_gap(bf16_runs):
    port16, jax16, jax32 = (bf16_runs[k][1] for k in (
        ("port", "bfloat16"), ("jax", "bfloat16"), ("jax", "float32")))
    for i in range(PAIRS):
        p, j16, j32 = (pair_result(o, i) for o in (port16, jax16, jax32))
        assert j16["matches"].shape[1] >= 32     # trained: real matches
        ours = 1 - match_agreement(p, j16, MATCH_PX)
        theirs = 1 - match_agreement(j16, j32, MATCH_PX)
        print(f"pair {i}: port vs JAX in bf16 disagree on {ours:.4f}, "
              f"JAX's bf16 vs f32 on {theirs:.4f}")
        assert ours <= 2 * theirs, (i, ours, theirs)
