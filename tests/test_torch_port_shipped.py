"""``build_shipped_model``: the port's pipelines of the committed trained
checkpoints, read by the port's own reader (``interop/orbax_read.py``),
against JAX's ``build_shipped_model`` (orbax), on the CPU.

At ``PipelineConfig(canvas_hw=(256, 256), oetr_hw=(256, 256))``, for
``superglue`` and ``loftr``, each with and without the overlap gate: the
same batch of one texture pair (two offset views of one
``oetr_tpu.data.synthetic._texture``) through both pipelines
(``check_shipped_pipeline``; with the overlap gate in
``_shipped_overlap.py`` and LoFTR in ``_shipped_loftr.py``, each file
~60-90 s). Bounds (PERF.md's API parity row):

  keypoints      valid ones correspond one to one within 1e-3 px
  matches        equal sets (points within 1e-3 px), confidences 3e-5
                 (LoFTR) and 2e-4 (SuperGlue): ``CONF_TOL`` says why
  boxes          the overlap boxes within 5e-3 px

and JAX's shifted-texture gate through the port's LoFTR
(``tests/test_shipped_api.py``: >= 100 matches, median shift 8 +- 1.5 px),
and the errors JAX raises for a missing store and another matcher.
"""
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.data import images as j_images
from oetr_tpu.data.synthetic import _texture
from oetr_tpu.pipelines import PipelineConfig as JaxPipelineConfig
from oetr_tpu.pipelines import api as j_api
from oetr_tpu_torch.pipelines import api
from oetr_tpu_torch.pipelines.runner import run_batch
from test_torch_port_api import assert_same_keypoints, assert_same_matches

torch.set_num_threads(2)

PC = dict(canvas_hw=(256, 256), oetr_hw=(256, 256))


def _pair(seed: int = 6):
    """Two 256² views of one 384² texture, offset 128 px down and right:
    they share a quarter of the frame (on this texture the trained OETR
    trims both boxes; on flat textures it mostly keeps the whole frame)."""
    g = _texture(np.random.default_rng(seed), 384, 384).astype(
        np.float32) / 255
    return g[:256, :256], g[128:, 128:]


def _batch(images, cfg):
    """One pair prepared by JAX's image service: the numpy batch both
    pipelines take."""
    p = [j_images.prepare_image(im, cfg.canvas_hw, cfg.oetr_hw, 1024)
         for im in images]
    return j_images.batch_pairs([p[0]], [p[1]])


def _result(out: dict, batch: dict) -> dict:
    """A pipeline output (numpy) as ``get_matches`` returns it, plus the
    boxes."""
    s0, s1 = batch["scale_to_orig0"][0], batch["scale_to_orig1"][0]
    res = {"bbox0": out["bbox0"][0], "bbox1": out["bbox1"][0]}
    if "mkpts0" in out:
        v = out["valid"][0]
        k0, k1 = out["mkpts0"][0][v] * s0, out["mkpts1"][0][v] * s1
        return dict(res, kpts0=k0, kpts1=k1, confidence=out["conf"][0][v],
                    matches=np.stack([np.arange(len(k0))] * 2))
    m0, v0 = out["matches0"][0], out["valid0"][0]
    sel = (m0 > -1) & v0
    return dict(res, kpts0=out["keypoints0"][0] * s0,
                kpts1=out["keypoints1"][0] * s1,
                matches=np.stack([np.nonzero(sel)[0], m0[sel]]),
                confidence=out["matching_scores0"][0][sel],
                all_valid0=v0, all_valid1=out["valid1"][0])


def _run_jax(model, batch, with_overlap):
    import jax.numpy as jnp

    out = model[0](*(jnp.asarray(batch[k]) for k in (
        "image0", "image1", "full_hw0", "full_hw1", "oetr_img0",
        "oetr_img1", "scales0", "scales1")), with_overlap=with_overlap)
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _run_port(model, batch, with_overlap):
    with torch.no_grad():
        out = run_batch(model[0], batch, with_overlap)
    return {k: v.cpu().numpy() for k, v in out.items()
            if isinstance(v, torch.Tensor)}


# Trained SuperGlue over 2048 slots: its scores reach |94| and the two
# frameworks' float32 GNNs (different matmul blockings) differ by ~2e-5 of
# that, 1.7e-3; the confidences then differ by up to 6.3e-5 on the CPU,
# against 7.6e-6 between two of JAX's own runs on the same keypoints in
# another slot order. Trained LoFTR behind the gate (resampled crops):
# 1.05e-5. Seeded weights keep within 1e-5.
CONF_TOL = {"superglue": 2e-4, "loftr": 3e-5}


def check_shipped_pipeline(matcher: str, with_overlap: bool):
    """JAX's and the port's ``build_shipped_model(matcher, with_overlap)``
    on one texture pair: boxes, keypoints, matches and confidences."""
    jmodel = j_api.build_shipped_model(matcher, with_overlap,
                                       cfg=JaxPipelineConfig(**PC))
    pmodel = port.build_shipped_model(matcher, with_overlap,
                                      cfg=port.PipelineConfig(**PC),
                                      device="cpu")
    for key in ("matcher", "extractor", "overlaper"):
        assert pmodel[1][key] == jmodel[1][key]
    batch = _batch(_pair(), jmodel[1]["config"])
    want = _result(_run_jax(jmodel, batch, with_overlap), batch)
    got = _result(_run_port(pmodel, batch, with_overlap), batch)
    np.testing.assert_allclose(got["bbox0"], want["bbox0"], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(got["bbox1"], want["bbox1"], rtol=0,
                               atol=5e-3)
    if with_overlap:       # the trained gate trims the frames
        assert (np.abs(np.stack([want["bbox0"], want["bbox1"]])
                       - [0, 0, 256, 256]) > 8).any()
    assert want["matches"].shape[1] >= 32     # trained: real matches
    assert_same_keypoints(got, want)
    assert_same_matches(got, want, conf_tol=CONF_TOL[matcher])


def test_shipped_superglue_matches_jax():
    check_shipped_pipeline("superglue", False)


def test_shipped_loftr_recovers_shift(tmp_path):
    """JAX's shifted-texture gate (tests/test_shipped_api.py) through the
    port's ``get_matches``: the pair rolled 8 px to the right."""
    import cv2

    model = port.build_shipped_model("loftr", cfg=port.PipelineConfig(**PC),
                                     device="cpu")
    g = _texture(np.random.default_rng(11), 256, 256)
    p0, p1 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    cv2.imwrite(p0, g[..., ::-1])
    cv2.imwrite(p1, np.roll(g, 8, axis=1)[..., ::-1])
    out = api.get_matches(model, p0, p1, with_overlap=False)
    m = out["matches"]
    assert m.shape[1] >= 100, m.shape
    d = out["kpts1"][m[1]] - out["kpts0"][m[0]]
    assert abs(float(np.median(d[:, 0])) - 8.0) < 1.5
    assert abs(float(np.median(d[:, 1]))) < 1.5


def test_shipped_errors_match_jax(tmp_path):
    """A missing store raises FileNotFoundError with JAX's message, another
    matcher ValueError, a CUDA device without a card RuntimeError."""
    with pytest.raises(FileNotFoundError) as jerr:
        j_api.build_shipped_model(ckpt_root=str(tmp_path),
                                  cfg=JaxPipelineConfig(**PC))
    # (JAX builds each store's template before it looks for the store: for
    # LoFTR and OETR its message is the same with their paths.)
    for kw, rel in (({}, ".ckpt_matching_r5/superpoint"),
                    ({"matcher": "loftr"}, ".ckpt_loftr_r5/loftr"),
                    ({"with_overlap": True}, ".ckpt_oetr_r5/params")):
        with pytest.raises(FileNotFoundError) as perr:
            port.build_shipped_model(ckpt_root=str(tmp_path),
                                     cfg=port.PipelineConfig(**PC),
                                     device="cpu", **kw)
        assert str(perr.value) == str(jerr.value).replace(
            ".ckpt_matching_r5/superpoint", rel)
    with pytest.raises(ValueError) as jerr:
        j_api.build_shipped_model("NN")
    with pytest.raises(ValueError) as perr:
        port.build_shipped_model("NN", device="cpu")
    assert str(perr.value) == str(jerr.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            port.build_shipped_model(device="cuda")
