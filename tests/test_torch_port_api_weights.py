"""The public matching API on the costlier models against the JAX
package, on the CPU: ``build_model`` + ``get_matches`` for SuperPoint,
SuperGlue (9 layers over the registry's 2048 keypoint slots) and the
flagship OETR overlaper, and the trained ``.ckpt_loftr_r5`` through
``get_matches`` on JAX's shifted-texture pair. The helpers are
``test_torch_port_api.py``'s.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

import oetr_tpu_torch as port
from oetr_tpu.pipelines import api as j_api
from oetr_tpu.pipelines import PipelineConfig as JaxPipelineConfig
from oetr_tpu_torch import interop
from oetr_tpu_torch.pipelines import api
from test_torch_port_api import (_models, _texture_files,
                                 assert_same_keypoints, assert_same_matches)

torch.set_num_threads(2)


def test_superpoint_superglue_oetr_get_matches_matches_jax(tmp_path):
    """The README's quick-start combination at a 128² canvas and OETR
    pass, both sides' overlap boxes from the same seeded OETR (its random
    boxes crop unrelated regions, and with the retry off (threshold 0)
    the seeded SuperGlue keeps few matches over 0.2): valid keypoints
    within 1e-3 px, the match sets and confidences equal."""
    paths = _texture_files(tmp_path, seed=3)
    jmodel, pmodel = _models("superpoint_aachen", "superglue_outdoor",
                             "oetr", fallback_min_matches=0)
    want = j_api.get_matches(jmodel, *paths)
    got = api.get_matches(pmodel, *paths)
    assert set(got) == set(want)
    assert want["all_valid0"].sum() > 100
    assert_same_keypoints(got, want)
    assert_same_matches(got, want)


def test_trained_loftr_get_matches_matches_jax(tmp_path):
    """.ckpt_loftr_r5 through get_matches on JAX's shifted-texture pair
    (its shipped-model test): JAX's match set, and the +8 px shift."""
    import orbax.checkpoint as ocp

    from oetr_tpu.data.synthetic import _texture
    from oetr_tpu.models.loftr import LoFTR as JaxLoFTR
    from oetr_tpu.pipelines import DensePipeline as JaxDensePipeline

    root = os.path.join(os.path.dirname(__file__), "..")
    kw = dict(d_coarse=192, d_fine=96, coarse_layers=4, max_matches=1024)
    jm = JaxLoFTR(**kw)
    z = jnp.zeros((1, 256, 256, 1), jnp.float32)
    params = ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(root, ".ckpt_loftr_r5", "loftr")),
        jax.jit(jm.init)(jax.random.key(0), z, z))
    g = _texture(np.random.default_rng(11), 256, 256)
    p0, p1 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    cv2.imwrite(p0, g[..., ::-1])
    cv2.imwrite(p1, np.roll(g, 8, axis=1)[..., ::-1])

    pc = dict(canvas_hw=(256, 256), oetr_hw=(256, 256))
    jcfg = JaxPipelineConfig(**pc)
    jmodel = (JaxDensePipeline(jm, params, cfg=jcfg),
              {"matcher": "loftr", "config": jcfg})
    pm = port.build_loftr(device="cpu", **kw)
    pm.load_state_dict(interop.convert_loftr_params(
        jax.tree.map(np.asarray, params), **kw))
    pcfg = port.PipelineConfig(**pc)
    pmodel = (port.DensePipeline(pm, cfg=pcfg),
              {"matcher": "loftr", "config": pcfg})
    want = j_api.get_matches(jmodel, p0, p1, with_overlap=False)
    got = api.get_matches(pmodel, p0, p1, with_overlap=False)
    assert want["matches"].shape[1] >= 100
    assert_same_matches(got, want)
    m = got["matches"]
    d = got["kpts1"][m[1]] - got["kpts0"][m[0]]
    assert abs(float(np.median(d[:, 0])) - 8.0) < 1.5
    assert abs(float(np.median(d[:, 1]))) < 1.5


