"""The port's file-based paths against the JAX package, on the CPU: the
scene writers, the evaluation flows of ``oetr_tpu_torch/scripts/
evaluate.py`` against the JAX shell scripts' code, and the MegaDepth
loader, all on files; then the same paths in a child interpreter that
refuses cv2 and h5py.

Bounds:
  generate_scene / generate_scene_3d   with JAX's renderers handed the
                                       port's (so both render the same
                                       pixels): every JPEG byte for byte,
                                       the pair lines and the depth arrays
                                       equal
  MegaDepthPairsDataset                one batch (geometry and masks)
                                       equal to JAX's
  the flows, on JAX's generators'      run stats equal; the h5 keypoints
  files, the committed trained trees   within 1e-3 px and the matches
  on both sides (SuperPoint k 256,     equal, as sets of positions (two
  SuperGlue d 128, the flagship OETR   keypoints whose scores differ by
  at 160², f32)                        rounding trade slots); AUC and mAA
                                       within 0.5 percentage points (the
                                       port on JAX's Gumbel draws);
                                       precision, matching score and MMA
                                       equal (PERF.md §2)
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import h5py
import jax
import numpy as np
import pytest
import torch

from oetr_tpu.data import megadepth as jmega
from oetr_tpu.data import synthetic as jsyn
from oetr_tpu.evalx import datasets as jdatasets
from oetr_tpu.evalx import hpatches as jhpatches
from oetr_tpu.evalx import imc as jimc
from oetr_tpu.evalx import megadepth as jmegadepth
from oetr_tpu.pipelines.runner import run_benchmark as j_run_benchmark
from oetr_tpu_torch.data import megadepth as pmega
from oetr_tpu_torch.data import synthetic as psyn
from oetr_tpu_torch.scripts import evaluate
from test_torch_port_evalx import jax_draws  # noqa: F401 (fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KPT_PX = 1e-3
AUC_PP = 0.5
HW = 160
K = 256


# ---------------------------------------------------------------- writers --

def _files(base):
    out = {}
    for dirpath, _, names in os.walk(base):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, base)] = p
    return out


GENERATORS = {
    "plain": ("generate_scene", dict(n_pairs=3, image_hw=96,
                                     max_shift_px=24, seed=7)),
    "dolly": ("generate_scene", dict(n_pairs=3, image_hw=96,
                                     max_shift_px=24, seed=7,
                                     scale_range=(2.0, 3.0))),
    "scene3d": ("generate_scene_3d", dict(n_pairs=2, image_hw=128, seed=3,
                                          scale_range=(1.1, 1.5),
                                          rot_deg=10.0, tilt_deg=6.0,
                                          illum_range=(0.85, 1.15))),
}


@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_generators_write_jaxs_files(tmp_path, monkeypatch, case):
    """JAX's writers (cv2.imwrite, cv2.resize, h5py) and the port's (its
    JPEG encoder, ``resize_linear_u8``, its HDF5 writer) on the same
    renders: JAX's ``_texture`` and ``_render_planes`` are handed the
    port's, whose pixels are within one level of cv2's
    (tests/test_torch_port_synthetic.py), so the writers see the same
    pixels and their files must agree exactly."""
    name, kw = GENERATORS[case]
    monkeypatch.setattr(jsyn, "_texture", psyn._texture)
    monkeypatch.setattr(jsyn, "_render_planes", psyn._render_planes)
    pj = getattr(jsyn, name)(str(tmp_path / "j"), **kw)
    pp = getattr(psyn, name)(str(tmp_path / "p"), **kw)
    assert open(pp).read() == open(pj).read()
    fj, fp = _files(tmp_path / "j"), _files(tmp_path / "p")
    assert sorted(fj) == sorted(fp)
    images = [k for k in fj if k.endswith(".jpg")]
    depths = [k for k in fj if k.endswith(".h5")]
    assert len(images) == len(depths) == 2 * kw["n_pairs"]
    for k in images:
        assert open(fp[k], "rb").read() == open(fj[k], "rb").read(), k
    for k in depths:
        with h5py.File(fj[k], "r") as a, h5py.File(fp[k], "r") as b:
            assert list(a.keys()) == list(b.keys()) == ["depth"]
            assert a["depth"].dtype == b["depth"].dtype
            np.testing.assert_array_equal(b["depth"][()], a["depth"][()])


# ----------------------------------------------------------------- loader --

def test_megadepth_loader_batch_matches_jax(tmp_path):
    """One batch of ``MegaDepthPairsDataset`` (images, GT boxes, geometry)
    and its segmentation masks, from JAX's generator's files with PNG
    masks cv2 wrote, resized 96 -> 64 and cropped: equal to JAX's
    (cv2 and h5py there, the port's own readers here)."""
    base = tmp_path / "scene"
    pairs = jsyn.generate_scene_3d(str(base), n_pairs=3, image_hw=96, seed=4,
                                   scale_range=(1.1, 1.4))
    os.makedirs(base / "masks")
    rng = np.random.default_rng(0)
    for name in os.listdir(base / "imgs"):
        cv2.imwrite(str(base / "masks" / name.replace(".jpg", ".png")),
                    rng.integers(0, 3, (96, 96), dtype=np.uint8) * 100)
    kw = dict(image_size=(64, 64), train=False, with_mask=True)
    want_ds = jmega.MegaDepthPairsDataset(str(base), pairs, **kw)
    got_ds = pmega.MegaDepthPairsDataset(str(base), pairs, **kw)
    want = next(want_ds.batches(2, geometry=True))
    got = next(got_ds.batches(2, geometry=True))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(3):
        g, w = got_ds[i], want_ds[i]
        for k in ("seg_mask1", "seg_mask2", "image1", "depth2"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got["overlap_valid"].any()


# ------------------------------------------------------------------ flows --

def _pipelines(guided: bool):
    """(JAX's, the port's) sparse pipeline on the committed trained trees,
    float32, at small widths: SuperPoint k 256 (threshold 0, descriptor
    128), SuperGlue d 128, with the flagship OETR when ``guided``; 128²
    canvases and OETR copies, fallback 30, heatmap boxes. The port's is
    ``build_shipped_model``'s models; both read the trees with the port's
    reader (bit-equal to orbax's restore)."""
    import jax.numpy as jnp

    from oetr_tpu.config import oetr_r50_config
    from oetr_tpu.models import build_oetr
    from oetr_tpu.models.superglue import SuperGlue
    from oetr_tpu.models.superpoint import SuperPoint
    from oetr_tpu.pipelines import PipelineConfig, SparsePipeline
    from oetr_tpu_torch.pipelines import api

    t = {n: api.shipped_tree(n) for n in ("oetr", "superpoint",
                                          "superglue")}
    as_jax = lambda x: jax.tree.map(jnp.asarray, x)
    kw = dict(canvas_hw=(HW, HW), oetr_hw=(HW, HW))
    sp = SuperPoint(max_keypoints=K, keypoint_threshold=0.0,
                    descriptor_dim=128)
    sg = SuperGlue(descriptor_dim=128)
    sg_params = as_jax(t["superglue"])
    jpipe = SparsePipeline(
        sp, {"params": {"net": as_jax(t["superpoint"])["params"]}},
        lambda d: sg.apply(sg_params, d),
        build_oetr(oetr_r50_config()) if guided else None,
        as_jax(t["oetr"]) if guided else None, PipelineConfig(**kw))
    shipped_sp = dict(api.SHIPPED_SP, max_keypoints=K)
    read = api.shipped_tree
    sp_kw = api.SHIPPED_SP
    api.shipped_tree = lambda name, ckpt_root=None: t[name]
    api.SHIPPED_SP = shipped_sp
    try:
        ppipe, _ = api.build_shipped_model(
            "superglue", with_overlap=guided,
            cfg=port_config(**kw), device="cpu")
    finally:
        api.shipped_tree, api.SHIPPED_SP = read, sp_kw
    return jpipe, ppipe


def port_config(**kw):
    from oetr_tpu_torch.pipelines import PipelineConfig

    return PipelineConfig(**kw)


# chip_smoke.py's evaluate phase renders mild viewpoint changes, as here;
# the generator's defaults (rotation 12°, tilt 8°, scale 1-1.8, shift 0.3,
# illumination 0.7-1.3) are the other case.
MILD_VIEWS = dict(scale_range=(1.0, 1.1), rot_deg=3.0, tilt_deg=2.0,
                  trans_frac=0.15)


def _mega_data(tmp_path, views=MILD_VIEWS):
    """JAX's generate_scene_3d (``views`` over its defaults) in a MegaDepth
    layout (data/mega/scene0) and its evaluation pair list."""
    data = tmp_path / "data"
    train = jsyn.generate_scene_3d(str(data / "mega" / "scene0"), n_pairs=3,
                                   image_hw=HW, seed=12, **views)
    from oetr_tpu.data.pairs import load_pairs
    fmt = lambda a: " ".join(str(x) for x in np.asarray(a).reshape(-1))
    pairs = tmp_path / "mega_pairs.txt"
    with open(pairs, "w") as f:
        for r in load_pairs(train):
            T = r.pose2 @ np.linalg.inv(r.pose1)
            f.write(f"mega/scene0/{r.image_path1} mega/scene0/"
                    f"{r.image_path2} {fmt(r.K1)} {fmt(r.K2)} {fmt(T)}\n")
    return data, pairs, train


def _imc_data(tmp_path):
    """The same renders in IMC's layout, calibration by h5py, and JAX's
    pair list from them."""
    data, _, train = _mega_data(tmp_path)
    from oetr_tpu.data.pairs import load_pairs
    imc = data / "phototourism-val" / "scene0" / "set_100"
    for sub in ("images", "calibration", "new-vis-pairs"):
        os.makedirs(imc / sub)
    keys = []
    for r in load_pairs(train):
        names = []
        for img, K, pose in ((r.image_path1, r.K1, r.pose1),
                             (r.image_path2, r.K2, r.pose2)):
            n = os.path.basename(img)[:-4]
            names.append(n)
            shutil.copyfile(data / "mega" / "scene0" / img,
                            imc / "images" / f"{n}.jpg")
            with h5py.File(imc / "calibration" / f"calibration_{n}.h5",
                           "w") as c:
                c.create_dataset("K", data=K)
                c.create_dataset("R", data=pose[:3, :3])
                c.create_dataset("T", data=pose[:3, 3])
        keys.append("-".join(names))
    np.save(imc / "new-vis-pairs" / "keys-th-0.1.npy", np.array(keys))
    scenes = tmp_path / "scenes.txt"
    scenes.write_text("phototourism-val/scene0 jpg\n")
    pairs = tmp_path / "imc_pairs.txt"
    assert jdatasets.generate_imc_pairs(str(scenes), str(data), str(pairs),
                                        0.1) == 3
    from oetr_tpu_torch.evalx import datasets as pdatasets
    pdatasets.generate_imc_pairs(str(scenes), str(data),
                                 str(tmp_path / "imc_port.txt"), 0.1)
    assert (tmp_path / "imc_port.txt").read_text() == pairs.read_text()
    return data, pairs


def _hpatches_data(tmp_path):
    """Two sequences of 1.ppm and 5 warps (JAX's texture, cv2's
    warpPerspective and PPM writer) with their H_1_i."""
    root = tmp_path / "hpatches"
    rng = np.random.default_rng(13)
    for seq in ("i_gen", "v_gen"):
        os.makedirs(root / seq)
        img = jsyn._texture(rng, HW, HW)
        cv2.imwrite(str(root / seq / "1.ppm"), img[..., ::-1])
        for i in range(2, 7):
            H = np.eye(3) + np.array([[rng.uniform(-0.08, 0.08),
                                       rng.uniform(-0.05, 0.05),
                                       rng.uniform(-6, 6)],
                                      [rng.uniform(-0.05, 0.05),
                                       rng.uniform(-0.08, 0.08),
                                       rng.uniform(-6, 6)],
                                      [rng.uniform(-2e-4, 2e-4),
                                       rng.uniform(-2e-4, 2e-4), 0.0]])
            warped = cv2.warpPerspective(img, H, (HW, HW))
            if seq == "i_gen":
                warped = np.clip(warped * (0.7 + 0.1 * i), 0,
                                 255).astype(np.uint8)
            cv2.imwrite(str(root / seq / f"{i}.ppm"), warped[..., ::-1])
            np.savetxt(root / seq / f"H_1_{i}", H)
    return root


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def _rows_same(got, want, what):
    """Two [N, D] arrays of positions equal as sets within KPT_PX (two
    keypoints whose scores differ by rounding trade slots)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    order = lambda a: a[np.lexsort(np.round(a, 2).T[::-1])]
    np.testing.assert_allclose(order(got), order(want), rtol=0,
                               atol=KPT_PX, err_msg=what)


def _same_results(got_dir, want_dir, pairwise):
    """Every scene's h5 files: the same keys; each image's keypoints the
    same positions within KPT_PX, and each pair's matches the same pairs
    of positions."""
    scenes = sorted(d for d in os.listdir(want_dir)
                    if os.path.isdir(os.path.join(want_dir, d)))
    assert scenes and sorted(
        d for d in os.listdir(got_dir)
        if os.path.isdir(os.path.join(got_dir, d))) == scenes
    for scene in scenes:
        kg, kw_ = (_h5(os.path.join(d, scene, "keypoints.h5"))
                   for d in (got_dir, want_dir))
        mg, mw = (_h5(os.path.join(d, scene, "matches.h5"))
                  for d in (got_dir, want_dir))
        assert sorted(kg) == sorted(kw_) and sorted(mg) == sorted(mw)
        for k in kw_:
            _rows_same(kg[k], kw_[k], f"{scene} keypoints {k}")
        for k in mw:
            a, b = k.split("-")
            k0, k1 = ((k, f"{b}-{a}") if pairwise else (a, b))
            matched = lambda kp, m: np.concatenate(
                [kp[k0][m[0]], kp[k1][m[1]]], 1)
            assert mg[k].shape == mw[k].shape, (scene, k)
            _rows_same(matched(kg, mg[k]), matched(kw_, mw[k]),
                       f"{scene} matches {k}")


def _megadepth_vs_jax(tmp_path, capsys, jax_draws, views, label):
    """scripts/evaluate_megadepth.sh's body (JAX's pipeline in-process)
    and the port's flow on the same files (``_mega_data(views)``), each
    held to the other; the matches a pair print (``pytest -s``). Returns
    (JAX's run, JAX's results, the port's flow's output and lines)."""
    data, pairs = _mega_data(tmp_path, views)[:2]
    jpipe, ppipe = _pipelines(guided=True)
    want_run = j_run_benchmark(jpipe, str(pairs), str(data),
                               str(tmp_path / "j"))
    with jax.enable_x64(False):
        want = jmegadepth.benchmark_results(str(pairs), str(tmp_path / "j"),
                                            pairwise=True)
    jax_draws(0)
    capsys.readouterr()
    got = evaluate.megadepth_flow(ppipe, str(pairs), str(data),
                                  str(tmp_path / "p"), device="cpu")
    printed = capsys.readouterr().out
    with capsys.disabled():
        print(f"\nMegaDepth flow, {label} viewpoints, {HW}², k {K}: "
              f"matches a pair JAX {want_run['matches_per_pair']}, the port "
              f"{got['run']['matches_per_pair']}; AUC@5/10/20 {got['aucs']}")
    assert got["run"] == want_run and want_run["matches_per_pair"] > 0
    _same_results(tmp_path / "p", tmp_path / "j", pairwise=True)
    np.testing.assert_allclose(got["aucs"], want[0], rtol=0, atol=AUC_PP)
    assert (got["precision"], got["matching_score"]) == tuple(want[1:])
    return want_run, want, got, printed


def test_megadepth_flow_matches_jax_script(tmp_path, capsys,
                                           jax_draws):  # noqa: F811
    want_run, want, got, printed = _megadepth_vs_jax(
        tmp_path, capsys, jax_draws, MILD_VIEWS, "mild")
    assert want_run["matches_per_pair"] > 20 and max(want[0]) > 0
    assert printed == f"run: {want_run}\n" + jmegadepth.summary_table(
        {evaluate.METHOD: [got["aucs"], *want[1:]]}) + "\n"


def test_megadepth_flow_at_generator_defaults_matches_jax(
        tmp_path, capsys, jax_draws):  # noqa: F811
    """The MegaDepth flow on the generator's default viewpoints, which the
    committed matchers (trained on the planar generator's pairs) find
    hard: JAX's script and the port give the same run and results there
    too, so the few matches a pair are the weights', not the port's."""
    _megadepth_vs_jax(tmp_path, capsys, jax_draws, {}, "the generator's "
                      "default")


def test_imc_flow_matches_jax_script(tmp_path, capsys,
                                     jax_draws):  # noqa: F811
    data, pairs = _imc_data(tmp_path)
    jpipe, ppipe = _pipelines(guided=True)
    method = evaluate.METHOD
    want_run = j_run_benchmark(jpipe, str(pairs), str(data),
                               str(tmp_path / "j"))
    with jax.enable_x64(False):
        want = jimc.benchmark_results(
            str(pairs), str(tmp_path / "j"), pairwise=True,
            dynamic_threshold=jimc.dynamic_threshold_for(method))
    jax_draws(0)
    capsys.readouterr()
    got = evaluate.imc_flow(ppipe, str(pairs), str(data),
                            str(tmp_path / "p"), device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert got["run"] == want_run and want_run["matches_per_pair"] > 20
    _same_results(tmp_path / "p", tmp_path / "j", pairwise=True)
    assert list(got["rows"]) == list(want[0])
    for d, a, p, m, v in zip(*want):
        row = got["rows"][d]
        np.testing.assert_allclose(row["aucs"], a, rtol=0, atol=AUC_PP)
        np.testing.assert_allclose(row["mAA@10"], v, rtol=0, atol=AUC_PP)
        assert (row["precision"], row["matching_score"]) == (p, m)
    assert printed[0] == f"run: {want_run}" and len(printed) == 1 + len(
        want[0])


def test_hpatches_flow_matches_jax_script(tmp_path, capsys):
    root = _hpatches_data(tmp_path)
    jpipe, ppipe = _pipelines(guided=False)
    # scripts/evaluate_hpatches.sh's body.
    os.makedirs(tmp_path / "j")
    pairs_txt = f"{tmp_path / 'j'}/hpatches_pairs.txt"
    n = jdatasets.generate_hpatches_pairs(str(root), pairs_txt)
    want_run = j_run_benchmark(jpipe, pairs_txt, str(root),
                               str(tmp_path / "j"), with_overlap=False,
                               pairwise=False)
    want = jhpatches.benchmark_results(list(jdatasets.iter_hpatches_results(
        pairs_txt, str(root), str(tmp_path / "j"))))
    capsys.readouterr()
    got = evaluate.hpatches_flow(ppipe, str(root), str(tmp_path / "p"))
    printed = capsys.readouterr().out.splitlines()
    assert got["pairs"] == n == 10
    assert got["run"] == want_run and want_run["matches_per_pair"] > 20
    _same_results(tmp_path / "p", tmp_path / "j", pairwise=False)
    assert got["table"] == want
    assert printed == [f"pairs: {n}", f"run: {want_run}"] + [
        f"{k}: {v}" for k, v in want.items()]


def test_evaluate_command_line_checks_its_arguments(capsys):
    for argv in (["megadepth", "a", "b"], ["hpatches", "a", "b", "c"],
                 ["imc", "a", "b", "c", "d", "e"], ["other", "a"]):
        with pytest.raises(SystemExit):
            evaluate.main(argv + ["--device", "cpu"])
    assert "positional arguments" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA card present")
        evaluate.main(["hpatches", "a", "b"])


# ------------------------------------------------- without cv2 and h5py --

CHILD = r'''
import contextlib, importlib, io, json, os, sys

BLOCKED = ("cv2", "h5py", "jax", "jaxlib", "flax", "oetr_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch

import chip_smoke
import oetr_tpu_torch as port
from oetr_tpu_torch.data.megadepth import MegaDepthPairsDataset
from oetr_tpu_torch.evalx.datasets import generate_imc_pairs
from oetr_tpu_torch.scripts import evaluate

torch.set_num_threads(2)
root = sys.argv[1]
w = chip_smoke.write_eval_data(root, n_pairs=2, hw=128)
n = generate_imc_pairs(w["imc_scenes"], root, os.path.join(root, "imc.txt"),
                       chip_smoke.EVAL_OVERLAP)
assert n == 2, n
cfg = port.OETRConfig(
    backbone=port.BackboneConfig(depth=18, last_layer=256, fused_stem=True),
    neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                         num_decoder_layers=1, attention="linear:cuda"))
oetr = port.build_oetr(cfg, device="cpu")
sp = port.build_superpoint(device="cpu", max_keypoints=128,
                           keypoint_threshold=1e-4)
sg = port.build_superglue(device="cpu", gnn_layers=2, match_threshold=0.0)
pcfg = port.PipelineConfig(canvas_hw=(128, 128), oetr_hw=(128, 128),
                           fallback_min_matches=0)
guided = port.SparsePipeline(sp, sg, oetr=oetr, cfg=pcfg)
plain = port.SparsePipeline(sp, sg, cfg=pcfg)
res = os.path.join(root, "results")
with contextlib.redirect_stdout(io.StringIO()):
    out = {
        "megadepth": evaluate.megadepth_flow(
            guided, w["mega_pairs"], root, os.path.join(res, "m"),
            device="cpu")["run"],
        "imc": evaluate.imc_flow(guided, os.path.join(root, "imc.txt"),
                                 root, os.path.join(res, "i"),
                                 device="cpu")["run"],
        "hpatches": evaluate.hpatches_flow(plain, w["hpatches"],
                                           os.path.join(res, "h"))["run"]}
ds = MegaDepthPairsDataset(os.path.join(root, "mega", "scene0"),
                           w["train_pairs"], image_size=(96, 96),
                           train=False)
batch = next(ds.batches(2, geometry=True))
assert batch["image1"].shape == (2, 96, 96, 3)
assert np.isfinite(batch["overlap_box1"]).all()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print(json.dumps(out))
'''


def test_file_paths_run_with_cv2_and_h5py_refused(tmp_path):
    """A child that refuses cv2, h5py and JAX writes the three trees with
    the port's writers (``chip_smoke.write_eval_data``: the scene
    generator's JPEGs and depth h5, IMC's calibration h5, HPatches' PPMs),
    runs the three flows on them (read back by the port's decoders, h5
    results written and read by its HDF5 subset) and one loader batch,
    and imports neither module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {k: v["num_pairs"] for k, v in runs.items()} == {
        "megadepth": 2, "imc": 2, "hpatches": 5}
    assert all(v["matches_per_pair"] > 0 for v in runs.values()), runs
