"""The port imports nothing of JAX or of the JAX package.

The port must start where only torch is installed: the machine with the
CUDA card lacks flax and orbax, which the JAX package's models and
checkpoints need, and h5py, cv2, tensorstore, zstandard, zarr and
numcodecs. A child interpreter refuses jax, jaxlib, flax, optax, orbax,
oetr_tpu, h5py, cv2, matplotlib and those four readers, then
imports every module of the port (the geometry, the evaluation package,
the h5 utilities, the pair lists, the trainer, the MegaDepth dataset, the
extractors, matchers and registry, the image service, the public API, the
runner, the demo, the plots, SfM and its demo, the scene generator and the
pair-list generation, the matching trainers and the FCOS head, the
reference-checkpoint converter, the profiling utilities, the parallel
layer, the entry points and the demo programs among them)
and ``chip_smoke``, runs a small forward on the CPU and ``get_matches``'s
helper below the decode, renders a scene with the generator's renderers,
bundle-adjusts a small problem, takes a SuperPoint train step, and finds
that the trainers' cv2 batch functions and the demo programs raise
ImportError (the demos name cv2). Another child reads the committed
checkpoints with the port's own reader and builds the shipped pipelines.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "oetr_tpu_torch"

CHILD = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "oetr_tpu", "h5py",
           "cv2", "matplotlib", "tensorstore", "zstandard", "zarr",
           "numcodecs")
MUST_LIST = ("oetr_tpu_torch.geometry.ransac",
             "oetr_tpu_torch.geometry.fivepoint",
             "oetr_tpu_torch.geometry.homography",
             "oetr_tpu_torch.geometry.epipolar",
             "oetr_tpu_torch.ops.small_eigh",
             "oetr_tpu_torch.evalx.twoview", "oetr_tpu_torch.evalx.imc_math",
             "oetr_tpu_torch.evalx.megadepth", "oetr_tpu_torch.evalx.imc",
             "oetr_tpu_torch.evalx.hpatches", "oetr_tpu_torch.evalx.datasets",
             "oetr_tpu_torch.evalx.metrics", "oetr_tpu_torch.evalx.trajectory",
             "oetr_tpu_torch.utils.h5io", "oetr_tpu_torch.data.pairs",
             "oetr_tpu_torch.training", "oetr_tpu_torch.training.losses",
             "oetr_tpu_torch.training.train",
             "oetr_tpu_torch.training.validation",
             "oetr_tpu_torch.training.cli", "oetr_tpu_torch.data.gt",
             "oetr_tpu_torch.data.megadepth",
             "oetr_tpu_torch.utils.profiling",
             "oetr_tpu_torch.models.matchers", "oetr_tpu_torch.models.d2net",
             "oetr_tpu_torch.models.r2d2", "oetr_tpu_torch.models.disk",
             "oetr_tpu_torch.models.aslfeat", "oetr_tpu_torch.models.cotr",
             "oetr_tpu_torch.models.sift_based", "oetr_tpu_torch.models.icp",
             "oetr_tpu_torch.models.registry", "oetr_tpu_torch.data.images",
             "oetr_tpu_torch.data.native", "oetr_tpu_torch.pipelines.api",
             "oetr_tpu_torch.pipelines.runner",
             "oetr_tpu_torch.pipelines.demo", "oetr_tpu_torch.utils.viz",
             "oetr_tpu_torch.utils.timer", "oetr_tpu_torch.sfm",
             "oetr_tpu_torch.sfm.ba", "oetr_tpu_torch.sfm.reconstruct",
             "oetr_tpu_torch.sfm.colmap_model",
             "oetr_tpu_torch.sfm.database", "oetr_tpu_torch.sfm.demo",
             "oetr_tpu_torch.data.synthetic",
             "oetr_tpu_torch.data.preprocess",
             "oetr_tpu_torch.training.superpoint",
             "oetr_tpu_torch.training.superglue",
             "oetr_tpu_torch.training.loftr",
             "oetr_tpu_torch.training.contextdesc",
             "oetr_tpu_torch.training.optim", "oetr_tpu_torch.models.fcos",
             "oetr_tpu_torch.interop.torch_convert",
             "oetr_tpu_torch.interop.zstd", "oetr_tpu_torch.interop.ocdbt",
             "oetr_tpu_torch.interop.orbax_read",
             "oetr_tpu_torch.interop.orbax_write",
             "oetr_tpu_torch.interop.from_flax",
             "oetr_tpu_torch.training.jax_state",
             "oetr_tpu_torch.parallel", "oetr_tpu_torch.parallel.mesh",
             "oetr_tpu_torch.parallel.multihost",
             "oetr_tpu_torch.parallel.ring_attention",
             "oetr_tpu_torch.parallel.pipeline",
             "oetr_tpu_torch.parallel.data", "oetr_tpu_torch.entry",
             "oetr_tpu_torch.scripts", "oetr_tpu_torch.scripts.common",
             "oetr_tpu_torch.scripts.train_demo",
             "oetr_tpu_torch.scripts.train_matching_demo",
             "oetr_tpu_torch.scripts.train_loftr_demo",
             "oetr_tpu_torch.scripts.eval_demo",
             "oetr_tpu_torch.scripts.overlap_ab_demo",
             "oetr_tpu_torch.scripts.probe_heatmap_boxes",
             "oetr_tpu_torch.scripts.sweep_decode",
             "oetr_tpu_torch.scripts.export_params")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
import oetr_tpu_torch

torch.set_num_threads(2)
names = [m.name for m in pkgutil.walk_packages(oetr_tpu_torch.__path__,
                                               "oetr_tpu_torch.")]
missing = [m for m in MUST_LIST if m not in names]
assert not missing, missing
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

from oetr_tpu_torch import BackboneConfig, NeckConfig, OETRConfig, build_oetr
cfg = OETRConfig(backbone=BackboneConfig(depth=18, last_layer=256,
                                         fused_stem=True),
                 neck=NeckConfig(d_model=64, nhead=4, num_layers=1,
                                 num_decoder_layers=1, attention="linear:cuda"))
model = build_oetr(cfg, device="cpu")
with torch.no_grad():
    out = model(torch.rand(1, 160, 160, 3), torch.rand(1, 160, 160, 3))
assert torch.isfinite(out["pred_bbox1"]).all()
from oetr_tpu_torch.pipelines import PipelineConfig, api
model = api.build_model("disk-desc", "disk", cfg=PipelineConfig(
    canvas_hw=(64, 64), oetr_hw=(64, 64)), device="cpu")
img = torch.rand(70, 90, 3).numpy()
res = api._match_images(model, img, img)
assert res["matches"].shape[0] == 2 and len(res["kpts0"]) == 2048
try:
    api.get_matches(model, "a.png", "b.png")
except ImportError:
    pass
else:
    raise AssertionError("get_matches read a file without cv2")
from oetr_tpu_torch.sfm import demo as sfm_demo
imgs, Kr, gt, depths = sfm_demo.render_rig(3, 64, 0, arc_deg=10.0)
assert imgs.shape == (3, 64, 64, 3) and (depths[0] > 0).all()
from oetr_tpu_torch.sfm import bundle_adjust
g = torch.Generator().manual_seed(0)
pts = torch.rand(20, 3, generator=g) + torch.tensor([0.0, 0.0, 5.0])
cams = torch.zeros(2, 6)
cams[1, 3] = 0.5
Ks = torch.tensor([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]]).expand(2, 3, 3)
oc = torch.arange(2).repeat_interleave(20)
op = torch.arange(20).repeat(2)
from oetr_tpu_torch.sfm.ba import project_residual
uv = project_residual(cams[oc], Ks[oc], pts[op], torch.zeros(40, 2))
res = bundle_adjust(cams, pts + 0.01, Ks, oc, op, uv, torch.ones(40, dtype=torch.bool),
                    iters=2, cg_iters=5)
assert torch.isfinite(res["cost_history"]).all()
from oetr_tpu_torch import training as tr
net = oetr_tpu_torch.build_superpoint_net(device="cpu", descriptor_dim=16)
opt = torch.optim.Adam(net.parameters(), lr=1e-3)
labels = torch.full((2, 4, 4), 64, dtype=torch.int32)
labels[:, 1, 2] = 9
m = tr.make_superpoint_train_step(net, opt, clip_norm=1.0)(
    torch.rand(2, 32, 32, 1), labels)
assert torch.isfinite(m["loss"])
for builder, args in ((tr.synthetic_shapes_batch, (2, 32)),
                      (tr.homography_pairs_batch, (2, 32)),
                      (tr.contextdesc_pairs_batch, (2, 32))):
    try:
        builder(np.random.default_rng(0), *args)
    except ImportError:
        continue
    raise AssertionError(f"{builder.__name__} ran without cv2")
from oetr_tpu_torch.scripts import (eval_demo, overlap_ab_demo, train_demo,
                                    train_loftr_demo, train_matching_demo)
for demo in (train_demo, train_matching_demo, train_loftr_demo, eval_demo,
             overlap_ab_demo):
    try:
        demo.main(["--device", "cpu"])
    except ImportError as e:
        assert "cv2" in str(e), e
        continue
    raise AssertionError(f"{demo.__name__} ran without cv2")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("modules", len(names))
'''


def test_port_runs_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("modules")[-1])
    assert n_modules >= 63


def test_shipped_weights_read_with_readers_refused():
    """``read_checkpoint`` reads all four committed stores and
    ``build_shipped_model(device="cpu")`` builds both matchers behind the
    OETR gate in a child that refuses tensorstore, zstandard, zarr and
    numcodecs with the rest of ``BLOCKED``."""
    code = CHILD.split("import numpy as np")[0] + r'''
import numpy as np
import oetr_tpu_torch as port
from oetr_tpu_torch.interop.orbax_read import read_checkpoint
n = 0
for rel in (".ckpt_matching_r5/superpoint", ".ckpt_matching_r5/superglue",
            ".ckpt_loftr_r5/loftr", ".ckpt_oetr_r5/params"):
    tree = read_checkpoint(rel)
    leaves = []
    stack = [tree]
    while stack:
        node = stack.pop()
        for v in node.values():
            (stack if isinstance(v, dict) else leaves).append(v)
    assert all(v.dtype == np.float32 for v in leaves)
    n += len(leaves)
cfg = port.PipelineConfig(canvas_hw=(64, 64), oetr_hw=(64, 64))
for matcher in ("superglue", "loftr"):
    pipe, conf = port.build_shipped_model(matcher, with_overlap=True,
                                          cfg=cfg, device="cpu")
    assert conf["overlaper"] == "oetr" and pipe.oetr is not None
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("leaves", n)
'''
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split("leaves")[-1]) == 292 + 24 + 273 + 157


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax|"
                         r"import optax|import orbax|from orbax|"
                         r"(import|from) (tensorstore|zstandard|zarr|"
                         r"numcodecs)\b|"
                         r"from oetr_tpu(\.| import)|import oetr_tpu(\.|\s|$))",
                         re.M)
    # the port's sources, not what a build may have put under _build/
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts)
    files += [ROOT / "chip_smoke.py", ROOT / "pose_timing.py",
              ROOT / "sfm_spread.py", ROOT / "chip_time_sites.py",
              ROOT / "ba_trace_steps.py",
              ROOT / "tests" / "torch_port_ranks.py"]
    assert len(files) >= 13
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_ba_trace_steps_needs_a_card(monkeypatch, capsys, tmp_path):
    """Without a CUDA card the BA trace script exits 1 and writes
    nothing."""
    import torch

    import ba_trace_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.json"
    assert ba_trace_steps.main(["--out", str(out)]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not out.exists()


def test_refusing_finder_lets_the_port_through():
    """The blocklist matches whole names: oetr_tpu_torch is not oetr_tpu."""
    code = ("import sys\n" + CHILD.split("sys.meta_path.insert")[0]
            + "f = Refuse()\n"
            "assert f.find_spec('oetr_tpu_torch') is None\n"
            "assert f.find_spec('jaxtyping') is None\n"
            "for n in ('oetr_tpu', 'oetr_tpu.config', 'jax.numpy', 'flax'):\n"
            "    try:\n"
            "        f.find_spec(n)\n"
            "    except ImportError:\n"
            "        continue\n"
            "    raise AssertionError(n)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-4000:]
