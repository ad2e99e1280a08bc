"""The port imports nothing of JAX or of the JAX package.

The port must start where only torch is installed: the machine with the
CUDA card lacks flax and orbax, which the JAX package's models and
checkpoints need, and h5py and cv2. A child interpreter refuses jax,
jaxlib, flax, optax, orbax, oetr_tpu, h5py and cv2, then imports every
module of the port (the geometry, the evaluation package, the h5 utilities
and the pair lists among them) and ``chip_smoke``, and runs a small
forward on the CPU.
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
           "cv2")
MUST_LIST = ("oetr_tpu_torch.geometry.ransac",
             "oetr_tpu_torch.geometry.fivepoint",
             "oetr_tpu_torch.geometry.homography",
             "oetr_tpu_torch.geometry.epipolar",
             "oetr_tpu_torch.ops.small_eigh",
             "oetr_tpu_torch.evalx.twoview", "oetr_tpu_torch.evalx.imc_math",
             "oetr_tpu_torch.evalx.megadepth", "oetr_tpu_torch.evalx.imc",
             "oetr_tpu_torch.evalx.hpatches", "oetr_tpu_torch.evalx.datasets",
             "oetr_tpu_torch.evalx.metrics", "oetr_tpu_torch.evalx.trajectory",
             "oetr_tpu_torch.utils.h5io", "oetr_tpu_torch.data.pairs")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
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
    assert n_modules >= 49


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax|"
                         r"import optax|import orbax|from orbax|"
                         r"from oetr_tpu(\.| import)|import oetr_tpu(\.|\s|$))",
                         re.M)
    # the port's sources, not what a build may have put under _build/
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 13
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders


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
