"""The port's ``probe_heatmap_boxes``, ``sweep_decode`` and ``export_params``
against JAX's scripts, on the CPU, on each other's states.

One JAX ``TrainState`` of the scripts' OETR at a small size (ResNet18 to
layer3, d 64, one encoder layer, 2 decoder layers, 128²) is written at step
3 by JAX's ``save_checkpoint``; the port loads it and writes it again
(``training/train.py``). JAX's scripts run in child processes
(``torch_port_jax_demo.py``) at tiny flags while the port's run here:

  probe    JAX's on the port's state, the port's on JAX's, ``--full``, 4
           held-out pairs: every mIoU row within 1e-4, the same best q,
           the A/B's matches a pair equal (cv2's SIFT on both sides) and
           its AUCs and precisions within 1e-4, one step of the JSON's 4
           places (the port's estimator on JAX's draws; the f32 pose
           errors follow each side's eigensolver's last bits: 0.1563
           against 0.1564 read)
  export   JAX's and the port's params store of the same state: equal leaf
           by leaf (paths, dtypes, bytes)
  sweep    both on the port's export, one (q, pad), 4 pairs: every field
           equal or within 1e-4 (floats)
"""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.data.synthetic import generate_scene
from oetr_tpu.training import train as jt
from oetr_tpu_torch.interop import read_checkpoint
from oetr_tpu_torch.scripts import (export_params, probe_heatmap_boxes,
                                    sweep_decode)
from oetr_tpu_torch.scripts.overlap_ab_demo import model_config
from oetr_tpu_torch.training import train as ptr
from test_torch_port_jax_state_cli import _jax_state
from torch_port_demo_checks import (field_mismatches, finish,
                                    install_jax_draws, start_jax)

torch.set_num_threads(2)

MODEL = ["--hw", "128", "--depth", "18", "--d_model", "64", "--layers", "1"]
PROBE = ["--step", "3", "--full", "--topk", "256"]
SWEEP = ["--val_pairs", "4", "--qs", "0.1", "--pads", "0.15", "--topk",
         "256"]


def _model_args(argv):
    return export_params.parse_args(["src", "out", *argv])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("scripts")
    args = _model_args(MODEL)
    pcfg = model_config(args)
    tokens = args.hw // 32
    jcfg = OETRConfig(
        backbone=BackboneConfig(depth=18, stop_layer="layer3",
                                last_layer=256),
        neck=NeckConfig(d_model=64, nhead=8, num_layers=1,
                        num_decoder_layers=2, max_shape=(tokens, tokens)))
    with jax.enable_x64(False):
        jt.save_checkpoint(str(base / "jax_ckpt"), _jax_state(pcfg, 3, 7))
    _, state = ptr.create_train_state(pcfg, ptr.TrainConfig(), device="cpu")
    ptr.save_checkpoint(str(base / "port_ckpt"),
                        ptr.load_checkpoint(str(base / "jax_ckpt"), 3, state))
    for name, seed in (("probe_data", 999), ("sweep_data", 1234)):
        generate_scene(str(base / name / "val"), n_pairs=4, image_hw=128,
                       seed=seed, scale_range=(1.8, 3.2))
    export_params.export(str(base / "port_ckpt"), str(base / "port_export"),
                         args)
    jax_runs = {
        "probe": start_jax(base, "probe", "probe_heatmap_boxes.py",
                           "--ckpt_dir", str(base / "port_ckpt"),
                           "--data_dir", str(base / "probe_data"), *MODEL,
                           *PROBE),
        "export": start_jax(base, "export", "export_params.py",
                            str(base / "jax_ckpt"), str(base / "jax_export"),
                            *MODEL, "--dec_layers", "2"),
        "sweep": start_jax(base, "sweep", "sweep_decode.py", "--ckpt",
                           str(base / "port_export" / "params"),
                           "--data_dir", str(base / "sweep_data"), *MODEL,
                           *SWEEP)}
    return base, jcfg, jax_runs


def test_export_params_equals_jax(runs):
    base, _, jax_runs = runs
    out, err = jax_runs["export"].pop("proc").communicate(timeout=600)
    assert "exported" in out, err[-3000:]
    step, path, n = export_params.export(str(base / "port_ckpt"),
                                         str(base / "port_export"),
                                         _model_args(MODEL))
    assert step == 3 and path == str(base / "port_export" / "params")
    got, want = read_checkpoint(path), read_checkpoint(
        base / "jax_export" / "params")
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in fg] == [k for k, _ in fw] and len(fw) == 136
    for (k, g), (_, w) in zip(fg, fw):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert n == sum(w.size for _, w in fw)


def test_probe_matches_jax(runs, monkeypatch):
    base, _, jax_runs = runs
    install_jax_draws(monkeypatch)
    got = probe_heatmap_boxes.run(probe_heatmap_boxes.parse_args(
        ["--ckpt_dir", str(base / "jax_ckpt"), "--data_dir",
         str(base / "probe_data"), *MODEL, *PROBE, "--device", "cpu"]))
    want = finish(jax_runs["probe"])["json"]
    assert got["best_q"] == want["best_q"]
    assert not field_mismatches(got, want, skip=("wall_s", "ckpt")), \
        field_mismatches(got, want, skip=("wall_s", "ckpt"))
    for mode in want["pose_ab"]:
        g, w = got["pose_ab"][mode], want["pose_ab"][mode]
        assert g["matches_per_pair"] == w["matches_per_pair"], mode


def test_sweep_matches_jax(runs, monkeypatch):
    base, _, jax_runs = runs
    install_jax_draws(monkeypatch)
    got = sweep_decode.run(sweep_decode.parse_args(
        ["--ckpt", str(base / "port_export" / "params"), "--data_dir",
         str(base / "sweep_data"), *MODEL, *SWEEP, "--device", "cpu"]))
    want = finish(jax_runs["sweep"])["json"]
    assert not field_mismatches(got, want, skip=("wall_s", "ckpt")), \
        field_mismatches(got, want, skip=("wall_s", "ckpt"))
    assert got["best"] == want["best"] == "q0.1_pad0.15"


def test_scripts_need_cv2_first(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mod, argv in ((probe_heatmap_boxes, ["--data_dir", str(tmp_path)]),
                      (sweep_decode, [])):
        monkeypatch.setattr(mod, "run",
                            lambda *a, **k: pytest.fail("ran without cv2"))
        with pytest.raises(ImportError, match="cv2"):
            mod.main([*argv, "--device", "cpu"])


def test_export_params_command_line(runs, tmp_path):
    """``python -m`` with no device: the store and JAX's message."""
    base, _, _ = runs
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    shutil.copytree(base / "port_ckpt", tmp_path / "src")
    run = subprocess.run(
        [sys.executable, "-m", "oetr_tpu_torch.scripts.export_params",
         str(tmp_path / "src"), str(tmp_path / "out"), *MODEL,
         "--dec_layers", "2"], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "loaded step 3" in run.stdout and "exported" in run.stdout
    assert np.array_equal(
        read_checkpoint(tmp_path / "out" / "params")["params"]["query_embed1"],
        read_checkpoint(base / "jax_ckpt" / "step_3")["params"]["params"][
            "query_embed1"])


def test_positional_encoding_reaches_k2_contiguous(monkeypatch):
    """The scripts' OETR sizes ``max_shape`` to its token grid; K2 takes
    only contiguous positional encodings (its wrapper raises on the card),
    so the model hands them over contiguous also when the grid is the
    whole table."""
    import oetr_tpu_torch as port
    from oetr_tpu_torch.models import transformer

    seen = []
    k2 = transformer.linear_encoder_attention

    def check(x, source, x_pos, s_pos, *args, **kwargs):
        seen.append(x_pos.is_contiguous() and s_pos.is_contiguous())
        return k2(x, source, x_pos, s_pos, *args, **kwargs)

    monkeypatch.setattr(transformer, "linear_encoder_attention", check)
    args = _model_args(MODEL)
    model = port.build_oetr(model_config(args, fused_stem=True,
                                         attention="linear:cuda"),
                            device="cpu")
    img = torch.rand(1, args.hw, args.hw, 3)
    with torch.no_grad():
        model(img, img)
    assert seen and all(seen)
