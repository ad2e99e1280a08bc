"""The port's matching demo programs against the JAX package's scripts, on
the CPU in float32: ``train_matching_demo`` (SuperPoint, then SuperGlue
on its keypoints, then the three-row table) and ``train_loftr_demo``.

JAX's two scripts run once, at tiny flags, in child processes
(``torch_port_jax_demo.py``: each train step's parameters, data and
metrics recorded), with ``--ckpt_dir``: their final parameters are read
back here with orbax. The host SuperPoint path is JAX's default. Then:

  streams     the port's host stream from numpy seed 0 (texture pool,
              shapes batch, homographies, SuperGlue's permutation) gives
              JAX's recorded batches (the texture pool from JAX's own
              renderer: the port's is held to it in
              test_torch_port_synthetic.py); SuperGlue's host features of
              JAX's trained SuperPoint on JAX's scenes give its batches
              (keypoints, validity, GT equal; scores, descriptors 1e-5);
              LoFTR's ``prep`` of one JAX generator batch gives JAX's
              step inputs (GT equal, images and warps 1e-5)
  training    each phase's own function (train_superpoint,
              train_superglue, train_loftr) run one step at a time from
              JAX's parameters before that step, on JAX's batches, with
              the port's optimizer carried over: each step's rate equal to
              optax's under the schedule JAX's script made, each parameter
              after it within 2·rate (after the first, within 1e-6 of
              max(1, |p|) where its gradient is clear of rounding), the
              step's whole gradient within GRAD_RTOL of JAX's (from JAX's
              Adam moments; LoFTR's LOFTR_GRAD_RTOL), the metrics it
              returns 1e-5 relative; then all steps at once from JAX's
              initial weights, within 2·lr a step of JAX's final ones
  evaluation  given JAX's trained parameters and scenes, every JSON field
              equals JAX's, or lies within 1e-4 where it is a float of a
              float (repeatability, precision, matches per pair, assign_*,
              AUCs, sigma); the pose estimator draws JAX's Gumbel noise
  resume      the port's programs run segmented at one step in child
              processes (each segment saves and re-executes): LoFTR's
              parameters equal an uninterrupted run's; the matching demo's
              equal a run whose numpy stream is reseeded with 1000 + the
              step at SuperPoint's resume, as JAX's script reseeds it
  cv2         with cv2 missing each main stops first, naming cv2
"""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from oetr_tpu.data import device_synth as jsynth_dev
from oetr_tpu.data.synthetic import _texture as jax_texture
from oetr_tpu_torch import interop
from oetr_tpu_torch.data.megadepth import MegaDepthPairsDataset
from oetr_tpu_torch.scripts import train_loftr_demo as loftr_demo
from oetr_tpu_torch.scripts import train_matching_demo as match_demo
from oetr_tpu_torch.scripts.common import adam, load_state
from oetr_tpu_torch.training.superpoint import (corners_to_cell_labels,
                                                synthetic_shapes_batch)
from torch_port_demo_checks import (GRAD_RTOL, LOFTR_GRAD_RTOL, ROOT,
                                    field_mismatches, finish, hold_params,
                                    hold_phase, install_jax_draws, only_dir,
                                    start_jax)

torch.set_num_threads(2)

MATCH_ARGS = ["--sp_steps", "2", "--sg_steps", "2", "--sp_batch", "2",
              "--sg_batch", "2", "--sp_hw", "64", "--hw", "64", "--topk",
              "64", "--train_pairs", "4", "--val_pairs", "2", "--tex_pool",
              "4", "--desc_dim", "32"]
LOFTR_ARGS = ["--steps", "2", "--batch", "2", "--hw", "64", "--d_coarse",
              "32", "--layers", "1", "--val_pairs", "4"]
SEGMENTED = ["--max_steps_per_segment", "1", "--device", "cpu"]
RTOL = 1e-5
SG_KW = dict(descriptor_dim=32)
LOFTR_KW = dict(d_coarse=32, d_fine=96, coarse_layers=1, max_matches=1024)


def _start_port(base, name, module, *argv):
    ckpt = base / name
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               TMPDIR=str(base))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"oetr_tpu_torch.scripts.{module}", *argv,
         "--ckpt_dir", str(ckpt)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, ckpt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("demos")
    jax_runs = {
        "match": start_jax(base, "match", "train_matching_demo.py",
                           *MATCH_ARGS, "--ckpt_dir",
                           str(base / "match" / "ckpt")),
        "loftr": start_jax(base, "loftr", "train_loftr_demo.py",
                           *LOFTR_ARGS, "--ckpt_dir",
                           str(base / "loftr" / "ckpt"))}
    port = {
        "match": _start_port(base, "port_match", "train_matching_demo",
                             *MATCH_ARGS[:-8], "--train_pairs", "2",
                             "--val_pairs", "1", "--tex_pool", "4",
                             "--desc_dim", "32", "--device_data",
                             *SEGMENTED),
        "loftr": _start_port(base, "port_loftr", "train_loftr_demo",
                             *LOFTR_ARGS[:-2], "--val_pairs", "1",
                             *SEGMENTED)}
    out = {k: finish(r) for k, r in jax_runs.items()}
    for k, (proc, ckpt) in port.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        out["port_" + k] = ckpt
    return out


def _orbax(run, name):
    return ocp.StandardCheckpointer().restore(
        str(run["tmp"] / "ckpt" / name))


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()} \
        if isinstance(tree, dict) else [torch.as_tensor(np.asarray(v))
                                        for v in tree]


def _close(got, want, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                   err_msg=what)


def _hold_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def _hold_training(model, rec, schedule, final, convert, lr, steps,
                   run_step, run_all, grad_rtol=GRAD_RTOL):
    """The phase held step by step (``hold_phase``: ``run_step(opt, sched,
    k)`` runs its step k alone), then all its steps at once
    (``run_all(opt, sched)``) against JAX's final parameters at 2·lr a
    step."""
    model.load_state_dict(convert(rec["init"]))
    opt, sched = adam(model, lr, steps)
    hold_phase(model, opt, rec, convert, lambda k: run_step(opt, sched, k),
               schedule, _hold_metrics, grad_rtol)

    model.load_state_dict(convert(rec["init"]))
    opt, sched = adam(model, lr, steps)
    run_all(opt, sched)
    hold_params(model, convert(final), lr, steps)


def _sp_stream(rng, args):
    """Replay the host SuperPoint stream: JAX's texture pool from ``rng``,
    then each step's shapes batch and pair batch."""
    import cv2

    pool = [cv2.cvtColor(jax_texture(rng, args.sp_hw, args.sp_hw),
                         cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
            for _ in range(args.tex_pool)]
    return match_demo.host_pair_batch(pool, args.sp_hw)


def _sp_batches(rng, pair_batch, args, steps):
    out = []
    for it in range(steps):
        imgs, corners, counts = synthetic_shapes_batch(rng, args.sp_batch,
                                                       args.sp_hw)
        labels = corners_to_cell_labels(corners, (args.sp_hw,) * 2, counts)
        im0, im1, H = pair_batch(rng, args.sp_batch, it)
        out.append([imgs, labels, im0, im1, H.astype(np.float32)])
    return out


def _match_args():
    return match_demo.parse_args(MATCH_ARGS + ["--device", "cpu"])


def test_superpoint_phase_matches_jax(runs):
    run, args = runs["match"], _match_args()
    rec = run["rec"]["make_superpoint_joint_train_step"]
    rng = np.random.default_rng(0)
    got = _sp_batches(rng, _sp_stream(rng, args), args, args.sp_steps)
    for g, w in zip(got, rec["batches"]):
        for a, b, what in zip(g, w, ("imgs", "labels", "im0", "im1", "H")):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=what)

    net = match_demo.build_superpoint_net(device="cpu", descriptor_dim=32)
    convert = lambda p: interop.convert_superpoint_net_params(
        p, descriptor_dim=32)

    def run_step(opt, sched, k):
        rng = np.random.default_rng(0)
        pair_batch = _sp_stream(rng, args)
        _sp_batches(rng, pair_batch, args, k)       # the draws before step k
        return match_demo.train_superpoint(net, opt, sched, args, rng,
                                           pair_batch, k, k + 1)

    def run_all(opt, sched):
        rng = np.random.default_rng(0)
        match_demo.train_superpoint(net, opt, sched, args, rng,
                                    _sp_stream(rng, args))

    _hold_training(net, rec, run["rec"]["schedules"][0],
                   _orbax(run, "superpoint"), convert, match_demo.SP_LR,
                   args.sp_steps, run_step, run_all)


def _trained_sp(run, args):
    net = match_demo.build_superpoint_net(device="cpu", descriptor_dim=32)
    net.load_state_dict(interop.convert_superpoint_net_params(
        _orbax(run, "superpoint"), descriptor_dim=32))
    return match_demo.extractor(net, args)


def _scenes(run, args, name):
    d = only_dir(run["tmp"], "oetr_matchdemo_") / name
    return MegaDepthPairsDataset(str(d), str(d / "pairs.txt"),
                                 image_size=(args.hw, args.hw), train=False)


def test_superglue_phase_matches_jax(runs):
    run, args = runs["match"], _match_args()
    rec = run["rec"]["make_superglue_train_step"]
    sp = _trained_sp(run, args)
    feats = match_demo.sg_host_features(sp, _scenes(run, args, "train"))
    rng = np.random.default_rng(0)
    _sp_batches(rng, _sp_stream(rng, args), args, args.sp_steps)  # SP's
    stream = match_demo.sg_host_batches(feats, rng, args.sg_batch, args.hw,
                                        "cpu")
    for got, want in zip(stream, rec["batches"]):
        for k in want:
            _close(got[k], want[k], k)

    sg = match_demo.build_sg(args, "cpu").train()
    convert = lambda p: interop.convert_superglue_params(p, **SG_KW)
    batch_of = lambda b: dict(_t(b), image_hw0=(args.hw, args.hw),
                              image_hw1=(args.hw, args.hw))
    _hold_training(
        sg, rec, run["rec"]["schedules"][1], _orbax(run, "superglue"),
        convert, match_demo.SG_HOST_LR, args.sg_steps,
        lambda opt, sched, k: match_demo.train_superglue(
            sg, opt, sched, iter([batch_of(rec["batches"][k])]), k + 1, k),
        lambda opt, sched: match_demo.train_superglue(
            sg, opt, sched, map(batch_of, rec["batches"]), args.sg_steps))


def test_matching_eval_matches_jax(runs, monkeypatch):
    run, args = runs["match"], _match_args()
    sp = _trained_sp(run, args)
    sg = match_demo.build_sg(args, "cpu")
    sg.load_state_dict(interop.convert_superglue_params(
        _orbax(run, "superglue"), **SG_KW))
    ds = _scenes(run, args, "val")
    install_jax_draws(monkeypatch)
    fields = match_demo.evaluate(sp, sg, [ds[i] for i in range(len(ds))],
                                 args, "cpu")
    want = {k: v for k, v in run["json"].items()
            if k in ("sift_nn", "sp_nn", "sp_sg", "repeatability@3px",
                     "sg_beats_nn_gate")}
    assert not field_mismatches(fields, want), field_mismatches(fields, want)


def _jax_scene_batch(args, it):
    """JAX's device generator batch of step ``it`` (fold_in(key(17), it)),
    as the JAX script draws it."""
    with jax.enable_x64(False):
        gen = jsynth_dev.make_device_generator(
            args.hw, args.batch, scale_range=(1.0, 2.0), p_translate=0.5)
        raw = gen(jax.random.fold_in(jax.random.key(loftr_demo.SEED), it))
        return {k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()}


def _loftr_args():
    return loftr_demo.parse_args(LOFTR_ARGS + ["--device", "cpu"])


def test_loftr_prep_and_training_match_jax(runs):
    run, args = runs["loftr"], _loftr_args()
    rec = run["rec"]["make_loftr_train_step"]
    raws = [_jax_scene_batch(args, it) for it in range(args.steps)]
    centers = loftr_demo.cell_centers(args.hw, "cpu")
    for raw, want in zip(raws, rec["batches"]):
        got = loftr_demo.prep(raw, centers)
        for g, w, what in zip(got, want, ("g0", "g1", "gt", "gt_xy1",
                                          "gt_ok1")):
            _close(g, w, what)

    model = loftr_demo.build_model(args, "cpu").train()
    convert = lambda p: interop.convert_loftr_params(p, **LOFTR_KW)
    _hold_training(
        model, rec, run["rec"]["schedules"][0], _orbax(run, "loftr"),
        convert, args.lr, args.steps,
        lambda opt, sched, k: loftr_demo.train_loftr(
            model, opt, sched, args, lambda it: raws[it], k, k + 1),
        lambda opt, sched: loftr_demo.train_loftr(
            model, opt, sched, args, lambda it: raws[it]), LOFTR_GRAD_RTOL)


def test_loftr_eval_matches_jax(runs, monkeypatch):
    run, args = runs["loftr"], _loftr_args()
    model = loftr_demo.build_model(args, "cpu")
    model.load_state_dict(interop.convert_loftr_params(
        _orbax(run, "loftr"), **LOFTR_KW))
    d = only_dir(run["tmp"], "oetr_loftr_") / "val"
    ds = MegaDepthPairsDataset(str(d), str(d / "pairs.txt"),
                               image_size=(args.hw, args.hw), train=False)
    install_jax_draws(monkeypatch)
    rows = loftr_demo.evaluate(model, [ds[i] for i in range(len(ds))], "cpu")
    want = {k: run["json"][k] for k in ("loftr", "sift_nn")}
    assert not field_mismatches(rows, want), field_mismatches(rows, want)


def _equal_states(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_loftr_resume_equals_uninterrupted(runs):
    """Segmented at one step (a save and a re-exec), LoFTR ends where an
    uninterrupted run ends: step it's pairs come from its own seed."""
    args = loftr_demo.parse_args(LOFTR_ARGS[:-2] + ["--val_pairs", "1"]
                                 + SEGMENTED)
    model = loftr_demo.build_model(args, "cpu")
    opt, sched = adam(model, args.lr, args.steps)
    loftr_demo.train_loftr(model, opt, sched, args,
                           loftr_demo.device_batches(args, "cpu"))
    _equal_states(interop.convert_loftr_params(
        load_state(str(runs["port_loftr"] / "loftr")), **LOFTR_KW),
        model.state_dict())


def test_matching_resume_reseeds_as_jax(runs):
    """Segmented at one step with --device_data: SuperGlue resumes its
    device stream exactly; SuperPoint's numpy stream restarts at seed 1000
    + the step, as JAX's script restarts it (its device pairs do not)."""
    argv = (MATCH_ARGS[:-8] + ["--train_pairs", "2", "--val_pairs", "1",
                               "--tex_pool", "4", "--desc_dim", "32",
                               "--device_data"] + SEGMENTED)
    args = match_demo.parse_args(argv + ["--ckpt_dir", "unused"])
    net = match_demo.build_superpoint_net(device="cpu", descriptor_dim=32)
    opt, sched = adam(net, match_demo.SP_LR, args.sp_steps)
    pairs = match_demo.device_pair_batch(args.sp_hw, args.sp_batch, "cpu")
    for start in range(args.sp_steps):
        rng = np.random.default_rng(1000 + start if start else 0)
        match_demo.train_superpoint(net, opt, sched, args, rng, pairs, start,
                                    start + 1)
    sp = match_demo.extractor(net, args)
    sg = match_demo.build_sg(args, "cpu").train()
    opt, sched = adam(sg, args.sg_lr, args.sg_steps)
    match_demo.train_superglue(sg, opt, sched,
                               match_demo.device_sg_batches(sp, args, "cpu"),
                               args.sg_steps)
    ckpt = runs["port_match"]
    _equal_states(interop.convert_superpoint_net_params(
        load_state(str(ckpt / "superpoint")), descriptor_dim=32),
        net.state_dict())
    _equal_states(interop.convert_superglue_params(
        load_state(str(ckpt / "superglue")), **SG_KW), sg.state_dict())


@pytest.mark.parametrize("demo", [match_demo, loftr_demo])
def test_demo_without_cv2_stops_first(demo, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(demo, "run",
                        lambda *a, **k: pytest.fail("ran without cv2"))
    with pytest.raises(ImportError, match="cv2"):
        demo.main(["--device", "cpu"])
