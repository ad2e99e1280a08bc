"""The port's OETR demo programs and its SIFT harness demo against the JAX
package's scripts, on the CPU in float32, and the native data service's
first build under concurrent processes.

JAX's ``scripts/train_demo.py``, ``eval_demo.py`` (plain and
``--scene3d``) and ``overlap_ab_demo.py`` run once, at tiny flags, in
child processes (``torch_port_jax_demo.py``: flax's dropout off,
numpy's global generator seeded with 0, every train step's parameters,
batches and metrics recorded); their scenes land in the child's TMPDIR,
where the port reads them. Then:

  training    the port's phase function (train_oetr, train_overlap), dropout
              off, run one step at a time from JAX's parameters before
              that step, on JAX's recorded host batches (which the port's
              own stream reproduces from the same numpy state), with the
              port's optimizer carried over: each step's rate equal to
              optax's under JAX's schedule, each parameter after it within
              2·rate (after the first, within 1e-6 of max(1, |p|) where
              its gradient is clear of rounding: PERF.md §2, the trainers'
              bounds), the step's whole gradient within GRAD_RTOL of JAX's
              (from JAX's Adam moments), the loss 1e-5 relative; then all
              steps at once from JAX's initial weights, within 2·lr a step
              of JAX's final parameters (Adam moves each entry whose
              gradient is rounding noise by ±lr on the noise's sign)
  evaluation  given JAX's parameters (initial and trained) and the same
              scenes, every JSON field equals JAX's, or lies within 1e-4
              where it is a float (recall, IoU, losses, AUCs, bootstrap
              sigma, precision); the pose estimator draws JAX's Gumbel
              noise of rng_seed 0
  cv2         with cv2 missing each main stops before any work with an
              ImportError naming cv2
  native      six processes build the data service at once, five
              rounds, each from a copy of ``native/`` with no library:
              all six load it; nothing is written under ``native/``
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from oetr_tpu_torch import interop
from oetr_tpu_torch.models.transformer import Dropout
from oetr_tpu_torch.scripts import eval_demo, overlap_ab_demo, train_demo
from oetr_tpu_torch.training.train import create_train_state
from torch_port_demo_checks import (ROOT, field_mismatches, finish,
                                    hold_params, hold_phase,
                                    install_jax_draws, only_dir, start_jax)

torch.set_num_threads(2)

TRAIN_ARGS = ["--steps", "2", "--batch", "2", "--train_pairs", "4",
              "--val_pairs", "4", "--hw", "64"]
EVAL_ARGS = ["--pairs", "4", "--hw", "96", "--topk", "256"]
EVAL3D_ARGS = ["--scene3d", "--pairs", "3", "--hw", "96", "--topk", "256"]
AB_ARGS = ["--steps", "2", "--batch", "2", "--train_pairs", "4",
           "--val_pairs", "3", "--hw", "64", "--topk", "256"]
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_demos")
    runs = {"train": start_jax(base, "train", "train_demo.py", *TRAIN_ARGS),
            "eval": start_jax(base, "eval", "eval_demo.py", *EVAL_ARGS),
            "eval3d": start_jax(base, "eval3d", "eval_demo.py",
                                *EVAL3D_ARGS),
            "ab": start_jax(base, "ab", "overlap_ab_demo.py", *AB_ARGS)}
    return {k: finish(r) for k, r in runs.items()}


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def _state_on(rec_params, cfg, train_cfg):
    """(model, state) of OETR's trainer from JAX's parameters."""
    model, state = create_train_state(cfg, train_cfg, device="cpu")
    model.load_state_dict(interop.convert_flax_params(rec_params, cfg))
    _dropout_off(model)
    return model, state


def _batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def _train_and_hold(run, cfg, train_cfg, run_step, train):
    """The phase held step by step (``hold_phase``: ``run_step(state, k)``
    runs its step k alone and returns its loss), then all its steps at
    once (``train(state) -> losses``, the phase's) from JAX's initial
    weights against JAX's final parameters. Returns the model after all
    steps and those losses."""
    rec = run["rec"]["make_train_step"]
    convert = lambda p: interop.convert_flax_params(p, cfg)

    def hold_loss(got, want):
        np.testing.assert_allclose(float(got), float(want["loss"]),
                                   rtol=LOSS_RTOL)

    model, state = _state_on(rec["init"], cfg, train_cfg)
    [schedule] = run["rec"]["schedules"]
    hold_phase(model, state.optimizer, rec, convert,
               lambda k: run_step(state, k), schedule, hold_loss)

    model, state = _state_on(rec["init"], cfg, train_cfg)
    losses = train(state)
    hold_params(model, convert(rec["final"]), train_cfg.lr,
                len(rec["params"]))
    return model, losses


def test_train_demo_matches_jax(jax_runs):
    run = jax_runs["train"]
    want, rec = run["json"], run["rec"]["make_train_step"]
    args = train_demo.parse_args(TRAIN_ARGS + ["--device", "cpu"])
    data = only_dir(run["tmp"], "oetr_synth_")
    np.random.seed(0)
    train_ds, val_ds = train_demo.open_datasets(str(data), args.hw)
    for got, w in zip(train_demo.epoch_batches(train_ds, args.batch),
                      rec["batches"]):
        _batches_equal(got, w)

    cfg = train_demo.model_config()
    model, _ = _state_on(rec["init"], cfg, train_demo.train_config(args))
    r_init = train_demo.evaluate(model, val_ds.batches(args.batch))
    model, losses = _train_and_hold(
        run, cfg, train_demo.train_config(args),
        lambda state, k: train_demo.train_oetr(
            state, iter([rec["batches"][k]]), 1, None)[0],
        lambda state: train_demo.train_oetr(
            state, iter(rec["batches"]), args.steps, None))
    model.load_state_dict(interop.convert_flax_params(rec["final"], cfg))
    r_final = train_demo.evaluate(model, val_ds.batches(args.batch))
    got = train_demo.summary(args, losses, r_init, r_final, time.time())
    assert not field_mismatches(got, want), field_mismatches(got, want)


@pytest.mark.parametrize("name,argv", [("eval", EVAL_ARGS),
                                       ("eval3d", EVAL3D_ARGS)])
def test_eval_demo_matches_jax(jax_runs, monkeypatch, name, argv):
    run = jax_runs[name]
    from oetr_tpu_torch.data.megadepth import MegaDepthPairsDataset

    args = eval_demo.parse_args(argv + ["--device", "cpu"])
    data = only_dir(run["tmp"], "oetr_evaldemo_")
    ds = MegaDepthPairsDataset(str(data), str(data / "pairs.txt"),
                               image_size=(args.hw, args.hw), train=False)
    install_jax_draws(monkeypatch)
    got = eval_demo.evaluate(args, [ds[i] for i in range(len(ds))],
                             time.time())
    assert not field_mismatches(got, run["json"]), field_mismatches(
        got, run["json"])


def test_overlap_ab_demo_matches_jax(jax_runs, monkeypatch):
    run = jax_runs["ab"]
    want, rec = run["json"], run["rec"]["make_train_step"]
    args = overlap_ab_demo.parse_args(AB_ARGS + ["--device", "cpu"])
    args.data_dir = str(only_dir(run["tmp"], "oetr_ab_"))
    np.random.seed(0)
    train_ds, val_ds = overlap_ab_demo.make_datasets(args)
    stream = overlap_ab_demo.batch_stream(args, train_ds, 0, "cpu")
    for got, w in zip(stream, rec["batches"]):
        _batches_equal(got, w)

    cfg = overlap_ab_demo.model_config(args)

    def run_step(state, k):
        it, last = overlap_ab_demo.train_overlap(
            state, iter([rec["batches"][k]]), args, k, None)
        assert it == k + 1
        return last

    def train(state):
        it, last = overlap_ab_demo.train_overlap(
            state, iter(rec["batches"]), args, 0, None)
        assert it == args.steps
        return [last]

    model, losses = _train_and_hold(run, cfg,
                                    overlap_ab_demo.train_config(args),
                                    run_step, train)
    model.load_state_dict(interop.convert_flax_params(rec["final"], cfg))
    install_jax_draws(monkeypatch)
    items = [val_ds[i] for i in range(len(val_ds))]
    got = {"metric": "overlap_ab_pose_auc", "steps": args.steps,
           "hw": args.hw, "val_pairs": args.val_pairs,
           "d_model": args.d_model, "layers": args.layers,
           "train_loss_last": overlap_ab_demo.loss_field(losses[-1]),
           **overlap_ab_demo.evaluate(model, items, args, "cpu")}
    assert not field_mismatches(got, want), field_mismatches(got, want)


@pytest.mark.parametrize("demo,work", [(train_demo, "write_scenes"),
                                       (eval_demo, "make_dataset"),
                                       (overlap_ab_demo, "run")])
def test_demo_without_cv2_stops_first(demo, work, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(demo, work,
                        lambda *a, **k: pytest.fail("ran without cv2"))
    with pytest.raises(ImportError, match="cv2"):
        demo.main(["--device", "cpu"])


NATIVE_CHILD = r"""
import sys, time
from pathlib import Path
from oetr_tpu_torch.data import native
from oetr_tpu_torch.ops import _build

src, builds, sync, rounds = sys.argv[1], sys.argv[2], Path(sys.argv[3]), \
    int(sys.argv[4])
native.NATIVE_SRC = Path(src)
print("ready", flush=True)
for r in range(rounds):
    while not (sync / f"go{r}").exists():
        time.sleep(0.002)
    _build.BUILD_DIR, native._lib = Path(f"{builds}/round{r}"), None
    print(native.native_available(), native.native_error(), flush=True)
"""


def test_native_first_build_has_no_race(tmp_path):
    """Six processes ask for the data service at once, five rounds, each
    round on a fresh build directory: every process gets the library."""
    src = tmp_path / "native"
    shutil.copytree(ROOT / "native", src,
                    ignore=shutil.ignore_patterns("*.so"))
    before = sorted(os.listdir(ROOT / "native"))
    sync, rounds = tmp_path / "sync", 5
    sync.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", NATIVE_CHILD, str(src / "dataservice.cpp"),
         str(tmp_path / "build"), str(sync), str(rounds)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready", p.stderr.read()
        for r in range(rounds):
            (sync / f"go{r}").touch()
            got = [p.stdout.readline().strip() for p in procs]
            assert got == ["True None"] * 6, (r, got)
            assert len(list((tmp_path / "build" / f"round{r}").glob(
                "libodsdata_*.so"))) == 1
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert sorted(os.listdir(ROOT / "native")) == before
