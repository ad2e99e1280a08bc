"""The port's multi-rank training against its one-process training, on the
CPU, in float32, over gloo.

Each rank is a process started by ``parallel.spawn`` (``torch_port_ranks``,
which imports no JAX) with one CPU thread; this process computes the
one-process references on the same global batch from the same seeds while
the ranks run. The batches give the data ranks unequal valid counts
(OETR's valid pairs 1 and 2, SuperGlue's and LoFTR's GT matches), so a
per-rank mean averaged by DDP would differ from the global batch's loss,
which the port's losses divide by the all-reduced counts.

Bounds (PERF.md §2's train-step row):
  metrics                 1e-5 relative, equal on every rank
  gradient norm           1e-4 relative
  each gradient           1e-4 of max(1, its largest |ref|)
  parameters after        2·lr (+1e-6·|p|); 1e-6 of max(1, |p|) where |g|
                          is above 1e-2 of the parameter's largest |g|
                          and 1e-6 (there both take Adam's same-sign step)
  checkpoints             bit-equal across layouts
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
import torch_port_ranks as ranks
from oetr_tpu_torch.parallel import spawn
from oetr_tpu_torch.training import train as ptr

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM_BOUND = 2 * ranks.LR
STEP_G_FLOOR = 1e-2


def _check_step(got: dict, ref: dict, what: str, norm: bool = True):
    assert sorted(got["metrics"]) == sorted(ref["metrics"]), what
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v) + 1e-7, \
            (what, k, got["metrics"][k], v)
    assert sorted(got["grads"]) == sorted(ref["grads"]), what
    for name, rg in ref["grads"].items():
        g = got["grads"][name]
        assert g.shape == rg.shape, (what, name)
        bound = 1e-4 * max(1.0, rg.abs().max().item())
        assert (g - rg).abs().max().item() <= bound, (what, name)
        p, rp = got["params"][name], ref["params"][name]
        diff = (p - rp).abs()
        assert (diff <= ADAM_BOUND + 1e-6 * rp.abs()).all(), (what, name)
        firm = rg.abs() > max(STEP_G_FLOOR * rg.abs().max().item(), 1e-6)
        assert (diff[firm] <= 1e-6 * torch.clamp(rp.abs()[firm],
                                                 min=1.0)).all(), \
            (what, name)
    if norm:
        assert abs(got["norm"] - ref["norm"]) <= 1e-4 * ref["norm"], what


def _load(tmp, prefix, n):
    return [torch.load(os.path.join(tmp, f"{prefix}_{r}.pt"),
                       weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank programs (2 and 4 ranks) and the one-process references,
    at the same time."""
    tmp = str(tmp_path_factory.mktemp("multiproc"))
    # The one-process checkpoint the 2-rank FSDP state loads: one step in.
    state = ranks.oetr_state("linear:cuda", dropout=True)
    step = ptr.make_train_step(**ranks.LOSSES)
    state, _ = step(state, ptr.batch_to(ranks.oetr_batch(), "cpu"),
                    torch.Generator().manual_seed(8))
    ptr.save_checkpoint(os.path.join(tmp, "ckpt_a"), state)
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(spawn, ranks.prog_two, 2, "cpu",
                          os.path.join(tmp, "rdv2"), (tmp,), 1)
        four = pool.submit(spawn, ranks.prog_four, 4, "cpu",
                           os.path.join(tmp, "rdv4"), (tmp,), 1)
        refs = {"dp": ranks.oetr_step(None),
                "dp_dropout": ranks.oetr_step(None, dropout=True),
                "linear": ranks.oetr_step(None, attention="linear"),
                "matching": ranks.matching_steps(None)}
        two.result()
        four.result()
    return tmp, refs, _load(tmp, "two", 2), _load(tmp, "four", 4)


@pytest.mark.parametrize("case", ["dp", "dp_dropout"])
def test_oetr_step_data_parallel_matches_one_process(runs, case):
    """DDP over 2 ranks (K2 and K3 switched on, their plain versions
    here), the valid pairs 1 and 2: the global batch's step; with the
    decoder's dropout on, each rank keeps its rows of the global masks."""
    _, refs, two, _ = runs
    for r, got in enumerate(two):
        _check_step(got[case], refs[case], (case, r))
    assert two[0][case]["metrics"] == two[1][case]["metrics"]


@pytest.mark.parametrize("case", ["tp_fsdp", "dp_tp"])
def test_oetr_step_tensor_parallel_matches_one_process(runs, case):
    """4 ranks, data 1 x model 2 x fsdp 2 and data 2 x model 2 (attention
    'linear': Megatron splits of q/k/v, merge, Dense_0/1; FSDP2 over the
    rest), against the one-process step; the gradient norm of the whole
    gradient."""
    _, refs, _, four = runs
    for r, got in enumerate(four):
        _check_step(got[case], refs["linear"], (case, r))


def test_k2_refuses_a_model_axis(runs):
    _, _, _, four = runs
    for got in four:
        assert "linear:cuda" in got["k2_tp_error"]
        assert "K2" in got["k2_tp_error"]


@pytest.mark.parametrize("trainer", ["superpoint", "superglue", "loftr"])
def test_matching_steps_data_parallel_match_one_process(runs, trainer):
    _, refs, two, _ = runs
    for r, got in enumerate(two):
        _check_step(got["matching"][trainer], refs["matching"][trainer],
                    (trainer, r), norm=False)


def _saved(ckpt_dir, step):
    """The checkpoint ``{ckpt_dir}/step_{step}`` (JAX's TrainState layout)
    as the port's state dicts, keyed by parameter name."""
    from oetr_tpu_torch.interop import flax_state_dict, read_checkpoint

    tree = read_checkpoint(os.path.join(ckpt_dir, f"step_{step}"))
    model = port.build_oetr(ranks.oetr_cfg("linear:cuda"), device="meta")
    adam = tree["opt_state"][0]
    mu, nu = (flax_state_dict(adam[k], model) for k in ("mu", "nu"))
    count = torch.tensor(float(adam["count"]))
    return {"step": int(tree["step"]),
            "model": flax_state_dict(tree["params"], model),
            "optimizer": {"state": {k: {"exp_avg": mu[k], "exp_avg_sq": nu[k],
                                        "step": count} for k in mu}},
            "scheduler": {"count": int(tree["opt_state"][2]["count"])}}


def test_checkpoint_crosses_layouts_bit_equal(runs):
    """A one-process checkpoint loaded on 2 FSDP ranks gathers back to the
    same bits; the checkpoint those ranks write after a step loads into
    one process bit for bit, and holds the one-process step's values."""
    tmp, _, _, _ = runs
    a = _saved(os.path.join(tmp, "ckpt_a"), 1)
    loaded = torch.load(os.path.join(tmp, "loaded.pt"), weights_only=True)
    assert torch.load(os.path.join(tmp, "k2_cache_dropped.pt"))
    for k, v in a["model"].items():
        assert torch.equal(loaded["model"][k], v), k
    for k, st in a["optimizer"]["state"].items():
        for kk in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(loaded["optimizer"]["state"][k][kk],
                               st[kk]), (k, kk)

    b_path = os.path.join(tmp, "ckpt_b")
    b = _saved(b_path, 2)
    assert b["step"] == 2 and b["scheduler"]["count"] == 2
    one = ptr.load_checkpoint(b_path, 2, ranks.oetr_state("linear:cuda",
                                                          dropout=True))
    assert one.step == 2
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, b["model"][k]), k
    want = ptr.load_checkpoint(os.path.join(tmp, "ckpt_a"), 1,
                               ranks.oetr_state("linear:cuda", dropout=True))
    step = ptr.make_train_step(**ranks.LOSSES)
    want, _ = step(want, ptr.batch_to(ranks.oetr_batch(9), "cpu"),
                   torch.Generator().manual_seed(8))
    for k, v in want.model.state_dict().items():
        diff = (b["model"][k] - v).abs()
        assert (diff <= ADAM_BOUND + 1e-6 * v.abs()).all(), k


def test_dryrun_multichip_four_ranks(runs):
    _, _, _, four = runs
    outs = [g["dryrun"] for g in four]
    for out in outs:
        assert out == outs[0]
        for k, v in out.items():
            assert np.isfinite(v), k
        assert out["pipeline_matches"] > 0
        assert out["pipeline_err"] < 1e-4


def test_asking_for_the_card_without_one_raises():
    from oetr_tpu_torch.parallel import initialize_distributed, make_mesh
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        initialize_distributed("file:///nonexistent", 2, 0)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        make_mesh({"data": 1})


def test_cli_runs_one_step_on_two_ranks(tmp_path):
    """The command line on 2 ranks with --tp 2 (data 1 x model 2: the
    encoder in plain 'linear'), a file rendezvous through --coordinator:
    one step of the flagship on 2 pairs, rank 0 alone logs and writes the
    checkpoint, which one process then loads."""
    from oetr_tpu_torch.data.synthetic import generate_scene
    base = str(tmp_path / "scene")
    pairs = generate_scene(base, n_pairs=2, image_hw=64, max_shift_px=8,
                           seed=3)
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "oetr_tpu_torch.training.cli",
         "--base_path", base, "--train_pairs", pairs, "--device", "cpu",
         "--batch_size", "2", "--image_size", "64", "--pairs_per_epoch",
         "0", "--epochs", "1", "--save_path", ckpt, "--log_every", "1",
         "--tp", "2", "--coordinator", f"file://{tmp_path}/rdv",
         "--num_processes", "2", "--process_id", str(r)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    log0, log1 = outs[0][1], outs[1][1]
    assert "2 processes, mesh" in log0
    assert "epoch 0 it 0 loss" in log0
    assert "epoch 0 checkpointed at step 1" in log0
    assert "INFO" not in log1
    assert os.listdir(ckpt) == ["step_1"]
    _, state = ptr.create_train_state(
        port.oetr_r50_kernels_config("float32", attention="linear"),
        port.TrainConfig(image_size=(64, 64)), device="cpu")
    state = ptr.load_checkpoint(ckpt, 1, state)
    assert state.step == 1 and state.scheduler.count == 1
