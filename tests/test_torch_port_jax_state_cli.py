"""The port's programs on states that JAX's ``save_checkpoint`` wrote (orbax),
and JAX's ``load_checkpoint`` on what they write, on the CPU:

  * ``python -m oetr_tpu_torch.training.cli --resume`` on a ``--save_path``
    holding JAX's flagship ``TrainState`` at step 1 (4 pairs, batch 2: 2
    steps an epoch): it resumes at JAX's epoch and iteration (epoch 0, it
    1), trains to step 4 and writes ``step_2`` and ``step_4``, which JAX's
    ``load_checkpoint`` restores with ``create_train_state``'s target: the
    step, the counts, and parameters bit-equal to the port's reader's;
  * ``pipelines/demo.py --checkpoint`` on JAX's flagship state: the boxes
    of the port's model with JAX's parameters;
  * ``scripts/overlap_ab_demo --ckpt_dir`` on JAX's state of its small
    OETR at step 2: resumed, one step, ``step_3`` restored by JAX.

JAX's states hold the port's seeded initial weights (``to_flax``) and
Adam moments drawn from a seed, written by JAX's own ``save_checkpoint``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.config import TrainConfig as JTrainConfig
from oetr_tpu.data.synthetic import generate_scene
from oetr_tpu.training import train as jt
from oetr_tpu_torch.interop import read_checkpoint, to_flax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64


def _jax_state(pcfg, step, seed):
    """JAX's TrainState at ``step`` of the model ``pcfg`` ports: the port's
    seeded weights, seeded moments, every count ``step``."""
    model = port.build_oetr(pcfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    params = jax.tree.map(jnp.asarray, to_flax(model.state_dict(), model))
    rng = np.random.default_rng(seed)
    draw = lambda p, s: jnp.asarray((s * rng.standard_normal(p.shape))
                                    .astype(np.float32))
    tx = jt.make_optimizer(JTrainConfig(), 1)
    adam, empty, sched = tx.init(params)
    adam = adam._replace(count=jnp.int32(step),
                         mu=jax.tree.map(lambda p: draw(p, 1e-3), params),
                         nu=jax.tree.map(lambda p: jnp.abs(draw(p, 1e-5)),
                                         params))
    sched = sched._replace(count=jnp.int32(step))
    return jt.TrainState(step=jnp.int32(step), params=params,
                         opt_state=(adam, empty, sched))


def _target(jcfg, hw):
    """JAX's restore target for ``jcfg``: ``create_train_state``'s shapes
    on the CPU device."""
    dev = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    shapes = jax.eval_shape(lambda: jt.create_train_state(
        jcfg, JTrainConfig(), jax.random.key(0), (hw, hw))[1])
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                       sharding=dev), shapes)


def _same_params(jtree, ptree):
    fj = jax.tree_util.tree_flatten_with_path(jtree)[0]
    fp = jax.tree_util.tree_flatten_with_path(ptree)[0]
    assert [jax.tree_util.keystr(k) for k, _ in fj] == \
        [jax.tree_util.keystr(k) for k, _ in fp]
    for (k, a), (_, b) in zip(fj, fp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """A save path holding JAX's flagship state at step 1."""
    base = tmp_path_factory.mktemp("jax_flagship")
    with jax.enable_x64(False):
        state = _jax_state(port.oetr_r50_config(), 1, 3)
        jt.save_checkpoint(str(base / "ckpt"), state)
    return base / "ckpt"


def test_cli_resumes_a_jax_save_path(flagship, tmp_path):
    import shutil

    save = tmp_path / "ckpt"
    shutil.copytree(flagship, save)
    scene = tmp_path / "scene"
    pairs = generate_scene(str(scene), n_pairs=4, image_hw=HW,
                           max_shift_px=8, seed=3, scale_range=(1.0, 1.6))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "oetr_tpu_torch.training.cli",
         "--base_path", str(scene), "--train_pairs", pairs, "--device",
         "cpu", "--batch_size", "2", "--image_size", str(HW),
         "--pairs_per_epoch", "0", "--epochs", "2", "--save_path", str(save),
         "--log_every", "1", "--resume"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "resumed from step 1 (epoch 0, it 1)" in run.stderr
    assert "epoch 0 checkpointed at step 2" in run.stderr
    assert "epoch 1 checkpointed at step 4" in run.stderr
    assert sorted(os.listdir(save)) == ["step_1", "step_2", "step_4"]
    ours = read_checkpoint(save / "step_4")
    with jax.enable_x64(False):
        back = jt.load_checkpoint(str(save), 4, _target(OETRConfig(), HW))
    assert int(back.step) == 4
    assert int(back.opt_state[0].count) == int(back.opt_state[2].count) == 4
    _same_params(back.params, ours["params"])
    _same_params(back.opt_state[0].nu, ours["opt_state"][0]["nu"])


def test_pipelines_demo_reads_a_jax_state(flagship, tmp_path, capsys):
    import cv2

    from oetr_tpu_torch.interop import convert_flax_params
    from oetr_tpu_torch.pipelines import demo

    rng = np.random.default_rng(4)
    data = tmp_path / "imgs"
    os.makedirs(data)
    for n in ("a.jpg", "b.jpg"):
        cv2.imwrite(str(data / n), rng.integers(0, 255, (90, 120, 3),
                                                dtype=np.uint8))
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("a.jpg b.jpg\n")
    size = 128
    demo.main(["--pairs", str(pairs), "--data", str(data), "--checkpoint",
               str(flagship), "--step", "1", "--out", str(tmp_path / "viz"),
               "--size", str(size), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "box0" in printed

    from oetr_tpu_torch.data.images import prepare_image, read_image
    cfg = port.OETRConfig()
    model = port.build_oetr(cfg, device="cpu")
    model.load_state_dict(convert_flax_params(
        read_checkpoint(flagship / "step_1")["params"], cfg))
    p = [prepare_image(read_image(str(data / n)), (size, size), (size, size))
         for n in ("a.jpg", "b.jpg")]
    with torch.no_grad():
        out = model(*(torch.from_numpy(x.oetr_image)[None] for x in p))
    assert f"box0 {np.round(out['pred_bbox1'][0].numpy(), 1)}" in printed


def test_overlap_ab_demo_resumes_a_jax_state(tmp_path):
    from oetr_tpu_torch.scripts import overlap_ab_demo

    argv = ["--steps", "3", "--batch", "2", "--train_pairs", "4",
            "--val_pairs", "2", "--hw", "64", "--ckpt_dir",
            str(tmp_path / "ab"), "--skip_eval", "--device", "cpu",
            "--data_dir", str(tmp_path / "data")]
    args = overlap_ab_demo.parse_args(argv)
    tokens = args.hw // 32
    jcfg = OETRConfig(
        backbone=BackboneConfig(depth=args.depth, stop_layer="layer3",
                                last_layer=256),
        neck=NeckConfig(d_model=args.d_model, nhead=8, num_layers=args.layers,
                        num_decoder_layers=args.dec_layers,
                        max_shape=(tokens, tokens)))
    with jax.enable_x64(False):
        jt.save_checkpoint(str(tmp_path / "ab"), _jax_state(
            overlap_ab_demo.model_config(args), 2, 5))
    out = overlap_ab_demo.run(args)
    assert out["steps"] == 3
    assert sorted(os.listdir(tmp_path / "ab")) == ["step_2", "step_3"]
    with jax.enable_x64(False):
        back = jt.load_checkpoint(str(tmp_path / "ab"), 3,
                                  _target(jcfg, args.hw))
    assert int(back.step) == 3 and int(back.opt_state[0].count) == 3
    _same_params(back.params,
                 read_checkpoint(tmp_path / "ab" / "step_3")["params"])
