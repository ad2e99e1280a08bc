"""The matching demo's ``--ckpt_dir`` in JAX's layout, both ways, on the CPU.

JAX's ``scripts/train_matching_demo.py`` keeps, under ``--ckpt_dir``, its
phases' final parameters (``superpoint``: the ``SuperPointNet`` tree,
``superglue``) with orbax, and their segment states ``{"params", "opt",
"step"}`` with ``opt`` the state of ``optax.chain(clip_by_global_norm(1.0),
adam(piecewise_constant_schedule(lr, {0.7·steps: 0.1})))``:

  JAX -> port   states saved by orbax's ``StandardCheckpointer`` (JAX's
                script's saver) restored by the port's ``common.restore``
                and ``load_final``: parameters, Adam's moments, the steps,
                the schedule's count and the step bit-equal
  port -> JAX   the port's ``saver`` and ``save_final`` restored by orbax
                with JAX's templates (``tx.init``): bit-equal
  shipped       the port's demo run with ``--ckpt_dir
                <root>/.ckpt_matching_r5`` at the shipped widths; JAX's
                ``build_shipped_model`` and the port's load what it
                trained, equal to its final parameters
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from oetr_tpu.models.superglue import SuperGlue
from oetr_tpu.models.superpoint import SuperPointNet
from oetr_tpu_torch import interop
from oetr_tpu_torch.models.superglue import build_superglue
from oetr_tpu_torch.models.superpoint import build_superpoint_net
from oetr_tpu_torch.scripts import common
from oetr_tpu_torch.scripts import train_matching_demo as match_demo
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

D = 32
STEPS = 10


def _tx(lr):
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.piecewise_constant_schedule(lr, {int(STEPS * 0.7): 0.1})))


def _sp_shapes():
    return jax.eval_shape(SuperPointNet(descriptor_dim=D).init,
                          jax.random.key(0), jnp.zeros((1, 64, 64, 1)))


def _sg_shapes(desc=D, k=8):
    data = {"keypoints0": jnp.zeros((1, k, 2)),
            "keypoints1": jnp.zeros((1, k, 2)),
            "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
            "descriptors0": jnp.zeros((1, k, desc)),
            "descriptors1": jnp.zeros((1, k, desc)),
            "valid0": jnp.ones((1, k), bool), "valid1": jnp.ones((1, k), bool)}
    return jax.eval_shape(lambda kk, dd: SuperGlue(descriptor_dim=desc).init(
        kk, dict(dd, image_hw0=(64, 64), image_hw1=(64, 64))),
        jax.random.key(0), data)


def _jax_segment_state(params, lr, step, seed):
    """JAX's script's segment state at ``step``: seeded moments."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(jnp.asarray, params)
    empty, (adam, sched) = _tx(lr).init(params)
    draw = lambda p, s: jnp.asarray((s * rng.standard_normal(p.shape))
                                    .astype(np.float32))
    adam = adam._replace(count=jnp.int32(step),
                         mu=jax.tree.map(lambda p: draw(p, 1e-3), params),
                         nu=jax.tree.map(lambda p: jnp.abs(draw(p, 1e-5)),
                                         params))
    return {"params": params, "step": jnp.int32(step),
            "opt": (empty, (adam, sched._replace(count=jnp.int32(step))))}


def _same(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def test_jax_states_restore_into_the_port(tmp_path):
    with jax.enable_x64(False):
        sp_params = seeded_params(_sp_shapes(), seed=1)
        sg_params = seeded_params(_sg_shapes(), seed=2)
        jstate = _jax_segment_state(sp_params, match_demo.SP_LR, 3, 4)
        ck = ocp.StandardCheckpointer()
        ck.save(str(tmp_path / "superpoint_state"), jstate)
        ck.save(str(tmp_path / "superglue"),
                jax.tree.map(jnp.asarray, sg_params))
        ck.wait_until_finished()
    net = build_superpoint_net(device="cpu", descriptor_dim=D)
    opt, sched = common.adam(net, match_demo.SP_LR, STEPS)
    assert common.restore(str(tmp_path / "superpoint_state"), net, opt,
                          sched) == 3
    conv = lambda t: interop.convert_superpoint_net_params(
        jax.tree.map(np.asarray, t), descriptor_dim=D)
    _same(net.state_dict(), conv(sp_params), "params")
    adam = jstate["opt"][1][0]
    mu, nu = conv(adam.mu), conv(adam.nu)
    for name, p in net.named_parameters():
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == 3.0
    assert sched.count == 3
    assert opt.param_groups[0]["lr"] == float(np.float32(match_demo.SP_LR))

    sg = build_superglue(device="cpu", descriptor_dim=D)
    assert common.load_final(str(tmp_path / "superglue"), sg)
    _same(sg.state_dict(), interop.convert_superglue_params(
        sg_params, descriptor_dim=D), "superglue")
    assert not common.load_final(str(tmp_path / "absent"), sg)


def test_port_states_restore_into_jax(tmp_path):
    net = build_superpoint_net(device="cpu", descriptor_dim=D,
                               generator=torch.Generator().manual_seed(3))
    opt, sched = common.adam(net, match_demo.SP_LR, STEPS)
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        sched.step()
    common.saver(str(tmp_path / "superpoint_state"), net, opt, sched)(2)
    # Saved again: the old one moves aside and goes.
    common.saver(str(tmp_path / "superpoint_state"), net, opt, sched)(2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["superpoint_state"]
    sg = build_superglue(device="cpu", descriptor_dim=D,
                         generator=torch.Generator().manual_seed(5))
    common.save_final(str(tmp_path / "superglue"), sg)

    with jax.enable_x64(False):
        dev = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
        tmpl = lambda shapes: jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=dev),
            shapes)
        sp = tmpl(_sp_shapes())
        target = {"params": sp, "step": jax.ShapeDtypeStruct(
            (), jnp.int32, sharding=dev),
            "opt": tmpl(jax.eval_shape(_tx(match_demo.SP_LR).init, sp))}
        ck = ocp.StandardCheckpointer()
        state = ck.restore(str(tmp_path / "superpoint_state"), target)
        sg_params = ck.restore(str(tmp_path / "superglue"),
                               tmpl(_sg_shapes()))
    assert int(state["step"]) == 2
    adam, sched_state = state["opt"][1]
    assert int(adam.count) == int(sched_state.count) == 2
    conv = lambda t: interop.convert_superpoint_net_params(
        jax.tree.map(np.asarray, t), descriptor_dim=D)
    _same(conv(state["params"]), net.state_dict(), "params")
    mu, nu = conv(adam.mu), conv(adam.nu)
    for name, p in net.named_parameters():
        assert torch.equal(mu[name], opt.state[p]["exp_avg"]), name
        assert torch.equal(nu[name], opt.state[p]["exp_avg_sq"]), name
    _same(interop.convert_superglue_params(
        jax.tree.map(np.asarray, sg_params), descriptor_dim=D),
        sg.state_dict(), "superglue")


def test_shipped_models_load_the_ports_demo(tmp_path):
    """The port's demo trains into ``<root>/.ckpt_matching_r5``; both
    ``build_shipped_model``s read it."""
    from oetr_tpu.pipelines.api import build_shipped_model as jax_shipped
    from oetr_tpu_torch.pipelines.api import build_shipped_model

    ckpt = tmp_path / ".ckpt_matching_r5"
    argv = ["--sp_steps", "1", "--sg_steps", "1", "--sp_batch", "2",
            "--sg_batch", "2", "--sp_hw", "64", "--hw", "64", "--topk", "64",
            "--train_pairs", "2", "--val_pairs", "1", "--device_data",
            "--device", "cpu", "--ckpt_dir", str(ckpt)]
    out = match_demo.run(match_demo.parse_args(argv), argv,
                         str(tmp_path / "scenes"))
    assert out["sp_steps"] == 1
    sp_tree = interop.read_checkpoint(ckpt / "superpoint")
    sg_tree = interop.read_checkpoint(ckpt / "superglue")
    pipe, _ = build_shipped_model("superglue", ckpt_root=str(tmp_path),
                                  device="cpu")
    _same({k.removeprefix("net."): v for k, v in
           pipe.extractor.state_dict().items()},
          interop.convert_superpoint_net_params(sp_tree, descriptor_dim=128),
          "superpoint")
    with jax.enable_x64(False):
        jpipe, conf = jax_shipped("superglue", ckpt_root=str(tmp_path))
    assert conf["matcher"] == "superglue"
    got = jax.tree_util.tree_flatten_with_path(
        jpipe.extractor_params["params"]["net"])[0]
    want = jax.tree_util.tree_flatten_with_path(sp_tree["params"])[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert np.asarray(a).tobytes() == b.tobytes(), k


@pytest.mark.parametrize("layout", ["foreign_chain", "missing_moment"])
def test_a_foreign_segment_state_raises(tmp_path, layout):
    net = build_superpoint_net(device="cpu", descriptor_dim=D)
    opt, sched = common.adam(net, match_demo.SP_LR, STEPS)
    common.saver(str(tmp_path / "s"), net, opt, sched)(1)
    tree = interop.read_checkpoint(tmp_path / "s")
    if layout == "foreign_chain":
        tree["opt"] = tree["opt"][1]          # adam alone, no clip
    else:
        del tree["opt"][1][0]["nu"]
    interop.write_checkpoint(tmp_path / "s", tree)
    with pytest.raises(ValueError):
        common.restore(str(tmp_path / "s"), net, opt, sched)
