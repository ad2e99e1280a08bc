"""JAX's orbax train states in the port and the port's in JAX, on the CPU,
in float32, at a small OETR (ResNet18 to layer3, d 64, 128²), dropout off
on both sides (flax's ``Dropout.__call__`` patched to the identity, the
port's rate 0).

  JAX -> port   JAX's ``save_checkpoint`` after 2 JAX steps, the port's
                ``load_checkpoint``: parameters, ``exp_avg``,
                ``exp_avg_sq``, the steps and the schedule's count
                bit-equal to JAX's, converted; then the port's step 3
                against JAX's step 3
  port -> JAX   the port saves after 2 port steps, JAX's
                ``load_checkpoint`` with ``create_train_state``'s target:
                bit-equal; JAX's step 3 against the port's
  step 3        the train-step parity row's bounds: the rate equal (the
                schedule drops at count 2, the step resumed), each metric
                1e-5 relative, each gradient 1e-4 of max(1, its largest
                |ref|) (JAX's from its Adam moments: g = (mu3 - b1·mu2) /
                (1 - b1)), or twice JAX's own spread where that is wider,
                each parameter within 2·rate and, where |g| is clear of
                rounding (above 1e-2 of its largest, and moved by less than
                1e-3 of itself in JAX's own spread), 1e-6 of max(1, |p|)

JAX's own spread: its step 3 from the same state with the first images
moved by one ulp. At JAX's step-2 parameters its backbone gradients move
by up to 1.3e-3 so (a point where the loss is ill-conditioned in f32: at
the port's step-2 parameters the spread is 4e-7), and the port's differ
from JAX's by the same 1.3e-3.

and ``read_checkpoint`` equal to orbax's restore without a target on
JAX's state; the port's earlier torch ``step_N`` file still read; and a
missing leaf, an extra leaf, a wrong shape, unequal torch steps and
another optax chain each refused. (The writer on mixed trees, the
flagship's tree and ``to_flax``: ``test_torch_port_jax_state_trees.py``.)
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.config import TrainConfig as JTrainConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.training import train as jt
from oetr_tpu_torch.interop import (convert_flax_params, read_checkpoint,
                                    write_checkpoint)
from oetr_tpu_torch.models.transformer import Dropout
from oetr_tpu_torch.training import train as ptr
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

HW = 128
BB = dict(depth=18, stop_layer="layer3", last_layer=256)
NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1,
            max_shape=(4, 4))
MILESTONES = (2,)          # the rate drops at count 2: the resumed step
LR = 1e-4
B1 = np.float32(0.9)
STEP_G_FLOOR = 1e-2


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32),
            "image2": rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32),
            "overlap_box1": np.array([[8.0, 12, 120, 100], [20, 4, 80, 124]],
                                     np.float32)[:b],
            "overlap_box2": np.array([[16.0, 16, 112, 112], [0, 40, 60, 128]],
                                     np.float32)[:b],
            "overlap_valid": np.array([True, True])[:b]}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _jax_state(params, tx):
    p = jax.tree.map(jnp.asarray, params)
    return jt.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                         opt_state=tx.init(p))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    assert got.tobytes() == want.tobytes(), what


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both directions: JAX's steps 1-3 (a checkpoint after 2), the port's
    steps 1-2 from the same initial parameters (a checkpoint after 2), and
    JAX's step 3 from the port's checkpoint; one jitted JAX step."""
    tmp = tmp_path_factory.mktemp("jax_state")
    jcfg = OETRConfig(backbone=BackboneConfig(**BB), neck=NeckConfig(**NECK))
    pcfg = port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=True, **BB),
        neck=port.NeckConfig(attention="linear:cuda", **NECK))
    batches = [_batch(20 + i) for i in range(3)]
    out = {"pcfg": pcfg, "batches": batches, "tmp": tmp}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jmodel = build_oetr(jcfg)
        zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
        params = seeded_params(jax.eval_shape(jmodel.init, jax.random.key(0),
                                              zeros, zeros), seed=4)
        tx = jt.make_optimizer(JTrainConfig(lr=LR, lr_milestones=MILESTONES),
                               steps_per_epoch=1)
        step = jt.make_train_step(jmodel, tx, cycle=True)
        key = jax.random.key(0)
        nudged = jax.tree.map(jnp.asarray, dict(
            batches[2], image1=np.nextafter(batches[2]["image1"],
                                            np.float32(2))))
        state = _jax_state(params, tx)
        for b in batches[:2]:
            state, _ = step(state, jax.tree.map(jnp.asarray, b), key)
        jt.save_checkpoint(str(tmp / "jax"), state)
        out["jax2"] = _np_tree(state)
        out["jax3_nudged"] = _np_tree(step(
            jax.tree.map(jnp.asarray, out["jax2"]), nudged, key)[0])
        state, m = step(state, jax.tree.map(jnp.asarray, batches[2]), key)
        out["jax3"], out["jax3_metrics"] = _np_tree(state), _np_tree(m)

        # The port's two steps from the same parameters, saved.
        model, pstate = _port_state(pcfg)
        model.load_state_dict(convert_flax_params(params, pcfg))
        pstep = ptr.make_train_step(cycle=True)
        for b in batches[:2]:
            pstate, _ = pstep(pstate, ptr.batch_to(b, "cpu"), None)
        ptr.save_checkpoint(str(tmp / "port"), pstate)
        out["port2"] = pstate
        loaded = jt.load_checkpoint(str(tmp / "port"), 2,
                                    _jax_state(params, tx))
        out["jax_loaded"] = _np_tree(loaded)
        out["jax3b_nudged"] = _np_tree(step(
            jax.tree.map(jnp.asarray, out["jax_loaded"]), nudged, key)[0])
        state, m = step(loaded, jax.tree.map(jnp.asarray, batches[2]), key)
        out["jax3b"], out["jax3b_metrics"] = _np_tree(state), _np_tree(m)
    return out


def _port_state(pcfg):
    model, state = ptr.create_train_state(
        pcfg, port.TrainConfig(lr=LR, lr_milestones=MILESTONES),
        device="cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model, state


def _optimizer_states(state):
    return {n: state.optimizer.state[p]
            for n, p in state.model.named_parameters()}


def _hold_equal(pstate, jtree, pcfg):
    """The port's state bit-equal to JAX's tree, converted."""
    assert pstate.step == int(jtree.step)
    adam, _, sched = jtree.opt_state
    assert pstate.scheduler.count == int(sched.count) == int(adam.count)
    params = convert_flax_params(jtree.params, pcfg)
    mu = convert_flax_params(adam.mu, pcfg)
    nu = convert_flax_params(adam.nu, pcfg)
    opt = _optimizer_states(pstate)
    for name, p in pstate.model.named_parameters():
        _same_bits(p.detach().numpy(), params[name].numpy(), name)
        _same_bits(opt[name]["exp_avg"].numpy(), mu[name].numpy(), name)
        _same_bits(opt[name]["exp_avg_sq"].numpy(), nu[name].numpy(), name)
        assert opt[name]["step"].dtype == torch.float32
        assert float(opt[name]["step"]) == int(adam.count), name


def _step3(pstate, batch):
    """The port's step 3: (state, metrics, the rate it took)."""
    rate = pstate.optimizer.param_groups[0]["lr"]
    pstate, metrics = ptr.make_train_step(cycle=True)(
        pstate, ptr.batch_to(batch, "cpu"), None)
    assert pstate.step == 3
    return pstate, metrics, rate


def _jax_grads(j2, j3, pcfg):
    """JAX's step-3 gradient from its Adam moments, in the port's names."""
    return convert_flax_params(jax.tree.map(
        lambda a, b: ((b.astype(np.float64) - B1 * a.astype(np.float64))
                      / (1 - B1)).astype(np.float32),
        j2.opt_state[0].mu, j3.opt_state[0].mu), pcfg)


def _hold_step3(pstate, pmetrics, rate, j2, j3, jmetrics, j3_nudged, pcfg):
    """The port's step 3 against JAX's, from equal states: the rate is
    optax's at count 2, past the milestone."""
    with jax.enable_x64(False):
        want = jt.multistep_schedule(
            JTrainConfig(lr=LR, lr_milestones=MILESTONES), 1)(2)
    assert np.float32(rate) == np.float32(want) < np.float32(LR)
    assert sorted(pmetrics) == sorted(jmetrics)
    for k in pmetrics:
        np.testing.assert_allclose(pmetrics[k].numpy(), jmetrics[k],
                                   rtol=1e-5, atol=0, err_msg=k)
    ref_g = _jax_grads(j2, j3, pcfg)
    own = _jax_grads(j2, j3_nudged, pcfg)
    ref_p = convert_flax_params(j3.params, pcfg)
    for name, p in pstate.model.named_parameters():
        g, rg = p.grad, ref_g[name]
        bound = max(1e-4 * max(1.0, rg.abs().max().item()),
                    2 * (own[name] - rg).abs().max().item())
        assert (g - rg).abs().max().item() <= bound, name
        diff = (p.detach() - ref_p[name]).abs()
        assert (diff <= 2 * rate + 1e-6 * ref_p[name].abs()).all(), name
        firm = (rg.abs() > max(STEP_G_FLOOR * rg.abs().max().item(), 1e-6)) \
            & ((own[name] - rg).abs() <= 1e-3 * rg.abs())
        assert (diff[firm] <= 1e-6 * torch.clamp(ref_p[name].abs()[firm],
                                                 min=1.0)).all(), name


def test_jax_state_loads_into_the_port_bit_equal(run):
    model, state = _port_state(run["pcfg"])
    state = ptr.load_checkpoint(str(run["tmp"] / "jax"), 2, state)
    _hold_equal(state, run["jax2"], run["pcfg"])
    _hold_step3(*_step3(state, run["batches"][2]), run["jax2"], run["jax3"],
                run["jax3_metrics"], run["jax3_nudged"], run["pcfg"])


def test_port_state_loads_into_jax_bit_equal(run):
    _, pstate = _port_state(run["pcfg"])
    pstate = ptr.load_checkpoint(str(run["tmp"] / "port"), 2, pstate)
    _hold_equal(pstate, run["jax_loaded"], run["pcfg"])
    _hold_step3(*_step3(pstate, run["batches"][2]), run["jax_loaded"],
                run["jax3b"], run["jax3b_metrics"], run["jax3b_nudged"],
                run["pcfg"])


def test_read_checkpoint_equals_orbax_restore(run):
    """JAX's state read by the port: optax's tuples as lists, its
    EmptyState as None, every array's bits, as orbax restores it with no
    target."""
    path = str(run["tmp"] / "jax" / "step_2")
    with jax.enable_x64(False):
        want = ocp.StandardCheckpointer().restore(path)
    got = read_checkpoint(path)
    assert isinstance(got["opt_state"], list) and got["opt_state"][1] is None
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    fw, fg = _flat(want), _flat(got)
    assert list(fw) == list(fg)
    for k in fw:
        _same_bits(fg[k], np.asarray(fw[k]), k)


def test_old_torch_checkpoint_still_loads(run, tmp_path):
    """A ``step_N`` file in the port's earlier torch layout."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict)

    src = run["port2"]
    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    torch.save({"step": src.step,
                "model": get_model_state_dict(src.model, options=opts),
                "optimizer": get_optimizer_state_dict(src.model,
                                                      src.optimizer,
                                                      options=opts),
                "scheduler": src.scheduler.state_dict()},
               tmp_path / "step_2")
    assert ptr.latest_checkpoint_step(str(tmp_path)) == 2
    _, state = _port_state(run["pcfg"])
    state = ptr.load_checkpoint(str(tmp_path), 2, state)
    assert state.step == 2 and state.scheduler.count == 2
    want, got = _optimizer_states(src), _optimizer_states(state)
    for name, p in src.model.named_parameters():
        assert torch.equal(dict(state.model.named_parameters())[name], p)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[name][k], want[name][k]), (name, k)


def _broken(tree, case):
    params = tree["params"]["params"]
    if case == "missing_leaf":
        del params["query_embed1"]
    elif case == "extra_leaf":
        params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    elif case == "wrong_shape":
        tree["opt_state"][0]["mu"]["params"]["query_embed1"] = np.zeros(
            (1, 3), np.float32)
    elif case == "foreign_chain":
        # optax.chain(clip_by_global_norm, adam): (EmptyState, (adam, sched))
        tree["opt_state"] = [None, [tree["opt_state"][0],
                                    tree["opt_state"][2]]]
    elif case == "no_empty_state":
        tree["opt_state"][1] = {"count": np.int32(2)}
    return tree


@pytest.mark.parametrize("case", ["missing_leaf", "extra_leaf",
                                  "wrong_shape", "foreign_chain",
                                  "no_empty_state"])
def test_a_bad_state_raises(run, tmp_path, case):
    tree = _broken(ptr.train_state_tree(run["port2"]), case)
    write_checkpoint(tmp_path / "step_2", tree)
    _, state = _port_state(run["pcfg"])
    with pytest.raises((KeyError, ValueError)):
        ptr.load_checkpoint(str(tmp_path), 2, state)


def test_unequal_torch_steps_raise(run):
    model, state = _port_state(run["pcfg"])
    params = list(model.parameters())
    for p in params:
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.optimizer.state[params[0]]["step"] += 1
    with pytest.raises(ValueError, match="steps"):
        ptr.train_state_tree(state)
