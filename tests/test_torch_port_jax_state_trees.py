"""The port's orbax writer and its inverse map on the CPU, with no JAX
compile:

  * ``interop.write_checkpoint`` restored by orbax bit for bit, with a
    target and without, on mixed trees: float32, int32 scalars, ``None``,
    nested sequences, values over 1024 bytes (out of line), enough keys
    to split the B-tree into interior nodes; and read back by
    ``read_checkpoint``;
  * the port's ``TrainState`` tree for ``oetr_r50_config()`` equal to
    ``jax.eval_shape`` of JAX's ``create_train_state`` in paths, shapes
    and dtypes;
  * ``interop.to_flax`` the inverse of the converters, bit for bit: the
    committed OETR, SuperPoint, SuperGlue and LoFTR stores and the fc
    config, the leaf kinds read from the modules.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import OETRConfig
from oetr_tpu.config import TrainConfig as JTrainConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.training import train as jt
from oetr_tpu_torch.interop import (convert_flax_params, read_checkpoint,
                                    to_flax, write_checkpoint)
from oetr_tpu_torch.training import train as ptr

torch.set_num_threads(2)


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    assert got.tobytes() == want.tobytes(), what


def _mixed_tree():
    rng = np.random.default_rng(5)
    tree = {"step": np.int32(7),
            "w": {"big": rng.normal(size=(40, 50)).astype(np.float32),
                  "small": rng.normal(size=(3,)).astype(np.float32)},
            "opt": [None, [{"count": np.int32(3),
                            "mu": {"x": np.arange(5, dtype=np.float32)}},
                           {"count": np.int32(3)}]],
            "ints": np.arange(6, dtype=np.int32).reshape(2, 3),
            "scalar": np.float32(-1.5),
            # Indices past 9, which sort as strings out of index order.
            "chain": [np.full((i % 4 + 1,), i, np.float32)
                      for i in range(12)]}
    for k in range(80):
        tree["w"][f"k{k:03d}"] = rng.normal(size=(k % 9 + 1,)).astype(
            np.float32)
    return tree


@pytest.mark.parametrize("node_bytes", [100_000_000, 700])
def test_write_checkpoint_restored_by_orbax(tmp_path, monkeypatch,
                                           node_bytes):
    """orbax restores the port's directory bit for bit, with a target and
    without; at 700 bytes a node (and 64-byte inline values) the B-tree
    has interior nodes."""
    from oetr_tpu_torch.interop import ocdbt
    from oetr_tpu_torch.interop.ocdbt import OcdbtStore

    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    monkeypatch.setattr(ocdbt, "MAX_INLINE_VALUE_BYTES",
                        1024 if node_bytes > 1e6 else 64)
    tree = _mixed_tree()
    path = tmp_path / "ck"
    write_checkpoint(path, tree)
    assert not (tmp_path / "ck.tmp").exists()
    store = OcdbtStore(path)
    assert (store.version["root_height"] > 0) == (node_bytes < 1e6)
    assert store.version["num_indirect_value_bytes"] >= 40 * 50 * 4
    with jax.enable_x64(False):
        ck = ocp.StandardCheckpointer()
        plain = ck.restore(str(path))
        dev = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
        target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            np.shape(x), np.asarray(x).dtype, sharding=dev), tree)
        targeted = ck.restore(str(path), target)
    for got in (plain, targeted, read_checkpoint(path)):
        assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
            jax.tree.structure(jax.tree.map(np.asarray, tree))
        fw, fg = _flat(tree), _flat(got)
        for k in fw:
            _same_bits(np.asarray(fg[k]), fw[k], k)
    # Written again over itself: replaced whole.
    tree["step"] = np.int32(8)
    write_checkpoint(path, tree)
    assert int(read_checkpoint(path)["step"]) == 8


def test_flagship_tree_equals_jax_train_state():
    """Paths, shapes and dtypes of the port's TrainState tree for
    ``oetr_r50_config()`` against JAX's ``create_train_state``."""
    with jax.enable_x64(False):
        want = jax.eval_shape(lambda: jt.create_train_state(
            OETRConfig(), JTrainConfig(), jax.random.key(0), (64, 64))[1])
    model, state = ptr.create_train_state(port.oetr_r50_config(),
                                          port.TrainConfig(), device="cpu")
    got = ptr.train_state_tree(state)
    assert got["opt_state"][1] is None
    kind = lambda a: f"{tuple(np.shape(a))} {np.dtype(a.dtype)}"
    norm = lambda k: k.replace(".", "").replace("[", "").replace("]", "")\
        .replace("'", "")
    fw = {norm(k): kind(v) for k, v in _flat(want).items()}
    fg = {norm(k): kind(np.asarray(v)) for k, v in _flat(got).items()}
    assert len(fw) == 3 * 292 + 3
    assert fg == fw


@pytest.mark.parametrize("case", ["flagship", "fc", "superpoint",
                                  "superglue", "loftr"])
def test_to_flax_inverts_the_converters(case):
    """``to_flax(convert(p)) == p`` bit for bit, the leaf kinds read from
    the modules."""
    from oetr_tpu_torch import interop
    from oetr_tpu_torch.models.loftr import build_loftr
    from oetr_tpu_torch.models.superglue import build_superglue
    from oetr_tpu_torch.models.superpoint import build_superpoint_net
    from test_torch_port_ocdbt import _template

    store = {"flagship": ".ckpt_oetr_r5/params",
             "superpoint": ".ckpt_matching_r5/superpoint",
             "superglue": ".ckpt_matching_r5/superglue",
             "loftr": ".ckpt_loftr_r5/loftr"}.get(case)
    if case == "fc":
        from oetr_tpu.config import oetr_fc_r50_config
        with jax.enable_x64(False):
            rgb = jnp.zeros((1, 64, 64, 3))
            shapes = jax.eval_shape(build_oetr(oetr_fc_r50_config()).init,
                                    jax.random.key(0), rgb, rgb)
        rng = np.random.default_rng(1)
        p = jax.tree.map(lambda s: rng.random(s.shape, np.float32), shapes)
        cfg = port.oetr_fc_r50_config()
        model = port.build_oetr(cfg, device="meta")
        state = convert_flax_params(p, cfg)
    else:
        p = read_checkpoint(os.path.join(os.path.dirname(__file__), "..",
                                         store))
        assert jax.tree.structure(p) == jax.tree.structure(_template(store))
        if case == "flagship":
            cfg = port.oetr_r50_kernels_config("float32")
            model = port.build_oetr(cfg, device="meta")
            state = convert_flax_params(p, cfg)
        elif case == "superpoint":
            model = build_superpoint_net(device="meta", descriptor_dim=128)
            state = interop.convert_superpoint_net_params(
                p, descriptor_dim=128)
        elif case == "superglue":
            model = build_superglue(device="meta", descriptor_dim=128)
            state = interop.convert_superglue_params(p, descriptor_dim=128)
        else:
            kw = dict(d_coarse=192, d_fine=96, coarse_layers=4)
            model = build_loftr(device="meta", **kw)
            state = interop.convert_loftr_params(p, **kw)
    back = to_flax(state, model)
    fw, fg = _flat(p), _flat(back)
    assert list(fw) == list(fg)
    for k in fw:
        _same_bits(fg[k], np.asarray(fw[k]), k)
