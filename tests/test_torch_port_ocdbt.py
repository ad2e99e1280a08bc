"""The port's checkpoint reader on the CPU: ``interop/ocdbt.py``'s
``OcdbtStore`` against tensorstore's OCDBT key-value store, and
``interop/orbax_read.py``'s ``read_checkpoint`` against orbax's restore.

  * the four committed stores: every key tensorstore lists, in order, and
    every value's bytes;
  * a store tensorstore writes here with small nodes, short inline values
    and a version-tree arity of 4 over eleven commits: interior B-tree
    nodes, out-of-line and inline values, version-tree nodes;
  * ``read_checkpoint`` on each store bit-equal, leaf by leaf (tree path,
    dtype, shape, bytes), to ``StandardCheckpointer().restore`` against a
    template of JAX's model of that store;
  * zarr arrays tensorstore writes: several chunks, an edge chunk, Fortran
    order, float64, int32, no compressor; a compressor or dtype the reader
    does not know, and a missing chunk, raise;
  * a flipped byte of a manifest or a node raises.
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts

from oetr_tpu_torch.interop.ocdbt import OcdbtStore
from oetr_tpu_torch.interop.orbax_read import read_array, read_checkpoint

ROOT = Path(__file__).resolve().parents[1]
STORES = [".ckpt_matching_r5/superpoint", ".ckpt_matching_r5/superglue",
          ".ckpt_loftr_r5/loftr", ".ckpt_oetr_r5/params"]


def _ts_store(path: Path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path.resolve()}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _assert_same_store(path: Path):
    want = _ts_store(path)
    keys = sorted(k.decode() for k in want.list().result())
    store = OcdbtStore(path)
    assert store.keys() == keys
    for k in keys:
        assert store.read(k) == bytes(want.read(k).result().value), k
    return store


@pytest.mark.parametrize("store", STORES)
def test_committed_store_equals_tensorstore(store):
    s = _assert_same_store(ROOT / store)
    assert s.version["num_keys"] == len(s.keys()) > 40


def test_written_store_with_interior_nodes(tmp_path):
    kv = _ts_store(tmp_path, max_decoded_node_bytes=600,
                   max_inline_value_bytes=64, version_tree_arity_log2=2,
                   compression={"id": "zstd", "level": 5})
    rng = np.random.default_rng(0)
    for commit in range(11):
        txn = ts.Transaction()
        for i in range(40):
            key = f"group{rng.integers(0, 5)}/item{commit:02d}_{i:03d}"
            value = rng.integers(0, 256, rng.integers(0, 200),
                                 dtype=np.uint8).tobytes()
            kv.with_transaction(txn)[key.encode()] = value
        txn.commit_async().result()
    s = _assert_same_store(tmp_path)
    assert s.version["root_height"] >= 2
    assert s.manifest["version_tree_nodes"]
    assert s.manifest["config"]["zstd_level"] == 5
    with pytest.raises(KeyError):
        s.read("group9/none")


def _template(store: str):
    """A restore template of JAX's model of ``store``: its init's shapes on
    the CPU device, with x64 off as the package runs (under the tests' x64
    its scalar and embedding parameters would be float64)."""
    with jax.enable_x64(False):
        return _template_x32(store)


def _template_x32(store: str):
    from oetr_tpu.config import oetr_r50_config
    from oetr_tpu.models import build_oetr
    from oetr_tpu.models.loftr import LoFTR
    from oetr_tpu.models.superglue import SuperGlue
    from oetr_tpu.models.superpoint import SuperPointNet

    key = jax.random.key(0)
    img = jnp.zeros((1, 64, 64, 1))
    if store.endswith("superpoint"):
        shapes = jax.eval_shape(SuperPointNet(descriptor_dim=128).init, key,
                                img)
    elif store.endswith("superglue"):
        k, d = 8, 128
        data = {"keypoints0": jnp.zeros((1, k, 2)),
                "keypoints1": jnp.zeros((1, k, 2)),
                "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
                "descriptors0": jnp.zeros((1, k, d)),
                "descriptors1": jnp.zeros((1, k, d)),
                "valid0": jnp.ones((1, k), bool),
                "valid1": jnp.ones((1, k), bool)}
        shapes = jax.eval_shape(lambda kk, dd: SuperGlue(
            descriptor_dim=d).init(kk, dict(dd, image_hw0=(64, 64),
                                            image_hw1=(64, 64))), key, data)
    elif store.endswith("loftr"):
        shapes = jax.eval_shape(LoFTR(d_coarse=192, d_fine=96,
                                      coarse_layers=4).init, key, img, img)
    else:
        rgb = jnp.zeros((1, 64, 64, 3))
        shapes = jax.eval_shape(build_oetr(oetr_r50_config()).init, key, rgb,
                                rgb)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                       sharding=sharding),
                        shapes)


@pytest.mark.parametrize("store", STORES)
def test_read_checkpoint_equals_orbax(store):
    import orbax.checkpoint as ocp

    path = str(ROOT / store)
    want = ocp.StandardCheckpointer().restore(path, _template(store))
    got = read_checkpoint(path)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray), p
        assert (g.dtype, g.shape) == (w.dtype, w.shape), p
        assert g.tobytes() == w.tobytes(), p


def _zarr(tmp_path: Path, name: str, arr: np.ndarray, chunks, **metadata):
    t = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "ocdbt",
                             "base": f"file://{tmp_path.resolve()}/"},
                 "path": name,
                 "metadata": {"shape": list(arr.shape), "chunks": chunks,
                              "dtype": arr.dtype.str, **metadata}},
                create=True).result()
    t.write(arr).result()


def test_read_array_layouts_and_refusals(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 7, 3))
    b = rng.integers(-9, 9, (6, 4)).astype(np.int32)
    c = rng.normal(size=(4,)).astype(np.float32)
    _zarr(tmp_path, "a", a, [2, 3, 3], compressor={"id": "zstd", "level": 3})
    _zarr(tmp_path, "b", b, [4, 4], order="F", compressor=None)
    _zarr(tmp_path, "c", c, [4], compressor={"id": "blosc"})
    _zarr(tmp_path, "d", c.astype(np.complex64), [4], compressor=None)
    store = OcdbtStore(tmp_path)
    np.testing.assert_array_equal(read_array(store, "a"), a)
    np.testing.assert_array_equal(read_array(store, "b"), b)
    assert read_array(store, "b").dtype == np.int32
    with pytest.raises(ValueError, match="compressor"):
        read_array(store, "c")
    with pytest.raises(ValueError, match="dtype"):
        read_array(store, "d")
    with pytest.raises(ValueError, match="no .zarray"):
        read_array(store, "e")


def test_a_missing_chunk_raises(tmp_path):
    """orbax writes every chunk (``store_array_data_equal_to_fill_value``):
    the reader takes a missing one for a damaged store, whatever the fill
    value says."""
    kv = _ts_store(tmp_path)
    meta = {"zarr_format": 2, "shape": [4, 4], "chunks": [2, 4],
            "dtype": "<f4", "order": "C", "compressor": None,
            "filters": None, "fill_value": 0.0}
    kv[b"x/.zarray"] = json.dumps(meta).encode()
    kv[b"x/0.0"] = np.arange(8, dtype="<f4").tobytes()
    with pytest.raises(ValueError, match="missing"):
        read_array(OcdbtStore(tmp_path), "x")
    kv[b"x/1.0"] = np.arange(8, 16, dtype="<f4").tobytes()
    np.testing.assert_array_equal(read_array(OcdbtStore(tmp_path), "x"),
                                  np.arange(16).reshape(4, 4))


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_a_flipped_byte_raises(tmp_path, target):
    src = ROOT / ".ckpt_matching_r5" / "superpoint"
    dst = tmp_path / "superpoint"
    shutil.copytree(src, dst)
    path = dst / "manifest.ocdbt" if target == "manifest" else next(
        (dst / "d").iterdir())
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        read_checkpoint(dst)
    with pytest.raises(FileNotFoundError):
        read_checkpoint(tmp_path / "none")
