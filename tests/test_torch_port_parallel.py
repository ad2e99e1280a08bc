"""The port's parallel layer (``oetr_tpu_torch/parallel``) against the JAX
package's, on the CPU, in float32.

JAX runs on 4 of the 8 virtual CPU devices (``tests/conftest.py``), in
``shard_map`` as its own tests run it, with x64 off. The port runs on 4
gloo ranks started by ``parallel.spawn``; the ranks (``torch_port_ranks``)
import no JAX, read the test's inputs from a file and write their results
under ``tmp_path``. Each side shards the same way: K/V blocks, observation
blocks and batch rows in rank order.

Bounds:
  make_mesh              -1 fills; a mesh wider than the group raises
                         "needs N devices"
  partition rules        on the flagship, the same leaves split over
                         'model' (by column or by row) and over 'fsdp' (a
                         dimension of the same size) as JAX's
                         ``param_shardings``
  ring, Ulysses,
  'full:ring'            1e-5 of max(1, |ref|), with masks and a fully
                         masked shard
  gpipe, pipelined
  encoder                outputs and gradients 1e-5 of max(1, |ref|)
  sharded BA             cost 1e-4 relative, cameras 1e-5, against JAX's
                         sharded BA and the port's local BA, in float64
                         as tests/test_sfm.py:139 runs (in float32 JAX's
                         own sharded and local BA part by 5e-4 in the
                         cameras on this problem)
  fcos_losses(group)     each rank's losses 1e-6 of max(1, |ref|) against
                         JAX's device's under ``data_axis``
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_ranks as ranks
from oetr_tpu.geometry.boxes import compute_locations as j_locations
from oetr_tpu.models import fcos as jfcos
from oetr_tpu.models import transformer as jtr
from oetr_tpu.parallel import mesh as jmesh
from oetr_tpu.parallel import pipeline as jpipe
from oetr_tpu.parallel.ring_attention import ring_attention as j_ring
from oetr_tpu.parallel.ring_attention import ring_context as j_ring_context
from oetr_tpu.parallel.ring_attention import ulysses_attention as j_ulysses
from oetr_tpu.sfm import ba as jba
from oetr_tpu_torch import parallel as pparallel
from oetr_tpu_torch.interop.from_flax import _state_dict
from oetr_tpu_torch.models import build_oetr
from oetr_tpu_torch.models.layers import init_params
from oetr_tpu_torch.models.transformer import QueryTransformer, _attend
from oetr_tpu_torch.sfm import bundle_adjust

torch.set_num_threads(2)

N = 4
TOL = 1e-5


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bound, (what, err, bound)


def _ba_problem(rng, n_cams=4, n_pts=32, noise=0.2):
    """tests/test_sfm.py's problem (rotations by the port's so3_exp)."""
    from scipy.spatial.transform import Rotation
    K = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]]),
                (n_cams, 1, 1))
    cams = []
    for i in range(n_cams):
        w = Rotation.from_euler("xyz", rng.uniform(-5, 5, 3),
                                degrees=True).as_rotvec()
        t = np.array([i * 0.5, 0.0, 0.0]) + rng.normal(0, 0.05, 3)
        cams.append(np.concatenate([w, t]))
    cams = np.stack(cams)
    pts = rng.uniform(-2, 2, (n_pts, 3)) + [0, 0, 8.0]
    oc, op, ouv = [], [], []
    for c in range(n_cams):
        R = Rotation.from_rotvec(cams[c, :3]).as_matrix()
        for p in range(n_pts):
            x = R @ pts[p] + cams[c, 3:]
            oc.append(c)
            op.append(p)
            ouv.append((K[c] @ (x / x[2]))[:2] + rng.normal(0, noise, 2))
    return cams, pts, K, np.array(oc), np.array(op), np.stack(ouv)


def _inputs():
    rng = np.random.default_rng(42)
    f32 = lambda a: np.asarray(a, np.float32)
    b, l, s, h, d = 2, 16, 32, 4, 8
    km = np.ones((b, s), bool)
    km[0, :8] = False                      # rank 0's block, all masked
    km[1, 5:20] = False
    inp = {"q": f32(rng.normal(0, 0.5, (b, l, h, d))),
           "k": f32(rng.normal(0, 0.5, (b, s, h, d))),
           "v": f32(rng.normal(0, 1.0, (b, s, h, d))), "kv_mask": km,
           "ws": f32(rng.normal(size=(N, 8, 8)) * 0.3),
           "xs": f32(rng.normal(size=(8, 2, 8)))}
    dt, nt = 16, 9
    inp.update(f0=f32(rng.normal(size=(4, nt, dt))),
               f1=f32(rng.normal(size=(4, nt, dt))),
               pos=f32(rng.normal(size=(1, nt, dt)) * 0.1),
               mask0=rng.uniform(size=(4, nt)) > 0.2,
               mask1=rng.uniform(size=(4, nt)) > 0.2)
    # tests/test_sfm.py:139's problem and draws, in float64 as it runs.
    brng = np.random.default_rng(42)
    cams, pts, K, oc, op, ouv = _ba_problem(brng)
    cams_init = cams + brng.normal(0, 0.005, cams.shape)
    cams_init[0] = cams[0]
    inp.update(cams=cams_init, pts=pts + brng.normal(0, 0.02, pts.shape),
               K=K, obs_cam=oc.astype(np.int64), obs_pt=op.astype(np.int64),
               obs_uv=ouv)
    fb = 8
    inp.update(locs=f32(np.asarray(j_locations(4, 4, stride=16))),
               cls=f32(rng.normal(size=(fb, 4, 4, 1))),
               reg=f32(np.abs(rng.normal(size=(fb, 4, 4, 4))) + 1),
               cent=f32(rng.normal(size=(fb, 4, 4, 1))),
               boxes=f32(np.array([[8.0, 8, 56, 56], [0, 0, 30, 40]] * 4)))
    return inp


def _jax_side(inp):
    """Every JAX reference, sharded over 4 devices, x64 off."""
    out = {}
    with jax.enable_x64(False):
        j = {k: jnp.asarray(v) for k, v in inp.items()
             if k != "transformer"}
        seq = _mesh("seq")
        qkv = (j["q"], j["k"], j["v"])
        out["ring"] = jax.jit(lambda q, k, v, m: j_ring(
            q, k, v, seq, kv_mask=m))(*qkv, j["kv_mask"])
        out["ring_nomask"] = jax.jit(lambda q, k, v: j_ring(
            q, k, v, seq))(*qkv)
        out["ulysses"] = jax.jit(lambda q, k, v, m: j_ulysses(
            q, k, v, seq, kv_mask=m))(*qkv, j["kv_mask"])

        def full_ring(q, k, v, m):
            with j_ring_context(seq, "seq"):
                return jtr._attend("full:ring", q, k, v, None, m)

        out["full_ring"] = jax.jit(full_ring)(*qkv, j["kv_mask"])
        pipe = _mesh("pipe")

        def loss_gpipe(w):
            y = jpipe.gpipe(lambda p, x: jnp.tanh(x @ p["w"]), {"w": w},
                            j["xs"], pipe)
            return jnp.sum(y ** 2), y

        (_, out["gpipe"]), out["gpipe_grad"] = jax.jit(jax.value_and_grad(
            loss_gpipe, has_aux=True))(j["ws"])

        tr = jtr.QueryTransformer(d_model=16, nhead=4, num_layers=N,
                                  num_decoder_layers=1)
        q0 = jnp.zeros((1, 16), jnp.float32)
        shapes = jax.eval_shape(tr.init, jax.random.key(0), j["f0"],
                                j["f1"], q0, q0, j["pos"], j["pos"],
                                j["mask0"], j["mask1"])["params"]
        params = _flax_tree(inp["transformer"], shapes)

        def enc(p, attention):
            return jpipe.pipelined_encoder(
                p, j["f0"], j["f1"], j["pos"], j["pos"], pipe,
                mask0=j["mask0"], mask1=j["mask1"], num_layers=N, nhead=4,
                attention=attention)

        for attention in ("linear", "full"):
            out[f"encoder_{attention}"] = jax.jit(
                lambda p, a=attention: enc(p, a))(params)
        out["encoder_grads"] = jax.jit(jax.grad(
            lambda p: sum(jnp.sum(x ** 2) for x in enc(p, "linear"))))(params)

    with jax.enable_x64(True):
        j = {k: jnp.asarray(inp[k]) for k in ("cams", "pts", "K", "obs_uv")}

        def sharded_ba(oc, op, ouv, valid):
            return jba.bundle_adjust(j["cams"], j["pts"], j["K"], oc, op,
                                     ouv, valid, iters=4, cg_iters=20,
                                     axis_name="obs")

        out["ba"] = shard_map(
            sharded_ba, mesh=_mesh("obs"), in_specs=(P("obs"),) * 4,
            out_specs=P())(jnp.asarray(inp["obs_cam"], jnp.int32),
                           jnp.asarray(inp["obs_pt"], jnp.int32), j["obs_uv"],
                           jnp.ones(len(inp["obs_cam"]), bool))
    with jax.enable_x64(False):
        j = {k: jnp.asarray(v) for k, v in inp.items()
             if k != "transformer"}

        def per_device(c, r, ce, bx):
            f = jfcos.fcos_losses(j["locs"], c, r, ce, bx, data_axis="data")
            return jnp.stack([f["cls_loss"], f["reg_loss"],
                              f["centerness_loss"]])[None]

        out["fcos"] = jax.jit(shard_map(
            per_device, mesh=_mesh("data"), in_specs=(P("data"),) * 4,
            out_specs=P("data")))(j["cls"], j["reg"], j["cent"], j["boxes"])
    return jax.tree.map(np.asarray, out)


def _transformer_state() -> dict:
    """A QueryTransformer(16, 4 heads, 4 layers, 1 decoder layer)'s seeded
    parameters, the port's names and layout."""
    with torch.device("meta"):
        tr = QueryTransformer(16, 4, N, 1)
    tr.to_empty(device="cpu")
    init_params(tr, torch.Generator().manual_seed(4))
    return {k: v.detach().clone() for k, v in tr.state_dict().items()}


def _flax_tree(state: dict, shapes) -> dict:
    """The port's state as the flax tree of ``shapes`` (the inverse of
    interop's map: weight [out, in] -> kernel [in, out], a norm's weight
    -> scale)."""
    def leaf(path, shape):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}
                                     .get(keys[-1], keys[-1])])
        t = state[name].numpy()
        return jnp.asarray(t.T if keys[-1] == "kernel" else t)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX references, computed while the port's 4 ranks run."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    inp["transformer"] = _transformer_state()
    sent = {k: v if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in inp.items()}
    torch.save(sent, tmp / "par_in.pt")
    with ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(pparallel.spawn, ranks.prog_parallel, N,
                                 "cpu", str(tmp / "rdv"), (str(tmp),), 1)
        want = _jax_side(inp)
        ranks_done.result()
    got = [torch.load(tmp / f"par_{r}.pt", weights_only=False)
           for r in range(N)]
    return inp, want, got


def test_make_mesh(both):
    _, _, got = both
    for g in got:
        assert g["mesh"] == (2, 2)
        assert "needs 8 devices, have 4" in g["mesh_error"]


def _jax_leaf_name(path):
    keys = [str(getattr(k, "key", k)) for k in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf])


def test_partition_rules_split_the_flagship_as_jax():
    """The port's rules and FSDP fallback on the flagship's parameters
    against JAX's ``param_shardings`` on a (data 2, model 2, fsdp 2) mesh
    of the 8 devices: the same leaves split over 'model', each the same
    way (a kernel's column split is the weight's row split), and over
    'fsdp' a dimension of the same size."""
    from oetr_tpu.config import OETRConfig
    from oetr_tpu.models import build_oetr as jbuild

    import oetr_tpu_torch as port
    with jax.enable_x64(False):
        jm = jbuild(OETRConfig())
        img = jnp.zeros((1, 64, 64, 3), jnp.float32)
        shapes = jax.eval_shape(jm.init, jax.random.key(0), img, img)
        mesh = jmesh.make_mesh({"data": 2, "model": 2, "fsdp": 2})
        jspecs = jax.tree_util.tree_flatten_with_path(
            jmesh.param_shardings(shapes["params"], mesh, fsdp_axis="fsdp"))
    jshape = dict(
        (_jax_leaf_name(p), leaf.shape) for p, leaf in
        jax.tree_util.tree_flatten_with_path(shapes["params"])[0])
    pmodel = build_oetr(port.oetr_r50_config(), device="meta")
    pshape = {n: tuple(p.shape) for n, p in pmodel.named_parameters()}
    pspecs = pparallel.param_shardings(pmodel, {"data": 2, "model": 2,
                                                "fsdp": 2}, fsdp_axis="fsdp")
    assert sorted(pspecs) == sorted(jshape)
    n_model = n_fsdp = 0
    for path, sh in jspecs[0]:
        name = _jax_leaf_name(path)
        jspec, pspec = tuple(sh.spec), pspecs[name]
        jm_ = "model" in jspec
        assert jm_ == ("model" in pspec), name
        if jm_:
            n_model += 1
            # [in, out] kernels against [out, in] weights; biases as is.
            want = jspec[::-1] if len(jspec) == 2 else jspec
            assert pspec == tuple(want) + (None,) * (len(pspec) - len(want)), \
                (name, jspec, pspec)
        jf = "fsdp" in jspec
        assert jf == ("fsdp" in pspec), name
        if jf:
            n_fsdp += 1
            assert (jshape[name][jspec.index("fsdp")]
                    == pshape[name][pspec.index("fsdp")]), name
    assert n_model >= 4 * 2 * 6
    assert n_fsdp > 100


@pytest.mark.parametrize("key", ["ring", "ring_nomask", "ulysses",
                                 "full_ring"])
def test_sequence_parallel_attention_matches_jax(both, key):
    _, want, got = both
    for r, g in enumerate(got):
        assert np.isfinite(g[key].numpy()).all(), (key, r)
        _close(g[key], want[key], what=(key, r))


def test_full_ring_needs_a_context():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="ring_context"):
        _attend("full:ring", q, q, q, None, None)


def test_gpipe_matches_jax(both):
    _, want, got = both
    for g in got:
        _close(g["gpipe"], want["gpipe"], what="out")
        _close(g["gpipe_grad"], want["gpipe_grad"], what="grad")


@pytest.mark.parametrize("attention", ["linear", "full"])
def test_pipelined_encoder_matches_jax(both, attention):
    _, want, got = both
    for g in got:
        for a, b in zip(g[f"encoder_{attention}"],
                        want[f"encoder_{attention}"]):
            _close(a, b, what=attention)


def test_pipelined_encoder_gradients_match_jax(both):
    _, want, got = both
    with torch.device("meta"):
        meta = QueryTransformer(16, 4, N, 1)
    ref = _state_dict(want["encoder_grads"], meta)
    for g in got:
        grads = g["encoder_grads"]
        enc = [n for n in ref if n.startswith("enc_")]
        assert sorted(n for n in grads if n.startswith("enc_")) == \
            sorted(enc)
        for n in enc:
            _close(grads[n], ref[n], what=n)


def test_sharded_ba_matches_jax_and_local(both):
    inp, want, got = both
    local = bundle_adjust(*(torch.as_tensor(inp[k]) for k in (
        "cams", "pts", "K", "obs_cam", "obs_pt", "obs_uv")),
        torch.ones(len(inp["obs_cam"]), dtype=torch.bool), iters=4,
        cg_iters=20)
    for g in got:
        ba = g["ba"]
        for ref_cost, ref_cams in ((want["ba"]["cost"], want["ba"]["cams"]),
                                   (float(local["cost"]), local["cams"])):
            np.testing.assert_allclose(float(ba["cost"]), float(ref_cost),
                                       rtol=1e-4)
            np.testing.assert_allclose(ba["cams"].numpy(),
                                       np.asarray(ref_cams), atol=1e-5)
        assert float(ba["cost"]) < 0.5 * float(ba["cost0"])


def test_fcos_losses_with_group_match_jax(both):
    _, want, got = both
    for g in got:
        _close(g["fcos"], want["fcos"], tol=1e-6, what="fcos")
