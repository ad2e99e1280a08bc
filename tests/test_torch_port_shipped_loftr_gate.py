"""JAX's LoFTR gate (``tests/test_shipped_loftr_gate.py``) through the port.

The committed ``.ckpt_loftr_r5`` (read by ``build_shipped_model``, the
port's reader) on JAX's held-out pairs: JAX's ``make_device_generator`` at
256², ``scale_range=(1.0, 2.0)``, ``p_translate=0.5``, key 991, 4 pairs.
The port must pass the gate's two thresholds with its own warp
(``training/loftr.py::warp_cell_centers_batch``): >= 100 valid matches a
pair on average, and a median endpoint error against the depth and pose
warp < 2.5 px. Its matches are held to JAX's LoFTR (orbax's restore, the
gate's own model) at the trained LoFTR bound of
``test_torch_port_loftr.py``: the valid match sets (cells0 -> cells1)
agree on >= 99%, and the agreed image-1 positions within 1e-3 px.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import oetr_tpu_torch as port
from oetr_tpu_torch.training.loftr import warp_cell_centers_batch

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / ".ckpt_loftr_r5" / "loftr"
HW, PAIRS, KEY = 256, 4, 991
MATCHES_MIN, MEDIAN_MAX_PX = 100, 2.5
PX_TOL = 1e-3


def _np(x):
    return x.detach().cpu().numpy()


def test_shipped_loftr_gate_through_the_port():
    import orbax.checkpoint as ocp

    from oetr_tpu.data.device_synth import make_device_generator
    from oetr_tpu.models.loftr import LoFTR

    kw = dict(d_coarse=192, d_fine=96, coarse_layers=4, max_matches=1024)
    model = LoFTR(**kw)
    z = jnp.zeros((1, HW, HW, 1), jnp.float32)
    params = ocp.StandardCheckpointer().restore(
        str(CKPT), jax.jit(model.init)(jax.random.key(0), z, z))
    raw = make_device_generator(HW, PAIRS, scale_range=(1.0, 2.0),
                                p_translate=0.5)(jax.random.key(KEY))
    raw = {k: np.asarray(v) for k, v in raw.items()}
    lum = np.asarray([0.299, 0.587, 0.114], np.float32)
    g0 = (raw["image1"].astype(np.float32) @ lum)[..., None]
    g1 = (raw["image2"].astype(np.float32) @ lum)[..., None]
    jout = jax.jit(model.apply)(params, jnp.asarray(g0), jnp.asarray(g1))
    jout = {k: np.asarray(v) for k, v in jout.items()}

    loftr = port.build_shipped_model("loftr", device="cpu")[0].loftr
    with torch.no_grad():
        pout = loftr(torch.from_numpy(g0), torch.from_numpy(g1))

    # The gate, on the port's matches and the port's warp.
    t = lambda k: torch.tensor(raw[k], dtype=torch.float32)
    T = t("pose2") @ torch.linalg.inv(t("pose1"))
    gt_xy1, gt_ok = warp_cell_centers_batch(pout["mkpts0"], t("depth1"),
                                            t("K1"), T, t("K2"),
                                            depth1=t("depth2"))
    valid = _np(pout["valid"] & gt_ok)
    assert valid.sum() >= MATCHES_MIN * PAIRS, valid.sum(-1)
    err = np.linalg.norm(_np(pout["mkpts1"]) - _np(gt_xy1), axis=-1)[valid]
    print(f"gate: {valid.sum(-1).tolist()} valid matches, median "
          f"{np.median(err):.4f} px")
    assert float(np.median(err)) < MEDIAN_MAX_PX, np.median(err)

    # The port's matches against JAX's.
    for i in range(PAIRS):
        def matches(out):
            v = out["valid"][i]
            c0, c1 = out["cells0"][i][v], out["cells1"][i][v]
            return {(a, b): p for a, b, p in zip(c0, c1,
                                                 out["mkpts1"][i][v])}
        pm = matches({k: _np(v) for k, v in pout.items()})
        jm = matches(jout)
        agreed = set(pm) & set(jm)
        assert len(agreed) >= 0.99 * max(len(pm), len(jm)), (len(pm),
                                                             len(jm))
        err = max(np.abs(pm[k] - jm[k]).max() for k in agreed)
        assert err <= PX_TOL, err
