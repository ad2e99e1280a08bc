"""The reference-checkpoint converter of the port against the JAX
package's, on the CPU.

No reference checkpoint is in the repository, so the test makes a
reference-layout ``state_dict`` by inverting JAX's own name map
(``oetr_tpu/interop/torch_convert.py``): its converter runs with its
layout functions replaced by tags until it asks for no missing key, which
gives every (flax leaf, reference key, transform) of the map; the seeded
flax params go back through the inverse transforms, and the keys a
reference checkpoint holds that neither converter reads are added (the
``backbone.layer0..4`` aliases, the classifier, layer4 beyond a layer3
cut, BatchNorm's ``num_batches_tracked``, the decoder layers' unused
projections). JAX's converter must map it back onto the flax tree leaf
for leaf before anything else is compared.

Then: the port's conversion equals JAX's conversion taken through
``convert_flax_params``, bit for bit (both only rename; the flax route
transposes there and back); both skip the same keys; the forward of the
port on its conversion agrees with JAX's forward on JAX's at
test_torch_port_oetr.py's bounds (ResNet-18 at layer3 and layer4, as
tests/test_torch_parity.py runs the reference; ResNet-50 at layer3, the
flagship, keys and shapes only); a missing key raises on both sides;
``load_reference_checkpoint`` reads a ``torch.save``d file with the
``state_dict`` wrapper and the ``module.`` prefix.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.interop import torch_convert as jtc
from oetr_tpu.models import build_oetr
from oetr_tpu.models.resnet import RESNET_SPECS
from oetr_tpu_torch.interop import (MissingReferenceKey,
                                    convert_flax_params,
                                    convert_oetr_state_dict,
                                    load_reference_checkpoint,
                                    reference_state_dict, skipped_keys)
from test_torch_port_oetr import TOLS
from test_torch_port_variants import variant_params

torch.set_num_threads(2)

# (depth, stop layer, channels there, d_model, image side)
CASES = {"r18_layer3": (18, "layer3", 256, 64, 160),
         "r18_layer4": (18, "layer4", 512, 64, 192),
         "r50_layer3": (50, "layer3", 1024, 256, None)}


def _configs(case):
    depth, layer, channels, d, _ = CASES[case]
    neck = dict(d_model=d, nhead=4 if d == 64 else 8,
                num_layers=1 if d == 64 else 4,
                num_decoder_layers=1 if d == 64 else 2)
    bb = dict(depth=depth, stop_layer=layer, last_layer=channels, norm="bn")
    return (OETRConfig(backbone=BackboneConfig(**bb), neck=NeckConfig(**neck)),
            port.OETRConfig(backbone=port.BackboneConfig(**bb),
                            neck=port.NeckConfig(**neck)))


def _jax_convert(sd, jcfg):
    return jtc.convert_oetr_state_dict(
        sd, depth=jcfg.backbone.depth, stop_layer=jcfg.backbone.stop_layer,
        num_layers=jcfg.neck.num_layers,
        num_decoder_layers=jcfg.neck.num_decoder_layers)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_name_map(params, jcfg, monkeypatch):
    """{flax path: (transform, reference key)}: JAX's converter run with its
    layout functions tagging their input, on a state_dict of key names that
    grows by each key it reports missing. The keys it asks for only where
    present (downsample branches, reductions) are seeded from the flax
    tree."""
    monkeypatch.setattr(jtc, "_np", lambda t: ("as_is", t))
    monkeypatch.setattr(jtc, "_conv", lambda t: ("conv", t))
    monkeypatch.setattr(jtc, "_lin", lambda t: ("linear", t))
    tree = params["params"]
    kind, stages = RESNET_SPECS[jcfg.backbone.depth]
    block, n_convs = (("BasicBlock", 2) if kind == "basic"
                      else ("Bottleneck", 3))
    sd, n = {}, 0
    stages_used = {"layer3": 3, "layer4": 4}[jcfg.backbone.stop_layer]
    for stage in range(stages_used):
        for b in range(stages[stage]):
            if f"Conv_{n_convs}" in tree["backbone"][f"{block}_{n}"]:
                key = (f"backbone.encoder.layer{stage + 1}.{b}"
                       ".downsample.0.weight")
                sd[key] = key
            n += 1
    for i in range(len(jcfg.neck.patch_sizes)):
        sd[f"patchmerging.reductions.{i}.weight"] = (
            f"patchmerging.reductions.{i}.weight")
    while True:
        try:
            out = _jax_convert(sd, jcfg)
            break
        except jtc._Missing as e:
            key = re.search(r"missing '(.+)'", str(e)).group(1)
            sd[key] = key
    monkeypatch.undo()
    return dict(_flatten(out["params"]))


def _inverse(transform, arr):
    if transform == "conv":
        return arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    if transform == "linear":
        return arr.T
    return arr


def reference_layout(params, jcfg, monkeypatch, seed=0):
    """A reference OETR state_dict (torch tensors) whose conversion is
    ``params``, with the keys that no converter reads."""
    name_map = _jax_name_map(params, jcfg, monkeypatch)
    leaves = dict(_flatten(params["params"]))
    assert set(name_map) == set(leaves)
    sd = {}
    for path, (transform, key) in name_map.items():
        sd[key] = torch.tensor(np.ascontiguousarray(
            _inverse(transform, np.asarray(leaves[path]))))
    g = torch.Generator().manual_seed(seed)
    extra = {}
    for key, val in sd.items():
        # torchvision's ResnetEncoder keeps its stages twice.
        m = re.match(r"backbone\.encoder\.(layer\d)\.(.*)", key)
        if m:
            extra[f"backbone.{m[1]}.{m[2]}"] = val.clone()
        m = re.match(r"backbone\.encoder\.(conv1|bn1)\.(.*)", key)
        if m:
            extra[f"backbone.layer0.{0 if m[1] == 'conv1' else 1}.{m[2]}"] = (
                val.clone())
        if key.endswith("running_var"):
            extra[key.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(1000))
    cls_in = 2048 if jcfg.backbone.depth > 34 else 512
    extra["backbone.encoder.fc.weight"] = torch.randn(1000, cls_in,
                                                      generator=g)
    extra["backbone.encoder.fc.bias"] = torch.randn(1000, generator=g)
    if jcfg.backbone.stop_layer == "layer3":
        extra["backbone.encoder.layer4.0.conv1.weight"] = torch.randn(
            512, cls_in // 2, 1, 1, generator=g)
    d = jcfg.neck.d_model
    for j in range(jcfg.neck.num_decoder_layers):
        for p in ("q_proj", "k_proj", "v_proj", "merge"):
            extra[f"transformer.decoder.layers.{j}.{p}.weight"] = torch.randn(
                d, d, generator=g)
    assert not set(extra) & set(sd)
    sd.update(extra)
    return sd


@functools.cache
def _case(name):
    """(case, JAX config, port config, seeded params, reference state_dict);
    JAX's converter checked to map the state_dict back onto the params."""
    jcfg, pcfg = _configs(name)
    model = build_oetr(jcfg)
    zeros = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = variant_params(
        jax.eval_shape(model.init, jax.random.key(0), zeros, zeros), seed=11)
    with pytest.MonkeyPatch.context() as mp:
        sd = reference_layout(params, jcfg, mp)
    back = dict(_flatten(_jax_convert(sd, jcfg)["params"]))
    want = dict(_flatten(params["params"]))
    assert set(back) == set(want)
    for path in want:
        assert np.array_equal(back[path], want[path]), path
    return name, jcfg, pcfg, params, sd


@pytest.fixture(params=sorted(CASES))
def case(request):
    return _case(request.param)


@pytest.fixture(params=["r18_layer3", "r18_layer4"])
def r18_case(request):
    return _case(request.param)


@pytest.fixture
def r18():
    return _case("r18_layer3")


def test_port_conversion_equals_the_flax_route(case):
    """Every parameter set once, each the same bits as JAX's conversion
    taken through convert_flax_params; the inverse map gives back the
    reference keys the conversion reads."""
    _, jcfg, pcfg, _, sd = case
    got = convert_oetr_state_dict(sd, pcfg)
    want = convert_flax_params(_jax_convert(sd, jcfg), pcfg)
    expected = {k: tuple(p.shape) for k, p in
                port.build_oetr(pcfg, device="meta").named_parameters()}
    assert {k: tuple(v.shape) for k, v in got.items()} == expected
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    ref = reference_state_dict(got, pcfg)
    assert set(ref) == set(sd) - set(skipped_keys(sd, pcfg))
    for key, val in ref.items():
        assert torch.equal(val, sd[key].float()), key


def test_skipped_keys_match_jax(case, monkeypatch):
    """The keys the port does not read are those JAX's converter does not:
    the aliases, the classifier, layer4 past a layer3 cut,
    num_batches_tracked and the decoder layers' unused projections."""
    _, jcfg, pcfg, _, sd = case
    names = {id(v): k for k, v in sd.items()}
    read = set()
    as_numpy = jtc._np

    def recording(t):
        read.add(names[id(t)])
        return as_numpy(t)

    monkeypatch.setattr(jtc, "_np", recording)
    _jax_convert(sd, jcfg)
    skipped = skipped_keys(sd, pcfg)
    assert skipped == sorted(set(sd) - read)
    kinds = {re.sub(r"\d+", "#", k) for k in skipped}
    assert "backbone.encoder.fc.weight" in kinds
    assert "backbone.layer#.#.weight" in kinds
    assert any(k.endswith("num_batches_tracked") for k in kinds)
    assert "transformer.decoder.layers.#.q_proj.weight" in kinds


def test_forward_matches_jax_on_the_same_checkpoint(r18_case):
    """The port's forward on its conversion against JAX's forward on JAX's
    conversion of the same reference state_dict (r18 at layer3 and layer4;
    the flagship's forward is the card's, chip_smoke.py's variants phase)."""
    name, jcfg, pcfg, _, sd = r18_case
    hw = CASES[name][4]
    rng = np.random.default_rng(12)
    im1, im2 = rng.uniform(0, 1, (2, 2, hw, hw, 3)).astype(np.float32)
    with jax.enable_x64(False):
        jparams = jax.tree.map(jnp.asarray, _jax_convert(sd, jcfg))
        jout = jax.tree.map(np.asarray, jax.jit(build_oetr(jcfg).apply)(
            jparams, im1, im2))
    model = port.build_oetr(pcfg, device="cpu")
    model.load_state_dict(convert_oetr_state_dict(sd, pcfg))
    with torch.no_grad():
        pout = model(torch.from_numpy(im1), torch.from_numpy(im2))
    for key in sorted(jout):
        np.testing.assert_allclose(
            pout[key].numpy(), jout[key], atol=TOLS[key.rstrip("12")],
            rtol=1e-4 if key.startswith("mem") else 0, err_msg=key)
    inner = pout["pred_bbox1"].numpy()
    assert ((inner > 0) & (inner < hw)).any()


@pytest.mark.parametrize("key", [
    "backbone.encoder.bn1.running_var",
    "backbone.encoder.layer2.0.downsample.1.running_mean",
    "patchmerging.norm.bias", "query_embed2.weight",
    "transformer.encoder.1.mlp.2.weight",
    "transformer.decoder.layers.0.multihead_attn.v_proj.bias",
    "tlbr_reg.2.bias"])
def test_missing_key_raises(r18, key):
    _, jcfg, pcfg, _, sd = r18
    sd = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(KeyError, match=re.escape(key)):
        _jax_convert(sd, jcfg)
    with pytest.raises(MissingReferenceKey, match=re.escape(key)):
        convert_oetr_state_dict(sd, pcfg)


def test_converter_refuses_other_backbones(r18):
    _, _, pcfg, _, sd = r18
    for bb in (dict(norm="gn"), dict(stem_s2d=True)):
        cfg = port.replace(pcfg, backbone=port.replace(pcfg.backbone, **bb))
        with pytest.raises(ValueError, match="norm='bn'"):
            convert_oetr_state_dict(sd, cfg)


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_reference_checkpoint_round_trip(r18, tmp_path, wrapped):
    """A checkpoint as the reference's trainer writes it (a ``state_dict``
    wrapper, DataParallel's ``module.`` prefix) and a bare state_dict."""
    _, _, pcfg, _, sd = r18
    path = tmp_path / "oetr.ckpt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3} if wrapped else sd, path)
    got = load_reference_checkpoint(str(path), pcfg)
    want = convert_oetr_state_dict(sd, pcfg)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
