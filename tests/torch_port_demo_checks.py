"""What the port's demo tests share: JAX's demo scripts run in child
processes through ``torch_port_jax_demo.py``, JAX's pose-estimator
draws given to the port, and the bounds that hold the port's JSON fields
and trained parameters to JAX's."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from oetr_tpu_torch.geometry import draws

ROOT = Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "torch_port_jax_demo.py"
JSON_TOL = 1e-4          # a JSON float (rounded to 4 places) of a float
FIRM_G = 1e-2            # a gradient entry clear of rounding: of its largest
FIRM_FLOOR = 1e-6
# A later step's whole gradient against JAX's, relative to its norm. The
# demos' SuperPoint, SuperGlue and OETR read 3e-7..6e-5 (printed under
# ``pytest -s``); LoFTR 1.9e-3 and 7.8e-3: its backbone's GroupNorm
# gradients are ill-conditioned in f32 on these scenes, on either side by
# turns. A wrong loss weight, clip or teacher moves it by 1e-1 and more.
GRAD_RTOL = 1e-3
LOFTR_GRAD_RTOL = 3e-2


def start_jax(base: Path, name: str, script: str, *argv: str) -> dict:
    """Start ``scripts/<script>`` through ``torch_port_jax_demo.py`` in a
    child process, its temporary files (the scenes) under ``base/name``."""
    tmp = base / name
    tmp.mkdir()
    env = dict(os.environ, TMPDIR=str(tmp), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(RUNNER), str(tmp / "rec.pkl"),
         str(ROOT / "scripts" / script), *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "tmp": tmp}


def finish(run: dict, timeout: float = 900) -> dict:
    """Wait for a started run: its JSON line (``json``) and the record
    of its train steps (``rec``)."""
    out, err = run.pop("proc").communicate(timeout=timeout)
    assert out.strip(), err[-4000:]
    run["json"] = json.loads(out.strip().splitlines()[-1])
    with open(run["tmp"] / "rec.pkl", "rb") as f:
        run["rec"] = pickle.load(f)
    return run


def only_dir(pattern_dir: Path, prefix: str) -> Path:
    found = sorted(pattern_dir.glob(prefix + "*"))
    assert len(found) == 1, found
    return found[0]


def install_jax_draws(monkeypatch, seed: int = 0) -> None:
    """The port's estimator draws JAX's Gumbel noise of key(seed) by stage
    (as ``tests/test_torch_port_evalx.py``), the demos' rng_seed 0."""
    with jax.enable_x64(False):
        rng_e, rng_h, rng_p = jax.random.split(jax.random.key(seed), 3)
        rng1, rng2, rng5 = jax.random.split(rng_e, 3)
    keys = {"round1": rng1, "round2": rng2, "five_point": rng5,
            "homography": rng_h, "parallax": rng_p}

    def gumbel(stage, shape, generator):
        with jax.enable_x64(False):
            g = jax.random.gumbel(keys[stage], tuple(shape))
        return torch.from_numpy(np.array(g))

    monkeypatch.setattr(draws, "gumbel", gumbel)


def field_mismatches(got, want, tol: float = JSON_TOL, path: str = "",
                     skip=("wall_s",)) -> list:
    """Where two JSON values differ: floats by more than ``tol`` (plus a
    rounding's width), everything else at all."""
    if isinstance(want, dict):
        keys = lambda d: sorted(k for k in d if k not in skip)
        out = [] if keys(got) == keys(want) else [
            (path, keys(got), keys(want))]
        for k in want:
            if k not in skip and k in got:
                out += field_mismatches(got[k], want[k], tol, f"{path}.{k}")
        return out
    if isinstance(want, float) and not isinstance(got, bool):
        if got is None or abs(got - want) > tol + 1e-9:
            return [(path, got, want)]
        return []
    return [] if got == want and type(got) is type(want) else [
        (path, got, want)]


def hold_params(model, want: dict, lr: float, steps: int):
    """The parameters after ``steps`` Adam(W) steps against JAX's: within
    2·lr a step everywhere (Adam moves an entry by about the rate a step)."""
    for name, p in model.named_parameters():
        ref = torch.as_tensor(np.asarray(want[name]))
        diff = (p.detach().cpu() - ref).abs()
        assert (diff <= 2 * lr * steps + 1e-6 * ref.abs()).all(), (
            name, float(diff.max()))


def hold_step(model, want: dict, rate: float, grads: dict,
              jax_grads: dict, first: bool,
              grad_rtol: float = GRAD_RTOL) -> dict:
    """One Adam(W) step at ``rate`` from JAX's parameters against JAX's:
    the parameters after it within 2·rate everywhere and, after a first
    step (``first``), within 1e-6 of max(1, |p|) where the gradient is
    clear of rounding (its largest |entry| times 1e-2, at least 1e-6: the
    update is then the same function of the same gradient). After a later
    step that does not hold (the update is a ratio of moments in which a
    gradient's rounding, ill-conditioned in places, can cancel), so the
    step's gradient ``grads`` (after the clip) is held to JAX's instead:
    the whole gradient within ``grad_rtol`` of its norm (a tensor's own
    share is no measure: where JAX's gradient is nearly 0, its first
    moments give back rounding). Returns its relative error."""
    num = den = 0.0
    for name, p in model.named_parameters():
        ref = torch.as_tensor(np.asarray(want[name]))
        diff = (p.detach().cpu() - ref).abs()
        assert (diff <= 2 * rate + 1e-6 * ref.abs()).all(), (
            name, float(diff.max()))
        g = grads[name].cpu().double()
        gj = torch.as_tensor(np.asarray(jax_grads[name])).double()
        num += float((g - gj).norm()) ** 2
        den += float(gj.norm()) ** 2
        if first:
            firm = g.abs() > max(FIRM_G * float(g.abs().max()), FIRM_FLOOR)
            assert (diff[firm] <= 1e-6 * torch.clamp(ref.abs()[firm],
                                                     min=1.0)).all(), (
                name, float(diff[firm].max()))
    err = (num / den) ** 0.5
    assert err <= grad_rtol, err
    return err


def jax_gradient(rec: dict, k: int) -> dict:
    """JAX's gradient of step ``k`` (after its clip) from Adam's first
    moments: (mu_k - 0.9 mu_k-1) / 0.1."""
    mu = lambda j: jax.tree.map(lambda a: np.asarray(a, np.float64),
                                rec["mu"][j])
    if k == 0:
        return jax.tree.map(lambda a: a / 0.1, mu(0))
    return jax.tree.map(lambda a, b: (a - 0.9 * b) / 0.1, mu(k), mu(k - 1))


def jax_rates(schedule, steps: int) -> list:
    """optax's rate at each of ``steps`` steps under a schedule JAX's
    script made (``(init_value, {boundary: scale})`` as the runner
    records it), in float32 as the script computes it."""
    import optax

    with jax.enable_x64(False):
        f = optax.piecewise_constant_schedule(*schedule)
        return [float(np.float32(f(k))) for k in range(steps)]


def hold_phase(model, optimizer, rec: dict, convert, run_step, schedule,
               hold_metrics, grad_rtol: float = GRAD_RTOL) -> list:
    """Every step k of a phase, run through the phase's own function
    (``run_step(k)`` runs step k alone and returns what the phase returns)
    from JAX's parameters before step k, with the port's optimizer and
    schedule carried over from its own step k - 1: the rate of the step
    equal to optax's under JAX's schedule, the parameters and gradient at
    ``hold_step``'s bounds, and what the step returns against JAX's
    metrics of that step (``hold_metrics(got, want)``). Returns
    ``hold_step``'s readings a step."""
    rates, grads = [], []
    names = {id(p): n for n, p in model.named_parameters()}

    def pre_step(opt, args, kwargs):
        rates.append(opt.param_groups[0]["lr"])
        grads.append({names[id(p)]: p.grad.detach().clone()
                      for g in opt.param_groups for p in g["params"]})

    optimizer.register_step_pre_hook(pre_step)
    steps = len(rec["params"])
    want_rates = jax_rates(schedule, steps)
    readings = []
    for k in range(steps):
        model.load_state_dict(convert(rec["params"][k]))
        got = run_step(k)
        assert len(rates) == k + 1 and rates[k] == want_rates[k], (
            k, rates, want_rates)
        after = rec["params"][k + 1] if k + 1 < steps else rec["final"]
        readings.append(hold_step(model, convert(after), want_rates[k],
                                  grads[k], convert(jax_gradient(rec, k)),
                                  k == 0, grad_rtol))
        hold_metrics(got, rec["metrics"][k])
    print(f"gradient's relative error a step: {readings}")
    return readings
