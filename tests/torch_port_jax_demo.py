"""Run one of the JAX package's demo scripts and record what its train
steps saw, for the port's demo tests.

    python tests/torch_port_jax_demo.py OUT.pkl scripts/NAME.py [ARGS...]

The script runs as ``__main__`` in this process, with flax's dropout
switched off (the port's tests hold the OETR demos with dropout off on
both sides), numpy's global generator seeded with 0 (the datasets
resample their pairs from it) and JAX's persistent compile cache left
off (the scripts would switch it on in the checkout). Every train step
the script builds is wrapped: each call's parameters before, its data
arguments, its metrics and Adam's first moment after it, and the
parameters after the last call are kept, and written to OUT.pkl as numpy
trees when the script exits: ``{name: {"params": [...], "init":
params[0], "batches": [...], "metrics": [...], "mu": [...], "final":
params}}``, the name that of the step's factory, and under
``"schedules"`` the arguments of every
``optax.piecewise_constant_schedule`` the script made, ``(init_value,
{boundary: scale})`` in the order made.

Run it as a child process: it patches flax and jax for its whole life.
"""
import atexit
import pickle
import runpy
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    out, script, *argv = sys.argv[1:]
    import flax.linen as nn
    import jax

    nn.Dropout.__call__ = lambda self, x, *a, **k: x
    # The scripts point JAX's persistent compile cache into the checkout;
    # a test run keeps its compiles to itself.
    update = jax.config.update
    jax.config.update = lambda name, value: None if (
        "persistent_cache" in name or "compilation_cache" in name) \
        else update(name, value)
    record = {"schedules": []}
    to_np = lambda tree: jax.tree.map(np.asarray, tree)

    import optax

    schedule = optax.piecewise_constant_schedule

    def recorded_schedule(init_value, boundaries_and_scales=None):
        record["schedules"].append(
            (float(init_value), {int(b): float(s) for b, s in
                                 (boundaries_and_scales or {}).items()}))
        return schedule(init_value, boundaries_and_scales)

    optax.piecewise_constant_schedule = recorded_schedule

    def adam_mu(opt_state):
        """Adam's first moment in an optax state (a tree like the
        params)."""
        is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
        [adam] = [x for x in jax.tree.leaves(opt_state, is_leaf=is_adam)
                  if is_adam(x)]
        return adam.mu

    def wrap(module, name, params_of, data_of, after):
        make = getattr(module, name)

        def factory(*a, **k):
            step = make(*a, **k)

            def wrapped(*args):
                rec = record.setdefault(name, {"params": [], "batches": [],
                                               "metrics": [], "mu": []})
                rec["params"].append(to_np(params_of(args)))
                rec["init"] = rec["params"][0]
                rec["batches"].append(to_np(data_of(args)))
                res = step(*args)
                params, opt_state, metrics = after(res)
                rec["metrics"].append(to_np(metrics))
                rec["mu"].append(to_np(adam_mu(opt_state)))
                rec["final"] = to_np(params)
                return res
            return wrapped
        setattr(module, name, factory)

    import oetr_tpu.training as jtraining
    from oetr_tpu.training import loftr, superglue, superpoint

    # OETR: step(state, batch, key) -> (state, metrics)
    wrap(jtraining, "make_train_step", lambda a: a[0].params,
         lambda a: a[1], lambda r: (r[0].params, r[0].opt_state, r[1]))
    # matching trainers: step(params, opt, *data) -> (params, opt, metrics)
    for module, name in ((superpoint, "make_superpoint_joint_train_step"),
                         (superpoint, "make_superpoint_joint_ha_train_step"),
                         (superglue, "make_superglue_train_step"),
                         (loftr, "make_loftr_train_step")):
        wrap(module, name, lambda a: a[0],
             lambda a: [x for x in a[2:] if not isinstance(x, tuple)]
             if not isinstance(a[2], dict) else
             {k: v for k, v in a[2].items() if not k.startswith("image_hw")},
             lambda r: r)

    def dump():
        with open(out, "wb") as f:
            pickle.dump(record, f)

    atexit.register(dump)
    sys.argv = [script, *argv]
    # After the imports: importing flax draws from numpy's generator.
    np.random.seed(0)
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
