"""A params-only store from a full train state, on the port
(``scripts/export_params.py``).

Reads the latest ``step_N`` under ``src`` (JAX's orbax ``TrainState``,
written by JAX's trainer or the port's: ``training/train.py``) and writes
its ``params`` subtree to ``{out}/params`` with
``interop.write_checkpoint``: the store that ``bench.py``, the pipelines
and ``pipelines/api.py::build_shipped_model`` read. The state's tree is
checked against the model of ``--depth``, ``--d_model``, ``--layers``,
``--dec_layers`` (every parameter once, each shape), and its leaves are
copied as they are. No device is used.

    python -m oetr_tpu_torch.scripts.export_params <train_ckpt_dir> <out_dir>
        [--depth 50 --d_model 256 --layers 4 --dec_layers 2 --hw 256]
"""
from __future__ import annotations

import argparse
import os

from ..interop.from_flax import flax_state_dict
from ..interop.orbax_read import read_checkpoint
from ..interop.orbax_write import write_checkpoint
from ..models.oetr import build_oetr
from ..training.jax_state import check_layout
from ..training.train import ADAMW_LAYOUT, latest_checkpoint_step
from .overlap_ab_demo import model_config


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dec_layers", type=int, default=2)
    ap.add_argument("--hw", type=int, default=256,
                    help="training image size (the positional encoding's "
                         "size the state was created with)")
    return ap.parse_args(argv)


def export(src: str, out: str, args) -> tuple[int, str, int]:
    """(the step exported, the store's path, its parameter count)."""
    step = latest_checkpoint_step(src)
    if step is None:
        raise SystemExit(f"no step_N checkpoints under {src}")
    tree = read_checkpoint(os.path.join(os.path.abspath(src), f"step_{step}"))
    check_layout(tree, ADAMW_LAYOUT, f"{src}/step_{step}")
    state = flax_state_dict(tree["params"], build_oetr(model_config(args),
                                                       device="meta"))
    path = os.path.abspath(os.path.join(out, "params"))
    write_checkpoint(path, tree["params"])
    return step, path, sum(t.numel() for t in state.values())


def main(argv=None):
    args = parse_args(argv)
    step, path, n = export(args.src, args.out, args)
    print(f"loaded step {step} from {args.src}")
    print(f"exported {n / 1e6:.1f}M params -> {path}")


if __name__ == "__main__":
    main()
