"""Scalar logging for the trainer (port of ``ScalarWriter`` in
``oetr_tpu/utils/profiling.py``; the rest of that module is not ported
yet).
"""
from __future__ import annotations

import json
import os


class ScalarWriter:
    """Scalars per step to TensorBoard through
    ``torch.utils.tensorboard`` where it imports, else as one JSON line a
    step to ``{logdir}/scalars.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
            self._fh = None
        except Exception:
            self._tb = None
            self._fh = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def write(self, step: int, scalars: dict) -> None:
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        else:
            self._fh.write(json.dumps(
                {"step": int(step),
                 **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._fh.close()
