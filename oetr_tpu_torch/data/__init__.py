"""The port's data: on-device synthetic pairs, and pair-list parsing."""
from .device_synth import (make_device_generator,
                           make_homography_pair_generator)
from .pairs import EvalPair, PairRecord, load_eval_pairs, load_pairs

__all__ = ["make_device_generator", "make_homography_pair_generator",
           "EvalPair", "PairRecord", "load_eval_pairs", "load_pairs"]
