"""Utilities: h5 result files in the reference's layout, the trainer's
scalar log."""
from .h5io import SceneResults, pair_key, save_scene_results, stem
from .profiling import ScalarWriter

__all__ = ["SceneResults", "pair_key", "save_scene_results", "stem",
           "ScalarWriter"]
