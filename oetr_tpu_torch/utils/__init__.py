"""Utilities: h5 result files in the reference's layout."""
from .h5io import SceneResults, pair_key, save_scene_results, stem

__all__ = ["SceneResults", "pair_key", "save_scene_results", "stem"]
