"""Utilities: h5 result files in the reference's layout, the trainer's
scalar log, the stage timer and frame source, and the plots (``viz``)."""
from .h5io import SceneResults, pair_key, save_scene_results, stem
from .profiling import ScalarWriter
from .timer import AverageTimer, VideoStreamer

__all__ = ["SceneResults", "pair_key", "save_scene_results", "stem",
           "ScalarWriter", "AverageTimer", "VideoStreamer"]
