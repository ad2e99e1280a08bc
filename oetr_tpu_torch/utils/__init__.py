"""Utilities: h5 result files in the reference's layout, the profiling
helpers and the trainer's scalar log, the stage timer and frame source,
and the plots (``viz``)."""
from .h5io import SceneResults, pair_key, save_scene_results, stem
from .profiling import (ScalarWriter, benchmark, device_memory_stats,
                        speed_of_light, trace)
from .timer import AverageTimer, VideoStreamer

__all__ = ["SceneResults", "pair_key", "save_scene_results", "stem",
           "ScalarWriter", "benchmark", "device_memory_stats",
           "speed_of_light", "trace", "AverageTimer", "VideoStreamer"]
