"""The port's data: on-device synthetic pairs, pair-list parsing, the
MegaDepth training pairs with their ground-truth boxes on the host, the
host image service (``images``; ``native``, the C++ loader), the host
scene generator that writes MegaDepth-style trees (``synthetic``) and the
offline pair-list generation (``preprocess``)."""
from .device_synth import (make_device_generator,
                           make_homography_pair_generator)
from .gt import overlap_bbox_np
from .images import (PreparedImage, batch_pairs, prepare_image,
                     read_image, resize_area)
from .megadepth import MegaDepthPairsDataset
from .pairs import EvalPair, PairRecord, load_eval_pairs, load_pairs
from .preprocess import generate_pairs, process_scene
from .synthetic import generate_scene, generate_scene_3d

__all__ = ["make_device_generator", "make_homography_pair_generator",
           "overlap_bbox_np", "MegaDepthPairsDataset", "EvalPair",
           "PairRecord", "load_eval_pairs", "load_pairs", "PreparedImage",
           "batch_pairs", "prepare_image", "read_image", "resize_area",
           "generate_pairs", "process_scene", "generate_scene",
           "generate_scene_3d"]
