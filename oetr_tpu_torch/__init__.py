"""PyTorch + CUDA port of oetr_tpu: the OETR forward and its trainer, the
matching trainers (SuperPoint, SuperGlue, LoFTR, ContextDesc; all in
``oetr_tpu_torch.training``), the FCOS head and its losses, the
overlap-guided sparse (SuperPoint +
SuperGlue) and dense (LoFTR) matching pipelines, the public matching API
(``build_model``, ``build_shipped_model`` from the committed trained
checkpoints, ``get_matches``, ``get_pose``; the registry of
extractors and matchers: D2-Net, R2D2, DISK, ASLFeat, SIFT, ContextDesc,
NN, DISK's matcher, COTR, ICP), the host image service and benchmark
runner, the on-device synthetic scene and homography pair generators,
two-view pose estimation, the benchmark evaluation, and reconstruction
(``oetr_tpu_torch.sfm``: tracks, DLT triangulation, bundle adjustment,
COLMAP model and database export; ``python -m oetr_tpu_torch.sfm.demo``).

The package stands alone: it imports torch and numpy, never JAX or the
``oetr_tpu`` package, so it runs where only torch is installed (the
machine with the CUDA card has neither flax nor orbax, which the JAX
package's models and checkpoints need); it reads the committed orbax
checkpoints with its own code (``interop.read_checkpoint``).
Entry points (``build_oetr``, ``build_superpoint``,
``build_superpoint_net``, ``build_superglue``, ``build_loftr``,
``build_fcos_head``, ``build_model``, ``models.registry.build``, ``get_pose``,
the modules and pipelines they feed, and the generators of
``make_device_generator`` and ``make_homography_pair_generator``) run on
the card unless the caller passes ``device="cpu"``; reading images and
drawing need cv2 and matplotlib, the h5 results h5py, each imported where
it is used. ``reconstruct`` runs on the card unless the caller passes
``device="cpu"``; ``estimate_pose``, ``bundle_adjust``,
``triangulate_points`` and the other geometry functions run where their
tensors lie;
``validation_error`` and the benchmark harnesses take numpy and run the
estimator on the card unless the caller passes ``device="cpu"``. The
train steps run where their model's parameters lie, the HA labeler on its
network's device and ``make_corner_labeler`` on ``device="cuda"`` by
default. ``oetr_tpu_torch.parallel`` runs them over several ranks (NCCL on
the card, gloo with ``device="cpu"``); ``oetr_tpu_torch.entry`` has the
flagship forward and ``dryrun_multichip``.
"""
from .config import (BackboneConfig, LossConfig, NeckConfig, OETRConfig,
                     TrainConfig, oetr_fc_r50_config, oetr_r50_config,
                     oetr_r50_kernels_config, replace)
from .data import make_device_generator, make_homography_pair_generator
from .evalx import pose_auc, validation_error
from .geometry import (estimate_pose, pose_error, ransac_essential,
                       ransac_homography, recover_pose)
from .models import (OETR, FCOSHead, LoFTR, SuperGlue, SuperPoint,
                     SuperPointNet, build_fcos_head, build_loftr, build_oetr,
                     build_superglue, build_superpoint, build_superpoint_net,
                     decode_boxes)
from .pipelines import (DensePipeline, PipelineConfig, SparsePipeline,
                        build_model, build_shipped_model, get_matches,
                        get_pose, run_benchmark)
from .sfm import (bundle_adjust, export_colmap, export_database, reconstruct,
                  triangulate_points)

__all__ = ["BackboneConfig", "LossConfig", "NeckConfig", "OETRConfig",
           "TrainConfig", "oetr_fc_r50_config",
           "oetr_r50_config", "oetr_r50_kernels_config", "replace", "OETR",
           "build_oetr", "decode_boxes", "SuperGlue", "SuperPoint",
           "build_superglue",
           "build_superpoint", "SuperPointNet", "build_superpoint_net",
           "FCOSHead", "build_fcos_head", "LoFTR", "build_loftr", "PipelineConfig",
           "SparsePipeline", "DensePipeline", "make_device_generator",
           "make_homography_pair_generator", "estimate_pose",
           "ransac_essential", "recover_pose", "ransac_homography",
           "pose_error", "validation_error", "pose_auc", "build_model",
           "build_shipped_model",
           "get_matches", "get_pose", "run_benchmark", "bundle_adjust",
           "export_colmap", "export_database", "reconstruct",
           "triangulate_points"]
