"""Training on one device: OETR's trainer (losses, the AdamW + MultiStep
train step, checkpoints with resume, IoU-recall validation and the command
line, ``python -m oetr_tpu_torch.training.cli``) and the matching trainers
of the JAX package: SuperPoint (MagicPoint detector loss, descriptor hinge,
homographic-adaptation and Shi-Tomasi labelers), SuperGlue (the transport
NLL through the plain Sinkhorn), LoFTR (coarse and fine losses) and
ContextDesc (InfoNCE and matchability). The matching steps take a torch
optimizer, an optional ``StepScheduler`` and optax's global-norm clip
(``optim.py``)."""
from .contextdesc import (contextdesc_info_nce, contextdesc_pairs_batch,
                          homography_gt_matches, make_contextdesc_train_step,
                          matchability_bce)
from .loftr import (loftr_coarse_loss, loftr_fine_loss,
                    make_loftr_train_step, shift_pair_gt,
                    warp_cell_centers_batch)
from .losses import (aux_match_loss, cycle_overlap_loss, difficulty_weights,
                     heatmap_ce_loss, interpolate_depth, oetr_losses,
                     size_loss, token_infonce_loss,
                     token_matches_from_geometry, total_loss,
                     warped_box_via_depth)
from .optim import (apply_update, clip_by_global_norm_,
                    piecewise_constant_schedule)
from .superglue import (gt_matches_batch, make_superglue_train_step,
                        superglue_nll_loss)
from .superpoint import (cell_centers, corners_to_cell_labels,
                         descriptor_hinge_loss, draw_ha_homographies,
                         ha_labels, ha_scores, homography_pairs_batch,
                         labels_from_scores, magicpoint_loss,
                         make_corner_labeler,
                         make_ha_labeler, make_superpoint_joint_ha_train_step,
                         make_superpoint_joint_train_step,
                         make_superpoint_train_step, random_homography,
                         shi_tomasi_scores, synthetic_shapes_batch)
from .train import (StepScheduler, TrainState, batch_to,
                    create_train_state, global_grad_norm,
                    latest_checkpoint_step, load_checkpoint, loss_fn,
                    make_optimizer, make_train_step, multistep_schedule,
                    save_checkpoint)
from .validation import evaluate

__all__ = [
    "aux_match_loss", "cycle_overlap_loss", "difficulty_weights",
    "heatmap_ce_loss", "interpolate_depth", "oetr_losses", "size_loss",
    "token_infonce_loss", "token_matches_from_geometry", "total_loss",
    "warped_box_via_depth", "StepScheduler",
    "TrainState", "batch_to", "create_train_state", "global_grad_norm",
    "latest_checkpoint_step", "load_checkpoint", "loss_fn", "make_optimizer",
    "make_train_step", "multistep_schedule", "save_checkpoint", "evaluate",
    "apply_update", "clip_by_global_norm_", "piecewise_constant_schedule",
    "cell_centers", "corners_to_cell_labels", "descriptor_hinge_loss",
    "draw_ha_homographies", "ha_labels", "ha_scores",
    "homography_pairs_batch", "labels_from_scores", "shi_tomasi_scores",
    "magicpoint_loss", "make_corner_labeler", "make_ha_labeler",
    "make_superpoint_joint_ha_train_step",
    "make_superpoint_joint_train_step", "make_superpoint_train_step",
    "random_homography", "synthetic_shapes_batch", "gt_matches_batch",
    "make_superglue_train_step", "superglue_nll_loss", "loftr_coarse_loss",
    "loftr_fine_loss", "make_loftr_train_step", "shift_pair_gt",
    "warp_cell_centers_batch", "contextdesc_info_nce",
    "contextdesc_pairs_batch", "homography_gt_matches",
    "make_contextdesc_train_step", "matchability_bce",
]
