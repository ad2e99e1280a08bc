"""OETR training on one device: losses, the AdamW + MultiStep train step,
checkpoints with resume, IoU-recall validation and the command line
(``python -m oetr_tpu_torch.training.cli``). The SuperPoint, SuperGlue,
LoFTR and ContextDesc trainers of the JAX package are not ported yet."""
from .losses import (aux_match_loss, cycle_overlap_loss, difficulty_weights,
                     heatmap_ce_loss, interpolate_depth, oetr_losses,
                     size_loss, token_infonce_loss,
                     token_matches_from_geometry, total_loss,
                     warped_box_via_depth)
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
]
