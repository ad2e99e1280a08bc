"""Weight conversion into the port's modules: flax trees
(``from_flax``, and back with ``to_flax``), the reference's torch
checkpoints (``torch_convert``), and orbax checkpoints read and written
without orbax (``orbax_read``, ``orbax_write``, over ``ocdbt`` and
``zstd``)."""
from .from_flax import (convert_aslfeat_params,
                        convert_channelattention_params,
                        convert_contextdesc_augmenter_params,
                        convert_contextdesc_params, convert_cotr_params,
                        convert_d2net_params, convert_disk_params,
                        convert_fcos_params, convert_flax_params,
                        convert_loftr_params, convert_patchembed_params,
                        convert_r2d2_params,
                        convert_spatialattention_params,
                        convert_superglue_params,
                        convert_superpoint_net_params,
                        convert_superpoint_params, flax_state_dict,
                        to_flax)
from .orbax_read import read_checkpoint
from .orbax_write import write_checkpoint
from .torch_convert import (MissingReferenceKey, convert_oetr_state_dict,
                            load_reference_checkpoint, reference_state_dict,
                            skipped_keys)

__all__ = ["convert_aslfeat_params", "convert_channelattention_params",
           "convert_contextdesc_augmenter_params",
           "convert_contextdesc_params", "convert_cotr_params",
           "convert_d2net_params", "convert_disk_params",
           "convert_fcos_params", "convert_flax_params",
           "convert_loftr_params", "convert_patchembed_params",
           "convert_r2d2_params", "convert_spatialattention_params",
           "convert_superglue_params", "convert_superpoint_net_params",
           "convert_superpoint_params", "flax_state_dict", "to_flax",
           "read_checkpoint", "write_checkpoint",
           "MissingReferenceKey",
           "convert_oetr_state_dict", "load_reference_checkpoint",
           "reference_state_dict", "skipped_keys"]
