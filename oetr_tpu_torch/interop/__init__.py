"""Weight conversion into the port's modules."""
from .from_flax import (convert_flax_params, convert_superglue_params,
                        convert_superpoint_params)

__all__ = ["convert_flax_params", "convert_superglue_params",
           "convert_superpoint_params"]
