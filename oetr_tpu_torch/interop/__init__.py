"""Weight conversion into the port's modules."""
from .from_flax import convert_flax_params

__all__ = ["convert_flax_params"]
