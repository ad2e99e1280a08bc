"""Box algebra used by the OETR heads."""
from .boxes import box_tlbr_to_xyxy, boxes_from_prob_map, mesh_grid_centers

__all__ = ["box_tlbr_to_xyxy", "boxes_from_prob_map", "mesh_grid_centers"]
