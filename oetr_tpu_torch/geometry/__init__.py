"""Box algebra used by the OETR heads, and ground-truth overlap boxes."""
from .boxes import box_tlbr_to_xyxy, boxes_from_prob_map, mesh_grid_centers
from .overlap import (overlap_bbox, overlap_bbox_pair, rigid_inverse,
                      warp_grid_via_depth)

__all__ = ["box_tlbr_to_xyxy", "boxes_from_prob_map", "mesh_grid_centers",
           "overlap_bbox", "overlap_bbox_pair", "rigid_inverse",
           "warp_grid_via_depth"]
