"""Geometry: box algebra of the OETR heads, ground-truth overlap boxes,
two-view epipolar geometry, homographies and pose estimation."""
from .boxes import box_tlbr_to_xyxy, boxes_from_prob_map, mesh_grid_centers
from .epipolar import (angle_error_mat, angle_error_vec, essential_from_pose,
                       normalize_keypoints, pose_error, project_points,
                       sampson_error, skew, symmetric_epipolar_error,
                       to_homogeneous, transform_points, unnormalize_keypoints)
from .homography import (apply_homography, homography_dlt, ransac_homography,
                         similarity_from_2pts, similarity_umeyama)
from .overlap import (overlap_bbox, overlap_bbox_pair, rigid_inverse,
                      warp_grid_via_depth)
from .ransac import (decompose_essential, decompose_homography, essential_8pt,
                     estimate_pose, ransac_essential, recover_pose)

__all__ = ["box_tlbr_to_xyxy", "boxes_from_prob_map", "mesh_grid_centers",
           "angle_error_mat", "angle_error_vec", "essential_from_pose",
           "normalize_keypoints", "pose_error", "project_points",
           "sampson_error", "skew", "symmetric_epipolar_error",
           "to_homogeneous", "transform_points", "unnormalize_keypoints",
           "apply_homography", "homography_dlt", "ransac_homography",
           "similarity_from_2pts", "similarity_umeyama",
           "overlap_bbox", "overlap_bbox_pair", "rigid_inverse",
           "warp_grid_via_depth", "decompose_essential",
           "decompose_homography", "essential_8pt", "estimate_pose",
           "ransac_essential", "recover_pose"]
