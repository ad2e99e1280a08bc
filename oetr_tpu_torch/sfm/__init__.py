"""SfM: COLMAP interop, bundle adjustment and triangulation on the card
(port of ``oetr_tpu/sfm``)."""
from .ba import (bundle_adjust, project_residual, residuals, triangulate_dlt,
                 triangulate_points)
from .colmap_model import (Camera, Image, Point3D, qvec2rotmat, read_model,
                           rotmat2qvec, write_model)
from .database import (COLMAPDatabase, image_ids_to_pair_id,
                       pair_id_to_image_ids)
from .reconstruct import (Tracks, build_tracks, export_colmap,
                          export_database, reconstruct)

__all__ = [
    "bundle_adjust", "project_residual", "residuals", "triangulate_dlt",
    "triangulate_points", "Camera", "Image", "Point3D", "qvec2rotmat",
    "read_model", "rotmat2qvec", "write_model", "COLMAPDatabase",
    "image_ids_to_pair_id", "pair_id_to_image_ids", "Tracks",
    "build_tracks", "export_colmap", "export_database", "reconstruct",
]
