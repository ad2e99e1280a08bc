"""On-device synthetic data of the port."""
from .device_synth import (make_device_generator,
                           make_homography_pair_generator)

__all__ = ["make_device_generator", "make_homography_pair_generator"]
