"""MegaDepth training pairs on the host (port of
``oetr_tpu/data/megadepth.py``, an own copy).

Per-epoch resampling of the pair list with a random central match inside
each pair's stored overlap boxes (validation pinned to numpy seed 42, the
global random state restored after), aspect-preserving resize to
``image_size``, a crop around the central match clamped at the borders,
ground-truth overlap boxes and masks computed online (``data/gt.py``), and
fixed-shape numpy batches for the train step. It draws from numpy's global
random state as JAX's does, so the same seed gives the same samples.

Images and masks are read with the port's own decoders (``data/jpeg.py``,
``cv2.imread``'s pixels), resized with its copies of cv2's INTER_LINEAR
and INTER_NEAREST, and the depth maps read with its HDF5 subset
(``utils/hdf5.py``): nothing needs cv2 or h5py, so the loader runs on the
machine with the CUDA card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils import hdf5
from .gt import overlap_bbox_np
from .jpeg import imread, resize_linear_u8, resize_nearest
from .pairs import PairRecord, load_pairs


def resize_dataset(img: np.ndarray, image_size: tuple[int, int],
                   depth: bool = False):
    """Aspect-preserving resize, the short side to image_size[0] (nearest
    for depth maps and masks, cv2's uint8 bilinear otherwise): (resized,
    (ratio_x, ratio_y))."""
    h, w = img.shape[:2]
    if w > h:
        new_w, new_h = int(image_size[0] / h * w), image_size[0]
    else:
        new_w, new_h = image_size[0], int(image_size[0] * h / w)
    resize = resize_nearest if depth else resize_linear_u8
    out = resize(img, (new_w, new_h))
    return out, (new_w / w, new_h / h)       # (ratio_x, ratio_y)


def central_crop(image1, image2, central_match, image_size):
    """Crops of image_size centred on the central match (y1, x1, y2, x2),
    clamped at the borders: (crop1, offset1 (row, col), crop2, offset2)."""
    def offsets(img, cy, cx, hw):
        i = max(int(cy) - hw[0] // 2, 0)
        if i + hw[0] >= img.shape[0]:
            i = img.shape[0] - hw[0]
        j = max(int(cx) - hw[1] // 2, 0)
        if j + hw[1] >= img.shape[1]:
            j = img.shape[1] - hw[1]
        return i, j

    i1, j1 = offsets(image1, central_match[0], central_match[1], image_size)
    i2, j2 = offsets(image2, central_match[2], central_match[3], image_size)
    return (image1[i1:i1 + image_size[0], j1:j1 + image_size[1]],
            np.array([i1, j1]),
            image2[i2:i2 + image_size[0], j2:j2 + image_size[1]],
            np.array([i2, j2]))


@dataclass
class SampledPair:
    record: PairRecord
    central_match: np.ndarray   # (y1, x1, y2, x2) in original pixels


class MegaDepthPairsDataset:
    """Pairs-txt backed dataset with per-epoch resampling."""

    def __init__(self, base_path: str, pairs_list_path: str,
                 image_size: tuple[int, int] = (640, 640),
                 pairs_per_epoch: int | None = None, train: bool = True,
                 with_mask: bool = False):
        self.base_path = base_path
        self.image_size = image_size
        self.pairs_per_epoch = pairs_per_epoch
        self.train = train
        self.with_mask = with_mask
        self.records = load_pairs(pairs_list_path)
        self.dataset: list[SampledPair] = []
        self.build_dataset()

    def build_dataset(self) -> None:
        """Resample the pairs and their central matches (validation: numpy
        seed 42, the global state restored after)."""
        if not self.train:
            state = np.random.get_state()
            np.random.seed(42)
        if self.pairs_per_epoch:
            ids = np.random.choice(len(self.records), self.pairs_per_epoch)
        else:
            ids = np.arange(len(self.records))
        self.dataset = []
        for i in ids:
            rec = self.records[i]
            b1, b2 = rec.overlap1, rec.overlap2
            px = np.random.randint(b1[0], b1[2])
            py = np.random.randint(b1[1], b1[3])
            x_ratio = (px - b1[0]) / (b1[2] - b1[0])
            y_ratio = (py - b1[1]) / (b1[3] - b1[1])
            qx = (b2[2] - b2[0]) * x_ratio + b2[0]
            qy = (b2[3] - b2[1]) * y_ratio + b2[1]
            self.dataset.append(SampledPair(
                rec, np.array([py, px, qy, qx], dtype=float)))
        if self.train:
            np.random.shuffle(self.dataset)
        else:
            np.random.set_state(state)

    def __len__(self) -> int:
        return len(self.dataset)

    def _read_depth(self, rel: str) -> np.ndarray:
        with hdf5.File(os.path.join(self.base_path, rel), "r") as f:
            return np.array(f["/depth"])

    def __getitem__(self, idx: int) -> dict:
        sp = self.dataset[idx]
        rec = sp.record
        image1 = imread(os.path.join(self.base_path, rec.image_path1))
        image2 = imread(os.path.join(self.base_path, rec.image_path2))
        depth1 = self._read_depth(rec.depth_path1)
        depth2 = self._read_depth(rec.depth_path2)

        image1, r1 = resize_dataset(image1, self.image_size)
        image2, r2 = resize_dataset(image2, self.image_size)
        central = sp.central_match * np.array([r1[1], r1[0], r2[1], r2[0]])
        image1, crop1, image2, crop2 = central_crop(image1, image2, central,
                                                    self.image_size)
        depth1, _ = resize_dataset(depth1, self.image_size, depth=True)
        depth2, _ = resize_dataset(depth2, self.image_size, depth=True)
        depth1 = depth1[crop1[0]:crop1[0] + self.image_size[0],
                        crop1[1]:crop1[1] + self.image_size[1]]
        depth2 = depth2[crop2[0]:crop2[0] + self.image_size[0],
                        crop2[1]:crop2[1] + self.image_size[1]]

        # GT overlap in the crop frames. ratio args are (y, x).
        box1, mask1, box2, mask2, valid = overlap_bbox_np(
            rec.K1, depth1, rec.pose1, crop1, (r1[1], r1[0]),
            rec.K2, depth2, rec.pose2, crop2, (r2[1], r2[0]))

        seg = {}
        if self.with_mask:
            # Segmentation masks lie beside the images under masks/ as
            # .png, resized (nearest) and cropped as the image is.
            def load_seg(rel, crop):
                p = os.path.join(
                    self.base_path,
                    rel.replace("images", "masks").replace("imgs", "masks")
                    .replace(".jpg", ".png").replace(".JPG", ".png"))
                if not os.path.isfile(p):
                    return np.zeros(self.image_size, np.float32)
                m = imread(p, grayscale=True)
                m, _ = resize_dataset(m, self.image_size, depth=True)
                m = m[crop[0]:crop[0] + self.image_size[0],
                      crop[1]:crop[1] + self.image_size[1]]
                return m.astype(np.float32)

            seg = {"seg_mask1": load_seg(rec.image_path1, crop1),
                   "seg_mask2": load_seg(rec.image_path2, crop2)}

        return {
            **seg,
            "image1": image1.astype(np.float32) / 255.0,
            "image2": image2.astype(np.float32) / 255.0,
            "depth1": depth1.astype(np.float32),
            "depth2": depth2.astype(np.float32),
            "intrinsics1": rec.K1.astype(np.float32),
            "intrinsics2": rec.K2.astype(np.float32),
            "pose1": rec.pose1.astype(np.float32),
            "pose2": rec.pose2.astype(np.float32),
            "bbox1": crop1.astype(np.float32),
            "bbox2": crop2.astype(np.float32),
            "ratio1": np.array(r1, np.float32),
            "ratio2": np.array(r2, np.float32),
            "overlap_box1": box1.astype(np.float32),
            "overlap_box2": box2.astype(np.float32),
            "overlap_valid": bool(valid),
            "file_name": (os.path.basename(rec.image_path1) + "_"
                          + os.path.basename(rec.image_path2)),
        }

    def batches(self, batch_size: int, drop_last: bool = True,
                geometry: bool = False):
        """Stacked fixed-shape numpy batches for the train step.

        ``geometry=True`` also stacks K1/2, depth1/2, pose1/2, crop1/2 and
        ratio1/2, which the depth-warped cycle loss and the token InfoNCE
        read, the ratios as (ratio_y, ratio_x), the warp's convention.
        """
        n = len(self)
        for start in range(0, n - (batch_size - 1 if drop_last else 0),
                           batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, n))]
            if len(items) < batch_size and drop_last:
                return
            batch = {}
            for k in ("image1", "image2", "overlap_box1", "overlap_box2"):
                batch[k] = np.stack([it[k] for it in items])
            batch["overlap_valid"] = np.array(
                [it["overlap_valid"] for it in items], bool)
            if geometry:
                for side in ("1", "2"):
                    batch["K" + side] = np.stack(
                        [it["intrinsics" + side] for it in items])
                    batch["depth" + side] = np.stack(
                        [it["depth" + side] for it in items])
                    batch["pose" + side] = np.stack(
                        [it["pose" + side] for it in items])
                    batch["crop" + side] = np.stack(
                        [it["bbox" + side] for it in items])
                    batch["ratio" + side] = np.stack(
                        [it["ratio" + side][::-1] for it in items])
            yield batch
