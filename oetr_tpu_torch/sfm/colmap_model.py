"""COLMAP sparse-model I/O (binary + text) and quaternion utilities (port
of ``oetr_tpu/sfm/colmap_model.py``, an own copy of its host code).

Format-compatible reader and writer of COLMAP's cameras / images /
points3D in the .bin and .txt layouts, and the qvec <-> rotation-matrix
conversions: the port's SfM results go to stock COLMAP tooling, and COLMAP
reconstructions come back for ATE evaluation.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix
    (ref: read_write_model.py:477-494)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x ** 2 - 2 * z ** 2,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x ** 2 - 2 * y ** 2],
    ])


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP quaternion (ref: :497-510)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_next_bytes(fid, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, fid.read(num_bytes))


def _write_bytes(fid, data, fmt, endian="<"):
    fid.write(struct.pack(endian + fmt, *data))


# ---------- binary ----------

def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            cid, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            np_ = CAMERA_MODEL_IDS[model_id].num_params
            params = _read_next_bytes(f, 8 * np_, "d" * np_)
            cameras[cid] = Camera(cid, CAMERA_MODEL_IDS[model_id].model_name,
                                  w, h, np.array(params))
    return cameras


def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        _write_bytes(f, (len(cameras),), "Q")
        for cam in cameras.values():
            model_id = CAMERA_MODEL_NAMES[cam.model].model_id
            _write_bytes(f, (cam.id, model_id, cam.width, cam.height), "iiQQ")
            _write_bytes(f, tuple(cam.params), "d" * len(cam.params))


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            vals = _read_next_bytes(f, 64, "idddddddi")
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(f, 24 * n2d, "ddq" * n2d)
            xys = np.array(data).reshape(-1, 3)[:, :2] if n2d else \
                np.zeros((0, 2))
            p3d = (np.array(data).reshape(-1, 3)[:, 2].astype(np.int64)
                   if n2d else np.zeros(0, np.int64))
            images[iid] = Image(iid, qvec, tvec, cam_id,
                                name.decode("utf-8"), xys, p3d)
    return images


def write_images_binary(images, path):
    with open(path, "wb") as f:
        _write_bytes(f, (len(images),), "Q")
        for im in images.values():
            _write_bytes(f, (im.id, *im.qvec, *im.tvec, im.camera_id),
                         "idddddddi")
            f.write(im.name.encode("utf-8") + b"\x00")
            _write_bytes(f, (len(im.xys),), "Q")
            for xy, pid in zip(im.xys, im.point3D_ids):
                _write_bytes(f, (xy[0], xy[1], int(pid)), "ddq")


def read_points3D_binary(path):
    points = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            err = vals[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(pid, xyz, rgb, err,
                                  np.array(track[0::2]),
                                  np.array(track[1::2]))
    return points


def write_points3D_binary(points, path):
    with open(path, "wb") as f:
        _write_bytes(f, (len(points),), "Q")
        for p in points.values():
            _write_bytes(f, (p.id, *p.xyz, *(int(c) for c in p.rgb),
                             p.error), "QdddBBBd")
            _write_bytes(f, (len(p.image_ids),), "Q")
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                _write_bytes(f, (int(iid), int(pidx)), "ii")


# ---------- text ----------

def write_cameras_text(cameras, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def read_cameras_text(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cameras[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array(el[4:], float))
    return cameras


def write_images_text(images, path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for im in images.values():
            q = " ".join(map(str, im.qvec))
            t = " ".join(map(str, im.tvec))
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{xy[0]} {xy[1]} {int(pid)}"
                for xy, pid in zip(im.xys, im.point3D_ids)) + "\n")


def read_images_text(path):
    images = {}
    with open(path) as f:
        # Keep empty point lines (images with zero observations) — only
        # strip comments.
        lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        if not lines[i].strip():
            continue
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], float)
        tvec = np.array(el[5:8], float)
        pts = lines[i + 1].split()
        xys = np.array(pts, float).reshape(-1, 3)[:, :2] if pts else \
            np.zeros((0, 2))
        pids = (np.array(pts, float).reshape(-1, 3)[:, 2].astype(np.int64)
                if pts else np.zeros(0, np.int64))
        images[iid] = Image(iid, qvec, tvec, int(el[8]), el[9], xys, pids)
    return images


def read_model(path, ext=".bin"):
    """Load (cameras, images, points3D) (ref: read_write_model.py:453-462)."""
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3D_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            None)


def write_model(cameras, images, points3D, path, ext=".bin"):
    """ref: read_write_model.py:465-474."""
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3D_binary(points3D, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
