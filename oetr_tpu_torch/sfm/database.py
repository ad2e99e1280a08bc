"""COLMAP SQLite database writer, schema-compatible with COLMAP (port of
``oetr_tpu/sfm/database.py``, an own copy of its host code).

The cameras / images / keypoints / descriptors / matches /
two_view_geometries tables and the pair-id packing with MAX_IMAGE_ID =
2^31 - 1, so the port's matches can be ingested by stock COLMAP for SfM.
"""
from __future__ import annotations

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {maxid}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
""".format(maxid=MAX_IMAGE_ID)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """Symmetric pair id (ref: database.py:112-115)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def _blob(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


class COLMAPDatabase(sqlite3.Connection):
    """COLMAP-compatible database (ref: database.py:138-260)."""

    @staticmethod
    def connect(path: str) -> "COLMAPDatabase":
        return sqlite3.connect(path, factory=COLMAPDatabase)

    def create_tables(self) -> None:
        self.executescript(_SCHEMA)

    def add_camera(self, model: int, width: int, height: int,
                   params: np.ndarray, prior_focal_length: bool = False,
                   camera_id: int | None = None) -> int:
        params = np.asarray(params, np.float64)
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height, _blob(params),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q=(1.0, 0.0, 0.0, 0.0), prior_t=(0.0, 0.0, 0.0),
                  image_id: int | None = None) -> int:
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        """keypoints [N, >=2] float32; COLMAP expects 2/4/6 cols
        (ref: database.py:205-219)."""
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.shape[1] in (2, 4, 6)
        self.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                     (image_id,) + keypoints.shape + (_blob(keypoints),))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                     (image_id,) + descriptors.shape + (_blob(descriptors),))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray) -> None:
        """matches [M, 2] uint32 index pairs (ref: database.py:222-233)."""
        assert matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                     (pair_id,) + matches.shape + (_blob(matches),))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray,
                              F=np.eye(3), E=np.eye(3), H=np.eye(3),
                              qvec=np.array([1.0, 0, 0, 0]),
                              tvec=np.zeros(3), config: int = 2) -> None:
        """ref: database.py:236-260."""
        assert matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, "
            "?, ?)",
            (pair_id,) + matches.shape + (
                _blob(matches), config,
                _blob(np.asarray(F, np.float64)),
                _blob(np.asarray(E, np.float64)),
                _blob(np.asarray(H, np.float64)),
                _blob(np.asarray(qvec, np.float64)),
                _blob(np.asarray(tvec, np.float64))))

    # -- readers (for round-tripping in tests / SfM import) --
    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.execute("SELECT rows, cols, data FROM keypoints WHERE "
                           "image_id=?", (image_id,)).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c)

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.execute("SELECT rows, cols, data FROM matches WHERE "
                           "pair_id=?", (pair_id,)).fetchone()
        r, c, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, c)
        return m[:, ::-1] if image_id1 > image_id2 else m
