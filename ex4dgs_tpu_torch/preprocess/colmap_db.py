"""Minimal COLMAP sqlite database writer (the public COLMAP schema).

Counterpart of `ex4dgs_tpu/preprocess/colmap_db.py`. Used to seed
known-pose triangulation (dataset_utils/colmap/pre_colmap.py:82-201 in the
reference does the same with the full upstream COLMAPDatabase class; only
cameras/images inserts are needed for the pipelines here).
"""
from __future__ import annotations

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = f"""
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {MAX_IMAGE_ID}),
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
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


class ColmapDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model: int, width: int, height: int,
                   params: np.ndarray, prior_focal_length: bool = False,
                   camera_id: int | None = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height,
             np.asarray(params, np.float64).tobytes(), prior_focal_length),
        )
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int, prior_q=None, prior_t=None,
                  image_id: int | None = None) -> int:
        q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q, np.float64)
        t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t, np.float64)
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q.tolist(), *t.tolist()),
        )
        return cur.lastrowid

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.close()
