"""LLFF pose handling (the poses_bounds.npy convention used by N3V).

Counterpart of `ex4dgs_tpu/preprocess/llff.py`. Mirrors
dataset_utils/etc_utils.py:8-72: the stored [3,5] blocks are [-y x z | t |
hwf] camera-to-world; conversion to world-to-camera follows the same column
permutation + inversion chain.
"""
from __future__ import annotations

import numpy as np


def llff_poses_to_w2c(poses: np.ndarray) -> list[np.ndarray]:
    """[3, 5, N] LLFF pose stack -> list of [4, 4] world-to-camera matrices."""
    # column permutation: (-y, x, z) -> (x, y, z) camera axes
    p = np.concatenate(
        [poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :],
         poses[:, 3:4, :], poses[:, 4:5, :]], axis=1
    )
    p = p[:, 0:4, :]  # drop hwf
    p = p.transpose([2, 0, 1])  # [N, 3, 4]
    n = p.shape[0]
    bottom = np.zeros((n, 1, 4))
    bottom[:, 0, 3] = 1
    c2w = np.concatenate([p, bottom], axis=1)
    w2c = np.linalg.inv(c2w)
    return [w2c[i] for i in range(n)]


def load_poses_bounds(path: str):
    """poses_bounds.npy -> (llff pose stack [3,5,N], bounds [N,2], (H,W,focal))."""
    pb = np.load(path)
    poses = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, -2:]
    H, W, focal = poses[0, :, -1]
    return poses.transpose(1, 2, 0), bounds, (int(H), int(W), float(focal))
