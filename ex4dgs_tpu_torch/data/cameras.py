"""Camera records: host-side pose/intrinsics + device-side RenderCamera.

Counterpart of `ex4dgs_tpu/data/cameras.py`. Mirrors the reference's
Camera/Cameravideo semantics (scene/cameras.py:21-350): per-frame
timestamp, near/far, optional off-center principal point (cxr/cyr),
per-camera exposure compensation (im_scale, Technicolor), and the
resolution downscale ladder (:162-296). `Camera.render_camera(device)`
gives the port's RenderCamera on a device (cuda unless told otherwise),
built once per device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import resolve_device
from ..ops.math3d import projection_matrix, world_to_view
from ..rendering import RenderCamera


@dataclasses.dataclass
class CameraInfo:
    """Lazy per-frame record from a dataset reader (CameraInfo2 analog)."""

    uid: int
    R: np.ndarray  # camera-to-world rotation (reader convention)
    T: np.ndarray  # world-to-camera translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    near: float
    far: float
    timestamp: float
    cxr: float = 0.0
    cyr: float = 0.0


@dataclasses.dataclass
class Camera:
    """Loaded camera with resolved render resolution."""

    colmap_id: int
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image_name: str
    image_path: str
    width: int  # render resolution
    height: int
    near: float
    far: float
    timestamp: float
    cxr: float = 0.0
    cyr: float = 0.0
    im_scale: float = 1.0
    _render_cameras: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def view(self) -> np.ndarray:
        return world_to_view(self.R, self.T)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.view)[:3, 3]

    def render_camera(self, device=None) -> RenderCamera:
        """This camera's RenderCamera on `device` (cuda unless told
        otherwise)."""
        dev = resolve_device(device)
        cam = self._render_cameras.get(dev)
        if cam is None:
            view = self.view
            P = projection_matrix(self.near, self.far, self.fovx, self.fovy,
                                  self.cxr, self.cyr)
            cam = self._render_cameras[dev] = RenderCamera.from_fov(
                view, P.astype(np.float64) @ view.astype(np.float64),
                self.camera_center, self.width, self.height, self.fovx, self.fovy,
                device=dev,
            )
        return cam


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """The reference's downscale ladder (cameras.py:198-218): -1 auto-caps
    widths above 1600px; 1/2/4/8 divide; other values set the target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def camera_from_info(info: CameraInfo, uid: int, resolution: int,
                     resolution_scale: float = 1.0, im_scale: float = 1.0) -> Camera:
    w, h = resolve_resolution(info.width, info.height, resolution, resolution_scale)
    return Camera(
        colmap_id=info.uid,
        uid=uid,
        R=info.R,
        T=info.T,
        fovx=info.fovx,
        fovy=info.fovy,
        image_name=info.image_name,
        image_path=info.image_path,
        width=w,
        height=h,
        near=info.near,
        far=info.far,
        timestamp=info.timestamp,
        cxr=info.cxr,
        cyr=info.cyr,
        im_scale=im_scale,
    )


def camera_to_json(idx: int, cam) -> dict:
    """Export record (utils/camera_utils-style JSON, cameras.py:330-350)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": idx,
        "img_name": getattr(cam, "image_name", str(idx)),
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [x.tolist() for x in rot],
        "fy": cam.height / (2 * math.tan(getattr(cam, "fovy", 1.0) / 2)),
        "fx": cam.width / (2 * math.tan(getattr(cam, "fovx", 1.0) / 2)),
    }
