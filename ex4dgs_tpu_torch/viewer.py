"""Live network viewer — the SIBR remote-viewer wire protocol.

Counterpart of `ex4dgs_tpu/viewer.py`, a behavioural mirror of the
reference's gaussian_renderer/network_gui.py: a non-blocking TCP listener;
each message is a 4-byte little-endian length + JSON camera/flags; the
reply is raw RGB bytes followed by a length-prefixed verify string. The
incoming matrices arrive in the viewer's convention (column-flipped,
transposed w.r.t. the mathematical matrices) and are converted here into a
`RenderCamera` on the viewer's device (cuda unless told otherwise).
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .rendering import RenderCamera


class ViewerRequest(NamedTuple):
    camera: RenderCamera | None  # None: a 0-resolution keep-alive
    do_training: bool
    shs_python: bool
    rot_scale_python: bool
    keep_alive: bool
    scaling_modifier: float
    timestamp: float


class NetworkViewer:
    def __init__(self, host: str = "127.0.0.1", port: int = 9898, device=None):
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.conn = None

    def init(self, retries: int = 10) -> int:
        """Bind with a port-retry loop (train.py:413-418). port=0 asks the
        OS for an ephemeral port; the bound port is returned."""
        for i in range(retries):
            try:
                self.listener.bind((self.host, self.port + i if self.port else 0))
                self.listener.listen()
                self.listener.settimeout(0)
                self.port = self.listener.getsockname()[1]
                return self.port
            except OSError:
                continue
        raise OSError("no free viewer port")

    def try_connect(self) -> None:
        try:
            self.conn, _addr = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:  # no viewer waiting (the listener does not block)
            pass

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer peer closed")
            buf += chunk
        return buf

    def _read_message(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def receive(self) -> ViewerRequest:
        msg = self._read_message()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return ViewerRequest(None, False, False, False, False, 1.0, 0.0)
        view_t = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        proj_t = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        # the viewer sends GL-flavoured transposed matrices with flipped y/z
        view_t[:, 1] *= -1
        view_t[:, 2] *= -1
        proj_t[:, 1] *= -1
        view = view_t.T  # the mathematical world->camera matrix
        proj = proj_t.T
        campos = np.linalg.inv(view)[:3, 3]
        cam = RenderCamera.from_fov(view, proj, campos, width, height, msg["fov_x"],
                                    msg["fov_y"], device=self.device)
        return ViewerRequest(
            camera=cam,
            do_training=bool(msg["train"]),
            shs_python=bool(msg["shs_python"]),
            rot_scale_python=bool(msg["rot_scale_python"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=float(msg["scaling_modifier"]),
            timestamp=float(msg.get("timestamp", 0.0)),
        )

    @staticmethod
    def to_bytes(image) -> bytes:
        """[H, W, 3] float in [0, 1] (tensor or array) -> the wire's RGB
        bytes, converted as the JAX viewer converts them (clip, *255,
        uint8)."""
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        return (np.clip(image, 0, 1) * 255).astype(np.uint8).tobytes()

    def send(self, image, verify: str) -> None:
        """image: [H, W, 3] float in [0, 1], tensor or array, or None."""
        if image is not None:
            self.conn.sendall(self.to_bytes(image))
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn, source_path: str, training_active: bool = True):
        """One GUI service round (train.py:93-106): accept if unconnected,
        else serve requests until the viewer releases the loop. A request
        that fails (a malformed message, a failed render) is reported on
        stderr and drops the connection, as does a peer that closed, so
        training goes on; the next poll accepts a new one."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                req = self.receive()
                img = None
                if req.camera is not None:
                    img = render_fn(req)
                self.send(img, source_path)
                if req.do_training and (training_active or not req.keep_alive):
                    break
            except Exception as e:  # the boundary that must keep training running
                if not isinstance(e, ConnectionError):  # not just the viewer leaving
                    traceback.print_exc()
                self.conn.close()
                self.conn = None

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
