"""SIBR-viewer network bridge, the gaussian_renderer/network_gui.py:26-85
protocol (counterpart of gaustar_tpu/tools/network_gui.py).

A wire-compatible server: the SIBR remote viewer connects over TCP, sends
little-endian length-prefixed JSON camera messages ({resolution_x/y, train,
fov_x/y, z_near/far, shs_python, rot_scale_python, keep_alive,
scaling_modifier, view_matrix, view_projection_matrix}), and receives raw RGB
bytes followed by a length-prefixed verify string. The y/z column sign flips
that the reference applies to incoming matrices are reproduced.

Inside a training loop (gaussian_splatting/train.py:83-101):

    gui = NetworkGUI()
    ...
    gui.poll(render_fn, keep_alive_default=True, source_path=dataset_path)

where render_fn(camera, scaling_modifier) -> [H, W, 3] image in [0, 1] (a
tensor on any device, or an array). The server listens on 127.0.0.1 unless
the caller names another host.
"""

from __future__ import annotations

import json
import socket

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, fov2focal


def camera_from_viewer_message(msg, device="cuda") -> Camera | None:
    """The Camera of the viewer's matrices (MiniCam), or None for a message
    without an image size."""
    width = msg["resolution_x"]
    height = msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(msg["view_matrix"], np.float64).reshape(4, 4)
    view[:, 1] *= -1
    view[:, 2] *= -1
    # The reference stores transposed (glm) matrices; the w2c is view.T.
    fx = fov2focal(msg["fov_x"], width)
    fy = fov2focal(msg["fov_y"], height)
    return Camera.from_w2c(view.T, fx, fy, width / 2.0, height / 2.0, int(width), int(height), device=device,
                           znear=float(msg.get("z_near", 0.01)), zfar=float(msg.get("z_far", 100.0)))


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device="cuda"):
        self.device = device
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()

    def try_connect(self):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read_msg(self):
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def send(self, image_bytes: bytes | None, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn, keep_alive_default: bool, source_path: str = ""):
        """One training-loop poll: serve a connected viewer until it hands
        control back (train.py:83-101). Returns True while training should
        run. A viewer that disconnects or sends a malformed message is
        dropped; errors of render_fn propagate."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                msg = self._read_msg()
            except (OSError, ValueError):
                self.conn = None
                break
            cam = camera_from_viewer_message(msg, self.device)
            img_bytes = None
            if cam is not None:
                img = render_fn(cam, float(msg.get("scaling_modifier", 1.0)))
                img = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
                img_bytes = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8).tobytes()
            try:
                self.send(img_bytes, source_path)
            except OSError:
                self.conn = None
                break
            if bool(msg.get("train", True)) and not bool(msg.get("keep_alive", keep_alive_default)):
                return True
            if cam is None and not keep_alive_default:
                return True
        return True
