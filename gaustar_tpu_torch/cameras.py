"""Camera model (counterpart of gaustar_tpu/cameras.py).

Per-camera intrinsics (fx, fy, cx, cy, width, height) and the world-to-camera
rigid transform, stored as the reference stores them: R is the c2w rotation
(the transposed w2c rotation) and T the w2c translation. From them come the
matrices the rasterizer reads:

  - `view`: the 4x4 world-to-view matrix, applied as view[:3, :3] @ p + view[:3, 3];
  - `proj`: the GL perspective with SuGaR's principal-point terms
    P[0, 2] = (cx - W/2)/s, P[1, 2] = (cy - H/2)/s, s = min(W, H)/2;
  - `full_proj = proj @ view`;
  - `camera_center`: the world-space camera position.

Float fields are float32 tensors on the camera's device; a batched camera
(`stack_cameras`) carries a leading axis on each of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.utils.general import resolve_device


def fov2focal(fov, pixels):
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal, pixels):
    return 2.0 * np.arctan(pixels / (2.0 * focal))


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor  # [3, 3] c2w rotation
    T: torch.Tensor  # [3] w2c translation
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.R.device

    @property
    def tanfovx(self):
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self):
        return self.height / (2.0 * self.fy)

    @property
    def view(self) -> torch.Tensor:
        top = torch.cat([self.R.T, self.T[:, None]], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=self.device)
        return torch.cat([top, bottom], dim=0)

    @property
    def proj(self) -> torch.Tensor:
        zf, zn = self.zfar, self.znear
        s = min(self.width, self.height) / 2.0
        px = (self.cx - self.width / 2.0) / s
        py = (self.cy - self.height / 2.0) / s
        one = torch.ones((), dtype=torch.float32, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return torch.stack(
            [
                torch.stack([one / self.tanfovx, zero, px, zero]),
                torch.stack([zero, one / self.tanfovy, py, zero]),
                torch.stack([zero, zero, one * zf / (zf - zn), -one * (zf * zn) / (zf - zn)]),
                torch.stack([zero, zero, one, zero]),
            ]
        )

    @property
    def full_proj(self) -> torch.Tensor:
        return self.proj @ self.view

    @property
    def camera_center(self) -> torch.Tensor:
        return -(self.R @ self.T)

    def downscale(self, factor: float) -> "Camera":
        """Downscale resolution (reference refine.py:275-280 downscale path)."""
        return dataclasses.replace(
            self,
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=self.cx / factor,
            cy=self.cy / factor,
            width=int(round(self.width / factor)),
            height=int(round(self.height / factor)),
        )

    @staticmethod
    def from_w2c(w2c, fx, fy, cx, cy, width: int, height: int, device="cuda", **kw) -> "Camera":
        """From a 4x4 world-to-camera matrix (COLMAP/OpenCV convention)."""
        dev = resolve_device(device)
        w2c = np.asarray(w2c, np.float64)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return Camera(
            R=t(np.ascontiguousarray(w2c[:3, :3].T)),
            T=t(w2c[:3, 3]),
            fx=t(fx),
            fy=t(fy),
            cx=t(cx),
            cy=t(cy),
            width=int(width),
            height=int(height),
            **kw,
        )


def stack_cameras(cams: list[Camera]) -> Camera:
    """Stack same-resolution cameras into one batched Camera (leading axis N)."""
    w, h = cams[0].width, cams[0].height
    if not all(c.width == w and c.height == h for c in cams):
        raise ValueError("stack_cameras requires equal image sizes")
    leaves = [torch.stack([getattr(c, f) for c in cams]) for f in ("R", "T", "fx", "fy", "cx", "cy")]
    return Camera(*leaves, width=w, height=h, znear=cams[0].znear, zfar=cams[0].zfar)


def index_camera(cams: Camera, i: int) -> Camera:
    """Select camera i from a batched Camera."""
    return Camera(
        R=cams.R[i],
        T=cams.T[i],
        fx=cams.fx[i],
        fy=cams.fy[i],
        cx=cams.cx[i],
        cy=cams.cy[i],
        width=cams.width,
        height=cams.height,
        znear=cams.znear,
        zfar=cams.zfar,
    )


def orbit_cameras(
    center: np.ndarray,
    distance: float,
    width: int,
    height: int,
    focal: float,
    n_azim: int = 12,
    elevations=(-40.0, -20.0, 0.0, 20.0, 40.0),
    device="cuda",
) -> list[Camera]:
    """The TSDF fusion views of refined_mesh.py:55-81 (sample_cam): n_azim
    azimuths at each elevation, all looking at `center` from `distance`. The
    default five elevations give 60 cameras."""
    cams = []
    for elev in elevations:
        for k in range(n_azim):
            azim = 360.0 * k / n_azim
            e, a = np.deg2rad(elev), np.deg2rad(azim)
            # Camera position on the orbit sphere.
            pos = center + distance * np.array(
                [np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)]
            )
            # Look-at: z forward towards center, y down-ish (OpenCV).
            z = center - pos
            z = z / np.linalg.norm(z)
            up = np.array([0.0, -1.0, 0.0])
            x = np.cross(up, z)
            if np.linalg.norm(x) < 1e-6:
                x = np.array([1.0, 0.0, 0.0])
            x = x / np.linalg.norm(x)
            y = np.cross(z, x)
            Rc2w = np.stack([x, y, z], axis=1)
            w2c = np.eye(4)
            w2c[:3, :3] = Rc2w.T
            w2c[:3, 3] = -Rc2w.T @ pos
            cams.append(
                Camera.from_w2c(w2c, focal, focal, width / 2.0, height / 2.0, width, height, device=device)
            )
    return cams
