"""Pinhole camera with radial-tangential distortion.

Port of orb_slam_tpu/geometry/camera.py: `CameraModel` with `create` and
`K` (:20-48), `distort` (:50-58), `project` (:60-73), `unproject`
(:75-81), `undistort_points` (:84-117) and `undistorted_bounds`
(:120-130). The coefficients are Python floats, so the zero-distortion
shortcut is a plain test (camera.py:93-98); every computation uses their
float32 values, as the JAX model stores them, so a model built by `create`
and one built by the constructor give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, width=640,
               height=480) -> "CameraModel":
        """A model holding each coefficient as its float32 value and the
        size as ints (JAX's `CameraModel.create`)."""
        return CameraModel(*(_f32(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2)),
                           int(width), int(height))

    @property
    def K(self) -> torch.Tensor:
        """The float32 [3, 3] intrinsic matrix, on the CPU (callers move it
        with `.to(device)`)."""
        fx, fy, cx, cy = (_f32(v) for v in (self.fx, self.fy, self.cx, self.cy))
        return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32)

    @property
    def distorted(self) -> bool:
        return any(c != 0.0 for c in (self.k1, self.k2, self.p1, self.p2))


def _f32(v: float) -> float:
    """The float32 value of a coefficient, as the JAX model stores it."""
    return float(torch.tensor(v, dtype=torch.float32))


def distort(cam: CameraModel, xn: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coordinates (..., 2)."""
    k1, k2, p1, p2 = (_f32(v) for v in (cam.k1, cam.k2, cam.p1, cam.p2))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def project(cam: CameraModel, p_cam: torch.Tensor,
            with_distortion: bool = False) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coordinates (..., 2). A depth
    with |z| < 1e-9 divides as 1e-9; callers mask z > 0 themselves
    (Frame::isInFrustum, src/Frame.cc:137-198)."""
    z = p_cam[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    xn = p_cam[..., :2] / zsafe[..., None]
    if with_distortion:
        xn = distort(cam, xn)
    fx, fy, cx, cy = (_f32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    return torch.stack([fx * xn[..., 0] + cx, fy * xn[..., 1] + cy], -1)


def unproject(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates (..., 2) -> normalized image-plane coordinates
    (..., 2), without removing distortion (`undistort_points` does)."""
    fx, fy, cx, cy = (_f32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def undistort_points(cam: CameraModel, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Undistort pixel coordinates (..., 2) by cv::undistortPoints'
    fixed-point iteration, back through K (src/Frame.cc:289-319). A camera
    with zero distortion returns `uv` itself, as the reference skips
    undistortion then (src/Frame.cc:291-297)."""
    if not cam.distorted:
        return uv
    fx, fy, cx, cy, k1, k2, p1, p2 = (
        _f32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2,
                          cam.p1, cam.p2))
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dx) / radial,
                         (xd[..., 1] - dy) / radial], -1)
    return torch.stack([fx * x[..., 0] + cx, fy * x[..., 1] + cy], -1)


def undistorted_bounds(cam: CameraModel):
    """Undistorted image bounds from the 4 corners (src/Frame.cc:321-349):
    (min_x, max_x, min_y, max_y) as Python floats."""
    corners = torch.tensor([[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
                            [cam.width, cam.height]], dtype=torch.float32)
    und = undistort_points(cam, corners)
    return (float(min(und[0, 0], und[2, 0])), float(max(und[1, 0], und[3, 0])),
            float(min(und[0, 1], und[1, 1])), float(max(und[2, 1], und[3, 1])))
