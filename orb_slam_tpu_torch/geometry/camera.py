"""Pinhole camera with radial-tangential distortion.

Port of orb_slam_tpu/geometry/camera.py: `CameraModel` (:20-49),
`undistort_points` (:85-117) and `undistorted_bounds` (:120-130). The
coefficients are Python floats, so the zero-distortion shortcut is a plain
test (camera.py:93-98).
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

    @property
    def distorted(self) -> bool:
        return any(c != 0.0 for c in (self.k1, self.k2, self.p1, self.p2))


def _f32(v: float) -> float:
    """The float32 value of a coefficient, as the JAX model stores it."""
    return float(torch.tensor(v, dtype=torch.float32))


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
