"""Trajectory output in the TUM format, and the trajectory errors.

Port of orb_slam_tpu/io/trajectory.py:16-63: `write_tum`, `read_tum`
(`timestamp tx ty tz qx qy qz qw`, the reference's KeyFrameTrajectory.txt,
src/main.cc:160-185), `camera_centers_from_cw`, `ate_rmse` (the absolute
trajectory error after a Sim3 alignment, the monocular evaluation: the
scale is not observable) and `rpe`. numpy around the port's `horn_sim3`,
which runs on the CPU in float32 as the JAX version runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_tpu_torch.geometry.horn import horn_sim3


def write_tum(path: str, rows, fps: float = 30.0):
    """rows: (frame_id, t_wc [3], q_xyzw [4]) as
    SLAMSystem.keyframe_trajectory() returns them."""
    with open(path, "w") as f:
        for fid, t, q in rows:
            f.write(f"{fid / fps:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def read_tum(path: str):
    """(timestamps [N], positions [N, 3], quaternions [N, 4])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def camera_centers_from_cw(T_cw):
    """[N, 4, 4] world-to-camera poses -> [N, 3] camera centres."""
    return -np.einsum("nij,ni->nj", T_cw[:, :3, :3], T_cw[:, :3, 3])


def ate_rmse(est_centers, gt_centers, with_scale=True):
    """(RMSE of the estimated centres against the ground truth after a
    Sim3 alignment, or an SE3 one without scale; the aligned centres)."""
    s, R, t = horn_sim3(
        torch.from_numpy(np.asarray(gt_centers, np.float32)),
        torch.from_numpy(np.asarray(est_centers, np.float32)),
        fix_scale=not with_scale)
    aligned = float(s) * est_centers @ R.numpy().T + t.numpy()
    err = aligned - gt_centers
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1)))), aligned


def rpe(est_centers, gt_centers, delta: int = 1):
    """RMS of the translation drift over `delta`-frame intervals."""
    de = est_centers[delta:] - est_centers[:-delta]
    dg = gt_centers[delta:] - gt_centers[:-delta]
    err = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt(np.mean(err * err)))
