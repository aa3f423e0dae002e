"""Visualization: frame overlay and map plot.

Port of orb_slam_tpu/io/viz.py:15-140 (`draw_frame`, `draw_map`,
`draw_live_frame`), copied, reading the map's tensors on the host. It
replaces the reference's ROS publishers: FramePublisher
(src/FramePublisher.cc), the debug image with tracked points and a status
bar, and MapPublisher (src/MapPublisher.cc), the point cloud, keyframes,
covisibility graph (weight >= 100), spanning tree and loop edges.
matplotlib, PIL and cv2 are optional and imported where they are used.
"""

from __future__ import annotations

import numpy as np


def draw_frame(img, xy, tracked_mask, state_name: str, n_kfs: int,
               n_pts: int, n_tracked: int):
    """RGB uint8 image with the keypoint overlay and a status bar
    (FramePublisher.cc:59-188). img: [H, W] grayscale."""
    img = np.asarray(img)
    H, W = img.shape
    rgb = np.stack([img, img, img], -1).astype(np.uint8)
    xy = np.asarray(xy).astype(int)
    tracked_mask = np.asarray(tracked_mask)
    for (x, y), t in zip(xy, tracked_mask):
        if x < 2 or y < 2 or x >= W - 2 or y >= H - 2:
            continue
        color = (0, 255, 0) if t else (120, 120, 255)
        rgb[y - 2:y + 3, x - 2:x + 3, 0] = color[0]
        rgb[y - 2:y + 3, x - 2:x + 3, 1] = color[1]
        rgb[y - 2:y + 3, x - 2:x + 3, 2] = color[2]
    bar = np.zeros((18, W, 3), np.uint8)
    try:
        import cv2

        text = (f"{state_name}  KFs:{n_kfs}  MPs:{n_pts}  "
                f"tracked:{n_tracked}")
        cv2.putText(bar, text, (4, 13), cv2.FONT_HERSHEY_PLAIN, 0.9,
                    (255, 255, 255), 1)
    except ImportError:
        pass
    return np.concatenate([rgb, bar], axis=0)


def draw_map(system, path: str | None = None, show_covisibility=True,
             show_spanning_tree=True, show_loop_edges=True):
    """Top-down (x-z) plot of points, keyframes and graph edges
    (MapPublisher.cc:29-349). Returns the matplotlib figure; saves it to
    `path` if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = system.map
    pt_valid = m.pt_valid.cpu().numpy()
    pts = m.pt_pos.cpu().numpy()[pt_valid]
    kf_valid = m.kf_valid.cpu().numpy()
    poses = m.kf_pose.cpu().numpy()
    centers = np.stack([
        -poses[k][:3, :3].T @ poses[k][:3, 3] for k in range(len(poses))
    ])

    fig, ax = plt.subplots(figsize=(8, 8))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="k", alpha=0.4,
                   label="map points")
    kf_idx = np.where(kf_valid)[0]
    ax.scatter(centers[kf_idx, 0], centers[kf_idx, 2], s=25, c="tab:blue",
               marker="s", label="keyframes")

    if show_covisibility:
        from orb_slam_tpu_torch.slam_map.covisibility import covisibility_weights
        W = covisibility_weights(m).cpu().numpy()
        for i in kf_idx:
            for j in kf_idx:
                if j > i and W[i, j] >= 100:
                    ax.plot([centers[i, 0], centers[j, 0]],
                            [centers[i, 2], centers[j, 2]],
                            c="tab:green", lw=0.6, alpha=0.6)
    if show_spanning_tree:
        sp = m.spanning_parent.cpu().numpy()
        for k in kf_idx:
            p = sp[k]
            if p >= 0 and kf_valid[p]:
                ax.plot([centers[k, 0], centers[p, 0]],
                        [centers[k, 2], centers[p, 2]],
                        c="tab:blue", lw=0.8, alpha=0.8)
    if show_loop_edges:
        le = m.loop_edges.cpu().numpy()
        for k in kf_idx:
            for j in le[k]:
                if j >= 0 and kf_valid[j] and j > k:
                    ax.plot([centers[k, 0], centers[j, 0]],
                            [centers[k, 2], centers[j, 2]],
                            c="tab:red", lw=1.5)
    if system.trajectory:
        traj = np.stack([
            -T[:3, :3].T @ T[:3, 3] for _, _, T in system.trajectory])
        ax.plot(traj[:, 0], traj[:, 2], c="tab:orange", lw=1.0,
                label="trajectory")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_live_frame(system, img, path: str | None = None):
    """Frame overlay from the system's last tracked frame
    (FramePublisher.cc:40): keypoints coloured by their map binding and a
    status bar with state, keyframe, point and tracked counts. Returns the
    RGB array; writes a PNG to `path` if given and PIL is there."""
    from orb_slam_tpu_torch.pipeline.system import STATE_NAMES

    pf = getattr(system, "_prev_frame", None)
    if pf is None:
        xy = np.zeros((0, 2), np.float32)
        tracked = np.zeros((0,), bool)
        n_tracked = 0
    else:
        frame, obs = pf
        valid = frame.valid.cpu().numpy()
        xy = frame.xy.cpu().numpy()[valid]
        tracked = (obs.cpu().numpy() >= 0)[valid]
        n_tracked = int(tracked.sum())
    rgb = draw_frame(
        np.asarray(img.cpu() if hasattr(img, "cpu") else img), xy, tracked,
        STATE_NAMES[system.state], system.n_keyframes, system.n_points,
        n_tracked)
    if path:
        try:
            from PIL import Image

            Image.fromarray(rgb).save(path)
        except ImportError:
            pass
    return rgb
