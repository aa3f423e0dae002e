"""Demo of the PyTorch port: render a synthetic sequence to disk, run the
full SLAM system on the images through the CLI-equivalent path, write the
trajectory, evaluate ATE, and plot the map.

    python examples/run_synthetic_torch.py [out_dir] [--device cpu]

The port's counterpart of examples/run_synthetic.py, line for line, with
two differences: the frames are written as binary PGM (io/dataset.py's
`write_pgm`), which needs no image library, and the map is drawn only
when matplotlib imports. It runs on the CUDA card unless `--device`
names another device.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def main(out_dir=None, device="cuda"):
    """Returns the summary it prints as JSON."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                      "orb_slam_tpu_torch_demo")
    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "frames")
    os.makedirs(img_dir, exist_ok=True)

    from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
    from orb_slam_tpu_torch.io.trajectory import (
        write_tum, ate_rmse, camera_centers_from_cw,
    )
    from orb_slam_tpu_torch.io.dataset import ImageDirDataset, write_pgm
    from orb_slam_tpu_torch.io.viz import draw_map
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
    from orb_slam_tpu_torch.pipeline.system import SLAMSystem, SlamConfig, STATE_NAMES
    from orb_slam_tpu_torch.slam_map import MapConfig
    from orb_slam_tpu_torch.geometry import CameraModel

    # 1. render a sequence
    scene = SyntheticScene(n_points=220, seed=21, width=320, height=240,
                           fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                           extent=(7.0, 5.0, 3.0), depth_range=(5.5, 8.5))
    n_frames = 20
    poses = lateral_trajectory(n_frames, step=0.1)
    for i in range(n_frames):
        img = scene.render_image(poses[i], patch=5)
        write_pgm(os.path.join(img_dir, f"{i:06d}.pgm"), img.astype(np.uint8))
    print(f"rendered {n_frames} frames to {img_dir}")

    # 2. run SLAM over the image directory
    cfg = SlamConfig(
        camera=CameraModel.create(scene.fx, scene.fy, scene.cx, scene.cy,
                                  width=320, height=240),
        orb=ORBConfig(n_features=400, n_levels=4),
        map=MapConfig(max_keyframes=16, max_points=1024, n_features=400),
        p_local=512, n_triangulation_neighbors=2, n_fuse_neighbors=2,
        local_ba_window=4, min_init_matches=60, min_init_keypoints=60,
        enable_loop_closing=False, enable_relocalisation=False,
    )
    system = SLAMSystem(cfg, device=device)
    est = {}
    for ts, img in ImageDirDataset(img_dir):
        fid = system.frame_id
        T = system.process(img=img, timestamp=ts)
        if T is not None:
            est[fid] = T
        print(f"frame {fid}: {STATE_NAMES[system.state]} "
              f"kfs={system.n_keyframes} pts={system.n_points}")

    # 3. outputs
    traj_path = os.path.join(out_dir, "KeyFrameTrajectory.txt")
    write_tum(traj_path, system.keyframe_trajectory())
    map_path = os.path.join(out_dir, "map.png")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        map_path = None
        print("matplotlib is not installed: the map plot is skipped")
    else:
        draw_map(system, map_path)

    ids = sorted(est.keys())
    C_est = camera_centers_from_cw(np.stack([est[i] for i in ids]))
    C_gt = camera_centers_from_cw(poses[ids])
    rmse, _ = ate_rmse(C_est, C_gt)
    summary = {
        "frames_tracked": len(est),
        "keyframes": system.n_keyframes,
        "map_points": system.n_points,
        "ate_rmse": round(rmse, 4),
        "trajectory": traj_path,
        "map_plot": map_path,
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    # the package from this checkout, when it is not installed
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(args.out_dir, args.device)
    sys.exit(0)
