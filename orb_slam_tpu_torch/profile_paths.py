"""Where the time goes on the card: the FAST and the Harris (nScoreType=0)
extract-and-track paths of chip_smoke.py, timed and profiled.

    python -m orb_slam_tpu_torch.profile_paths [--frames 64]

The scene, map and settings are chip_smoke.py's (640x480, 1000 features,
8 levels, an 8192-slot map seeded from frame 0, p_local 4096). The paths
run in turns, FAST, Harris, Harris, FAST; for each turn it prints the
host-clock ms/frame of the extraction alone and of the whole path (a
warmup window, then the median of 3 windows), then profiles one more
window with torch.profiler: device kernel time per frame, kernel launches
per frame, the device's busy share (kernel time over the unprofiled
whole-path time), the heaviest kernels and the device time per launch of
each of the port's own kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.settings import settings_text, slam_config_from_settings
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory, seed_map
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.slam_map.map_state import MapConfig

# the hand-written kernels of csrc/, whose time per launch is printed
PORT_KERNELS = ("fast_score_nms_kernel", "pose_gn_kernel",
                "fast_score_rect_kernel", "fast_cell_topk_kernel")


def _ms_per_frame(fn, n_frames, windows=3):
    """Median host-clock ms/frame of fn() over `windows` runs, after one
    warmup run, each ended by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    dts = []
    for _ in range(windows):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t)
    return statistics.median(dts) * 1e3 / n_frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {card}")

    dev = torch.device("cuda", 0)
    W, H, N = 640, 480, args.frames
    scene = SyntheticScene(n_points=800, width=W, height=H)
    poses = lateral_trajectory(N + 1, step=0.01)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses])).to(dev)
    K = torch.from_numpy(scene.K).to(dev)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, width=W, height=H)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "harris.yaml")
        with open(path, "w") as f:
            f.write(settings_text(camera, ORBConfig(score_harris=True)))
        h_cam, h_orb, _ = slam_config_from_settings(path)
    paths = {"FAST": (ORBConfig(), camera), "Harris": (h_orb, h_cam)}

    for name in ("FAST", "Harris", "Harris", "FAST"):
        cfg, cam = paths[name]
        ex = ORBExtractor(cfg, H, W, device=dev)
        f0 = ex(frames[0])
        state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                         MapConfig(max_keyframes=64, max_points=8192,
                                   n_features=cfg.n_features), device=dev)

        def run(shift):
            return extract_track_chunk(
                frames[1:] + shift, ex, cam, state,
                torch.from_numpy(poses[0]).to(dev), torch.eye(4, device=dev),
                K, p_local=4096, radius=15.0, min_inliers=30,
                use_motion_model=True, max_dist=100)

        extract_ms = _ms_per_frame(lambda: [ex(f) for f in frames[1:]], N)
        path_ms = _ms_per_frame(lambda: run(0.31), N)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(0.62)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / N
        launches = sum(e.count for e in kernels) / N
        print(f"{name}: extraction {extract_ms:.3f} ms/frame, whole path "
              f"{path_ms:.3f} ms/frame; device kernels {device_ms:.3f} "
              f"ms/frame ({launches:.1f} launches/frame), busy share "
              f"{device_ms / path_ms:.3f}; {card}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / N:9.1f} us/frame "
                  f"{e.count / N:6.1f}/frame  {e.key[:90]}")
        for e in kernels:
            if any(k in e.key for k in PORT_KERNELS):
                print(f"    port kernel {e.key[:60]}: "
                      f"{e.self_device_time_total / e.count:.2f} us per launch, "
                      f"{e.count / N:.1f} launches/frame")


if __name__ == "__main__":
    main()
