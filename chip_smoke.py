"""Smoke run of the PyTorch port on one CUDA card: builds both hand-written
kernels, holds each against its plain PyTorch version at main-path shapes,
then drives the port's extract-and-track main path over 64 frames.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. device: a CUDA card is required; prints `nvidia-smi` name and power
     limit;
  2. build: compiles csrc/fast_score_nms.cu (K1) and csrc/pose_gn.cu (K2);
  3. kernel vs plain on the card: K1 on the [8, 480, 640] canvas of a
     rendered frame, equal inside every level; K2 on 1024 rows with
     outliers, pose within 1e-4 and at most max(2, 1%) inlier flips;
     median times of both versions from CUDA events;
  4. small input: the main path on the card against the port's plain
     path on the CPU, 3 frames at 320x240;
  5. main path: 640x480, ORBConfig() (1000 features, 8 levels), an
     8192-slot map seeded from frame 0, p_local 4096, radius 15, motion
     model on, retry off (bench.py:46-105); checks that the path never
     synchronizes with the device, that both kernels ran once per frame,
     that every frame tracks with >= 30 inliers and the pose error bound
     below; then times three windows (median).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 64
MIN_INLIERS = 30
# Largest camera-centre error allowed on any tracked frame, in scene units
# (metres). The port's plain path at 320x240 / 300 features tracks within
# 0.6 cm of the ground truth on this trajectory (1 cm steps); at full size
# the bound leaves the same margin to the map's own back-projection error.
MAX_CENTER_ERR = 0.05


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30):
    """Median device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def center(T):
    """Camera centre of world->camera poses [..., 4, 4]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def check_k1(canvas, shapes):
    from orb_slam_tpu_torch.ops.fast_score_nms import (
        fast_score_nms, fast_score_nms_plain,
    )

    got = fast_score_nms(canvas, shapes)
    want = fast_score_nms_plain(canvas, shapes)
    torch.cuda.synchronize()
    err = 0.0
    for l, (h, w) in enumerate(shapes):
        a, b = got[l, :h, :w], want[l, :h, :w]
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"K1 differs from plain on level {l}: "
                                 f"{bad} pixels")
        err = max(err, float((a - b).abs().max()))
    ms = cuda_ms(lambda: fast_score_nms(canvas, shapes))
    plain_ms = cuda_ms(lambda: fast_score_nms_plain(canvas, shapes), reps=10)
    return err, ms, plain_ms


def check_k2(dev):
    """The outlier fixture of tests/test_solvers.py:220-234 at 1024 rows."""
    from orb_slam_tpu_torch.solvers.pose_opt import pose_gn_plain, pose_optimize

    rng = np.random.default_rng(42)
    N = 1024
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                    rng.uniform(4, 10, N)], 1).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.1, -0.05, 0.02]
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * 500.0 + [320, 240]
    uv = (uv + rng.normal(0, 1.0, (N, 2))).astype(np.float32)
    uv[::7] += rng.normal(0, 40, uv[::7].shape).astype(np.float32)
    valid = rng.random(N) > 0.1
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 8, N))).astype(np.float32)
    args = [torch.eye(4), torch.from_numpy(pts), torch.from_numpy(uv),
            torch.from_numpy(inv_s2), torch.from_numpy(valid), torch.from_numpy(K)]
    args = [a.to(dev).contiguous() for a in args]
    iters = (4, 3, 2, 2)
    T_k, inl_k, n_k = pose_optimize(*args, iters=iters)
    T_p, inl_p = pose_gn_plain(*args, iters=iters)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    flips = int((inl_k != inl_p).sum())
    if err > 1e-4:
        raise AssertionError(f"K2 pose differs from plain by {err}")
    if flips > max(2, N // 100):
        raise AssertionError(f"K2 inlier mask differs on {flips} rows")
    if int(n_k) != int(inl_k.sum()):
        raise AssertionError("K2 inlier count disagrees with its mask")
    ms = cuda_ms(lambda: pose_optimize(*args, iters=iters))
    plain_ms = cuda_ms(lambda: pose_gn_plain(*args, iters=iters), reps=10)
    return err, ms, plain_ms


def check_small_input(dev):
    """The main path on the card against the port's plain path on the CPU,
    3 frames at 320x240 / 300 features / 4 levels: the same keypoints (98%
    at least; the pyramid's f32 sums run in another order) and poses within
    1e-3. Returns the largest pose difference."""
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
    from orb_slam_tpu_torch.geometry.camera import CameraModel
    from orb_slam_tpu_torch.io.synthetic import (
        SyntheticScene, lateral_trajectory, seed_map,
    )
    from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig

    W, H = 320, 240
    scene = SyntheticScene(n_points=400, width=W, height=H, fx=250.0, fy=250.0,
                           cx=160.0, cy=120.0)
    poses = lateral_trajectory(4, step=0.01)
    imgs = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
    camera = CameraModel(250.0, 250.0, 160.0, 120.0, width=W, height=H)
    outs = []
    for d in (torch.device("cpu"), dev):
        ex = ORBExtractor(ORBConfig(n_features=300, n_levels=4), H, W).to(d)
        f0 = ex(imgs[0].to(d))
        state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                         MapConfig(max_keyframes=8, max_points=1024,
                                   n_features=300, n_levels=4),
                         device=d, n_extra=500)
        feats, _, chunk = extract_track_chunk(
            imgs[1:].to(d), ex, camera, state, torch.from_numpy(poses[0]).to(d),
            torch.eye(4, device=d), torch.from_numpy(scene.K).to(d), p_local=1024)
        outs.append((feats.xy.cpu(), chunk.pose.cpu()))
    (xy_c, pose_c), (xy_g, pose_g) = outs
    same = float((xy_g == xy_c).all(-1).float().mean())
    err = float((pose_g - pose_c).abs().max())
    if same < 0.98 or err > 1e-3:
        raise AssertionError(f"card vs CPU: {same:.3f} of keypoints equal, "
                             f"poses differ by {err}")
    return same, err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    card = device_line()
    print(f"device: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
    from orb_slam_tpu_torch.geometry.camera import CameraModel
    from orb_slam_tpu_torch.io.synthetic import (
        SyntheticScene, lateral_trajectory, seed_map,
    )
    from orb_slam_tpu_torch.ops import fast_score_nms as k1
    from orb_slam_tpu_torch.ops.fast_stack import build_pyramid_stack
    from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig
    from orb_slam_tpu_torch.solvers import pose_opt as k2

    # -- build
    t0 = time.perf_counter()
    k1.KERNEL.load()
    k2.KERNEL.load()
    print(f"build: K1 {k1.KERNEL.build_seconds:.2f} s, K2 "
          f"{k2.KERNEL.build_seconds:.2f} s, total "
          f"{time.perf_counter() - t0:.2f} s")

    # -- scene, extractor, map
    W, H = 640, 480
    scene = SyntheticScene(n_points=800, width=W, height=H)
    poses = lateral_trajectory(N_FRAMES + 1, step=0.01)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
    frames = frames.to(dev)
    extractor = ORBExtractor(ORBConfig(), H, W).to(dev)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, width=W, height=H)
    K = torch.from_numpy(scene.K).to(dev)

    # -- kernel vs plain at main-path shapes
    canvas = build_pyramid_stack(frames[0], extractor.Rp, extractor.Cp)
    k1_err, k1_ms, k1_plain_ms = check_k1(canvas, extractor.shapes)
    print(f"K1 fast_score_nms: bit-equal to plain on {list(canvas.shape)}; "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    k2_err, k2_ms, k2_plain_ms = check_k2(dev)
    print(f"K2 pose_gn: max |dT| {k2_err:.3g} vs plain at 1024 rows; "
          f"kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

    same, err = check_small_input(dev)
    print(f"small input (320x240, 3 frames): card vs CPU plain path: "
          f"{same:.4f} of keypoints equal, poses within {err:.3g}")

    # -- main path
    f0 = extractor(frames[0])
    state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                     MapConfig(max_keyframes=64, max_points=8192,
                               n_features=1000), device=dev)
    n_seed = int(state.pt_valid.sum())
    pose0 = torch.from_numpy(poses[0]).to(dev)
    vel0 = torch.eye(4, device=dev)

    def run(imgs):
        return extract_track_chunk(
            imgs, extractor, camera, state, pose0, vel0, K, p_local=4096,
            radius=15.0, min_inliers=MIN_INLIERS, use_motion_model=True,
            max_dist=100)

    torch.cuda.synchronize()
    k1.KERNEL.launches = 0
    k2.KERNEL.launches = 0
    # the path must never wait for the device: any synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    feats, xy_und, chunk = run(frames[1:])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {"K1": k1.KERNEL.launches, "K2": k2.KERNEL.launches}
    for name, n in launches.items():
        if n < N_FRAMES:
            raise AssertionError(f"{name} launched {n} times over {N_FRAMES} frames")
    n_in = chunk.n_inliers.cpu()
    if feats.xy.shape != (N_FRAMES, 1000, 2) or not torch.isfinite(chunk.pose).all():
        raise AssertionError("main path returned malformed features or poses")
    if int(n_in.min()) < MIN_INLIERS:
        raise AssertionError(f"frames under {MIN_INLIERS} inliers: {n_in.tolist()}")
    gt = torch.from_numpy(poses[1:]).to(dev)
    c_err = (center(chunk.pose) - center(gt)).norm(dim=-1).cpu()
    if float(c_err.max()) > MAX_CENTER_ERR:
        raise AssertionError(f"camera centre error {float(c_err.max()):.4f} "
                             f"> {MAX_CENTER_ERR}")
    print(f"main path: map {n_seed} points, inliers min {int(n_in.min())} "
          f"median {int(n_in.median())}, matches median "
          f"{int(chunk.n_matches.median())}, centre error max "
          f"{float(c_err.max()):.4f} mean {float(c_err.mean()):.4f}, "
          f"launches {launches}")

    # timing as bench.py: a warmup window, then the median of 3 windows,
    # each on frames shifted by a small intensity step so no frame repeats
    def window(wi):
        imgs = frames[1:] + 0.31 * wi
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run(imgs)
        torch.cuda.synchronize()
        float(out[2].pose.sum())
        return time.perf_counter() - t

    window(1)
    dts = [window(100 + wi) for wi in range(3)]
    dt = statistics.median(dts)
    print(f"main path timing on {card}: windows "
          f"{[round(d * 1e3, 2) for d in dts]} ms per {N_FRAMES} frames, "
          f"median {dt * 1e3 / N_FRAMES:.3f} ms/frame = "
          f"{N_FRAMES / dt:.2f} frames/s")

    print(json.dumps({"kernels": [
        {"name": "fast_score_nms", "route": "cuda",
         "source": "orb_slam_tpu_torch/csrc/fast_score_nms.cu",
         "replaces": "orb_slam_tpu/ops/pallas_fast.py:121",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "pose_gn", "route": "cuda",
         "source": "orb_slam_tpu_torch/csrc/pose_gn.cu",
         "replaces": "orb_slam_tpu/solvers/pose_opt_pallas.py:113",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
