"""Where the time goes on the card: the FAST and the Harris (nScoreType=0)
extract-and-track paths and the mapping path of chip_smoke.py, timed and
profiled, and local BA's solver stages.

    python -m orb_slam_tpu_torch.profile_paths [--frames 64] [--spread]

The scene, map and settings are chip_smoke.py's (640x480, 1000 features,
8 levels; the tracking paths against an 8192-slot map seeded from frame 0,
p_local 4096; the mapping path a SLAMSystem at the SlamConfig defaults,
seeded with frames 0 and 1 as keyframes, moving MAPPING_STEP and turning
MAPPING_YAW per frame). The paths run in turns, FAST, Harris, mapping,
mapping, Harris, FAST. For a tracking path each turn prints the host-clock ms/frame of the
extraction alone and of the whole path (a warmup window, then the median
of 3 windows), then profiles one more window with torch.profiler: device
kernel time per frame, kernel launches per frame, the device's busy share
(kernel time over the unprofiled whole-path time), the heaviest kernels
and the device time per launch of each of the port's own kernels. For the
mapping path (process_batch at the default chunk of 8 frames, so the
frames of a chunk after a keyframe are extracted and tracked again; the
launch check of chip_smoke.py runs one frame per chunk instead) each turn
runs the frames once with a host clock on every local-mapping stage (the
device synchronized at each end), then once more under torch.profiler
with each stage labelled, and prints per keyframe
integration and per stage the host-clock ms, the device time, the device
work items launched (kernels, copies, fills) and the busy share; the rest
of the path is tracking and the host's replay. Last, the split of one
local-BA solver step (`ba_stage_split`) at chip_smoke.py's two shapes.
With --spread, only `mapping_spread`: the mapping path's keyframe centre
error over scene seeds and the order of BA's float sums, on the card and
the CPU. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.settings import settings_text, slam_config_from_settings
from orb_slam_tpu_torch.io.synthetic import (
    SyntheticScene, lateral_trajectory, seed_keyframe_map, seed_map,
)
from orb_slam_tpu_torch.pipeline import system as slam
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from orb_slam_tpu_torch.solvers import local_ba as ba

# the hand-written kernels of csrc/, whose time per launch is printed
PORT_KERNELS = ("fast_score_nms_kernel", "pose_gn_kernel",
                "fast_score_rect_kernel", "fast_cell_topk_kernel")


# the mapping path's trajectory: lateral_trajectory's step per frame, and
# its yaw per frame, which turns the camera toward the scene's centre as it
# moves (on the card a pure sideways path drifts in scale by ~9 cm over its
# 5 m; this one stayed within 2.6 cm)
MAPPING_STEP = 0.08
MAPPING_YAW = 0.01
# device work in a torch.profiler chrome trace, and its launch calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start_working(s: slam.SLAMSystem, scene, poses, frames) -> int:
    """Seed `s` with frames 0 and 1 as keyframes 0 and 1, as the two-view
    initialisation leaves a system, ready to track frame 2. Returns the
    number of seeded points."""
    feats = [s.extractor(frames[i]) for i in (0, 1)]
    m, n, n1 = seed_keyframe_map(scene, poses[:2], feats, scene.K, s.cfg.map,
                                 device=s.device)
    s.map = m
    s.free_kf = list(range(2, s.cfg.map.max_keyframes))
    s.free_pt = list(range(n, s.cfg.map.max_points))
    s.kf_order[:2] = [0, 1]
    s.kf_counter, s.frame_id = 2, 2
    s.last_pose = m.kf_pose[1].cpu().numpy().copy()
    s.last_kf_frame, s.last_kf_slot, s.ref_kf_tracked = 1, 1, n1
    s.trajectory = [(0, 0.0, np.asarray(poses[0], np.float32)),
                    (1, 1 / 30.0, s.last_pose.copy())]
    s.state = slam.WORKING
    s._refresh_local_mask()
    return n


def mapping_system(scene, poses, frames, device) -> slam.SLAMSystem:
    """A SLAMSystem at the SlamConfig defaults (MapConfig(): 256
    keyframes, 16384 points; ORBConfig(); max_ba_cams 80, max_ba_points
    2048) for the scene's camera, started from frames 0 and 1."""
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                         width=scene.width, height=scene.height)
    s = slam.SLAMSystem(slam.SlamConfig(camera=camera), device=device)
    start_working(s, scene, poses, frames)
    return s


def keyframe_center_errors(s: slam.SLAMSystem, poses):
    """(frame ids [n], camera centres [n, 3], distance of each centre to
    the ground truth of its frame [n]) of the live keyframes of `s`, as
    float64 numpy."""
    m = s.map
    live = m.kf_valid.cpu().numpy()
    fid = m.kf_frame_id.cpu().numpy()[live]
    center = lambda T: -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    c = center(m.kf_pose.cpu().double().numpy()[live])
    g = center(np.asarray(poses, np.float64)[fid])
    return fid, c, np.linalg.norm(c - g, axis=1)


def _atomic_scatter_add_(out, rows, index, values, live):
    """local_ba._scatter_add_ with CUDA's atomic index_add_ on the card,
    whose order of addition changes from run to run."""
    spare = torch.arange(rows, rows + index.shape[0], device=index.device)
    return out.index_add_(0, torch.where(live, index, spare), values)


def mapping_spread(card, N, seeds=(0, 1, 2, 3), cpu_seeds=(0, 1), device=None):
    """How far the mapping path's keyframe centres move with the order of
    its float sums: chip_smoke.py's phase 9 (one frame per chunk) for each
    scene seed on the card with BA's ordered scatter-adds (the port's,
    which repeat), twice with CUDA's atomic index_add_ in their place, and
    on the CPU for `cpu_seeds`. Prints per run the keyframes inserted, the
    least inliers of a frame and the keyframe centre error's max and mean,
    and per CPU run the largest distance between its keyframe centres and
    the card's (ordered run) over the keyframes of the same frames.
    `device`: the card (default cuda:0)."""
    cpu = torch.device("cpu")
    card_dev = device or torch.device("cuda", 0)
    for seed in seeds:
        scene = SyntheticScene(n_points=800, width=640, height=480, seed=seed)
        poses = lateral_trajectory(N + 2, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
        frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
        runs = [("card, ordered", card_dev, False), ("card, atomic", card_dev, True),
                ("card, atomic", card_dev, True)]
        if seed in cpu_seeds:
            runs.append(("CPU", cpu, False))
        ref = None
        for label, dev, atomic in runs:
            fr = frames.to(dev)
            s = mapping_system(scene, poses, fr, dev)
            inl = []
            apply_chunk = s._apply_chunk

            def recorded(feats, xy, chunk, n, ts, apply_chunk=apply_chunk, inl=inl):
                consumed, out = apply_chunk(feats, xy, chunk, n, ts)
                inl.extend(chunk.n_inliers[:consumed].tolist())
                return consumed, out

            s._apply_chunk = recorded
            ordered = ba._scatter_add_
            if atomic:
                ba._scatter_add_ = _atomic_scatter_add_
            t = time.perf_counter()
            try:
                s.process_batch(fr[2:N + 2], chunk_size=1)
            finally:
                ba._scatter_add_ = ordered
            run_s = time.perf_counter() - t
            fid, c, err = keyframe_center_errors(s, poses)
            vs = ""
            if ref is None:
                ref = dict(zip(fid.tolist(), c))
            else:
                both = [i for i, f in enumerate(fid.tolist()) if f in ref]
                d = max((np.linalg.norm(c[i] - ref[fid[i]]) for i in both), default=0.0)
                vs = (f"; vs the card's ordered run: {len(both)} keyframes of the "
                      f"same frames ({len(fid) - len(both)} not), centres up to "
                      f"{d:.4f} apart")
            print(f"spread seed {seed} {label}: {s.kf_counter - 2} keyframes, "
                  f"{len(fid)} live, inliers min {min(inl)}, keyframe centre "
                  f"error max {err.max():.4f} mean {err.mean():.4f} "
                  f"({run_s:.1f} s){vs}; {card}", flush=True)


class StageClock:
    """A SLAMSystem stage timer: host-clock seconds of each stage, the
    device synchronized at both ends, appended to `record[name]`."""

    def __init__(self, record: dict):
        self.record = record

    def __call__(self, name):
        return _Stage(self.record, name)


class _Stage:
    def __init__(self, record, name):
        self.record, self.name = record, name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.record.setdefault(self.name, []).append(time.perf_counter() - self.t)
        return False


def device_work_by_label(trace_path):
    """{label: (device us, work items)} of a chrome trace: each kernel,
    copy or fill is charged to the innermost user annotation whose host
    span holds the runtime call that launched it (matched by correlation
    id); work launched outside every annotation is charged to None."""
    with open(trace_path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in evs if e.get("cat") == "user_annotation"),
                   key=lambda x: x[1] - x[0])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    out = {}
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        label = None
        if t is not None:
            label = next((n for a, b, n in spans if a <= t <= b), None)
        us, n = out.get(label, (0.0, 0))
        out[label] = (us + e.get("dur", 0), n + 1)
    return out


def ba_stage_inputs(P, O, Kl, dev, seed=0):
    """The synthetic inputs of scripts/profile_ba.py: 128 identity
    cameras, 90 of them optimized (slot 0 fixed), P points, O observations
    each to a random camera, one edge in five live."""
    K = 128
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(
        kf_pose=torch.eye(4, device=dev).repeat(K, 1, 1),
        pt_pos=t(np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                           rng.uniform(4, 10, P)], 1).astype(np.float32)),
        obs_kf=t(rng.integers(0, 90, (P, O)).astype(np.int32)),
        uv=t(rng.uniform([0, 0], [640, 480], (P, O, 2)).astype(np.float32)),
        w=t((rng.random((P, O)) < 0.2).astype(np.float32)),
        cam_opt=(torch.arange(K, device=dev) < 90) & (torch.arange(K, device=dev) > 0),
        pt_opt=torch.ones(P, dtype=torch.bool, device=dev),
        K_mat=t(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)),
        Kl=Kl)


def _event_ms(fn, reps):
    """Median CUDA-event ms of fn() over `reps` runs after one warmup."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ba_stage_split(dev, P, O=32, Kl=80, reps=5):
    """CUDA-event medians (ms) of the stages of one local-BA solver step
    on ba_stage_inputs, through local_ba's own stage helpers and cumulative
    as scripts/profile_ba.py times them: B1 `_edge_terms`; B2 = B1 +
    `_point_blocks` (3x3 inverse, Cholesky); B3 = B2 + `_camera_system`
    (the Schur terms and their assembly into the reduced camera system);
    B5 `_solve_cameras` alone, the dense [6 Kl] solve. Also
    `_schur_assembly` alone, JAX's form of it (a loop over the second
    observation, :279-285, each round scattered by CUDA's atomic
    `index_add_` with the dead edges on one dump row; and that loop's
    einsums alone), and the whole `_solve_iteration`."""
    x = ba_stage_inputs(P, O, Kl, dev)
    Kk = x["kf_pose"].shape[0]
    local_id = ba._camera_compaction(x["cam_opt"], Kl)[0]
    kf_idx = torch.where(x["w"] > 0, local_id[x["obs_kf"].long().clamp(0, Kk - 1)], Kl)
    damping = torch.tensor(1e-3, device=dev)

    def b1():
        return ba._edge_terms(x["kf_pose"], x["pt_pos"], x["obs_kf"], x["uv"], x["K_mat"])

    def b2():
        r, Jc, Jp, _ = b1()
        w = x["w"][..., None, None]
        return (r, Jc, Jp, Jc * w) + ba._point_blocks(Jp * w, Jp, r, x["pt_opt"],
                                                      damping)

    def b3():
        r, Jc, Jp, wJc, Hpp_inv, L, bp = b2()
        return ba._camera_system(wJc, Jc, Jp, r, Hpp_inv, L, bp, kf_idx,
                                 x["pt_opt"], Kl)

    def jax_loop(D, atomic):
        S = torch.zeros(((Kl + 1) * (Kl + 1), 6, 6), device=dev)
        for q in range(O):
            V = torch.einsum("poxz,pyz->poxy", D, D[:, q])
            if atomic:
                cell = (kf_idx * (Kl + 1) + kf_idx[:, q:q + 1]).reshape(-1)
                S.index_add_(0, cell, -V.reshape(-1, 6, 6))
        return S

    L = b2()[5]
    H, b, C = b3()
    D = torch.einsum("poxy,pyz->poxz", C, L)
    d = torch.arange(Kl, device=dev)
    Hs = H[:Kl, :Kl].clone()
    Hs[d, d] += damping * torch.eye(6, device=dev)
    return {
        "B1 edge terms": _event_ms(b1, reps),
        "B2 ..+ point blocks": _event_ms(b2, reps),
        "B3 ..+ camera system": _event_ms(b3, reps),
        "B5 dense solve": _event_ms(lambda: ba._solve_cameras(Hs, b[:Kl]), reps),
        "Schur assembly alone": _event_ms(lambda: ba._schur_assembly(D, kf_idx, Kl),
                                          reps),
        "JAX's O loop, atomic index_add_": _event_ms(lambda: jax_loop(D, True), reps),
        "JAX's O loop, einsums alone": _event_ms(lambda: jax_loop(D, False), reps),
        "whole _solve_iteration": _event_ms(lambda: ba._solve_iteration(
            x["kf_pose"], x["pt_pos"], x["w"], x["obs_kf"], x["uv"], x["K_mat"],
            x["cam_opt"], x["pt_opt"], damping, Kl=Kl), reps),
    }


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


def profile_tracking(name, cfg, cam, scene, poses, frames, K, N, card):
    """One turn of a tracking path (see the module docstring)."""
    dev = frames.device
    H, W = frames.shape[1:]
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


def profile_mapping(scene, poses, frames, N, card):
    """One turn of the mapping path (see the module docstring)."""
    dev = frames.device
    host = {}
    s = mapping_system(scene, poses, frames, dev)
    s._stage_timer = StageClock(host)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s.process_batch(frames[2:N + 2])
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t
    n_kf = s.kf_counter - 2

    s = mapping_system(scene, poses, frames, dev)
    s._stage_timer = record_function
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s.process_batch(frames[2:N + 2])
            torch.cuda.synchronize()
        trace = os.path.join(tmp, "mapping.json")
        prof.export_chrome_trace(trace)
        work = device_work_by_label(trace)
    n_kf_prof = s.kf_counter - 2
    stage_s = sum(sum(v) for v in host.values())
    dev_us = sum(us for us, _ in work.values())
    items = sum(n for _, n in work.values())
    print(f"mapping: {N} frames, {n_kf} keyframes ({n_kf_prof} in the profiled "
          f"run), whole path {path_s * 1e3 / N:.3f} ms/frame, local mapping "
          f"{stage_s * 1e3 / max(n_kf, 1):.3f} ms per keyframe integration; "
          f"device {dev_us / 1e3 / N:.3f} ms/frame, {items / N:.1f} work items/"
          f"frame, busy share {dev_us * 1e-6 / path_s:.3f}; {card}")
    for name in list(host) + [None]:
        us, n = work.get(name, (0.0, 0))
        if name is None:
            label, h = "tracking and replay (outside the stages)", path_s - stage_s
        else:
            label, h = name, sum(host[name])
        per = max(n_kf_prof, 1)
        print(f"    {label}: host {h * 1e3 / max(n_kf, 1):.3f} ms, device "
              f"{us / 1e3 / per:.3f} ms, {n / per:.1f} work items per keyframe "
              f"integration; busy share {us * 1e-6 / max(h, 1e-9):.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--spread", action="store_true",
                    help="run only mapping_spread: the mapping path's keyframe "
                         "centre error over scene seeds and scatter orders")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {card}")

    if args.spread:
        mapping_spread(card, args.frames)
        return
    dev = torch.device("cuda", 0)
    W, H, N = 640, 480, args.frames
    scene = SyntheticScene(n_points=800, width=W, height=H)
    render = lambda ps: torch.from_numpy(
        np.stack([scene.render_image(p) for p in ps])).to(dev)
    poses = lateral_trajectory(N + 1, step=0.01)
    frames = render(poses)
    m_poses = lateral_trajectory(N + 2, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    m_frames = render(m_poses)
    K = torch.from_numpy(scene.K).to(dev)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, width=W, height=H)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "harris.yaml")
        with open(path, "w") as f:
            f.write(settings_text(camera, ORBConfig(score_harris=True)))
        h_cam, h_orb, _ = slam_config_from_settings(path)
    paths = {"FAST": (ORBConfig(), camera), "Harris": (h_orb, h_cam)}

    for name in ("FAST", "Harris", "mapping", "mapping", "Harris", "FAST"):
        if name == "mapping":
            profile_mapping(scene, m_poses, m_frames, N, card)
        else:
            profile_tracking(name, *paths[name], scene, poses, frames, K, N, card)
    for P in (2048, 16384):
        split = ba_stage_split(dev, P)
        print(f"BA solver step at P={P}, O=32, Kl=80 (CUDA-event medians, "
              f"{card}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))


if __name__ == "__main__":
    main()
