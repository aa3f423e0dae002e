"""CLI: `python -m orb_slam_tpu_torch.cli run <settings.yaml> <dataset>`.

Port of orb_slam_tpu/cli.py:27-204 (`cmd_run`, `cmd_eval`, `main`), the
reference's `rosrun ORB_SLAM ORB_SLAM <vocab> <settings>` (README.md:116)
without ROS: a dataset path (an image directory or a video) replaces the
image topic, and the keyframe trajectory is written at shutdown
(KeyFrameTrajectory.txt, main.cc:160-185). `run` takes JAX's flags
through the port's io/settings.py, io/dataset.py, SLAMSystem or (with
`--async`) AsyncSLAMSystem and io/trajectory.py, and two more: `--device`
(default `cuda`): without a card, only `--device cpu` runs; and `--pace
SECONDS`, which hands the frames over as a camera sending one every
SECONDS would, as the reference's examples pace a sequence by sleeping
until the next frame's timestamp (Examples/Monocular/mono_tum.cc); by
default, as in JAX's CLI, the frames go in as fast as the system takes
them, and with `--async` such a caller can outrun local mapping and lose
the camera (ROADMAP C17). A settings file that gives no frame size
(ORB-SLAM's and ORB-SLAM2's files give none) takes the dataset's first
image's (`settings_for_images`), where JAX takes 640x480. TF32 is off,
as in chip_smoke.py, so the card's matrix products keep f32 precision.
The `[final]` line names the device where JAX names its backend. With
`--stages` the system runs under a StageTimer that never synchronizes,
and its summary follows the `[final]` line: per span and stage the host
ms per frame, its self time and its count, then the program's counters.

    python -m orb_slam_tpu_torch.cli run settings.yaml frames/ --async
    python -m orb_slam_tpu_torch.cli eval KeyFrameTrajectory.txt gt.txt
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def settings_for_images(path: str, first_image=None):
    """(CameraModel, ORBConfig, extras) of the settings file at `path` for
    a dataset whose first image is `first_image` ([H, W] or [H, W, 3];
    None for an empty dataset): a file that gives no Camera.width and
    Camera.height, as ORB-SLAM2's KITTI00-02.yaml and ORB-SLAM's
    Settings.yaml give none, takes the image's size, as ORB-SLAM does
    (its frames take their size from the image); without an image, the
    reader's 640x480."""
    from orb_slam_tpu_torch.io.settings import slam_config_from_settings

    if first_image is None:
        return slam_config_from_settings(path)
    height, width = first_image.shape[:2]
    return slam_config_from_settings(path, width=int(width), height=int(height))


def cmd_run(args):
    import torch

    from orb_slam_tpu_torch.device import require_device
    from orb_slam_tpu_torch.io.dataset import PrefetchIterator, open_dataset
    from orb_slam_tpu_torch.io.trajectory import write_tum
    from orb_slam_tpu_torch.pipeline.system import STATE_NAMES, SLAMSystem, SlamConfig
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig

    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    vocab = None
    if args.vocab:
        from orb_slam_tpu_torch.place.vocabulary import load_text
        print(f"loading vocabulary {args.vocab} ...", file=sys.stderr)
        vocab = load_text(args.vocab)

    frames = iter(PrefetchIterator(open_dataset(args.dataset)))
    first = next(frames, None)
    cam, orb, extras = settings_for_images(
        args.settings, None if first is None else first[1])
    if first is not None:
        frames = itertools.chain([first], frames)
    cfg = SlamConfig(
        camera=cam, orb=orb,
        map=MapConfig(max_keyframes=args.max_keyframes,
                      max_points=args.max_points,
                      n_features=orb.n_features),
        vocabulary=vocab,
        use_motion_model=extras["use_motion_model"],
        # reference: mMaxFrames = 18 * fps / 30 (Tracking.cc:78)
        max_frames_between_kf=max(1, int(round(18 * extras["fps"] / 30.0))),
        p_local=args.p_local,
        min_init_matches=args.min_init_matches,
        min_init_keypoints=args.min_init_matches,
        track_chunk_size=max(1, args.chunk),
    )
    if args.use_async:
        # tracking here, LocalMapping and LoopClosing on their own threads
        # (the reference's three threads, main.cc:123-133)
        from orb_slam_tpu_torch.pipeline.async_system import AsyncSLAMSystem
        system = AsyncSLAMSystem(cfg, device=device)
    else:
        system = SLAMSystem(cfg, device=device)
    if args.stages:
        from orb_slam_tpu_torch.utils.timing import StageTimer
        system._stage_timer = StageTimer(sync=False)
    try:
        n, t0 = _run_frames(args, system, STATE_NAMES, frames)
        if args.use_async:
            system.finish()
    finally:
        if args.use_async:
            system.close()
    wall = time.perf_counter() - t0
    print(
        f"[final] frames={n} keyframes={system.n_keyframes} "
        f"points={system.n_points} loops_closed={system.n_loops_closed} "
        f"relocalisations={system.n_relocs} "
        f"state={STATE_NAMES[system.state]} "
        f"device={_device_name(device)} "
        f"fps={n / max(wall, 1e-9):.1f}",
        file=sys.stderr,
    )
    if args.stages:
        print(_stages_report(system._stage_timer, n), file=sys.stderr)
    write_tum(args.out, system.keyframe_trajectory(), fps=extras["fps"])
    if args.viz_every:
        from orb_slam_tpu_torch.io.viz import draw_map
        draw_map(system, args.viz_out)
        print(f"wrote {args.viz_out}", file=sys.stderr)
    print(f"wrote {args.out} ({system.n_keyframes} keyframes)", file=sys.stderr)


def _stages_report(timer, n_frames: int) -> str:
    """The stage timer's summary per frame of the run: each span and
    stage's host ms per frame, self ms per frame and count, then each
    counter's sum and events."""
    per = 1e3 / max(n_frames, 1)
    lines = [f"[stages] {n_frames} frames; ms per frame (self), count"]
    lines += [f"  {k:30s} {v['total_s'] * per:9.3f} ({v['self_s'] * per:9.3f}) "
              f"x{v['count']}" for k, v in timer.summary().items()]
    lines += [f"  {k:30s} {sum(v)} over {len(v)} events"
              for k, v in sorted(timer.counters.items())]
    return "\n".join(lines)


def _run_frames(args, system, state_names, ds):
    """Feed the dataset to the system: chunks of `args.chunk` frames
    through process_batch, or one frame at a time through process at
    chunk 1. With `args.pace` > 0, frame i arrives `i * args.pace` seconds
    after the first: the caller waits for each frame to arrive, and hands
    over every frame that has arrived, at most a chunk, before it waits
    (profile_paths.PacedFeed's rule). Returns (frames fed, the start on
    the host clock)."""

    def _frame_path(viz_out):
        import os
        root, ext = os.path.splitext(viz_out or "viz.png")
        return f"{root}_frame{ext or '.png'}"

    def _progress(n, t0):
        dt = time.perf_counter() - t0
        print(
            f"[{n}] state={state_names[system.state]} "
            f"kfs={system.n_keyframes} pts={system.n_points} "
            f"loops={system.n_loops_closed} fps={n / dt:.1f}",
            file=sys.stderr,
        )

    def _viz(img):
        from orb_slam_tpu_torch.io.viz import draw_live_frame, draw_map
        draw_map(system, args.viz_out)
        draw_live_frame(system, img, _frame_path(args.viz_out))

    n, t0 = 0, time.perf_counter()

    def _arrived(i, before_wait=lambda: None):
        """Wait for frame i to arrive; `before_wait` runs first if it has
        not arrived yet."""
        due = t0 + i * args.pace
        if args.pace > 0 and time.perf_counter() < due:
            before_wait()
            time.sleep(max(0.0, due - time.perf_counter()))

    if args.chunk > 1:
        # buffered chunks: one extract-and-track chunk per process_batch
        # call (SLAMSystem.process_batch)
        buf_img, buf_ts = [], []

        def _drain():
            nonlocal n
            if not buf_img:
                return
            system.process_batch(buf_img, timestamps=buf_ts,
                                 chunk_size=args.chunk)
            n += len(buf_img)
            last_img = buf_img[-1]
            buf_img.clear()
            buf_ts.clear()
            _progress(n, t0)
            if args.viz_every and (n // args.chunk) % max(
                    1, args.viz_every // args.chunk) == 0:
                _viz(last_img)

        for i, (ts, img) in enumerate(ds):
            _arrived(i, _drain)
            buf_img.append(img)
            buf_ts.append(ts)
            if len(buf_img) >= args.chunk:
                _drain()
            if args.max_frames and n >= args.max_frames:
                break
        _drain()
    else:
        for i, (ts, img) in enumerate(ds):
            _arrived(i)
            system.process(img=img, timestamp=ts)
            n += 1
            if n % 30 == 0:
                _progress(n, t0)
            if args.viz_every and n % args.viz_every == 0:
                _viz(img)
            if args.max_frames and n >= args.max_frames:
                break
    return n, t0


def cmd_eval(args):
    import numpy as np

    from orb_slam_tpu_torch.io.trajectory import ate_rmse, read_tum, rpe

    ts_e, p_e, _ = read_tum(args.estimate)
    ts_g, p_g, _ = read_tum(args.groundtruth)
    # associate by nearest timestamp (TUM protocol)
    idx = np.searchsorted(ts_g, ts_e)
    idx = np.clip(idx, 0, len(ts_g) - 1)
    keep = np.abs(ts_g[idx] - ts_e) < args.max_dt
    rmse, aligned = ate_rmse(p_e[keep], p_g[idx][keep])
    # RPE on the Sim3-aligned estimate (monocular scale is unobservable)
    r1 = rpe(aligned, p_g[idx][keep], delta=1)
    print(json.dumps({"ate_rmse": rmse, "rpe_1": r1,
                      "n_associated": int(keep.sum())}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="orb_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run SLAM on a dataset")
    r.add_argument("settings", help="settings YAML (reference schema)")
    r.add_argument("dataset", help="image directory or video file")
    r.add_argument("--vocab", default=None, help="DBoW2 text vocabulary")
    r.add_argument("--out", default="KeyFrameTrajectory.txt")
    r.add_argument("--max-frames", type=int, default=0)
    r.add_argument("--max-keyframes", type=int, default=256)
    r.add_argument("--max-points", type=int, default=16384)
    r.add_argument("--viz-every", type=int, default=0,
                   help="write a map plot every N frames (the reference's "
                        "rviz MapPublisher refresh, MapPublisher.cc)")
    r.add_argument("--viz-out", default="map.png")
    r.add_argument("--p-local", type=int, default=4096,
                   help="tracking candidate pool size")
    r.add_argument("--min-init-matches", type=int, default=100,
                   help="two-view init acceptance floor "
                        "(reference: Tracking.cc:345)")
    r.add_argument("--chunk", type=int, default=16,
                   help="frames per extract-and-track chunk (1 = one frame "
                        "at a time through process)")
    r.add_argument("--pace", type=float, default=0.0,
                   help="seconds between frames: hand them over as a camera "
                        "would (0: as fast as the system takes them)")
    r.add_argument("--async", dest="use_async", action="store_true",
                   help="run LocalMapping + LoopClosing on background "
                        "threads (the reference's 3-thread layout)")
    r.add_argument("--stages", action="store_true",
                   help="time the system's spans and stages without "
                        "synchronizing, and print their summary and its "
                        "counters after the [final] line")
    r.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    r.set_defaults(fn=cmd_run)

    e = sub.add_parser("eval", help="ATE RMSE vs ground truth (TUM format)")
    e.add_argument("estimate")
    e.add_argument("groundtruth")
    e.add_argument("--max-dt", type=float, default=0.05)
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
