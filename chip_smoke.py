"""Smoke run of the PyTorch port on one CUDA card: builds the four
hand-written kernels, holds each against its plain PyTorch version at
main-path shapes, then drives the port's three detection paths over 64
frames: the FAST extract-and-track main path, the Harris
(nScoreType=0) extract-and-track path built from a settings file, and the
cell-fused detector.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. device: a CUDA card is required; prints `nvidia-smi` name and power
     limit;
  2. build: compiles csrc/fast_score_nms.cu (K1), csrc/pose_gn.cu (K2),
     csrc/fast_score_rect.cu (K3), csrc/fast_cell_topk.cu (K4), K2 with
     -DPOSE_GN_PROFILE and the min/max probe csrc/minmax_probe.cu, one
     nvcc each, all at once; prints each kernel's registers, shared memory
     and spills from nvcc's -Xptxas -v report;
  3. kernel vs plain on the card, bit for bit for K1, K3 and K4:
     K1, K3 and K4 on the [8, 480, 640] canvas of a rendered frame, K1
     equal inside every level, K3 equal over the whole canvas (score and
     keep), K4 equal in values and packed positions; K2 on 1024 and on 32
     rows with outliers, pose within 1e-4 and at most max(2, 1%) inlier
     flips. Times (cuda_ms) are CUDA graph replays of 30 captured calls,
     plain versions included: the device's time, with no host work between
     launches. K2 at 32 rows is the chain's latency floor; the profiled K2
     build prints thread 0's cycles per phase of the chain at 32 and 1024
     rows; K3 is also timed on a canvas of zeros (every tile takes its
     early-out) and of noise (none does). K4's bound counts the cells that
     meet the detectable interior (the line also prints the bound over
     every strip pixel). The min/max probe measures the rate at which the
     SMs issue f32 min/max (per second, per SM per clock, with the SM
     clock); each stencil kernel's min/max floor is the min/max its inputs
     need over that rate (K1: the level pixels; K3: the pixels of tiles
     without the early-out; K4: the cells that meet the interior), printed
     with the kernel's share of it;
  4. small input: the FAST main path on the card against the port's plain
     path on the CPU, 3 frames at 320x240;
  5. FAST main path: 640x480, ORBConfig() (1000 features, 8 levels), an
     8192-slot map seeded from frame 0, p_local 4096, radius 15, motion
     model on, retry off (bench.py:46-105); checks that the path never
     synchronizes with the device, that K1 and K2 ran once per frame and
     K3 and K4 never, that every frame tracks with >= 30 inliers and the
     pose error bound below;
  6. Harris path: the same scene and map size, with camera, extractor
     (nScoreType 0, 1000 features, 8 levels, fastTh 20) and motion model
     read by io/settings.py from a settings file written to a temporary
     directory; the map seeded from the Harris extractor's frame 0; the
     same checks with K3 and K2 once per frame and K1 never;
  7. cell-fused detector: DetectCellsFused on each frame's [8, 480, 640]
     canvas, with no host sync and K4 once per frame; its output shapes
     equal the stacked detector's, and the share of its keypoints that
     the FAST path also selects is printed;
  8. timing of both tracking paths as bench.py: a warmup window each,
     then the median of 3 windows each, the paths in turns (F H H F F H);
  9. mapping path: the port's SLAMSystem at the SlamConfig defaults
     (MapConfig(): 256 keyframes, 16384 points; max_ba_cams 80,
     max_ba_points 2048; OBS_CAP 32) on the same scene along
     lateral_trajectory(step=MAPPING_STEP, yaw_rate=MAPPING_YAW) (see
     profile_paths.py), seeded with frames 0 and 1 as
     keyframes (io/synthetic.py::seed_keyframe_map), then process_batch
     over 64 frames one frame per chunk: extract and track (K1, K2), the
     keyframe policy, and for each keyframe insertion, covisibility, point
     culling, triangulation, fuse, point statistics, two-phase local BA
     and keyframe culling. Checks: every frame >= 30 inliers, >= 6
     keyframes, points triangulated, every live keyframe's camera centre
     within 5 cm of the ground truth, K1 and K2 once per frame, all outputs
     finite. Then the path again, timed without that run's recording and
     stage clock: ms/frame at one frame per chunk (its keyframes and
     points compared with the checked run's) and at the default
     track_chunk_size of 8; the checked run's ms per keyframe integration
     split by stage; one keyframe integration from the same saved state
     on the card and on the CPU plain path (poses within 1e-3: the f32
     products round differently on the two devices); one bundle_adjust on
     the final map at the default configuration; and the split of one
     local-BA solver step at P=2048 and at P=16384
     (profile_paths.ba_stage_split).
Each path's launch counts are set to 0 just before it runs and read just
after. The last three lines are the kernel table as JSON (launches from
the path that runs the kernel: K1 and K2 the FAST path, K3 the Harris
path, K4 the cell-fused run; `minmax_floor_ms` for the stencil kernels),
the card's name and power limit, and
{"ok": true, "device": ...}.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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

# Published H100 SXM peaks (NVIDIA data sheet) for the bound of each
# kernel: the larger of bytes / memory rate and operations / f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Reckoned operations per pixel: the FAST score at its leanest (the
# circular 9-window min and max of the 16 circle pixels by van Herk /
# Gil-Werman at 44 each, 15 + 15 to combine the 16 arcs, the centre
# subtracted from the 2 results, 1 final max = 121; csrc/fast_score.cuh),
# the 3x3 NMS (8 max + 1 compare) and the border mask (4 compares + 1
# select).
FAST_SCORE_OPS = 2 * 44 + 2 * 15 + 2 + 1
NMS_OPS = 9
MASK_OPS = 5
# K4's top-K round per cell pixel: max, two compares, select, min, zeroing
TOPK_ROUND_OPS = 6
# K2 per row and Gauss-Newton iteration: projection, residual, Huber
# weight, Jacobian and the 27 weighted sums of the normal equations
GN_OPS_PER_ROW_ITER = 150
# The f32 min/max among those operations, which the SMs issue at their own
# rate (measured by csrc/minmax_probe.cu, not published): the stencil's 119
# (2 x 44 arcs, 2 x 15 combines, the final max), the 3x3 maximum's 8 and a
# top-K round's max and min. The stencil kernels' min/max floor is their
# count over the measured rate.
FAST_SCORE_MINMAX = 2 * 44 + 2 * 15 + 1
NMS_MINMAX = 8
TOPK_ROUND_MINMAX = 2
PROBE_CHAINS = 16    # kChains in csrc/minmax_probe.cu
# the mapping path: the keyframe whose integration runs again from its saved
# state on the card and on the CPU (the n-th after the two seeded ones), and
# the largest pose difference allowed between the two runs
CHECK_KEYFRAME = 4
MAX_CARD_CPU_POSE_DIFF = 1e-3
MIN_KEYFRAMES = 6


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, trials=3):
    """Device time of one fn() in ms, the median of `trials` timed runs
    after a warmup, each timed with CUDA events and divided by `reps`. The
    `reps` calls are captured once in a CUDA graph and each run is one
    replay, so no host work sits between the launches and the time is the
    device's own."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    run = g.replay
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def ptxas_summary(source):
    """'kernel: R registers, S bytes smem, spill stores/loads a/b' for each
    kernel of csrc/<source>, from nvcc's -Xptxas -v report."""
    from orb_slam_tpu_torch import _build

    out, name, frame = [], "?", "?"
    for line in _build.ptxas_report(source).splitlines():
        m = re.search(r"Compiling entry function '.*\d([a-z][a-z0-9_]*?_kernel)",
                      line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"stack frame {m.group(1)} bytes, spill stores/loads "
                     f"{m.group(2)}/{m.group(3)} bytes")
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                      r"(?:, (\d+) bytes smem)?", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} "
                       f"bytes static smem, {frame}")
    return "; ".join(out)


def bound_ms(n_bytes, n_ops):
    """(least time in ms, what sets it) for the given bytes and f32 ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bits_equal(a, b):
    """Equal bit for bit: float tensors compared as their int32 patterns,
    so -0.0 and +0.0 differ."""
    as_bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return a.shape == b.shape and torch.equal(as_bits(a), as_bits(b))


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
        if not bits_equal(a.contiguous(), b.contiguous()):
            bad = int((a != b).sum())
            raise AssertionError(f"K1 differs from plain on level {l}: "
                                 f"{bad} pixels")
        err = max(err, float((a - b).abs().max()))
    ms = cuda_ms(lambda: fast_score_nms(canvas, shapes))
    plain_ms = cuda_ms(lambda: fast_score_nms_plain(canvas, shapes), reps=10)
    px = sum(h * w for h, w in shapes)
    bound = bound_ms(8 * px, px * (FAST_SCORE_OPS + NMS_OPS + MASK_OPS))
    return err, ms, plain_ms, bound, px * (FAST_SCORE_MINMAX + NMS_MINMAX)


def k2_inputs(N, dev):
    """The outlier fixture of tests/test_solvers.py:220-234 at N rows."""
    rng = np.random.default_rng(42)
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
    return [a.to(dev).contiguous() for a in args]


def check_k2(dev, N=1024):
    """K2 against plain at N rows, iters (4, 3, 2, 2): pose within 1e-4, at
    most max(2, 1%) inlier flips, the count equal to the mask's sum."""
    from orb_slam_tpu_torch.solvers.pose_opt import pose_gn_plain, pose_optimize

    args = k2_inputs(N, dev)
    iters = (4, 3, 2, 2)
    T_k, inl_k, n_k = pose_optimize(*args, iters=iters)
    T_p, inl_p = pose_gn_plain(*args, iters=iters)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    flips = int((inl_k != inl_p).sum())
    if err > 1e-4:
        raise AssertionError(f"K2 pose differs from plain by {err} at N={N}")
    if flips > max(2, N // 100):
        raise AssertionError(f"K2 inlier mask differs on {flips} of {N} rows")
    if int(n_k) != int(inl_k.sum()):
        raise AssertionError("K2 inlier count disagrees with its mask")
    ms = cuda_ms(lambda: pose_optimize(*args, iters=iters))
    plain_ms = cuda_ms(lambda: pose_gn_plain(*args, iters=iters), reps=10)
    # inputs: T, K, 3D points, uv, 1/sigma^2, valid; outputs: T, mask, count
    n_bytes = 64 + 36 + N * (12 + 8 + 4 + 1) + 64 + N + 4
    bound = bound_ms(n_bytes, sum(iters) * N * GN_OPS_PER_ROW_ITER)
    return err, ms, plain_ms, bound, None


# phases of K2's chain, in the order of `enum Phase` in csrc/pose_gn.cu
K2_PHASES = ("stage", "rows", "reduce", "barrier1", "column sums", "solve",
             "compose", "barrier2", "final")
K2_PROFILE_BUILD = ("pose_gn.cu", ("-DPOSE_GN_PROFILE",))


def k2_phase_cycles(dev, reps=20):
    """K2 built with -DPOSE_GN_PROFILE at 32 and 1024 rows, iters (4, 3, 2,
    2): {N: (graph-replay ms of that build, thread 0's clock64() cycles of
    each phase per launch, summed over the iterations)}."""
    import ctypes

    from orb_slam_tpu_torch import _build
    from orb_slam_tpu_torch.solvers.pose_opt import KERNEL

    lib = ctypes.CDLL(str(_build.build_libraries([K2_PROFILE_BUILD])[K2_PROFILE_BUILD]))
    fn, read = lib.pose_gn, lib.pose_gn_phase_cycles
    fn.argtypes, fn.restype = KERNEL.argtypes, ctypes.c_int
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    out = {}
    for N in (32, 1024):
        T0, pts, uv, is2, valid, K = k2_inputs(N, dev)
        T = torch.empty((4, 4), device=dev)
        inl = torch.empty((N,), dtype=torch.bool, device=dev)
        n_in = torch.empty((), dtype=torch.int32, device=dev)

        def call():
            rc = fn(T0.data_ptr(), K.data_ptr(), pts.data_ptr(), uv.data_ptr(),
                    is2.data_ptr(), valid.data_ptr(), T.data_ptr(), inl.data_ptr(),
                    n_in.data_ptr(), N, 4, 3, 2, 2, 1e-3,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"profiled pose_gn: CUDA error {rc}")

        ms = cuda_ms(call)
        cycles = np.zeros(len(K2_PHASES), dtype=np.uint64)
        read(cycles.ctypes.data)          # reading zeroes the sums
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        if read(cycles.ctypes.data):
            raise RuntimeError("profiled pose_gn: cannot read the phase cycles")
        out[N] = (ms, cycles / reps)
    return out


def k3_tiles(canvas):
    """(how many of `canvas`'s 32x32 tiles have a uniform 40x40 window (bit
    patterns, edge-clamped) and take K3's early-out, how many tiles there
    are, the canvas pixels of the other tiles)."""
    import torch.nn.functional as F

    L, H, W = canvas.shape
    bits = canvas.view(torch.int32).double()[:, None]   # int32 -> f64 is exact
    pad = F.pad(bits, (4, 4 + (-W) % 32, 4, 4 + (-H) % 32), mode="replicate")
    hi = F.max_pool2d(pad, 40, stride=32)
    lo = -F.max_pool2d(-pad, 40, stride=32)
    uniform = (hi == lo)[:, 0]                             # [L, rows, cols]
    edge = lambda n, size: (size - 32 * torch.arange(n, device=canvas.device)
                            ).clamp(max=32)
    px = edge(uniform.shape[1], H)[:, None] * edge(uniform.shape[2], W)[None]
    return int(uniform.sum()), uniform.numel(), int((px * ~uniform).sum())


def k3_split(canvas):
    """K3's time on a canvas whose every tile takes the early-out (zeros) and
    on one where none does (uniform noise)."""
    from orb_slam_tpu_torch.ops.fast_score_rect import fast_score_nms_rect

    gen = torch.Generator(device=canvas.device).manual_seed(0)
    zeros = torch.zeros_like(canvas)
    noise = torch.rand(canvas.shape, generator=gen, device=canvas.device) * 255
    return {kind: cuda_ms(lambda c=c: fast_score_nms_rect(c))
            for kind, c in (("uniform", zeros), ("active", noise))}


def check_k3(canvas):
    from orb_slam_tpu_torch.ops.fast_score_rect import (
        fast_score_nms_rect, fast_score_nms_rect_plain,
    )

    score, keep = fast_score_nms_rect(canvas)
    p_score, p_keep = fast_score_nms_rect_plain(canvas)
    torch.cuda.synchronize()
    if not (bits_equal(score, p_score) and bits_equal(keep, p_keep)):
        raise AssertionError(
            f"K3 differs from plain: {int((score != p_score).sum())} scores, "
            f"{int((keep != p_keep).sum())} keep flags")
    err = float((score - p_score).abs().max())
    ms = cuda_ms(lambda: fast_score_nms_rect(canvas))
    plain_ms = cuda_ms(lambda: fast_score_nms_rect_plain(canvas), reps=10)
    px = canvas.numel()       # every canvas pixel: read, score and keep out
    bound = bound_ms(px * (4 + 4 + 1), px * (FAST_SCORE_OPS + NMS_OPS))
    # min/max: the pixels of the tiles without the early-out
    active_px = k3_tiles(canvas)[2]
    return (err, ms, plain_ms, bound,
            active_px * (FAST_SCORE_MINMAX + NMS_MINMAX))


def check_k4(canvas, shapes):
    from orb_slam_tpu_torch.ops.fast_cell_topk import (
        cell_block_table, empty_cells, fast_cell_topk, fast_cell_topk_plain,
    )

    vals, pos = fast_cell_topk(canvas, shapes)
    p_vals, p_pos = fast_cell_topk_plain(canvas, shapes)
    torch.cuda.synchronize()
    if not (bits_equal(vals, p_vals) and bits_equal(pos, p_pos)):
        raise AssertionError(
            f"K4 differs from plain: {int((vals != p_vals).sum())} values, "
            f"{int((pos != p_pos).sum())} positions")
    err = float((vals - p_vals).abs().max())
    ms = cuda_ms(lambda: fast_cell_topk(canvas, shapes))
    plain_ms = cuda_ms(lambda: fast_cell_topk_plain(canvas, shapes), reps=10)
    # bytes: the canvas pixels the strips cover, read once, and the outputs;
    # operations: every pixel of the cells that meet the detectable interior
    # (the other cells' output follows from the shapes alone)
    lvl, r0s, c0s = cell_block_table(shapes, 32, 256, 16)
    H, W = canvas.shape[1:]
    covered = sum((min(r + 32, H) - r) * (min(c + 256, W) - c)
                  for r, c in zip(r0s, c0s))
    n_cells = int((~empty_cells(shapes, 32, 256, 16)).sum())
    per_px = FAST_SCORE_OPS + NMS_OPS + MASK_OPS + 4 * TOPK_ROUND_OPS
    n_bytes = 4 * covered + vals.numel() * 8
    bound = bound_ms(n_bytes, n_cells * 32 * 32 * per_px)
    every_strip_px = bound_ms(n_bytes, len(lvl) * 32 * 256 * per_px)
    print(f"K4 bound: {every_strip_px[0] * 1e3:.3f} us ({every_strip_px[1]}) "
          f"counting every pixel of the {len(lvl)} strips, "
          f"{bound[0] * 1e3:.3f} us ({bound[1]}) counting the {n_cells} of "
          f"{len(lvl) * 8} cells that meet the detectable interior")
    minmax = n_cells * 32 * 32 * (FAST_SCORE_MINMAX + NMS_MINMAX
                                  + 4 * TOPK_ROUND_MINMAX)
    return err, ms, plain_ms, bound, minmax, tuple(vals.shape)


def minmax_rate(dev, iters=4096, threads=256, blocks_per_sm=8):
    """The rate at which the card issues f32 min/max, from
    csrc/minmax_probe.cu with `blocks_per_sm` blocks of `threads` per SM:
    (min/max per second over the card, the median over SMs of the min/max
    per SM cycle over the span its blocks ran, the median SM clock over
    those spans in Hz, nvidia-smi's clocks.sm read while the probe runs)."""
    import ctypes

    from orb_slam_tpu_torch._build import CudaKernel

    probe = CudaKernel("minmax_probe.cu", "minmax_probe",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = blocks_per_sm * n_sm
    inp = torch.linspace(-3.0, 5.0, 64, device=dev)
    out = torch.empty(blocks * threads, device=dev)
    record = torch.empty((blocks, 5), dtype=torch.int64, device=dev)

    def call():
        probe(inp.data_ptr(), out.data_ptr(), record.data_ptr(), blocks,
              threads, iters, torch.cuda.current_stream().cuda_stream)

    ms = cuda_ms(call, reps=10)
    # keep the card busy for ~1 s while nvidia-smi reads the clock
    for _ in range(int(1000 / ms)):
        call()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("min/max probe: non-finite output")
    per_block = threads * iters * PROBE_CHAINS
    rates, clocks = [], []
    rec = record.cpu()
    for sm in rec[:, 0].unique():
        r = rec[rec[:, 0] == sm]
        cycles = int(r[:, 2].max() - r[:, 1].min())
        ns = int(r[:, 4].max() - r[:, 3].min())
        rates.append(len(r) * per_block / cycles)
        clocks.append(cycles / ns * 1e9)
    per_s = blocks * per_block / (ms * 1e-3)
    return per_s, statistics.median(rates), statistics.median(clocks), smi


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
        ex = ORBExtractor(ORBConfig(n_features=300, n_levels=4), H, W, device=d)
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


def system_state(s):
    """A copy of everything a keyframe integration reads and writes."""
    m = s.map
    return dict(
        map={f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)},
        lists={k: list(getattr(s, k)) for k in ("free_kf", "free_pt")},
        arrays={k: getattr(s, k).copy() for k in ("kf_order", "pt_forward",
                                                  "last_pose", "velocity")},
        scalars={k: getattr(s, k) for k in ("kf_counter", "frame_id", "state",
                                            "last_kf_frame", "last_kf_slot",
                                            "ref_kf_tracked")},
        local_mask=None if s.local_mask is None else s.local_mask.clone())


def integrate_from(snap, frame, obs, n_in, pose, device):
    """One _integrate_keyframe on `device` from a saved state; returns the
    system and the host-clock seconds it took."""
    from orb_slam_tpu_torch.pipeline import system as slam
    from orb_slam_tpu_torch.slam_map.map_state import MapState

    s = slam.SLAMSystem(snap["cfg"], device=device)
    s.map = MapState(**{k: v.to(device) for k, v in snap["map"].items()})
    for k, v in snap["lists"].items():
        setattr(s, k, list(v))
    for k, v in snap["arrays"].items():
        setattr(s, k, v.copy())
    for k, v in snap["scalars"].items():
        setattr(s, k, v)
    s.local_mask = None if snap["local_mask"] is None else snap["local_mask"].to(device)
    fr = slam.FrameData(*(t.to(device) for t in (frame.xy, frame.desc, frame.octave,
                                                  frame.angle, frame.valid)),
                        frame.frame_id, frame.timestamp)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    s._integrate_keyframe(fr, obs.to(device), n_in, pose=pose)
    sync()
    return s, time.perf_counter() - t


def mapping_path(dev, card, kernels, scene):
    """Phase 9 (module docstring). Returns the K1/K2 launch counts."""
    from orb_slam_tpu_torch.io.synthetic import lateral_trajectory
    from orb_slam_tpu_torch.profile_paths import (
        MAPPING_STEP, MAPPING_YAW, StageClock, ba_stage_split,
        keyframe_center_errors, mapping_system,
    )
    from orb_slam_tpu_torch.slam_map.observations import OBS_CAP
    from orb_slam_tpu_torch.solvers.local_ba import bundle_adjust

    poses = lateral_trajectory(N_FRAMES + 2, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses])).to(dev)
    s = mapping_system(scene, poses, frames, dev)
    cfg = s.cfg
    print(f"mapping path: step {MAPPING_STEP} and yaw {MAPPING_YAW} rad per "
          f"frame, {N_FRAMES} frames after "
          f"the 2 seeded keyframes ({int(s.map.pt_valid.sum())} points), "
          f"MapConfig({cfg.map.max_keyframes}, {cfg.map.max_points}, "
          f"{cfg.map.n_features}), max_ba_cams {cfg.max_ba_cams}, max_ba_points "
          f"{cfg.max_ba_points}, OBS_CAP {OBS_CAP}; the checked run one frame "
          f"per chunk (the default is {cfg.track_chunk_size})")

    # the checked run: record each frame's inliers, each integration's
    # counts and the state before the CHECK_KEYFRAME-th integration, with a
    # host clock on every stage
    inliers, counts, snap = [], [], {}
    apply_chunk, integrate = s._apply_chunk, s._integrate_keyframe

    def recorded_apply(feats, xy, chunk, n, ts):
        consumed, out = apply_chunk(feats, xy, chunk, n, ts)
        inliers.extend(chunk.n_inliers[:consumed].tolist())
        return consumed, out

    def recorded_integrate(frame, obs, n_in, pose=None, abort=None):
        if s.kf_counter == 2 + CHECK_KEYFRAME - 1 and not snap:
            snap.update(system_state(s), cfg=cfg, args=(
                frame, obs.clone(), n_in, np.array(pose)))
        slot = integrate(frame, obs, n_in, pose, abort)
        counts.append(dict(s.mapping_counts))
        return slot

    s._apply_chunk, s._integrate_keyframe = recorded_apply, recorded_integrate
    stage_s = {}
    s._stage_timer = StageClock(stage_s)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    out = s.process_batch(frames[2:], chunk_size=1)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}

    n_kf = s.kf_counter - 2
    created = sum(sum(c["created"]) for c in counts)
    m = s.map
    fid, _, c_err = keyframe_center_errors(s, poses)
    finite = (all(np.isfinite(p).all() for p in out)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    print(f"mapping path: {len(out)} frames tracked, inliers min {min(inliers)} "
          f"median {int(np.median(inliers))}; {n_kf} keyframes inserted, "
          f"{len(fid)} live; {created} points triangulated, "
          f"{sum(c['culled'] for c in counts)} culled, "
          f"{sum(c['fuse_bound'] for c in counts)} features bound and "
          f"{sum(c['merged'] for c in counts)} points merged by fuse, "
          f"{sum(c['kf_culled'] for c in counts)} keyframes culled; "
          f"{int(m.pt_valid.sum())} points at the end; keyframe centre error max "
          f"{c_err.max():.4f} mean {c_err.mean():.4f} (frames "
          f"{sorted(fid.tolist())}); launches {launches}")
    if len(out) != N_FRAMES or min(inliers) < MIN_INLIERS:
        raise AssertionError(f"mapping path: {len(out)} frames, inliers {inliers}")
    if n_kf < MIN_KEYFRAMES or created == 0:
        raise AssertionError(f"mapping path: {n_kf} keyframes, {created} points")
    if c_err.max() > MAX_CENTER_ERR:
        raise AssertionError(f"mapping path: keyframe centre error {c_err.max():.4f}")
    if not finite:
        raise AssertionError("mapping path: non-finite output")
    expect_launches = {"K1": N_FRAMES, "K2": N_FRAMES, "K3": 0, "K4": 0}
    if launches != expect_launches:
        raise AssertionError(f"mapping path: launches {launches}, "
                             f"expected {expect_launches}")

    # the path timed without the recording, the stage clock and the
    # snapshot: one frame per chunk (as checked), then the default chunk
    timed = {}
    for chunk in (1, cfg.track_chunk_size):
        r = mapping_system(scene, poses, frames, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.process_batch(frames[2:], chunk_size=chunk)
        torch.cuda.synchronize()
        timed[chunk] = (time.perf_counter() - t, r)
    same = torch.equal(timed[1][1].map.kf_pose, m.kf_pose) and torch.equal(
        timed[1][1].map.pt_pos, m.pt_pos)
    print(f"mapping path timing on {card}: {timed[1][0] * 1e3 / N_FRAMES:.3f} "
          f"ms/frame at one frame per chunk (not the default; keyframe poses and "
          f"points {'bit-identical to' if same else 'DIFFERENT from'} the checked "
          f"run's)")
    for chunk, (dt, r) in timed.items():
        if chunk == 1:
            continue
        _, _, e = keyframe_center_errors(r, poses)
        print(f"mapping path timing on {card}: {dt * 1e3 / N_FRAMES:.3f} ms/frame "
              f"at the default {chunk} frames per chunk ({r.kf_counter - 2} "
              f"keyframes, centre error max {e.max():.4f} mean {e.mean():.4f})")

    # the checked run's time, split by stage
    its = np.array(s.ba_iterations)
    per_kf = lambda v: sum(v) * 1e3 / n_kf
    n_nb = sum(len(c["created"]) for c in counts)
    local = sum(sum(v) for v in stage_s.values())
    print(f"mapping path, checked run on {card}: {checked_s * 1e3 / N_FRAMES:.3f} "
          f"ms/frame (the stage clock's syncs and the state snapshot included); "
          f"local mapping {local * 1e3 / n_kf:.3f} ms per keyframe integration "
          f"({n_kf} integrations)")
    for name, v in stage_s.items():
        extra = ""
        if name.startswith("triangulation"):
            extra = f", {sum(v) * 1e3 / max(n_nb, 1):.3f} ms per neighbour ({n_nb} neighbours)"
        if name.startswith("BA phase"):
            # ba_iterations alternates (phase 1, 0) and (0, phase 2) calls
            n_it = its[0::2, 0] if name.endswith("1") else its[1::2, 1]
            extra = (f", {n_it.mean():.2f} LM iterations per call, "
                     f"{sum(v) * 1e3 / max(n_it.sum(), 1):.3f} ms per iteration")
        print(f"    {name}: {per_kf(v):.3f} ms per keyframe integration{extra}; {card}")

    # one integration from the same saved state, card and CPU
    frame, obs, n_in, pose = snap.pop("args")
    g, g_s = integrate_from(snap, frame, obs, n_in, pose, dev)
    c, c_s = integrate_from(snap, frame, obs, n_in, pose, torch.device("cpu"))
    gv, cv = g.map.kf_valid.cpu(), c.map.kf_valid
    pose_diff = float((g.map.kf_pose.cpu() - c.map.kf_pose)[gv & cv].abs().max())
    both = g.map.pt_valid.cpu() & c.map.pt_valid
    pt_diff = float((g.map.pt_pos.cpu() - c.map.pt_pos)[both].abs().max())
    print(f"card vs CPU, keyframe {CHECK_KEYFRAME} integrated from one saved state: "
          f"max |d pose| {pose_diff:.3g}, max |d point| {pt_diff:.3g} over "
          f"{int(both.sum())} points live in both, validity flips "
          f"{int((g.map.pt_valid.cpu() != c.map.pt_valid).sum())}, kf_obs differing "
          f"{float((g.map.kf_obs.cpu() != c.map.kf_obs).float().mean()):.5f}; "
          f"counts card {g.mapping_counts}, CPU {c.mapping_counts}; BA iterations "
          f"card {g.ba_iterations}, CPU {c.ba_iterations}; {g_s * 1e3:.1f} ms on "
          f"the card ({card}), {c_s * 1e3:.1f} ms on the CPU")
    if not pose_diff <= MAX_CARD_CPU_POSE_DIFF:
        raise AssertionError(f"card vs CPU keyframe poses differ by {pose_diff}")

    # BA alone on the final map around the newest keyframe, chosen as
    # _local_mapping chooses, at the default configuration
    kf = s.last_kf_slot
    cam_opt, pt_opt = s._local_ba_sets(m, kf, s._covisible_neighbors(m, kf)[2])
    ba_its = []
    kw = dict(max_opt_cams=cfg.max_ba_cams, max_opt_pts=cfg.max_ba_points,
              scale_factor=cfg.map.scale_factor)
    bundle_adjust(m, s.K_dev, cam_opt, pt_opt, **kw)            # warmup
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, _, _ = bundle_adjust(m, s.K_dev, cam_opt, pt_opt, iterations=ba_its, **kw)
    torch.cuda.synchronize()
    ba_ms = (time.perf_counter() - t) * 1e3
    if not torch.isfinite(st.kf_pose).all():
        raise AssertionError("bundle_adjust: non-finite poses")
    print(f"bundle_adjust alone on the final map ({int(cam_opt.sum())} cameras, "
          f"{int(pt_opt.sum())} points; iters1 5, iters2 10, Kl {cfg.max_ba_cams}, "
          f"Pl {cfg.max_ba_points}): {ba_ms:.3f} ms, LM iterations {ba_its[0]}; {card}")
    for P in (cfg.max_ba_points, cfg.map.max_points):
        split = ba_stage_split(dev, P)
        print(f"BA solver step at P={P}, O=32, Kl=80 (scripts/profile_ba.py's "
              f"inputs, CUDA-event medians): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f"; {card}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    card = device_line()
    print(f"device: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from orb_slam_tpu_torch import _build
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
    from orb_slam_tpu_torch.geometry.camera import CameraModel
    from orb_slam_tpu_torch.io.settings import (
        settings_text, slam_config_from_settings,
    )
    from orb_slam_tpu_torch.io.synthetic import (
        SyntheticScene, lateral_trajectory, seed_map,
    )
    from orb_slam_tpu_torch.ops import fast_cell_topk as k4
    from orb_slam_tpu_torch.ops import fast_score_nms as k1
    from orb_slam_tpu_torch.ops import fast_score_rect as k3
    from orb_slam_tpu_torch.ops.fast_stack import (
        DetectCellsFused, build_pyramid_stack, detect_keypoints_packed,
    )
    from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig
    from orb_slam_tpu_torch.solvers import pose_opt as k2

    kernels = {"K1": k1.KERNEL, "K2": k2.KERNEL, "K3": k3.KERNEL, "K4": k4.KERNEL}

    # -- build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build_libraries([k.source for k in kernels.values()]
                           + [K2_PROFILE_BUILD, "minmax_probe.cu"])
    for k in kernels.values():
        k.load()
    print(f"build: {', '.join(k.source for k in kernels.values())}, "
          f"pose_gn.cu -DPOSE_GN_PROFILE and minmax_probe.cu in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc, then load)")

    def run_counted(fn):
        """fn() with every launch count set to 0 just before and read just
        after, under the no-host-sync guard."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, {name: k.launches for name, k in kernels.items()}

    def expect_launches(path, got, want):
        if got != want:
            raise AssertionError(f"{path}: launches {got}, expected {want}")

    # -- scene, extractors, map
    W, H = 640, 480
    scene = SyntheticScene(n_points=800, width=W, height=H)
    poses = lateral_trajectory(N_FRAMES + 1, step=0.01)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
    frames = frames.to(dev)
    extractor = ORBExtractor(ORBConfig(), H, W, device=dev)
    camera = CameraModel(scene.fx, scene.fy, scene.cx, scene.cy, width=W, height=H)
    K = torch.from_numpy(scene.K).to(dev)

    # -- kernel vs plain at main-path shapes
    canvas = build_pyramid_stack(frames[0], extractor.Rp, extractor.Cp)
    checks = {"K1": check_k1(canvas, extractor.shapes), "K2": check_k2(dev),
              "K3": check_k3(canvas), "K4": check_k4(canvas, extractor.shapes)}
    print(f"K1 fast_score_nms: bit-equal to plain inside every level of "
          f"{list(canvas.shape)}")
    print(f"K2 pose_gn: max |dT| {checks['K2'][0]:.3g} vs plain at 1024 rows")
    print(f"K3 fast_score_rect: score and keep bit-equal to plain over the "
          f"whole {list(canvas.shape)} canvas")
    print(f"K4 fast_cell_topk: values and positions bit-equal to plain, "
          f"output {list(checks['K4'][5])}")
    # K2 at 32 rows, where the row work is negligible: the chain's own
    # latency, the floor of this design
    k2_floor_ms = check_k2(dev, N=32)[1]
    for name, c in checks.items():
        floor = (f", chain floor {k2_floor_ms:.4f} ms (32 rows)"
                 if name == "K2" else "")
        print(f"{name}: kernel {c[1]:.4f} ms, plain {c[2]:.4f} ms "
              f"(graph replay), bound {c[3][0] * 1e3:.3f} us "
              f"({c[3][1]}){floor} on {card}")
    for N, (ms, cyc) in k2_phase_cycles(dev).items():
        print(f"K2 phases at {N} rows, thread-0 cycles per launch (profiled "
              f"build, {ms:.4f} ms): "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(K2_PHASES, cyc))
              + f"; total {cyc.sum():.0f}")
    k3_ms = k3_split(canvas)
    n_uniform, n_tiles, _ = k3_tiles(canvas)
    print(f"K3 split: {k3_ms['uniform']:.4f} ms with every tile uniform, "
          f"{k3_ms['active']:.4f} ms with none; the frame's canvas has "
          f"{n_uniform} of {n_tiles} tiles uniform")
    for name, source in [(n, k.source) for n, k in kernels.items()] + [
            ("probe", "minmax_probe.cu")]:
        print(f"ptxas {name} {source}: {ptxas_summary(source)}")

    # the min/max issue rate, and each stencil kernel's share of the floor
    # it sets: the min/max that the kernel's inputs need over that rate
    per_s, per_sm_clock, clock_hz, smi_clock = minmax_rate(dev)
    print(f"min/max probe: {per_s:.4g} f32 min/max per second, "
          f"{per_sm_clock:.2f} per SM per clock at {clock_hz / 1e9:.3f} GHz "
          f"(medians over the SMs of clock64 and globaltimer over the span "
          f"each SM's blocks ran); nvidia-smi clocks.sm, clocks.max.sm: "
          f"{smi_clock}; on {card}")
    floors = {}
    for name in ("K1", "K3", "K4"):
        minmax, ms = checks[name][4], checks[name][1]
        floors[name] = minmax / per_s * 1e3
        print(f"{name} min/max floor: {minmax / 1e6:.1f} M min/max -> "
              f"{floors[name] * 1e3:.2f} us; the kernel's {ms * 1e3:.2f} us "
              f"is {floors[name] / ms:.2f} of it")

    same, err = check_small_input(dev)
    print(f"small input (320x240, 3 frames): card vs CPU plain path: "
          f"{same:.4f} of keypoints equal, poses within {err:.3g}")

    pose0 = torch.from_numpy(poses[0]).to(dev)
    vel0 = torch.eye(4, device=dev)
    gt = torch.from_numpy(poses[1:]).to(dev)

    def track_path(name, ex, cam, use_motion_model):
        """Seed a map from ex's frame 0, run the 64 frames counted and
        checked. Returns (launches, a function timing one window)."""
        f0 = ex(frames[0])
        state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                         MapConfig(max_keyframes=64, max_points=8192,
                                   n_features=ex.config.n_features), device=dev)
        n_seed = int(state.pt_valid.sum())

        def run(imgs):
            return extract_track_chunk(
                imgs, ex, cam, state, pose0, vel0, K, p_local=4096,
                radius=15.0, min_inliers=MIN_INLIERS,
                use_motion_model=use_motion_model, max_dist=100)

        (feats, _, chunk), launches = run_counted(lambda: run(frames[1:]))
        n_in = chunk.n_inliers.cpu()
        if (feats.xy.shape != (N_FRAMES, ex.config.n_features, 2)
                or not torch.isfinite(chunk.pose).all()):
            raise AssertionError(f"{name}: malformed features or poses")
        if int(n_in.min()) < MIN_INLIERS:
            raise AssertionError(f"{name}: frames under {MIN_INLIERS} inliers: "
                                 f"{n_in.tolist()}")
        c_err = (center(chunk.pose) - center(gt)).norm(dim=-1).cpu()
        if float(c_err.max()) > MAX_CENTER_ERR:
            raise AssertionError(f"{name}: camera centre error "
                                 f"{float(c_err.max()):.4f} > {MAX_CENTER_ERR}")
        print(f"{name}: map {n_seed} points, inliers min {int(n_in.min())} "
              f"median {int(n_in.median())}, matches median "
              f"{int(chunk.n_matches.median())}, centre error max "
              f"{float(c_err.max()):.4f} mean {float(c_err.mean()):.4f}, "
              f"launches {launches}")

        def window(wi):
            """Seconds for the 64 frames shifted by a small intensity step,
            so no frame repeats."""
            imgs = frames[1:] + 0.31 * wi
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run(imgs)
            torch.cuda.synchronize()
            float(out[2].pose.sum())
            return time.perf_counter() - t

        return launches, window

    # -- FAST main path
    fast_launches, fast_window = track_path("FAST main path", extractor,
                                            camera, True)
    expect_launches("FAST main path", fast_launches,
                    {"K1": N_FRAMES, "K2": N_FRAMES, "K3": 0, "K4": 0})

    # -- Harris path, from a settings file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "harris.yaml")
        with open(path, "w") as f:
            f.write(settings_text(camera, ORBConfig(score_harris=True)))
        h_cam, h_orb, h_extras = slam_config_from_settings(path)
    if not h_orb.score_harris or (h_cam.width, h_cam.height) != (W, H):
        raise AssertionError(f"settings file read as {h_orb}, {h_cam}")
    harris = ORBExtractor(h_orb, H, W, device=dev)
    harris_launches, harris_window = track_path(
        "Harris path", harris, h_cam, h_extras["use_motion_model"])
    expect_launches("Harris path", harris_launches,
                    {"K1": 0, "K2": N_FRAMES, "K3": N_FRAMES, "K4": 0})

    # -- cell-fused detector on every frame's canvas
    cells = DetectCellsFused(extractor.shapes, extractor.quotas, device=dev)
    stacks = [build_pyramid_stack(f, extractor.Rp, extractor.Cp)
              for f in frames[1:]]
    cell_out, cell_launches = run_counted(lambda: [cells(s) for s in stacks])
    expect_launches("cell-fused run", cell_launches,
                    {"K1": 0, "K2": 0, "K3": 0, "K4": N_FRAMES})
    shared, n_fast = 0, 0
    for s, (xy_c, _, v_c) in zip(stacks, cell_out):
        xy_f, _, v_f = detect_keypoints_packed(s, extractor.selector)
        if [t.shape for t in (xy_c, v_c)] != [t.shape for t in (xy_f, v_f)]:
            raise AssertionError("cell-fused output shapes differ from the "
                                 "stacked detector's")
        mark = torch.zeros((len(extractor.shapes), H * W + 1), dtype=torch.bool,
                           device=dev)
        lin = lambda xy, v: torch.where(v, xy[..., 1] * W + xy[..., 0], H * W)
        mark.scatter_(1, lin(xy_f, v_f).long(), True)
        mark[:, H * W] = False
        shared += int(torch.gather(mark, 1, lin(xy_c, v_c).long()).sum())
        n_fast += int(v_f.sum())
    print(f"cell-fused run: launches {cell_launches}, {shared / n_fast:.4f} of "
          f"the FAST path's {n_fast / N_FRAMES:.1f} keypoints/frame also "
          f"selected (not expected to be 1: K=4 per cell caps the pool)")

    # timing as bench.py (a warmup window, then the median of 3 windows),
    # the two paths in turns: FAST, Harris, Harris, FAST, FAST, Harris
    windows = {"FAST main path": fast_window, "Harris path": harris_window}
    dts = {name: [] for name in windows}
    for name, window in windows.items():
        window(1)
    fast, harris = windows
    for wi, name in enumerate([fast, harris, harris, fast, fast, harris]):
        dts[name].append(windows[name](100 + wi))
    for name, ts in dts.items():
        dt = statistics.median(ts)
        print(f"{name} timing on {card}: windows "
              f"{[round(d * 1e3, 2) for d in ts]} ms per {N_FRAMES} frames, "
              f"median {dt * 1e3 / N_FRAMES:.3f} ms/frame = "
              f"{N_FRAMES / dt:.2f} frames/s")

    mapping_path(dev, card, kernels, scene)

    launches = {"K1": fast_launches["K1"], "K2": fast_launches["K2"],
                "K3": harris_launches["K3"], "K4": cell_launches["K4"]}
    meta = {
        "K1": ("fast_score_nms", "orb_slam_tpu_torch/csrc/fast_score_nms.cu",
               "orb_slam_tpu/ops/pallas_fast.py:121"),
        "K2": ("pose_gn", "orb_slam_tpu_torch/csrc/pose_gn.cu",
               "orb_slam_tpu/solvers/pose_opt_pallas.py:113"),
        "K3": ("fast_score_rect", "orb_slam_tpu_torch/csrc/fast_score_rect.cu",
               "orb_slam_tpu/ops/pallas_fast.py:32"),
        "K4": ("fast_cell_topk", "orb_slam_tpu_torch/csrc/fast_cell_topk.cu",
               "orb_slam_tpu/ops/pallas_fast.py:287"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[k], "max_abs_err": checks[k][0],
         "ms": checks[k][1], "plain_ms": checks[k][2],
         "bound_ms": checks[k][3][0], "bound_by": checks[k][3][1],
         "library_ms": None, "timing": "graph replay",
         "plain_timing": "graph replay",
         "minmax_floor_ms": floors.get(k),
         **({"chain_floor_ms": k2_floor_ms} if k == "K2" else {})}
        for k, (name, source, replaces) in meta.items()]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
