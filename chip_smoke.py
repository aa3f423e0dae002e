"""Smoke run of the PyTorch port on one CUDA card: builds the five
hand-written kernels, holds each against its plain PyTorch version at
main-path shapes, then drives the port's three detection paths over 64
frames: the FAST extract-and-track main path, the Harris
(nScoreType=0) extract-and-track path built from a settings file, and the
cell-fused detector; then the mapping path from a seeded map and the
whole system from raw frames through its own two-view initialisation,
that system lost in a blackout and relocalised against its keyframe
database, that system closing a drifted loop, the same frames with the
mapper and loop threads live, the command line, the mapping path with
its bundle adjustment sharded over a mesh of devices, the port of the
repo's demo (examples/run_synthetic_torch.py), and the system on a map
small enough that both slot pools fill and recycle.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh    # phases 1, 2, 9 and 18 alone

Phases (any failure raises and the exit code is non-zero):
  1. device: a CUDA card is required; prints `nvidia-smi` name and power
     limit;
  2. build: compiles csrc/fast_score_nms.cu (K1), csrc/pose_gn.cu (K2),
     csrc/fast_score_rect.cu (K3), csrc/fast_cell_topk.cu (K4),
     csrc/keypoint_select.cu (K5), K2 with -DPOSE_GN_PROFILE and the
     min/max probe csrc/minmax_probe.cu, one nvcc each, all at once;
     prints each kernel's registers, shared memory and spills from nvcc's
     -Xptxas -v report;
  3. kernel vs plain on the card, bit for bit for K1, K3, K4 and K5:
     K1, K3 and K4 on the [8, 480, 640] canvas of a rendered frame, K1
     equal inside every level, K3 equal over the whole canvas (score and
     keep), K4 equal in values and packed positions; K5 (the keypoint
     selection) equal to the plain selector in xy, score and valid, once
     per selection, on the masked canvas after K1 of a rendered frame at
     640x480/1000, 752x480/1000 and 1241x376/2000 features, after K3 and
     the Harris ranking at 640x480, and on canvases all zero, of one score
     everywhere, with most cells under 4 corners above th_ini and with
     texture-skewed cells (k5_adversarial); K2 on 1024 and on 32
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
     synchronizes with the device, that K1, K2 and K5 ran once per frame
     and K3 and K4 never, that every frame tracks with >= 30 inliers and the
     pose error bound below;
  6. Harris path: the same scene and map size, with camera, extractor
     (nScoreType 0, 1000 features, 8 levels, fastTh 20) and motion model
     read by io/settings.py from a settings file written to a temporary
     directory; the map seeded from the Harris extractor's frame 0; the
     same checks with K3, K2 and K5 once per frame and K1 never;
  7. cell-fused detector: DetectCellsFused on each frame's [8, 480, 640]
     canvas, with no host sync, K4 once per frame and K5 never; its
     output shapes equal the stacked detector's, and the share of its
     keypoints that the FAST path also selects is printed;
  8. timing of both tracking paths as bench.py: a warmup window each,
     then the median of 3 windows each, the paths in turns (F H H F F H);
  9. mapping path: the port's SLAMSystem at the SlamConfig defaults
     (MapConfig(): 256 keyframes, 16384 points; max_ba_cams 80,
     max_ba_points 2048; OBS_CAP 32) on the same scene along
     lateral_trajectory(step=MAPPING_STEP, yaw_rate=MAPPING_YAW) (see
     profile_paths.py), seeded with frames 0 and 1 as
     keyframes (io/synthetic.py::seed_keyframe_map), then process_batch
     over 64 frames one frame per chunk, which routes each frame through
     `process` (make_frame, then `_track`): extract and track (K1, K2),
     the keyframe policy, and for each keyframe insertion, covisibility,
     point culling, triangulation, fuse, point statistics, two-phase local
     BA and keyframe culling. Checks: every frame >= 30 inliers, >= 6
     keyframes, points triangulated, the live keyframes' ATE after a Sim3
     alignment at most 2% of the ground-truth path length (profile_paths.
     keyframe_ate), and as a guard on this one seeded scene every live
     keyframe's camera centre within 5 cm of the ground truth, K1 and K2
     once per frame, all outputs finite; it prints the keyframes of this
     scene's recorded baseline (PERF.md section 6) beside its own. Then the path again, timed without that run's recording and
     stage clock: ms/frame at one frame per chunk (its keyframes and
     points compared with the checked run's) and at the default
     track_chunk_size of 8; the checked run's ms per keyframe integration
     split by stage; one keyframe integration from the same saved state
     on the card and on the CPU plain path (poses within 1e-3: the f32
     products round differently on the two devices); one bundle_adjust on
     the final map at the default configuration; and the split of one
     local-BA solver step at P=2048 and at P=16384
     (profile_paths.ba_stage_split).
 10. init path: the system at the SlamConfig defaults (loop closing and
     relocalisation off) from raw frame 0 through its own two-view
     initialisation, 66 frames through process_batch at chunk 8. Checks:
     WORKING within 10 frames, >= 90% of the later frames tracked, >= 6
     keyframes, keyframe ATE <= 2% of the path, K1 once per extraction, K2
     at least once per tracked frame;
 11. initialize_two_view on the init path's successful inputs, card
     against CPU on the same minimal sets, and timed (CUDA events) with its
     linalg parts split out;
 12. relocalisation path (profile_paths.reloc_path): the system with
     relocalisation on, loop closing off and the shipped 95,118-word
     vocabulary (ORBConfig(), MapConfig(), bow_slots 1000, 128 EPnP
     hypotheses), raw frames 0-47 of the mapping trajectory through
     process_batch at chunk 8, 3 uniform-gray frames (a blackout), then the
     frames of poses 20-35 again. Checks: LOST after the blackout with no
     auto-reset (> 5 keyframes); relocalised within the first 3 revisit
     frames; the relocalised camera centre, under the keyframe
     trajectory's Sim3 alignment, within 2% of the mapped path's length
     of the ground truth; every later revisit frame tracked and the
     keyframe ATE <= 2%; K1 once per extraction, K2 at least once inside
     every _relocalize that reaches EPnP; all outputs finite. Prints the
     _relocalize split by stage (profile_paths.relocalize_split) of the
     successful call and of a failed call on a blank frame, the BoW add
     per keyframe integration, and ms/frame from a second run without
     the stage clock;
 13. place recognition and EPnP on the card, timed with CUDA events
     (`_relocalize` reads counts on the host: no graph replay):
     transform + bow_vector of the relocalised frame's 1000 descriptors
     on the shipped tree and on a synthetic full k=10, L=6 tree
     (1,111,111 nodes, ORBvoc.txt's shape; profile_paths.synthetic_tree),
     words and ids equal to the CPU's and weights within 1e-6; l1_score
     against a 256-row database (scores within 1e-6 of the CPU's, the
     candidates equal, and the nearest accumulated score's margin to the
     0.75 cut); epnp_ransac on the successful call's 1000 rows and 128
     four-point sets, card against CPU: inlier counts within 1%, flags
     equal on >= 99% of rows, the pose refined by pose_optimize on the
     inliers within 1e-3 (the best hypothesis is printed: a four-point
     set's null space is four-dimensional rounding noise, so the winner
     among equally good hypotheses can differ); one _relocalize from the
     saved state on the card and the CPU with the same sets: the same
     accept decision, pose within 1e-3;
 14. loop path (profile_paths.loop_path): the system at the SlamConfig
     defaults (loop closing and relocalisation on, the shipped
     vocabulary, ORBConfig(), MapConfig(), chunk 8) from raw frames of a
     wide version of the mapping scene along a sideways path out and the
     same poses back (profile_paths.LOOP_SCENE_TEXT), the recent half of
     the map drifted through the Sim3 profile_paths.LOOP_DRIFT after the
     first keyframe at or past frame profile_paths.LOOP_DRIFT_AT. Checks:
     WORKING within 10 frames, >= 90% of the later frames tracked, a loop
     closed onto a keyframe of the first quarter of the path out, the
     keyframe ATE after a Sim3 alignment just after the correction and at
     the end at most MAX_LOOP_ATE_RATIO of the one just before it, just
     after it within MAX_LOOP_AFTER_VS_JAX of the JAX package's CPU
     reading on the same frames and at the end within
     MAX_LOOP_ATE_VS_JAX of it (JAX_LOOP_ATE_*), K1 once per extraction,
     K2 at least once per tracked frame, all outputs finite. Prints the
     split by stage (profile_paths.loop_split) of the accepted pass and of
     a detect with no candidate, the correction's group, merges and
     essential-graph edges; the accepted pass again from its saved state
     (profile_paths.loop_replay) on the card and the CPU with the same
     sets (the same decision and candidate, S12 within MAX_LOOP_DS12,
     keyframe poses within 1e-3); the same pass on the card with the
     essential graph's step made a no-op, whose ATE must fail the checks
     above (a control: the checks tell a corrected map from one corrected
     only in the new keyframe's group); and ms/frame from a second run
     without the stage clock;
 15. the loop closer's device calls on the accepted pass's own inputs,
     timed with CUDA events around whole calls and held against the CPU:
     sim3_ransac (1000 rows x 300 sets) and optimize_sim3 (s, R, t within
     MAX_LOOP_DS12), search_by_sim3 and project_loop_points (flags equal
     on >= 99%), fuse_points_into_keyframes at P=16384 (kf_obs equal on
     >= 99.9%, remapped points within 2), optimize_essential_graph dense
     at K=256 on the pass's graph and PCG at K=1024 on
     profile_paths.chain_pose_graph (within MAX_LOOP_DGRAPH).
 16. async path (profile_paths.async_path): the loop path's 319 frames
     through AsyncSLAMSystem at the same configuration, the mapper and
     loop threads live, the frames handed over as a camera sends them,
     one every profile_paths.ASYNC_FRAME_PERIOD seconds
     (profile_paths.PacedFeed: every frame that has arrived, at most a
     chunk of 8 per call, as the reference's examples pace a sequence);
     the drift goes in inside an exclusive window (finish, request_stop,
     inject_drift, release) that the camera waits out. Checks: the final
     finish() drains within its timeout and neither thread stored an
     error, WORKING within 10 frames, >= 90% of later frames tracked,
     phase 14's loop checks (a closure onto the first quarter, the
     keyframe ATE just after it and at the end; ASYNC_LOOP_GATED), K1
     once per extraction, K2 at least once per tracked frame, all outputs
     finite. Prints the tracking thread's ms/frame inside process_batch
     beside phase 14's sequential timing run and their ratio, with the
     final drain, keyframes and loops closed against phase 14's, the
     mapper's integrations, and the keyframe ATE before and after each
     correction and at the end. Then the session: save_session of the
     async system, load_session into a fresh SLAMSystem on the card with
     relocalisation off, every map and database array equal, and the
     path's last 8 frames through the loaded system again at chunk 8,
     last first from the saved final pose, each tracked with >= 30
     inliers and none relocalised;
 17. the CLI: 64 frames of the mapping scene and trajectory written as
     binary PGM, a settings file (FAST, 1000 features, 8 levels) and the
     ground truth as a TUM file in a temporary directory; `cli.main(["run",
     settings, frames, "--chunk", "8", "--async", "--pace", CLI_PACE,
     "--out", traj])` on the card (the frames handed over as a camera
     sending one every CLI_PACE seconds would), then `cli.main(["eval",
     traj, gt])`. Checks: >= 6 keyframes in the trajectory, the eval's
     ate_rmse <= 2% of the ground-truth path length, K1 once per
     extraction. Then the same run unpaced, as JAX's CLI feeds a
     directory: K1 once per extraction, and its keyframes and final state
     printed as ROADMAP C17's reading (an unpaced caller outruns local
     mapping, so what it keeps depends on the host's speed). Prints both
     `[final]` lines (their fps).
 18. mesh mode (run right after phase 9, from its final map and saved
     state): a mesh of MESH_SHARDS entries cuda:i modulo the visible
     cards (shared cuda:0 on one card, distinct cards where there are
     enough; the line says which), 4 x 1 for BA and 2 x 2 for matching.
     bundle_adjust on phase 9's final map around its newest keyframe at
     the mapping path's shapes (max_ba_cams 80, max_ba_points 2048,
     OBS_CAP 32) with and without the mesh, on the points _local_mapping
     chooses and on those of them seen by >= 3 keyframes: on the scale of
     a map of unit median depth, poses within 5e-5, the points seen by >=
     3 keyframes within 5e-4 and the others within 1.5e-2, the robust
     costs within 1e-4 relative (the LM's stop tolerance), the outlier and
     observation tables equal, every reduction of the mesh run over all
     its shards, and the mesh run repeated bit for bit; both timed with
     CUDA events. One _integrate_keyframe from phase 9's saved
     state with `SlamConfig.mesh` against one device, in turns (on the
     same scale poses within 1e-4, points 1e-3 / 1.5e-2; at most 2
     validity flips, under 0.5% of kf_obs differing, the two mesh runs
     bit-equal); then that
     system maps the next MESH_FRAMES frames one per chunk through
     process_batch, every BA on the mesh: each frame tracked, keyframe ATE
     <= 2% of the path, K1 once per frame, K2 at least once, K3 and K4
     never. sharded_hamming_argmin at [4096, 8] x [1000, 8] and
     sharded_ransac_best over 300 integer scores (ties at the maximum)
     equal to their one-device answers.
 19. example: examples/run_synthetic_torch.py's `main` on the card into a
     temporary directory (20 frames of a 220-point scene written as PGM
     at 320x240, read back by ImageDirDataset, 400 features, 4 levels,
     MapConfig(16, 1024), loop closing and relocalisation off). Checks: >=
     90% of the 20 frames tracked, >= MIN_EXAMPLE_KEYFRAMES keyframes, the
     printed ATE (every tracked frame, Sim3-aligned) <= MAX_EXAMPLE_ATE_SHARE
     of the 1.9 m path, K1 once per extraction, K2 at least once per frame
     tracked after the initialisation frame, K3 and K4 never;
 20. capacity path (profile_paths.capacity_path): the system at the
     SlamConfig defaults (ORBConfig(), chunk 8, relocalisation on with the
     shipped vocabulary, loop closing off) on MapConfig(CAPACITY_KEYFRAMES
     = 16, CAPACITY_POINTS = 512) from raw 640x480 frames of the loop
     scene, CAPACITY_LEGS = 6 sideways legs of CAPACITY_SWEEP = 30 frames
     out and back (175 frames), under profile_paths.SlotRecord. Checks
     (profile_paths.capacity_failures): more point slots written than the
     pool holds, a keyframe decision refused with free_kf empty, a
     keyframe culled and every culled slot taken by a later keyframe,
     free_pt exactly the invalid point slots once each, free_kf no live
     keyframe, every pt_forward entry -1 or a slot with each live point
     its own, the live keyframes' spanning tree acyclic with one root, >=
     90% of the frames after the first tracked one tracked, WORKING at the
     end, the keyframe ATE <= 2% of the path; K1 once per extraction, K2
     at least once per frame tracked after the initialisation frame, K3
     and K4 never, all outputs finite. Prints the slots written and
     recycled, the keyframes culled (with the pool full or not), the
     frames at capacity, ms/frame and ms per integration before capacity
     and at it (an integration that takes the pool's last free slot).
Each path's launch counts are set to 0 just before it runs and read just
after. The last three lines are the kernel table as JSON (launches from
the path that runs the kernel: K1 and K2 the FAST path, K3 the Harris
path, K4 the cell-fused run, K5 the FAST path (K5 runs once per
extraction on every path but the cell-fused run); `init_path_launches`
those of phase 10, `reloc_path_launches` those of phase 12's checked run,
`loop_path_launches` those of phase 14's, `async_path_launches` those
of phase 16's, `cli_path_launches` those of phase 17's paced `run`,
`mesh_path_launches` those of phase 18's mesh-mode mapping run,
`example_path_launches` those of phase 19, `capacity_path_launches`
those of phase 20; `minmax_floor_ms` for the stencil kernels),
the card's name and power limit, and
{"ok": true, "device": ...}.
"""

import contextlib
import dataclasses
import io
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
# the mapping runs' correctness: the keyframe ATE after a Sim3 alignment
# (the monocular map's scale is its own) at most this share of the
# ground-truth path length; the init path initialised within INIT_WITHIN
# frames and tracking at least MIN_TRACKED_SHARE of the frames after
MAX_ATE_SHARE = 0.02
INIT_WITHIN = 10
MIN_TRACKED_SHARE = 0.9
# initialize_two_view on the card against the CPU, from the same matches
# and minimal sets: the largest |dR| and |dt| (unit t) allowed and the
# least share of rows whose is_triangulated agrees. The CPU readings of
# the port against JAX on a small-parallax pair: R 2.7e-6, t 3.7e-4
# (tests/test_torch_init_system.py): t is an f32 eigenvector of a Gram
# matrix and moves with the order of its sums
MAX_TWO_VIEW_DR = 1e-3
MAX_TWO_VIEW_DT = 1e-2
MIN_TRI_AGREE = 0.99
# the loop path: the JAX package's keyframe ATE on the same frames on the
# CPU (python -m tests.test_torch_loop_e2e jax 0: 0.848 just before its
# correction) just after it and at the end. The port's ATE just after the correction
# and at the end may be at most MAX_LOOP_ATE_RATIO of its ATE just before
# it: JAX's own correction reaches 0.649 of it on these frames (0.642 at
# the end), short of a half, because the drift is one jump at a seam and
# the essential graph spreads the loop's mismatch over the whole cycle,
# the seam's edges included (ROADMAP C14), so the port is held to the
# reference's ratio. Its ATE just after the correction may exceed JAX's by
# MAX_LOOP_AFTER_VS_JAX, which still lies below the map before the
# correction (0.800 on the card, 0.848 in JAX), and at the end by
# MAX_LOOP_ATE_VS_JAX. The card against the CPU on one loop pass: S12 (and
# the Sim3 solvers' s, R, t) and the essential graph's s, R, t, whose
# card-vs-CPU readings were 1.04e-4 (dense, K=256) and 1.39e-4 (PCG,
# K=1024, t of size ~4) on an NVIDIA H100 80GB HBM3: about twice the larger
JAX_LOOP_ATE_AFTER = 0.5509683756972411
JAX_LOOP_ATE = 0.5448967734480621
MAX_LOOP_ATE_RATIO = 0.65
MAX_LOOP_AFTER_VS_JAX = 1.1
MAX_LOOP_ATE_VS_JAX = 1.5
MAX_LOOP_DS12 = 1e-4
MAX_LOOP_DGRAPH = 3e-4
# the mesh phase (phase 18): the shards of its meshes (cuda:i modulo the
# visible cards), the frames after the saved keyframe it tracks and maps,
# the sizes of its sharded matching and RANSAC, and its bounds:
# tests/test_parallel.py's for a mesh against one device, whole BA (poses
# 5e-5, points 5e-4) and one integration (1e-4, 1e-3), with
# tests/test_torch_system_map.py's for the points seen by one or two
# keyframes, which a reordered sum moves along their rays (ROADMAP C7).
# Those bounds hold on maps of unit median depth, as the two-view
# initialisation scales them; phase 9's map is metric (points 4-12 m out),
# so distances are taken over its median depth, and rotations as they are.
# The LM stops a phase once a step gains under 1e-4 of the cost, a test
# that flips with the f32 order of the sums (phase 9's integration on the
# card and the CPU ran its second phase for 9 and 1 iterations), so the
# two BAs may stop at other iterations; their robust costs must then agree
# within that tolerance
MESH_SHARDS = 4
MESH_FRAMES = 16
MESH_MATCH_ROWS, MESH_MATCH_COLS, MESH_HYPOTHESES = 4096, 1000, 300
MESH_BA_POSE, MESH_BA_POINT, MESH_BA_COST = 5e-5, 5e-4, 1e-4
MESH_INTEGRATION_POSE, MESH_INTEGRATION_POINT = 1e-4, 1e-3
WEAK_POINT_DIFF = 1.5e-2
# phase 16 holds the async path to phase 14's loop checks
ASYNC_LOOP_GATED = True
# the CLI phase (phase 17): frames of the mapping trajectory, and the
# seconds between frames of its gated run. Phase 9's integrations on
# these frames take ~150 ms; unpaced, the run kept 15 keyframes in one
# call and 5 in another (PERF.md, PR 10)
CLI_FRAMES = 64
CLI_PACE = 0.5
# the example phase (phase 19): examples/run_synthetic_torch.py's 20
# frames; the keyframes it must reach, and its ATE (over every tracked
# frame, after a Sim3 alignment) over the 1.9 m path. The ATE of these 20
# frames at 320x240 jumps with the last bit of a pixel: the JAX package on
# the CPU reads 2.31% of the path on the example's frames (pixels
# truncated, as PIL saves them) and 5.39% on the same frames rounded; the
# port 2.85-4.09% on the CPU and 4.33% on the card (ROADMAP C19). So the
# bound is above both packages' readings, not the 2% of the longer paths
EXAMPLE_FRAMES = 20
MIN_EXAMPLE_KEYFRAMES = 3
MAX_EXAMPLE_ATE_SHARE = 0.06


def card_lines() -> list:
    """`nvidia-smi`'s name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def device_line() -> str:
    return card_lines()[0]


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


# K5's level tables (ROADMAP F8): the main path's and two other frame
# sizes and feature counts, (name, height, width, features)
K5_TABLES = (("640x480/1000", 480, 640, 1000), ("752x480/1000", 480, 752, 1000),
             ("1241x376/2000", 376, 1241, 2000))
# what the canvases hold outside each level's true size: the selection
# must never read it (K1 leaves it unwritten)
K5_OUTSIDE = 999.0


def k5_cells(selector):
    """(level, cell, y0, y1, x0, x1) of every cell of `selector`'s grids, in
    canvas pixels, cut to the level's true size."""
    b = selector.border
    out = []
    for l, ((h, w), (rows, cols, ch, cw)) in enumerate(zip(selector.shapes,
                                                           selector.grids)):
        for c in range(rows * cols):
            r, k = divmod(c, cols)
            y0, x0 = b + r * ch, b + k * cw
            out.append((l, c, y0, min(y0 + ch, h), x0, min(x0 + cw, w)))
    return out


def k5_skew_counts(selector, l):
    """Corner counts of level l's cells on the texture-skewed canvas: 45%
    empty, 45% one over the fair share (the first pass of the
    redistribution takes them), one cell at the quota of the second pass
    (which takes it), the rest richer than k_tot."""
    rows, cols = selector.grids[l][:2]
    n, quota = rows * cols, selector.quotas[l]
    fair = -(-quota // n)
    band = [c * 20 // n for c in range(n)]
    counts = [0 if b < 9 else fair + 1 if b < 18
              else selector.k_tots[l] + 40 * c for c, b in enumerate(band)]
    empty, low = counts.count(0), counts.count(fair + 1)
    if empty and empty + low < n:
        q1 = fair + -(-empty * fair // (n - empty))
        d1 = low * (q1 - fair - 1) if q1 > fair else 0
        q2 = fair + -(-d1 // max(n - empty - low, 1)) if d1 > 0 else q1
        if q2 > q1:
            counts[empty + low] = q2
    return counts


def k5_adversarial(selector, H, W, seed=0):
    """Masked score canvases [L, H, W] (numpy f32) that stress the
    selection, by name: all zero (a grey frame); one score on every level
    pixel (ties everywhere, so the pool and the final pick go by index,
    and every cell holds more candidates than k_tot); most cells with at
    most 3 scores above th_ini (the th_min fallback); texture-skewed cells
    (empty, barely above the fair share, or rich past k_tot with integer
    scores) that send the redistribution through several passes. All but
    the first hold K5_OUTSIDE outside each level's true size."""
    rng = np.random.default_rng(seed)
    L = len(selector.shapes)
    th_ini, th_min = selector.th_ini, selector.th_min
    outside = np.full((L, H, W), K5_OUTSIDE, np.float32)
    for l, (h, w) in enumerate(selector.shapes):
        outside[l, :h, :w] = 0.0
    ties = outside.copy()
    for l, (h, w) in enumerate(selector.shapes):
        ties[l, :h, :w] = th_ini + 11.0
    fallback, skewed = outside.copy(), outside.copy()
    for l, c, y0, y1, x0, x1 in k5_cells(selector):
        n_px = max(0, (y1 - y0) * (x1 - x0))
        if not n_px:
            continue
        at = lambda n: np.unravel_index(rng.choice(n_px, min(n, n_px),
                                                   replace=False),
                                        (y1 - y0, x1 - x0))
        # fallback: a few weak corners, 0-3 strong ones (4-9 in every
        # fifth cell, which keeps th_ini)
        ys, xs = at(n_px // 20)
        fallback[l, y0 + ys, x0 + xs] = rng.uniform(th_min - 2.0, th_ini,
                                                    len(ys)).astype(np.float32)
        ys, xs = at(int(rng.integers(4, 10)) if c % 5 == 4 else c % 4)
        fallback[l, y0 + ys, x0 + xs] = rng.uniform(th_ini, 90.0,
                                                    len(ys)).astype(np.float32)
        # skewed: cells in bands of corner counts
        ys, xs = at(k5_skew_counts(selector, l)[c])
        skewed[l, y0 + ys, x0 + xs] = rng.integers(
            int(th_ini) + 1, int(th_ini) + 60, len(ys)).astype(np.float32)
    return {"all zero": np.zeros((L, H, W), np.float32), "ties": ties,
            "th_min fallback": fallback, "texture-skewed": skewed}


def k5_cases(dev, tables=K5_TABLES):
    """(name, selector, masked canvas on dev) for every K5 check: for each
    of `tables` the main path's canvas after K1 on a rendered frame and
    k5_adversarial's canvases; at 640x480 also the Harris path's canvas
    after K3 and the Harris ranking."""
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
    from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
    from orb_slam_tpu_torch.ops.fast import harris_rank, harris_score_map
    from orb_slam_tpu_torch.ops.fast_score_nms import fast_score_nms
    from orb_slam_tpu_torch.ops.fast_score_rect import fast_score_nms_rect
    from orb_slam_tpu_torch.ops.fast_stack import build_pyramid_stack, level_masked

    cases = []
    for name, h, w, n in tables:
        scene = SyntheticScene(n_points=800, width=w, height=h, cx=w / 2,
                               cy=h / 2)
        img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1],
                                                  noise=2.0)).to(dev)
        ex = ORBExtractor(ORBConfig(n_features=n), h, w, device=dev)
        sel = ex.selector
        stack = build_pyramid_stack(img, ex.Rp, ex.Cp)
        cases.append((f"{name} main path (K1)", sel,
                      fast_score_nms(stack, sel.shapes, border=sel.border)))
        if (h, w) == (480, 640):
            score, keep = harris_rank(*fast_score_nms_rect(stack),
                                      harris_score_map(stack), sel.th_ini,
                                      sel.th_min)
            cases.append((f"{name} Harris path (K3, ranking)", sel,
                          level_masked(score, keep, sel)))
        for kind, canvas in k5_adversarial(sel, *stack.shape[1:]).items():
            cases.append((f"{name} {kind}", sel, torch.from_numpy(canvas).to(dev)))
    return cases


def k5_compare(selector, canvas):
    """K5 against the plain selector on one canvas: the names of the
    outputs (xy, score, valid) that differ bit for bit, and K5's launches."""
    from orb_slam_tpu_torch.ops import keypoint_select as k5

    before = k5.KERNEL.launches
    got = k5.keypoint_select(canvas, selector)
    launches = k5.KERNEL.launches - before
    want = selector.plain(canvas)
    torch.cuda.synchronize()
    bad = [name for name, a, b in zip(("xy", "score", "valid"), got, want)
           if not bits_equal(a, b)]
    return bad, launches


def check_k5(dev):
    """K5 bit-equal to the plain selector on every k5_cases canvas, one
    launch per selection; times on the 640x480 main path's canvas."""
    from orb_slam_tpu_torch.ops.keypoint_select import keypoint_select

    cases = k5_cases(dev)
    for name, sel, canvas in cases:
        bad, launches = k5_compare(sel, canvas)
        if bad or launches != 1:
            raise AssertionError(f"K5 on {name}: {bad} differ from plain, "
                                 f"{launches} launches")
    print(f"K5 keypoint_select: xy, score and valid bit-equal to plain on "
          f"{len(cases)} canvases: {', '.join(c[0] for c in cases)}")
    _, sel, canvas = cases[0]
    ms = cuda_ms(lambda: keypoint_select(canvas, sel))
    plain_ms = cuda_ms(lambda: sel.plain(canvas), reps=10)
    # the level pixels read once, the outputs (xy, score, valid) written once
    px = sum(h * w for h, w in sel.shapes)
    bound = bound_ms(4 * px + len(sel.shapes) * max(sel.quotas) * 13, 0)
    return 0.0, ms, plain_ms, bound, None


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


def restore(snap, frame, device):
    """(a SLAMSystem on `device` holding a state saved by system_state, the
    frame on `device`), and the keyframe database if one was saved."""
    from orb_slam_tpu_torch.convert import database_from_numpy
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
    if "db" in snap:
        s.vocab = snap["vocab"]
        s.db = database_from_numpy(s.vocab, snap["db"], device=device)
    fr = slam.FrameData(*(t.to(device) for t in (frame.xy, frame.desc, frame.octave,
                                                  frame.angle, frame.valid)),
                        frame.frame_id, frame.timestamp)
    return s, fr


def timed(fn, device):
    """(fn(), host-clock seconds), the device synchronized at both ends."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def integrate_from(snap, frame, obs, n_in, pose, device):
    """One _integrate_keyframe on `device` from a saved state; returns the
    system and the host-clock seconds it took."""
    s, fr = restore(snap, frame, device)
    _, dt = timed(lambda: s._integrate_keyframe(fr, obs.to(device), n_in, pose=pose),
                  device)
    return s, dt


def mapping_path(dev, card, kernels, scene):
    """Phase 9 (module docstring). Returns the K1/K2 launch counts."""
    from orb_slam_tpu_torch.io.synthetic import lateral_trajectory
    from orb_slam_tpu_torch.profile_paths import (
        MAPPING_STEP, MAPPING_YAW, ba_stage_split,
        keyframe_ate, keyframe_center_errors, mapping_system,
    )
    from orb_slam_tpu_torch.slam_map.observations import OBS_CAP
    from orb_slam_tpu_torch.solvers.local_ba import bundle_adjust
    from orb_slam_tpu_torch.utils.timing import StageTimer

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

    # the checked run: record each tracked frame's inliers (the keyframe
    # test reads them once per tracked frame), each integration's counts
    # and the state before the CHECK_KEYFRAME-th integration, with a host
    # clock on every stage
    inliers, counts, snap = [], [], {}
    need, integrate = s._need_new_keyframe, s._integrate_keyframe

    def recorded_need(frame_id, n_in):
        inliers.append(n_in)
        return need(frame_id, n_in)

    def recorded_integrate(frame, obs, n_in, pose=None, abort=None):
        if s.kf_counter == 2 + CHECK_KEYFRAME - 1 and not snap:
            snap.update(system_state(s), cfg=cfg, args=(
                frame, obs.clone(), n_in, np.array(pose)))
        slot = integrate(frame, obs, n_in, pose, abort)
        counts.append(dict(s.mapping_counts))
        return slot

    s._need_new_keyframe, s._integrate_keyframe = recorded_need, recorded_integrate
    timer = s._stage_timer = StageTimer()
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
    ate, scale, length, _ = keyframe_ate(s, poses)
    finite = (all(p is not None and np.isfinite(p).all() for p in out)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    print(f"mapping path: {len(out)} frames tracked, inliers min {min(inliers)} "
          f"median {int(np.median(inliers))}; {n_kf} keyframes inserted, "
          f"{len(fid)} live; {created} points triangulated, "
          f"{sum(c['culled'] for c in counts)} culled, "
          f"{sum(c['fuse_bound'] for c in counts)} features bound and "
          f"{sum(c['merged'] for c in counts)} points merged by fuse, "
          f"{sum(c['kf_culled'] for c in counts)} keyframes culled; "
          f"{int(m.pt_valid.sum())} points at the end; keyframe ATE after a Sim3 "
          f"alignment {ate:.5f} m (scale {scale:.5f}) on a {length:.4f} m path, "
          f"{ate / length:.5f} of it; keyframe centre error max {c_err.max():.4f} "
          f"mean {c_err.mean():.4f} (frames {sorted(fid.tolist())}; the recorded "
          f"baseline of this scene, PERF.md: 19 keyframes inserted, 17 live, centre "
          f"error max 0.0212 mean 0.0089); launches {launches}")
    if len(out) != N_FRAMES or len(inliers) != N_FRAMES or min(inliers) < MIN_INLIERS:
        raise AssertionError(f"mapping path: {len(out)} frames, inliers {inliers}")
    if n_kf < MIN_KEYFRAMES or created == 0:
        raise AssertionError(f"mapping path: {n_kf} keyframes, {created} points")
    if not ate <= MAX_ATE_SHARE * length:
        raise AssertionError(f"mapping path: keyframe ATE {ate:.5f} over "
                             f"{MAX_ATE_SHARE} of the {length:.4f} m path")
    # a guard on this one seeded scene, not a check of the path (ROADMAP C8)
    if c_err.max() > MAX_CENTER_ERR:
        raise AssertionError(f"mapping path: keyframe centre error {c_err.max():.4f}")
    if not finite:
        raise AssertionError("mapping path: non-finite output")
    expect_launches = {"K1": N_FRAMES, "K2": N_FRAMES, "K3": 0, "K4": 0,
                       "K5": N_FRAMES}
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
    # the stages alone: the program's spans nest around and inside them
    stage_s = {n: v for n, v in timer.times.items() if n in timer.stage_names}
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
    return launches, dict(snap=snap, args=(frame, obs, n_in, pose), system=s,
                          poses=poses, frames=frames)


def median_depth(state, kf):
    """The median depth of the live points in keyframe kf's camera: the
    map's scale (the two-view initialisation sets it to 1)."""
    T = state.kf_pose[kf]
    z = state.pt_pos[state.pt_valid] @ T[2, :3] + T[2, 3]
    return float(z[z > 0].median())


def ba_difference(a, b, n_obs, depth):
    """Two maps' differences on the scale of a map of unit median depth
    (distances over `depth`): (largest |d R| over the live keyframes,
    largest |d t|, largest |d point| over the points live in both and
    seen by >= 3 keyframes, over all of them, validity flips, share of
    kf_obs differing)."""
    kv = a.kf_valid & b.kf_valid
    pv = a.pt_valid & b.pt_valid
    dT = (a.kf_pose - b.kf_pose)[kv].abs()
    d = (a.pt_pos - b.pt_pos).abs().amax(1) / depth
    return (float(dT[:, :3, :3].max()), float(dT[:, :3, 3].max()) / depth,
            float(d[pv & (n_obs >= 3)].max()), float(d[pv].max()),
            int((a.pt_valid != b.pt_valid).sum()),
            float((a.kf_obs != b.kf_obs).float().mean()))


def ba_cost(state, K, pt_opt, outlier, scale_factor):
    """BA's robust cost (local_ba's LM metric) of `state` over the edges of
    the points pt_opt that BA kept as inliers."""
    from orb_slam_tpu_torch.solvers import local_ba

    obs_kf, _, _, uv, inv_s2, edge_on = local_ba._ba_inputs(state, pt_opt,
                                                            scale_factor)
    chi2, z = local_ba._edge_chi2(state.kf_pose, state.pt_pos, obs_kf, uv, K, inv_s2)
    return float(local_ba._robust_cost(chi2, z, edge_on & ~outlier))


def mesh_devices() -> list:
    """MESH_SHARDS entries cuda:i, i modulo the visible cards."""
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(MESH_SHARDS)]


def mesh_phase(dev, card, kernels, mapped, devices):
    """Phase 18 (module docstring) on a mesh of `devices`. Returns the
    K1..K4 launches of the mesh-mode mapping run."""
    from orb_slam_tpu_torch.ops.matching import hamming_matrix
    from orb_slam_tpu_torch.parallel import make_mesh
    from orb_slam_tpu_torch.parallel.sharding import (
        sharded_hamming_argmin, sharded_ransac_best,
    )
    from orb_slam_tpu_torch.profile_paths import keyframe_ate
    from orb_slam_tpu_torch.slam_map.observations import OBS_CAP, observation_table
    from orb_slam_tpu_torch.solvers import local_ba

    mesh = make_mesh(devices=devices, model_axis=1)        # BA: 4 x 1
    grid = make_mesh(devices=devices)                       # matching: 2 x 2
    distinct = len(set(devices))
    spread = (f"{len(devices)} shards on distinct devices {devices}"
              if distinct == len(devices) else
              f"{len(devices)} shards sharing {distinct} device(s) {sorted(set(map(str, devices)))}")
    print(f"mesh mode: {spread}; BA mesh {mesh.shape}, matching mesh "
          f"{grid.shape}; cards: {card_lines()}")

    # the reductions bundle_adjust makes, and over how many shards each
    reductions = []
    plain_psum = local_ba.psum

    def counted_psum(parts):
        reductions.append(len(parts))
        return plain_psum(parts)

    # BA with and without the mesh on phase 9's final map around its newest
    # keyframe: the points _local_mapping chooses, and those of them seen
    # by >= 3 keyframes; at the mapping path's shapes
    s = mapped["system"]
    m, cfg = s.map, s.cfg
    kf = s.last_kf_slot
    cam_opt, local_pts = s._local_ba_sets(m, kf, s._covisible_neighbors(m, kf)[2])
    n_obs = observation_table(m)[2].sum(1)
    depth = median_depth(m, kf)
    kw = dict(max_opt_cams=cfg.max_ba_cams, max_opt_pts=cfg.max_ba_points,
              scale_factor=cfg.map.scale_factor)
    failures = []
    for label, pt_opt in (("local points", local_pts),
                          ("seen by >= 3 keyframes", local_pts & (n_obs >= 3))):
        runs = {}
        reductions.clear()
        local_ba.psum = counted_psum
        try:
            for name, mm in (("single", None), ("mesh", mesh), ("again", mesh)):
                its = []
                runs[name] = local_ba.bundle_adjust(m, s.K_dev, cam_opt, pt_opt,
                                                    mesh=mm, iterations=its,
                                                    **kw) + (its,)
        finally:
            local_ba.psum = plain_psum
        (ss, so, st, si), (ms, mo, mt, mi), (rs, ro, _, _) = runs.values()
        dR, dt, seen3_d, all_d, _, _ = ba_difference(ms, ss, n_obs, depth)
        cost_s, cost_m = (ba_cost(x, s.K_dev, pt_opt, o, cfg.map.scale_factor)
                          for x, o in ((ss, so), (ms, mo)))
        cost_d = abs(cost_m - cost_s) / cost_s
        tables = torch.equal(mo, so) and all(torch.equal(a, b) for a, b in zip(mt, st))
        repeats = (torch.equal(ms.kf_pose, rs.kf_pose)
                   and torch.equal(ms.pt_pos, rs.pt_pos) and torch.equal(mo, ro))
        timing = ""
        if label == "local points":
            ms_single = event_ms(lambda: local_ba.bundle_adjust(
                m, s.K_dev, cam_opt, pt_opt, **kw))
            ms_mesh = event_ms(lambda: local_ba.bundle_adjust(
                m, s.K_dev, cam_opt, pt_opt, mesh=mesh, **kw))
            per_it = lambda ms, its: ms / sum(its[0])
            timing = (f"; CUDA events: one device {ms_single:.3f} ms, mesh "
                      f"{ms_mesh:.3f} ms ({ms_mesh / ms_single:.2f}x); per LM "
                      f"iteration {per_it(ms_single, si):.3f} / "
                      f"{per_it(ms_mesh, mi):.3f} ms "
                      f"({per_it(ms_mesh, mi) / per_it(ms_single, si):.2f}x)")
        print(f"mesh BA, {label} ({int(cam_opt.sum())} cameras, {int(pt_opt.sum())} "
              f"points; Kl {cfg.max_ba_cams}, Pl {cfg.max_ba_points}, OBS_CAP "
              f"{OBS_CAP}) against one device, over the median depth {depth:.3f}: "
              f"max |d R| {dR:.3g}, |d t| {dt:.3g}, |d point| {seen3_d:.3g} (seen by "
              f">= 3 keyframes), {all_d:.3g} (all); robust cost over the inlier "
              f"edges {cost_s:.6g} / {cost_m:.6g} (relative {cost_d:.3g}); outlier and "
              f"observation tables {'equal' if tables else 'DIFFERENT'}; LM "
              f"iterations {si} / {mi}; {len(reductions)} reductions over "
              f"{sorted(set(reductions))} shards; the mesh run repeated "
              f"{'bit for bit' if repeats else 'DIFFERENTLY'}{timing}; {card}")
        if not (max(dR, dt) <= MESH_BA_POSE and seen3_d <= MESH_BA_POINT
                and all_d <= WEAK_POINT_DIFF and cost_d <= MESH_BA_COST):
            failures.append(f"mesh BA, {label}: poses {dR} / {dt}, points {seen3_d}"
                            f" / {all_d}, cost {cost_d}")
        if not tables:
            failures.append(f"mesh BA, {label}: outlier or observation table differs")
        if not repeats:
            failures.append(f"mesh BA, {label}: a second run gave other bits")
        # 2 LM phases: per iteration 3 reductions of the solve and 2 of the
        # costs, over every shard in the mesh runs
        if (set(reductions) != {1, len(devices)}
                or reductions.count(len(devices)) < 5):
            failures.append(f"mesh BA, {label}: reductions {reductions}")

    # one keyframe integration from phase 9's saved state, mesh against one
    # device, in turns
    snap = mapped["snap"]
    frame, obs, n_in, pose = mapped["args"]
    mesh_snap = dict(snap, cfg=dataclasses.replace(snap["cfg"], mesh=mesh))
    out = {}
    for name in ("single", "mesh", "mesh", "single"):
        sys_, dt = integrate_from(mesh_snap if name == "mesh" else snap, frame, obs,
                                  n_in, pose, dev)
        out.setdefault(name, []).append((sys_, dt))
    a, b = out["single"][0][0], out["mesh"][0][0]
    n_obs = observation_table(a.map)[2].sum(1)
    depth = median_depth(a.map, a.last_kf_slot)
    dR, dt, seen3_d, all_d, flips, obs_d = ba_difference(b.map, a.map, n_obs, depth)
    same = torch.equal(out["mesh"][1][0].map.pt_pos, b.map.pt_pos)
    print(f"mesh integration of keyframe {CHECK_KEYFRAME} from phase 9's saved state "
          f"against one device, over the median depth {depth:.3f}: max |d R| "
          f"{dR:.3g}, |d t| {dt:.3g}, |d point| {seen3_d:.3g} (seen by >= 3 "
          f"keyframes), {all_d:.3g} (all), validity "
          f"flips {flips}, kf_obs differing {obs_d:.5f}; keyframes {a.kf_counter} / "
          f"{b.kf_counter}; the two mesh runs {'bit-equal' if same else 'DIFFERENT'}; "
          f"host ms, single {[round(dt * 1e3, 1) for _, dt in out['single']]}, mesh "
          f"{[round(dt * 1e3, 1) for _, dt in out['mesh']]}; {card}")
    if not (max(dR, dt) <= MESH_INTEGRATION_POSE and seen3_d <= MESH_INTEGRATION_POINT
            and all_d <= WEAK_POINT_DIFF and flips <= 2 and obs_d < 0.005
            and a.kf_counter == b.kf_counter and same):
        failures.append("mesh integration: outside test_parallel.py's bounds")

    # the mapping path in mesh mode: the same integration, then the next
    # frames one per chunk through process_batch, every BA on the mesh
    frames, poses = mapped["frames"], mapped["poses"]
    first = frame.frame_id + 1
    imgs = frames[first:first + MESH_FRAMES]
    r, fr = restore(mesh_snap, frame, dev)
    if r.cfg.mesh is not mesh:
        raise AssertionError("mesh mode: the restored system lost its mesh")
    reductions.clear()
    local_ba.psum = counted_psum
    try:
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        r._integrate_keyframe(fr, obs.to(dev), n_in, pose=pose)
        outs = r.process_batch(imgs, chunk_size=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        local_ba.psum = plain_psum
    ate, _, length, fid = keyframe_ate(r, poses)
    n_kf = r.kf_counter - b.kf_counter + 1
    finite = (all(p is not None and np.isfinite(p).all() for p in outs)
              and bool(torch.isfinite(r.map.kf_pose[r.map.kf_valid]).all())
              and bool(torch.isfinite(r.map.pt_pos[r.map.pt_valid]).all()))
    print(f"mesh mode mapping path: keyframe {CHECK_KEYFRAME}'s integration then "
          f"frames {first}-{first + len(imgs) - 1} one per chunk: {len(outs)} "
          f"tracked, {n_kf} keyframes integrated on the mesh ({len(r.ba_iterations)}"
          f" BA calls, {reductions.count(len(devices))} reductions over "
          f"{len(devices)} shards), keyframe ATE {ate:.5f} on a {length:.4f} m path "
          f"({ate / length:.5f} of it), {dt * 1e3 / len(imgs):.1f} ms/frame with the "
          f"integration; launches {launches}; {card}")
    if len(outs) != len(imgs) or not finite or not ate <= MAX_ATE_SHARE * length:
        failures.append(f"mesh mode mapping path: {len(outs)} frames, ATE {ate}")
    if (launches["K1"] != len(imgs) or launches["K2"] < len(imgs)
            or launches["K3"] or launches["K4"] or launches["K5"] != len(imgs)):
        failures.append(f"mesh mode mapping path: launches {launches}")
    if n_kf < 2 or reductions.count(len(devices)) < 5 * n_kf:
        failures.append(f"mesh mode mapping path: {n_kf} keyframes, reductions "
                        f"{reductions}")

    # sharded matching and RANSAC against their one-device answers
    g = torch.Generator(device=dev).manual_seed(18)
    words = lambda n: torch.randint(-2**31, 2**31 - 1, (n, 8), generator=g,
                                    device=dev, dtype=torch.int32)
    desc_p, desc_f = words(MESH_MATCH_ROWS), words(MESH_MATCH_COLS)
    best, dist = sharded_hamming_argmin(grid)(desc_p, desc_f)
    D = hamming_matrix(desc_p, desc_f)
    want_best = D.argmin(1)
    scores = torch.randint(0, 200, (MESH_HYPOTHESES,), generator=g, device=dev
                           ).to(torch.float32)
    s_best, i_best = sharded_ransac_best(grid)(scores)
    match_ok = (torch.equal(best.long(), want_best)
                and torch.equal(dist, D.gather(1, want_best[:, None])[:, 0]))
    ransac_ok = (float(s_best) == float(scores.max())
                 and int(i_best) == int(scores.argmax()))
    print(f"sharded_hamming_argmin [{MESH_MATCH_ROWS},8]x[{MESH_MATCH_COLS},8] on "
          f"{grid.shape}: {'equal to' if match_ok else 'DIFFERENT from'} one device; "
          f"sharded_ransac_best over {MESH_HYPOTHESES} hypotheses "
          f"({int((scores == scores.max()).sum())} at the maximum): "
          f"{'equal' if ransac_ok else 'DIFFERENT'}")
    if not (match_ok and ransac_ok):
        failures.append("sharded matching or RANSAC differs from one device")
    if failures:
        raise AssertionError("mesh mode: " + "; ".join(failures))
    return launches


def counting_extractions(extractors):
    """Wrap each extractor's forward to count its calls; returns the count
    as a one-item list."""
    count = [0]
    for ex in extractors:
        def counted(img, forward=ex.forward):
            count[0] += 1
            return forward(img)
        ex.forward = counted
    return count


def init_path(dev, card, kernels, scene):
    """Phase 10 (module docstring). Returns (K1..K4 launches of the run,
    the inputs of the successful initialize_two_view call)."""
    from orb_slam_tpu_torch.io.synthetic import lateral_trajectory
    from orb_slam_tpu_torch.pipeline import system as slam
    from orb_slam_tpu_torch.profile_paths import (
        MAPPING_STEP, MAPPING_YAW, init_system, keyframe_ate,
    )

    n = N_FRAMES + 2
    poses = lateral_trajectory(n, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses])).to(dev)
    s = init_system(scene, dev)
    # count the extractions (K1 runs once in each) and record the
    # two-view calls and the initialisation
    extractions = counting_extractions((s.extractor, s.extractor_init))
    calls, init = [], {}
    two_view = slam.initialize_two_view

    def recorded_two_view(x1, x2, valid, K, **kw):
        res = two_view(x1, x2, valid, K, **kw)
        calls.append(((x1.clone(), x2.clone(), valid.clone(), K, kw["idx"].clone()), res))
        return res

    try_init = s._try_initialize

    def recorded_init(frame):
        ok = try_init(frame)
        if ok:
            init.update(frame=frame.frame_id, points=s.ref_kf_tracked,
                        homography=bool(calls[-1][1].used_homography),
                        attempts=len(calls))
        return ok

    s._try_initialize = recorded_init
    slam.initialize_two_view = recorded_two_view
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    try:
        out = s.process_batch(frames)
    finally:
        slam.initialize_two_view = two_view
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {name: k.launches for name, k in kernels.items()}

    if not init or init["frame"] >= INIT_WITHIN:
        raise AssertionError(f"init path: not initialised within {INIT_WITHIN} "
                             f"frames ({init})")
    after = out[init["frame"] + 1:]
    tracked = sum(p is not None for p in after)
    n_kf = s.kf_counter
    ate, scale, length, fid = keyframe_ate(s, poses)
    m = s.map
    finite = (all(np.isfinite(p).all() for p in out if p is not None)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    print(f"init path: {n} raw frames 640x480 through process_batch at the default "
          f"chunk of {s.cfg.track_chunk_size}, ORBConfig() (2000 features until "
          f"WORKING), loop closing and relocalisation off: initialised at frame "
          f"{init['frame']} after {init['attempts']} two-view attempts "
          f"(used_homography {init['homography']}, {init['points']} points "
          f"triangulated); {tracked} of the {len(after)} frames after it tracked, "
          f"lost_count {s.lost_count}; {n_kf} keyframes inserted, {len(fid)} live, "
          f"{int(m.pt_valid.sum())} points; keyframe ATE after a Sim3 alignment "
          f"{ate:.5f} (scale {scale:.5f}) on a {length:.4f} m path, "
          f"{ate / length:.5f} of it; {extractions[0]} extractions; launches "
          f"{launches}; {run_s * 1e3 / n:.3f} ms/frame on {card}")
    if tracked < MIN_TRACKED_SHARE * len(after):
        raise AssertionError(f"init path: {tracked} of {len(after)} frames tracked")
    if n_kf < MIN_KEYFRAMES:
        raise AssertionError(f"init path: {n_kf} keyframes")
    if not ate <= MAX_ATE_SHARE * length:
        raise AssertionError(f"init path: keyframe ATE {ate:.5f} over "
                             f"{MAX_ATE_SHARE} of the {length:.4f} m path")
    if not finite:
        raise AssertionError("init path: non-finite output")
    # K1 once in every extraction (every frame once, and again each frame
    # a chunk extracted past a keyframe or a weak frame), K2 at least once
    # per tracked frame
    if (launches["K1"] != extractions[0] or extractions[0] < n
            or launches["K2"] < tracked or launches["K3"] or launches["K4"]
            or launches["K5"] != extractions[0]):
        raise AssertionError(f"init path: launches {launches}, {extractions[0]} "
                             f"extractions, {tracked} frames tracked")
    good = [c for c in calls if bool(c[1].success)]
    return launches, good[-1][0]


def event_ms(fn, reps=10):
    """Median CUDA-event ms of whole fn() calls after a warmup (the
    torch.linalg calls read their info on the host: no graph capture)."""
    fn()
    torch.cuda.synchronize()
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


def two_view_phases(args, card):
    """initialize_two_view on the init path's successful inputs: the card
    against the CPU on the same matches and minimal sets, then timed on
    the card (CUDA events around whole calls) with its torch.linalg
    parts split out: the 400 minimal fits (200 H, 200 F), the two rounds
    of refit and re-gate, and the 12-way _check_rt."""
    from orb_slam_tpu_torch.solvers import two_view as tv

    x1, x2, valid, K, idx = args
    card_res = tv.initialize_two_view(x1, x2, valid, K, idx=idx)
    cpu = torch.device("cpu")
    cpu_res = tv.initialize_two_view(*(a.to(cpu) for a in (x1, x2, valid, K)),
                                      idx=idx.to(cpu))
    dR = float((card_res.R21.cpu() - cpu_res.R21).abs().max())
    dt = float((card_res.t21.cpu() - cpu_res.t21).abs().max())
    agree = float((card_res.is_triangulated.cpu() == cpu_res.is_triangulated)
                  .float().mean())
    same = (bool(card_res.success) == bool(cpu_res.success)
            and bool(card_res.used_homography) == bool(cpu_res.used_homography))
    print(f"initialize_two_view card vs CPU ({x1.shape[0]} rows, "
          f"{int(valid.sum())} matches, the same 200 sets): success "
          f"{bool(card_res.success)}/{bool(cpu_res.success)}, used_homography "
          f"{bool(card_res.used_homography)}/{bool(cpu_res.used_homography)}, "
          f"max |dR| {dR:.3g}, max |dt| {dt:.3g}, is_triangulated agrees on "
          f"{agree:.5f} of the rows, n_good {int(card_res.n_good)}/"
          f"{int(cpu_res.n_good)}")
    if not (same and dR <= MAX_TWO_VIEW_DR and dt <= MAX_TWO_VIEW_DT
            and agree >= MIN_TRI_AGREE):
        raise AssertionError("initialize_two_view: the card and the CPU disagree")

    n1, T1 = tv._normalize_points(x1, valid)
    n2, T2 = tv._normalize_points(x2, valid)
    inF = inH = valid

    def fits():
        return tv._dlt_h(n1[idx], n2[idx]), tv._dlt_f(n1[idx], n2[idx])

    def refits():
        for _ in range(2):
            F = T2.T @ tv._refit_f(n1, n2, inF.float()) @ T1
            tv._score_f(F, x1, x2, valid)
            H = tv._inv(T2) @ tv._refit_h(n1, n2, inH.float()) @ T1
            tv._score_h(H, x1, x2, valid)

    Rs, ts = card_res.R21.expand(12, 3, 3), card_res.t21.expand(12, 3)
    inl = valid.expand(12, -1)
    ms = {"whole call": event_ms(lambda: tv.initialize_two_view(x1, x2, valid, K,
                                                                idx=idx)),
          "400 minimal fits (SVD)": event_ms(fits),
          "2 refits and re-gates (eigh, SVD, inv)": event_ms(refits),
          "12-way _check_rt (eigh per point)": event_ms(
              lambda: tv._check_rt(Rs, ts, x1, x2, K, inl))}
    print(f"initialize_two_view timing at {x1.shape[0]} rows (CUDA events around "
          f"whole calls, medians of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; the three parts {sum(list(ms.values())[1:]) / ms['whole call']:.3f} "
          f"of the whole; {card}")
    return ms


def database_state(db):
    """A host copy of a keyframe database's rows and active flags."""
    return dict(bow_ids=db.bow_ids.cpu().numpy(), bow_w=db.bow_w.cpu().numpy(),
                active=db.active.copy())


def relocalize_from(snap, sets, device):
    """One _relocalize of the saved frame on `device` from a saved state,
    drawing the given minimal sets; returns (accepted, last_pose, n_relocs,
    host-clock seconds)."""
    s, fr = restore(snap, snap["frame"], device)
    queue = [idx.to(device) for idx in sets]
    s._reloc_sets = lambda valid: queue.pop(0)
    ok, dt = timed(lambda: s._relocalize(fr), device)
    return ok, s.last_pose.copy(), s.n_relocs, dt


def split_line(split, skip=6):
    """'stage a/b/... ms, ...' of a relocalize_split or loop_split record,
    one time per run of the stage, each name without its first `skip`
    characters ("reloc ", "loop ")."""
    return ", ".join(f"{k[skip:]} " + "/".join(f"{v * 1e3:.3f}" for v in vs) + " ms"
                     for k, vs in split.items())


def reloc_phase(dev, card, kernels, scene):
    """Phase 12 (module docstring). Returns (K1..K4 launches of the checked
    run, what phase 13 reuses: the system, the successful call's record,
    its saved state and its last EPnP inputs)."""
    from orb_slam_tpu_torch import profile_paths as pp
    from orb_slam_tpu_torch.pipeline import system as slam
    from orb_slam_tpu_torch.utils.timing import StageTimer

    s = pp.reloc_system(scene, dev)
    extractions = counting_extractions((s.extractor, s.extractor_init))
    # per _relocalize call: K2 launches inside it and the state before it;
    # every epnp_ransac call's inputs
    per_call, epnp_calls = [], []
    relocalize = s._relocalize

    def watched(frame):
        snap = dict(system_state(s), cfg=s.cfg, vocab=s.vocab,
                    db=database_state(s.db), frame=frame)
        k2 = kernels["K2"].launches
        n_epnp = len(epnp_calls)
        ok = relocalize(frame)
        per_call.append(dict(k2=kernels["K2"].launches - k2,
                             epnp=len(epnp_calls) - n_epnp, snap=snap if ok else None))
        return ok

    ransac = slam.epnp_ransac

    def recorded_ransac(pw, uv, valid, inv_s2, K, **kw):
        epnp_calls.append((pw.clone(), uv.clone(), valid.clone(), inv_s2.clone(), K,
                           kw["idx"].clone()))
        return ransac(pw, uv, valid, inv_s2, K, **kw)

    s._relocalize = watched
    stages = {}
    s._stage_timer = StageTimer(times=stages)
    slam.epnp_ransac = recorded_ransac
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    try:
        r = pp.reloc_path(scene, dev, system=s)
    finally:
        slam.epnp_ransac = ransac
    launches = {name: k.launches for name, k in kernels.items()}

    calls, gt, rev = r["calls"], r["gt"], r["revisit"]
    for c, w in zip(calls, per_call):
        c.update(w)
    rmse, align, length = pp.reloc_alignment(s, gt)
    first_fid = pp.RELOC_MAPPED + pp.RELOC_BLACKOUT
    good = [c for c in calls if c["ok"]]
    ok_call = good[0] if good else None
    reloc_i = None if ok_call is None else ok_call["frame_id"] - first_fid
    err = float("nan")
    if reloc_i is not None and 0 <= reloc_i < len(rev) and rev[reloc_i] is not None:
        err = pp.aligned_centre_error(align, gt, rev[reloc_i], ok_call["frame_id"])
    ab = r["after_blackout"]
    m = s.map
    outs = [p for p in r["mapped"] + r["revisit"] if p is not None]
    finite = (all(np.isfinite(p).all() for p in outs)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    blank = [c for c in calls if c["frame_id"] < first_fid]
    print(f"reloc path: {r['n_frames']} raw frames 640x480 through process_batch at "
          f"chunk {s.cfg.track_chunk_size} (frames 0-{pp.RELOC_MAPPED - 1} of "
          f"lateral_trajectory(step={pp.MAPPING_STEP}, yaw_rate={pp.MAPPING_YAW}), "
          f"{pp.RELOC_BLACKOUT} uniform-gray frames, poses {pp.RELOC_REVISIT[0]}-"
          f"{pp.RELOC_REVISIT[1] - 1} again), ORBConfig(), MapConfig(), bow_slots "
          f"{s.cfg.bow_slots}, the shipped {s.vocab.n_words}-word vocabulary: "
          f"{sum(p is not None for p in r['mapped'])} of {len(r['mapped'])} mapped "
          f"frames tracked; after the blackout {slam.STATE_NAMES[ab['state']]} with "
          f"{ab['n_keyframes']} keyframes, lost_count {ab['lost_count']}; "
          f"{len(calls)} _relocalize calls ({len(blank)} on blank frames), n_relocs "
          f"{s.n_relocs}, relocalised at revisit frame {reloc_i}, its aligned centre "
          f"{err:.5f} m off ({err / length:.5f} of the {length:.4f} m mapped path); "
          f"{sum(p is not None for p in rev)} of {len(rev)} revisit frames tracked; "
          f"{s.kf_counter} keyframes inserted, {s.n_keyframes} live; keyframe ATE "
          f"{rmse:.5f} ({rmse / length:.5f} of the path); {extractions[0]} "
          f"extractions; launches {launches}; per call (frame, ok, EPnP calls, K2): "
          f"{[(c['frame_id'], c['ok'], c['epnp'], c['k2']) for c in calls]}; "
          f"{r['seconds'] * 1e3 / r['n_frames']:.3f} ms/frame with the stage clock on; "
          f"{card}")
    if ab["state"] != slam.LOST or ab["n_keyframes"] <= 5:
        raise AssertionError(f"reloc path: after the blackout {ab}")
    if reloc_i is None or not 0 <= reloc_i < 3 or s.n_relocs < 1:
        raise AssertionError(f"reloc path: not relocalised within 3 revisit frames "
                             f"({reloc_i}, n_relocs {s.n_relocs})")
    if not err <= MAX_ATE_SHARE * length:
        raise AssertionError(f"reloc path: relocalised centre {err} m off")
    if any(p is None for p in rev[reloc_i + 1:]) or not rmse <= MAX_ATE_SHARE * length:
        raise AssertionError(f"reloc path: revisit frames lost or keyframe ATE {rmse}")
    if not finite:
        raise AssertionError("reloc path: non-finite output")
    if (launches["K1"] != extractions[0] or launches["K3"] or launches["K4"]
            or launches["K5"] != extractions[0]
            or any(c["epnp"] and c["k2"] < 1 for c in calls)):
        raise AssertionError(f"reloc path: launches {launches}, {extractions[0]} "
                             f"extractions")
    print(f"_relocalize split, the successful call (frame {ok_call['frame_id']}; ms per "
          f"stage, each candidate tried): {split_line(ok_call['split'])}; {card}")
    if blank:
        print(f"_relocalize split, a failed call on a blank frame (frame "
              f"{blank[0]['frame_id']}): {split_line(blank[0]['split'])}; {card}")
    n_kf = len(stages.get("BoW add", []))
    if n_kf:
        print(f"BoW add (transform, bow_vector, database add): "
              f"{sum(stages['BoW add']) * 1e3 / n_kf:.3f} ms per keyframe integration "
              f"over {n_kf} integrations; {card}")

    # the path again without recording or stage clock, for ms/frame
    t = pp.reloc_path(scene, dev, record=False)
    print(f"reloc path timing: {t['seconds'] * 1e3 / t['n_frames']:.3f} ms/frame "
          f"without the stage clock; n_relocs {t['system'].n_relocs}, first revisit "
          f"frame tracked "
          f"{next((i for i, p in enumerate(t['revisit']) if p is not None), None)}; "
          f"{card}")
    epnp_inputs = epnp_calls[sum(c["epnp"] for c in calls[:calls.index(ok_call) + 1]) - 1]
    return launches, s, ok_call, epnp_inputs


def place_phases(dev, card, s, ok_call, epnp_inputs):
    """Phase 13 (module docstring)."""
    from orb_slam_tpu_torch.convert import database_from_numpy
    from orb_slam_tpu_torch.place import KeyFrameDatabase
    from orb_slam_tpu_torch.place.vocabulary import bow_vector, l1_score, transform
    from orb_slam_tpu_torch.profile_paths import synthetic_tree
    from orb_slam_tpu_torch.slam_map.covisibility import covisibility_weights
    from orb_slam_tpu_torch.solvers import epnp
    from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize

    cpu = torch.device("cpu")
    frame = ok_call["snap"]["frame"]
    desc, valid = frame.desc, frame.valid
    W = s.cfg.bow_slots

    # transform + bow_vector, card against CPU, on two trees
    for name, voc in (("shipped", s.vocab), ("synthetic k=10 L=6", synthetic_tree(10, 6))):
        def bow(d, v, voc=voc):
            words, nodes = transform(voc, d, v)
            ids, w = bow_vector(words, voc.device_arrays(d.device)[3], n_slots=W)
            return words, nodes, ids, w

        g = bow(desc, valid)
        c = bow(desc.cpu(), valid.cpu())
        same = all(torch.equal(a.cpu(), b) for a, b in zip(g[:3], c[:3]))
        dw = float((g[3].cpu() - c[3]).abs().max())
        ms = event_ms(lambda: bow(desc, valid))
        t_only = event_ms(lambda: transform(voc, desc, valid))
        print(f"transform + bow_vector, {name} tree ({len(voc.node_desc)} nodes, "
              f"{voc.n_words} words, {voc.node_desc.nbytes / 1e6:.1f} MB of node "
              f"descriptors), {int(valid.sum())} of {len(valid)} descriptors: "
              f"{ms:.3f} ms ({t_only:.3f} ms transform alone; CUDA events, median "
              f"of 10); card vs CPU: words, nodes and ids "
              f"{'equal' if same else 'DIFFERENT'}, weights within {dw:.3g}; {card}")
        if not same or dw > 1e-6:
            raise AssertionError(f"transform/bow_vector on the {name} tree: the card "
                                 f"and the CPU disagree")

    # scores against every row of a 256-keyframe database
    live = np.where(s.db.active)[0]
    db = KeyFrameDatabase(s.vocab, 256, W, device=dev)
    for row in range(256):
        src = int(live[row % len(live)])
        db.add(row, s.db.bow_ids[src], s.db.bow_w[src])
    ids, w, _ = db.compute_bow(desc, valid)
    sc_card = l1_score(ids, w, db.bow_ids, db.bow_w)
    sc_cpu = l1_score(ids.cpu(), w.cpu(), db.bow_ids.cpu(), db.bow_w.cpu())
    d_sc = float((sc_card.cpu() - sc_cpu).abs().max())
    ms_dev = event_ms(lambda: l1_score(ids, w, db.bow_ids, db.bow_w))
    ms_host = event_ms(lambda: db.scores_against_all(ids, w))
    Wc = covisibility_weights(s.map).cpu().numpy()
    cands, acc, cut = s.db.relocalisation_scores(ids, w, Wc)
    db_cpu = database_from_numpy(s.vocab, database_state(s.db), device=cpu)
    cands_cpu = db_cpu.detect_relocalisation_candidates(ids.cpu(), w.cpu(), Wc)
    margin = min((abs(a - cut) for a in acc.values()), default=float("nan"))
    print(f"scores_against_all at K=256, W={W}: {ms_dev:.3f} ms on the device "
          f"(l1_score, one batched searchsorted), {ms_host:.3f} ms with the copy to "
          f"the host; card vs CPU within {d_sc:.3g}; the relocalised frame's "
          f"candidates {[int(c) for c in cands]} (CPU {[int(c) for c in cands_cpu]}), "
          f"nearest accumulated score {margin:.4g} from the 0.75 cut {cut:.4g}; "
          f"{card}")
    if d_sc > 1e-6 or [int(c) for c in cands] != [int(c) for c in cands_cpu]:
        raise AssertionError("database scores or candidates: card and CPU disagree")

    # EPnP RANSAC on the successful call's last inputs and sets
    pw, uv, ok, inv_s2, K, idx = epnp_inputs

    def counts(args, sets):
        p_, u_, v_, i_, K_ = args
        Rs, ts = epnp.epnp_solve(p_[sets], u_[sets], K_)
        err = epnp._reproj_err(Rs, ts, p_, u_, K_[0, 0], K_[1, 1], K_[0, 2], K_[1, 2])
        return (v_ & (err * i_ < 5.991)).sum(-1)

    res = []
    for d in (dev, cpu):
        args = [a.to(d) for a in (pw, uv, ok, inv_s2, K)]
        R, t_, inl, n = epnp.epnp_ransac(*args, idx=idx.to(d))
        T0 = torch.eye(4, device=d)
        T0[:3, :3], T0[:3, 3] = R, t_
        T_ref = pose_optimize(T0, args[0], args[1], args[3], inl, args[4])[0]
        res.append((R.cpu(), t_.cpu(), inl.cpu(), int(n), T_ref.cpu(),
                    int(torch.argmax(counts(args, idx.to(d))))))
    g, c = res
    agree = float((g[2] == c[2]).float().mean())
    d_raw = float(max((g[0] - c[0]).abs().max(), (g[1] - c[1]).abs().max()))
    d_ref = float((g[4] - c[4]).abs().max())
    args = [pw, uv, ok, inv_s2, K]
    ms = event_ms(lambda: epnp.epnp_ransac(*args, idx=idx))
    print(f"epnp_ransac at {len(pw)} rows ({int(ok.sum())} valid), {len(idx)} "
          f"hypotheses of {idx.shape[1]}: {ms:.3f} ms (CUDA events, median of 10); "
          f"card vs CPU on the same sets: best hypothesis {g[5]}/{c[5]}, inliers "
          f"{g[3]}/{c[3]}, inlier flags equal on {agree:.5f} of rows, max |d pose| "
          f"{d_raw:.3g} as drawn and {d_ref:.3g} after pose_optimize on the inliers; "
          f"{card}")
    if (abs(g[3] - c[3]) > 0.01 * c[3] or agree < 0.99
            or not d_ref <= MAX_CARD_CPU_POSE_DIFF):
        raise AssertionError("epnp_ransac: the card and the CPU disagree")

    # one _relocalize from the saved state, card and CPU, the same sets
    snap = ok_call["snap"]
    ok_g, T_g, n_g, s_g = relocalize_from(snap, ok_call["sets"], dev)
    ok_c, T_c, n_c, s_c = relocalize_from(snap, ok_call["sets"], cpu)
    d_T = float(np.abs(T_g - T_c).max())
    print(f"card vs CPU, one _relocalize from the saved state of frame "
          f"{frame.frame_id} with the same sets: accepted {ok_g}/{ok_c}, n_relocs "
          f"{n_g}/{n_c}, max |d pose| {d_T:.3g}; {s_g * 1e3:.1f} ms on the card "
          f"({card}), {s_c * 1e3:.1f} ms on the CPU")
    if ok_g != ok_c or not ok_g or not d_T <= MAX_CARD_CPU_POSE_DIFF:
        raise AssertionError("_relocalize: the card and the CPU disagree")


def to_device(x, d):
    """x with every tensor on device d (MapStates, lists, tuples and dicts
    taken apart)."""
    from orb_slam_tpu_torch.slam_map.map_state import MapState

    if torch.is_tensor(x):
        return x.to(d)
    if isinstance(x, MapState):
        return x.replace(**{f.name: getattr(x, f.name).to(d)
                            for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, d) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, d) for k, v in x.items()}
    return x


# the loop closer's device calls whose inputs phase 14 records from the
# accepted pass, for phase 15
LOOP_CALLS = ("sim3_ransac", "optimize_sim3", "search_by_sim3",
              "project_loop_points", "fuse_points_into_keyframes",
              "optimize_essential_graph")


@contextlib.contextmanager
def recording_loop_calls(record):
    """Inside it, the inputs of each LOOP_CALLS call of the loop closer go
    into `record` (a dict, by name)."""
    from orb_slam_tpu_torch.pipeline import loop_closing as lc

    saved = {name: getattr(lc, name) for name in LOOP_CALLS}
    for name, fn in saved.items():
        def recorded(*a, name=name, fn=fn, **kw):
            record[name] = (a, kw)
            return fn(*a, **kw)
        setattr(lc, name, recorded)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lc, name, fn)


@contextlib.contextmanager
def essential_graph_off():
    """Inside it, the loop closer's essential graph returns its base
    vertices unchanged: the correction moves only the new keyframe's
    group (the control of phase 14)."""
    from orb_slam_tpu_torch.pipeline import loop_closing as lc

    saved = lc.optimize_essential_graph
    lc.optimize_essential_graph = lambda base_s, base_R, base_t, *a, **kw: (
        base_s, base_R, base_t)
    try:
        yield
    finally:
        lc.optimize_essential_graph = saved


def loop_ate_failures(before, after, end=None):
    """The ATE checks of phase 14 that a loop correction fails, from the
    keyframe ATE just before it, just after it and (if given) at the end
    of the path: a list of descriptions, empty if all hold."""
    failed = []
    if not after <= MAX_LOOP_ATE_RATIO * before:
        failed.append(f"{after:.5f} after the correction over {MAX_LOOP_ATE_RATIO} x "
                      f"{before:.5f} before it")
    if not after <= MAX_LOOP_AFTER_VS_JAX * JAX_LOOP_ATE_AFTER:
        failed.append(f"{after:.5f} after the correction over {MAX_LOOP_AFTER_VS_JAX} x "
                      f"JAX's {JAX_LOOP_ATE_AFTER:.5f}")
    if end is not None and not end <= MAX_LOOP_ATE_RATIO * before:
        failed.append(f"{end:.5f} at the end over {MAX_LOOP_ATE_RATIO} x {before:.5f} "
                      f"before the correction")
    if end is not None and not end <= MAX_LOOP_ATE_VS_JAX * JAX_LOOP_ATE:
        failed.append(f"{end:.5f} at the end over {MAX_LOOP_ATE_VS_JAX} x JAX's "
                      f"{JAX_LOOP_ATE:.5f}")
    return failed


def loop_phase(dev, card, kernels):
    """Phase 14 (module docstring). Returns (K1..K4 launches of the checked
    run, the accepted closure's record, the inputs of its device calls,
    the sequential readings phase 16 compares with: ms/frame of the timing
    run, keyframes, loops closed, keyframe ATE before and after the
    correction and at the end)."""
    from orb_slam_tpu_torch import profile_paths as pp

    scene = pp.loop_scene()
    s = pp.loop_system(scene, dev)
    extractions = counting_extractions((s.extractor, s.extractor_init))
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    r = pp.loop_path(scene, dev, system=s)
    launches = {name: k.launches for name, k in kernels.items()}

    out, poses, closures = r["out"], r["poses"], r["closures"]
    first = next((i for i, p in enumerate(out) if p is not None), len(out))
    tracked = sum(p is not None for p in out[first:])
    n_after = len(out) - first
    ate, scale, length, _ = pp.keyframe_ate(s, poses)
    fid = s.map.kf_frame_id.cpu().numpy()
    c = closures[0] if closures else None
    m = s.map
    finite = (all(np.isfinite(p).all() for p in out if p is not None)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    print(f"loop path: {len(out)} raw frames 640x480 through process_batch at chunk "
          f"{s.cfg.track_chunk_size} ({pp.LOOP_SCENE_TEXT}), the SlamConfig defaults "
          f"(loop closing and relocalisation on, the shipped vocabulary), the drift "
          f"{pp.LOOP_DRIFT} (scale, translation) after the first keyframe at or past "
          f"frame {pp.LOOP_DRIFT_AT}: "
          f"{pp.loop_summary(r)}; {extractions[0]} extractions; launches {launches}; "
          f"{card}")
    if first >= INIT_WITHIN:
        raise AssertionError(f"loop path: WORKING at frame {first}")
    if tracked < MIN_TRACKED_SHARE * n_after:
        raise AssertionError(f"loop path: {tracked} of {n_after} frames tracked")
    if s.n_loops_closed < 1 or c is None:
        raise AssertionError("loop path: no loop closed")
    if not fid[c["cand"]] < pp.LOOP_CAND_BEFORE:
        raise AssertionError(f"loop path: the loop keyframe's frame {fid[c['cand']]} is "
                             f"not among the first {pp.LOOP_CAND_BEFORE}")
    failed = loop_ate_failures(c["ate_before"], c["ate_after"], ate)
    if failed:
        raise AssertionError(f"loop path: keyframe ATE {failed}")
    if not finite:
        raise AssertionError("loop path: non-finite output")
    if (launches["K1"] != extractions[0] or launches["K2"] < tracked
            or launches["K3"] or launches["K4"] or launches["K5"] != extractions[0]):
        raise AssertionError(f"loop path: launches {launches}, {extractions[0]} "
                             f"extractions, {tracked} frames tracked")
    closing = next(p for p in r["passes"] if p["frame_id"] == c["frame_id"])
    print(f"loop closing split, the accepted pass (frame {c['frame_id']}, keyframe "
          f"{c['new_kf']} to {c['cand']}; ms per stage, each candidate tried): "
          f"{split_line(closing['split'], 5)}; {card}")
    plain = [p for p in r["passes"] if list(p["split"]) == ["loop detect"]]
    if plain:
        print(f"loop closing split, a detect with no candidate (frame "
              f"{plain[-1]['frame_id']}): {split_line(plain[-1]['split'], 5)}; "
              f"{len(plain)} of {len(r['passes'])} passes stopped there; {card}")
    print(f"loop correction: n_loops_closed {s.n_loops_closed}, group of "
          f"{c['group']} keyframes, {c['merged']} points merged by the fuse, "
          f"{c['loop_connections']} loop connections, {c['edges']} edges in the "
          f"essential graph ({c['solver']}); {card}")

    # the accepted pass again from its saved state, card and CPU
    record = {}
    s_g, hit_g, sec_g = pp.loop_replay(c, dev, within=recording_loop_calls(record))
    s_c, hit_c, sec_c = pp.loop_replay(c, torch.device("cpu"))
    m_g, m_c = s_g.map, s_c.map
    live = m_c.kf_valid
    dS = max(float((a - b).abs().max()) for a, b in zip(hit_g["S12"], hit_c["S12"]))
    dT = float((m_g.kf_pose.cpu()[live] - m_c.kf_pose[live]).abs().max())
    print(f"card vs CPU, the accepted loop-closing pass from its saved state with "
          f"the same sets: n_loops_closed {s_g.n_loops_closed}/{s_c.n_loops_closed}, "
          f"candidate {hit_g.get('cand')}/{hit_c.get('cand')}, max |d S12| {dS:.3g}, "
          f"max |d pose| {dT:.3g} over {int(live.sum())} keyframes; keyframe ATE "
          f"after it {pp.keyframe_ate(s_g, poses)[0]:.5f} on the card (the path's "
          f"{c['ate_after']:.5f}); {sec_g * 1e3:.1f} ms on the card ({card}), "
          f"{sec_c * 1e3:.1f} ms on the CPU")
    if (s_g.n_loops_closed != s_c.n_loops_closed or hit_g.get("cand") != hit_c.get("cand")
            or not dS <= MAX_LOOP_DS12 or not dT <= MAX_CARD_CPU_POSE_DIFF):
        raise AssertionError("loop closing pass: the card and the CPU disagree")

    # the control: the same pass with the essential graph a no-op must
    # fail the ATE checks
    with essential_graph_off():
        s_n, _, _ = pp.loop_replay(c, dev)
    ate_n = pp.keyframe_ate(s_n, poses)[0]
    failed = loop_ate_failures(c["ate_before"], ate_n)
    print(f"control, the accepted pass with the essential graph a no-op (the new "
          f"keyframe's group of {c['group']} corrected alone): keyframe ATE "
          f"{c['ate_before']:.5f} -> {ate_n:.5f}; fails the checks: {failed or 'none'}; "
          f"{card}")
    if not failed:
        raise AssertionError("loop path: the ATE checks pass a map whose essential "
                             "graph did nothing")

    # the path again without recording or stage clock, for ms/frame
    t = pp.loop_path(scene, dev, record=False)
    seq_ms = t["seconds"] * 1e3 / t["n_frames"]
    print(f"loop path timing: {seq_ms:.3f} ms/frame "
          f"without the stage clock; n_loops_closed {t['system'].n_loops_closed}; "
          f"{card}")
    seq = dict(ms=seq_ms, keyframes=s.kf_counter, loops=s.n_loops_closed, ate=ate,
               ate_before=c["ate_before"], ate_after=c["ate_after"])
    return launches, c, record, seq


def loop_timings(dev, card, record):
    """Phase 15 (module docstring): the loop closer's device calls on the
    accepted pass's inputs and a PCG pose graph at K = 1024, each timed on
    the card (CUDA events around whole calls) and held against the CPU."""
    from orb_slam_tpu_torch import profile_paths as pp
    from orb_slam_tpu_torch.pipeline import loop_closing as lc

    cpu = torch.device("cpu")

    def both(name, args=None, kw=None, reps=10):
        a, k = record[name] if args is None else (args, kw or {})
        fn = getattr(lc, name)
        g = fn(*to_device(a, dev), **to_device(k, dev))
        t = time.perf_counter()
        c = fn(*to_device(a, cpu), **to_device(k, cpu))
        cpu_ms = (time.perf_counter() - t) * 1e3
        ms = event_ms(lambda: fn(*to_device(a, dev), **to_device(k, dev)), reps)
        return g, c, ms, cpu_ms

    def d(x, y):
        return float((x.cpu().double() - y.double()).abs().max())

    lines, bad = [], []
    g, c, ms, cpu_ms = both("sim3_ransac")
    rows = record["sim3_ransac"][0][0].shape[0]
    sets = record["sim3_ransac"][1]["idx"].shape[0]
    dsrt = max(d(x, y) for x, y in zip(g[:3], c[:3]))
    agree = float((g[3].cpu() == c[3]).float().mean())
    lines.append(f"sim3_ransac at {rows} rows x {sets} sets: {ms:.3f} ms (CPU {cpu_ms:.1f} "
                 f"ms); card vs CPU: max |d s, R, t| {dsrt:.3g}, inliers {int(g[4])}/"
                 f"{int(c[4])}, flags equal on {agree:.5f}")
    bad += [] if dsrt <= MAX_LOOP_DS12 and agree >= 0.995 else ["sim3_ransac"]
    g, c, ms, cpu_ms = both("optimize_sim3")
    dsrt = max(d(x, y) for x, y in zip(g[:3], c[:3]))
    lines.append(f"optimize_sim3 at {rows} rows: {ms:.3f} ms (CPU {cpu_ms:.1f} ms); card "
                 f"vs CPU: max |d s, R, t| {dsrt:.3g}, inliers {int(g[4])}/{int(c[4])}")
    bad += [] if dsrt <= MAX_LOOP_DS12 and abs(int(g[4]) - int(c[4])) <= 0.01 * int(c[4]) + 1 \
        else ["optimize_sim3"]
    for name in ("search_by_sim3", "project_loop_points"):
        g, c, ms, cpu_ms = both(name)
        agree = float((g[1].cpu() == c[1]).float().mean())
        lines.append(f"{name}: {ms:.3f} ms (CPU {cpu_ms:.1f} ms); card vs CPU: "
                     f"{int(g[1].sum())}/{int(c[1].sum())} matches, flags equal on "
                     f"{agree:.5f} of {g[1].shape[0]} features")
        bad += [] if agree >= 0.99 else [name]
    g, c, ms, cpu_ms = both("fuse_points_into_keyframes", reps=3)
    a = record["fuse_points_into_keyframes"][0]
    P = a[0].pt_valid.shape[0]
    n_dst = sum(int(x) >= 0 for x in a[2])
    obs_agree = float((g[0].kf_obs.cpu() == c[0].kf_obs).float().mean())
    merged = [int((r.cpu() != torch.arange(P)).sum()) for r in (g[1], c[1])]
    lines.append(f"fuse_points_into_keyframes at P={P} into {n_dst} keyframes: "
                 f"{ms:.3f} ms (CPU {cpu_ms:.1f} ms); card vs CPU: kf_obs equal on "
                 f"{obs_agree:.6f}, points remapped {merged[0]}/{merged[1]}")
    bad += [] if obs_agree >= 0.999 and abs(merged[0] - merged[1]) <= 2 else ["fuse"]
    g, c, ms, cpu_ms = both("optimize_essential_graph", reps=3)
    K = record["optimize_essential_graph"][0][0].shape[0]
    n_e = int(record["optimize_essential_graph"][0][8].sum())
    dg = max(d(x, y) for x, y in zip(g, c))
    lines.append(f"optimize_essential_graph dense at K={K} ({n_e} edges of the "
                 f"accepted pass, 15 LM iterations): {ms:.3f} ms (CPU {cpu_ms:.1f} ms); "
                 f"card vs CPU max |d s, R, t| {dg:.3g}")
    bad += [] if dg <= MAX_LOOP_DGRAPH else ["essential graph dense"]
    chain = pp.chain_pose_graph(1024)
    g, c, ms, cpu_ms = both("optimize_essential_graph", chain,
                            dict(iters=15, solver="cg"), reps=3)
    dg = max(d(x, y) for x, y in zip(g, c))
    lines.append(f"optimize_essential_graph PCG at K=1024 ({int(chain[8].sum())} edges, "
                 f"15 LM iterations of 100 CG steps): {ms:.3f} ms (CPU {cpu_ms:.1f} ms); "
                 f"card vs CPU max |d s, R, t| {dg:.3g}")
    bad += [] if dg <= MAX_LOOP_DGRAPH else ["essential graph PCG"]
    for line in lines:
        print(f"{line}; CUDA events, medians; {card}")
    if bad:
        raise AssertionError(f"loop timings: the card and the CPU disagree: {bad}")


def async_phase(dev, card, kernels, seq):
    """Phase 16 (module docstring). Returns the K1..K4 launches of the run."""
    from orb_slam_tpu_torch import profile_paths as pp
    from orb_slam_tpu_torch.pipeline import system as slam
    from orb_slam_tpu_torch.slam_map.serialization import load_session, save_session

    scene = pp.loop_scene()
    s = pp.async_system(scene, dev)
    try:
        extractions = counting_extractions((s.extractor, s.extractor_init))
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        r = pp.async_path(scene, dev, system=s)
        launches = {name: k.launches for name, k in kernels.items()}
        if s._mapper_error is not None or s._loop_error is not None:
            raise AssertionError(f"async path: thread errors {s._mapper_error!r}, "
                                 f"{s._loop_error!r}")
        out, poses, closures = r["out"], r["poses"], r["closures"]
        first = next((i for i, p in enumerate(out) if p is not None), len(out))
        tracked = sum(p is not None for p in out[first:])
        n_after = len(out) - first
        ate = pp.keyframe_ate(s, poses)[0]
        m = s.map
        finite = (all(np.isfinite(p).all() for p in out if p is not None)
                  and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
                  and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
        track_ms = r["track_s"] * 1e3 / r["n_frames"]
        drain_ms = (r["track_s"] + r["drain_s"]) * 1e3 / r["n_frames"]
        print(f"async path: {len(out)} raw frames 640x480, AsyncSLAMSystem at the "
              f"SlamConfig defaults (mapper and loop threads live, the shipped "
              f"vocabulary, at most chunk {s.cfg.track_chunk_size} per call), fed as a "
              f"camera sends them (profile_paths.PacedFeed), the drift injected in a "
              f"finish / request_stop / inject / release window: "
              f"{pp.async_summary(r)}; {extractions[0]} extractions; launches "
              f"{launches}; {card}")
        print(f"async vs sequential on the loop path's frames: tracking thread "
              f"{track_ms:.3f} ms/frame inside process_batch, {drain_ms:.3f} with the "
              f"final drain; phase 14's sequential timing run {seq['ms']:.3f} ms/frame; "
              f"ratio {track_ms / seq['ms']:.3f} (with the drain "
              f"{drain_ms / seq['ms']:.3f}); keyframes {s.kf_counter} vs "
              f"{seq['keyframes']}, loops closed {s.n_loops_closed} vs {seq['loops']}; "
              f"keyframe ATE at the end {ate:.5f} vs {seq['ate']:.5f} (phase 14: "
              f"{seq['ate_before']:.5f} -> {seq['ate_after']:.5f} at its correction); "
              f"{card}")
        for c in closures:
            print(f"async loop closure: keyframe ATE {c['ate_before']:.5f} just before, "
                  f"{c['ate_after']:.5f} just after ({c['ate_after'] / c['ate_before']:.3f}"
                  f" of it), {ate:.5f} at the end ({ate / c['ate_before']:.3f})")
        if first >= INIT_WITHIN:
            raise AssertionError(f"async path: WORKING at frame {first}")
        if tracked < MIN_TRACKED_SHARE * n_after:
            raise AssertionError(f"async path: {tracked} of {n_after} frames tracked")
        if ASYNC_LOOP_GATED:
            c = closures[0] if closures else None
            fid = m.kf_frame_id.cpu().numpy()
            if s.n_loops_closed < 1 or c is None:
                raise AssertionError("async path: no loop closed")
            if not fid[c["cand"]] < pp.LOOP_CAND_BEFORE:
                raise AssertionError(f"async path: the loop keyframe's frame "
                                     f"{fid[c['cand']]} is not among the first "
                                     f"{pp.LOOP_CAND_BEFORE}")
            failed = loop_ate_failures(c["ate_before"], c["ate_after"], ate)
            if failed:
                raise AssertionError(f"async path: keyframe ATE {failed}")
        if not finite:
            raise AssertionError("async path: non-finite output")
        if (launches["K1"] != extractions[0] or launches["K2"] < tracked
                or launches["K3"] or launches["K4"]
                or launches["K5"] != extractions[0]):
            raise AssertionError(f"async path: launches {launches}, {extractions[0]} "
                                 f"extractions, {tracked} frames tracked")

        # the session on the card: saved from the async system, loaded into
        # a fresh SLAMSystem with relocalisation off, the arrays equal, and
        # the path's last 8 frames through the loaded system again at chunk
        # 8. The loaded system resumes at the saved final pose, so the
        # frames run last first, each one step from the one before (frame
        # 311 is 7 steps, 0.56 m, from it), the motion model reset (the
        # path turns back). Each must be tracked with >= 30 inliers, read
        # at the keyframe decision every tracked frame reaches.
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "session.npz")
            t = time.perf_counter()
            save_session(path, s)
            t_save = time.perf_counter() - t
            size = os.path.getsize(path)
            s2 = slam.SLAMSystem(dataclasses.replace(s.cfg, enable_relocalisation=False),
                                 device=dev)
            t = time.perf_counter()
            load_session(path, s2)
            t_load = time.perf_counter() - t
        differ = [f.name for f in dataclasses.fields(m)
                  if not torch.equal(getattr(m, f.name), getattr(s2.map, f.name))]
        differ += [k for k in ("bow_ids", "bow_w")
                   if not torch.equal(getattr(s.db, k), getattr(s2.db, k))]
        if not np.array_equal(s.db.active, s2.db.active):
            differ.append("active")
        s2.velocity = np.eye(4, dtype=np.float32)
        inliers, ladder = [], [0]
        need, track = s2._need_new_keyframe, s2._track

        def recorded_need(frame_id, n_inliers):
            inliers.append(int(n_inliers))
            return need(frame_id, n_inliers)

        def counted_track(frame):
            ladder[0] += 1
            return track(frame)

        s2._need_new_keyframe, s2._track = recorded_need, counted_track
        kf0, relocs0, lost0 = s2.kf_counter, s2.n_relocs, s2.lost_count
        again = s2.process_batch(list(r["frames"][-8:].flip(0)), chunk_size=8)
        print(f"session: saved in {t_save:.2f} s ({size / 2**20:.1f} MiB), loaded into a "
              f"fresh SLAMSystem on the card in {t_load:.2f} s; arrays that differ: "
              f"{differ or 'none'}; the path's last 8 frames through the loaded system "
              f"at chunk 8, last first, relocalisation off: "
              f"{sum(p is not None for p in again)} of 8 tracked, inliers {inliers}, "
              f"{ladder[0]} through the ladder, {s2.n_relocs - relocs0} relocalisations, "
              f"{s2.kf_counter - kf0} keyframes inserted; {card}")
        if differ:
            raise AssertionError(f"session: {differ} differ after the round trip")
        if (any(p is None or not np.isfinite(p).all() for p in again)
                or len(inliers) != 8 or min(inliers) < MIN_INLIERS
                or s2.n_relocs != relocs0 or s2.lost_count != lost0):
            raise AssertionError(f"session: the last 8 frames after the reload: "
                                 f"inliers {inliers}")
    finally:
        s.close()
    return launches


def cli_phase(dev, card, kernels):
    """Phase 17 (module docstring). Returns the K1..K4 launches of `run`."""
    from orb_slam_tpu_torch import cli
    from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
    from orb_slam_tpu_torch.geometry.so3 import rot_to_quat
    from orb_slam_tpu_torch.io.dataset import write_pgm
    from orb_slam_tpu_torch.io.settings import settings_text
    from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
    from orb_slam_tpu_torch.io.trajectory import camera_centers_from_cw, write_tum
    from orb_slam_tpu_torch.profile_paths import MAPPING_STEP, MAPPING_YAW

    W, H = 640, 480
    scene = SyntheticScene(n_points=800, width=W, height=H)
    poses = lateral_trajectory(CLI_FRAMES, step=MAPPING_STEP, yaw_rate=MAPPING_YAW)
    camera = scene.camera_model()
    centers = camera_centers_from_cw(np.asarray(poses, np.float64))
    length = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
    forward = ORBExtractor.forward
    extractions = [0]

    def counted(self, img):
        extractions[0] += 1
        return forward(self, img)

    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        for i, p in enumerate(poses):
            write_pgm(os.path.join(frames, f"{i:06d}.pgm"), scene.render_image(p))
        settings = os.path.join(tmp, "settings.yaml")
        with open(settings, "w") as f:
            f.write(settings_text(camera, ORBConfig(n_features=1000, n_levels=8)))
        gt = os.path.join(tmp, "gt.txt")
        write_tum(gt, [(i, -T[:3, :3].T @ T[:3, 3],
                        rot_to_quat(torch.from_numpy(T[:3, :3].T.copy())).numpy())
                       for i, T in enumerate(np.asarray(poses, np.float64))])

        def run(traj, *extra):
            """`run` on the frames; returns its [final] line, trajectory rows,
            launches and extractions."""
            err = io.StringIO()
            extractions[0] = 0
            ORBExtractor.forward = counted
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            try:
                with contextlib.redirect_stderr(err):
                    cli.main(["run", settings, frames, "--chunk", "8", "--async",
                              *extra, "--out", traj])
            finally:
                ORBExtractor.forward = forward
                torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
            final = next((l for l in err.getvalue().splitlines()
                          if l.startswith("[final]")), "")
            return final, np.loadtxt(traj, ndmin=2), launches, extractions[0]

        traj = os.path.join(tmp, "traj.txt")
        final, rows, launches, n_ext = run(traj, "--pace", str(CLI_PACE))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["eval", traj, gt])
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"CLI: run {CLI_FRAMES} PGM frames 640x480 (the mapping scene and "
              f"trajectory), FAST, 1000 features, 8 levels, --chunk 8 --async "
              f"--pace {CLI_PACE}: {final!r}; {len(rows)} keyframes in the "
              f"trajectory; eval {result}, ATE {result['ate_rmse'] / length:.5f} "
              f"of the {length:.3f} m path; {n_ext} extractions; launches "
              f"{launches}; {card}")
        if len(rows) < MIN_KEYFRAMES:
            raise AssertionError(f"CLI: {len(rows)} keyframes in the trajectory")
        if not result["ate_rmse"] <= MAX_ATE_SHARE * length:
            raise AssertionError(f"CLI: ATE {result['ate_rmse']:.5f} over "
                                 f"{MAX_ATE_SHARE} of the {length:.3f} m path")
        if launches["K1"] != n_ext or launches["K5"] != n_ext or n_ext < CLI_FRAMES:
            raise AssertionError(f"CLI: launches {launches}, {n_ext} extractions")
        u_final, u_rows, u_launches, u_ext = run(os.path.join(tmp, "unpaced.txt"))
        print(f"CLI unpaced (ROADMAP C17's reading, not gated): {u_final!r}; "
              f"{len(u_rows)} keyframes in the trajectory; {u_ext} extractions; "
              f"launches {u_launches}; {card}")
        if (u_launches["K1"] != u_ext or u_launches["K5"] != u_ext
                or u_ext < CLI_FRAMES):
            raise AssertionError(f"CLI unpaced: launches {u_launches}, "
                                 f"{u_ext} extractions")
    return launches


def example_phase(dev, card, kernels):
    """Phase 19 (module docstring). Returns the K1..K4 launches of the run."""
    import importlib.util

    from orb_slam_tpu_torch.frontend.orb_extractor import ORBExtractor
    from orb_slam_tpu_torch.io.synthetic import lateral_trajectory
    from orb_slam_tpu_torch.io.trajectory import camera_centers_from_cw

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "run_synthetic_torch.py")
    spec = importlib.util.spec_from_file_location("run_synthetic_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    gt = camera_centers_from_cw(lateral_trajectory(EXAMPLE_FRAMES, step=0.1))
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    forward = ORBExtractor.forward
    extractions = [0]

    def counted(self, img):
        extractions[0] += 1
        return forward(self, img)

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        ORBExtractor.forward = counted
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                summary = example.main(tmp, device=str(dev))
        finally:
            ORBExtractor.forward = forward
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = {name: k.launches for name, k in kernels.items()}
    text = out.getvalue()
    printed = json.loads(text[text.rindex("\n{") + 1:])
    ate, tracked = printed["ate_rmse"], printed["frames_tracked"]
    print(f"example: examples/run_synthetic_torch.py on {dev} ({EXAMPLE_FRAMES} PGM "
          f"frames 320x240, 400 features, 4 levels, MapConfig(16, 1024)): "
          f"{tracked} frames tracked, {printed['keyframes']} keyframes, "
          f"{printed['map_points']} points, ATE {ate} on the {length:.3f} m path "
          f"({ate / length:.5f} of it), map plot {printed['map_plot']}; "
          f"{extractions[0]} extractions; launches {launches}; {run_s:.2f} s; {card}")
    if printed != summary:
        raise AssertionError(f"example: printed {printed}, returned {summary}")
    if tracked < MIN_TRACKED_SHARE * EXAMPLE_FRAMES:
        raise AssertionError(f"example: {tracked} of {EXAMPLE_FRAMES} frames tracked")
    if printed["keyframes"] < MIN_EXAMPLE_KEYFRAMES:
        raise AssertionError(f"example: {printed['keyframes']} keyframes")
    if not ate <= MAX_EXAMPLE_ATE_SHARE * length:
        raise AssertionError(f"example: ATE {ate} over {MAX_EXAMPLE_ATE_SHARE} of "
                             f"the {length:.3f} m path")
    # K1 once in every extraction, K2 at least once per frame tracked after
    # the initialisation frame (whose pose the two-view solver gives)
    if (launches["K1"] != extractions[0] or extractions[0] < EXAMPLE_FRAMES
            or launches["K2"] < tracked - 1 or launches["K3"] or launches["K4"]
            or launches["K5"] != extractions[0]):
        raise AssertionError(f"example: launches {launches}, {extractions[0]} "
                             f"extractions, {tracked} frames tracked")
    return launches


def capacity_phase(dev, card, kernels):
    """Phase 20 (module docstring). Returns the K1..K4 launches of the run."""
    from orb_slam_tpu_torch.profile_paths import (
        capacity_failures, capacity_path, capacity_summary, capacity_system,
        loop_scene,
    )

    scene = loop_scene()
    s = capacity_system(scene, dev)
    extractions = counting_extractions((s.extractor, s.extractor_init))
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    r = capacity_path(scene, dev, system=s)
    launches = {name: k.launches for name, k in kernels.items()}
    rec = r["record"]
    full = [c for c in rec.culls if c[2]]
    before = [ms for ms, f in rec.integrations if not f]
    at = [ms for ms, f in rec.integrations if f]
    first = next((i for i, p in enumerate(r["out"]) if p is not None), 0)
    tracked = sum(p is not None for p in r["out"][first + 1:])
    m = s.map
    finite = (all(np.isfinite(p).all() for p in r["out"] if p is not None)
              and bool(torch.isfinite(m.kf_pose[m.kf_valid]).all())
              and bool(torch.isfinite(m.pt_pos[m.pt_valid]).all()))
    med = lambda v: f"{statistics.median(v):.3f}" if v else "none"
    print(f"capacity path: {capacity_summary(r)}; {extractions[0]} extractions; "
          f"launches {launches}; {card}")
    print(f"capacity slots: {len(rec.written)} point slots written into "
          f"{s.cfg.map.max_points}, {rec.recycled} of them recycled; "
          f"{s.kf_counter} keyframe slots allocated into "
          f"{s.cfg.map.max_keyframes}")
    print(f"capacity culls: {len(rec.culls)} keyframes culled, {len(full)} with "
          f"the pool full; {len(rec.replaced(rec.culls))} of the slots culled, "
          f"{len(rec.replaced(full))} of those culled with the pool full, taken "
          f"by a later keyframe")
    print(f"capacity frames: {rec.refused_full} frames at capacity (keyframe "
          f"decisions refused with free_kf empty) of {r['n_frames']}")
    print(f"capacity timing: {r['seconds'] * 1e3 / r['n_frames']:.3f} ms/frame; ms "
          f"per integration before capacity {med(before)} (median of "
          f"{len(before)}), at capacity {med(at)} (median of {len(at)}); {card}")
    failures = capacity_failures(r)
    if not finite:
        failures.append("non-finite output")
    # K1 once in every extraction, K2 at least once per frame tracked after
    # the initialisation frame
    if (launches["K1"] != extractions[0] or extractions[0] < r["n_frames"]
            or launches["K2"] < tracked or launches["K3"] or launches["K4"]
            or launches["K5"] != extractions[0]):
        failures.append(f"launches {launches}, {extractions[0]} extractions, "
                        f"{tracked} frames tracked after the first")
    if failures:
        raise AssertionError(f"capacity path: {failures}")
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
    from orb_slam_tpu_torch.io.settings import (
        settings_text, slam_config_from_settings,
    )
    from orb_slam_tpu_torch.io.synthetic import (
        SyntheticScene, lateral_trajectory, seed_map,
    )
    from orb_slam_tpu_torch.ops import fast_cell_topk as k4
    from orb_slam_tpu_torch.ops import fast_score_nms as k1
    from orb_slam_tpu_torch.ops import fast_score_rect as k3
    from orb_slam_tpu_torch.ops import keypoint_select as k5
    from orb_slam_tpu_torch.ops.fast_stack import (
        DetectCellsFused, build_pyramid_stack, detect_keypoints_packed,
    )
    from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig
    from orb_slam_tpu_torch.solvers import pose_opt as k2

    kernels = {"K1": k1.KERNEL, "K2": k2.KERNEL, "K3": k3.KERNEL, "K4": k4.KERNEL,
               "K5": k5.KERNEL}

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
    camera = scene.camera_model()
    K = torch.from_numpy(scene.K).to(dev)
    if sys.argv[1:] == ["--mesh"]:
        # phases 9 and 18 alone, for a machine with several cards
        _, mapped = mapping_path(dev, card, kernels, scene)
        mesh_phase(dev, card, kernels, mapped, mesh_devices())
        return 0

    # -- kernel vs plain at main-path shapes
    canvas = build_pyramid_stack(frames[0], extractor.Rp, extractor.Cp)
    checks = {"K1": check_k1(canvas, extractor.shapes), "K2": check_k2(dev),
              "K3": check_k3(canvas), "K4": check_k4(canvas, extractor.shapes),
              "K5": check_k5(dev)}
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
                    {"K1": N_FRAMES, "K2": N_FRAMES, "K3": 0, "K4": 0,
                     "K5": N_FRAMES})

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
                    {"K1": 0, "K2": N_FRAMES, "K3": N_FRAMES, "K4": 0,
                     "K5": N_FRAMES})

    # -- cell-fused detector on every frame's canvas
    cells = DetectCellsFused(extractor.shapes, extractor.quotas, device=dev)
    stacks = [build_pyramid_stack(f, extractor.Rp, extractor.Cp)
              for f in frames[1:]]
    cell_out, cell_launches = run_counted(lambda: [cells(s) for s in stacks])
    expect_launches("cell-fused run", cell_launches,
                    {"K1": 0, "K2": 0, "K3": 0, "K4": N_FRAMES, "K5": 0})
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

    _, mapped = mapping_path(dev, card, kernels, scene)
    mesh_launches = mesh_phase(dev, card, kernels, mapped, mesh_devices())
    del mapped
    init_launches, two_view_args = init_path(dev, card, kernels, scene)
    two_view_phases(two_view_args, card)
    reloc_launches, reloc_sys, ok_call, epnp_inputs = reloc_phase(dev, card, kernels,
                                                                  scene)
    place_phases(dev, card, reloc_sys, ok_call, epnp_inputs)
    loop_launches, _, loop_record, loop_seq = loop_phase(dev, card, kernels)
    loop_timings(dev, card, loop_record)
    async_launches = async_phase(dev, card, kernels, loop_seq)
    cli_launches = cli_phase(dev, card, kernels)
    example_launches = example_phase(dev, card, kernels)
    capacity_launches = capacity_phase(dev, card, kernels)

    launches = {"K1": fast_launches["K1"], "K2": fast_launches["K2"],
                "K3": harris_launches["K3"], "K4": cell_launches["K4"],
                "K5": fast_launches["K5"]}
    meta = {
        "K1": ("fast_score_nms", "orb_slam_tpu_torch/csrc/fast_score_nms.cu",
               "orb_slam_tpu/ops/pallas_fast.py:121"),
        "K2": ("pose_gn", "orb_slam_tpu_torch/csrc/pose_gn.cu",
               "orb_slam_tpu/solvers/pose_opt_pallas.py:113"),
        "K3": ("fast_score_rect", "orb_slam_tpu_torch/csrc/fast_score_rect.cu",
               "orb_slam_tpu/ops/pallas_fast.py:32"),
        "K4": ("fast_cell_topk", "orb_slam_tpu_torch/csrc/fast_cell_topk.cu",
               "orb_slam_tpu/ops/pallas_fast.py:287"),
        "K5": ("keypoint_select", "orb_slam_tpu_torch/csrc/keypoint_select.cu",
               "none (XLA ops: orb_slam_tpu/ops/fast_stack.py:297, "
               "orb_slam_tpu/ops/fast.py:103)"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[k], "max_abs_err": checks[k][0],
         "ms": checks[k][1], "plain_ms": checks[k][2],
         "bound_ms": checks[k][3][0], "bound_by": checks[k][3][1],
         "library_ms": None, "timing": "graph replay",
         "plain_timing": "graph replay",
         "minmax_floor_ms": floors.get(k),
         "init_path_launches": init_launches[k],
         "reloc_path_launches": reloc_launches[k],
         "loop_path_launches": loop_launches[k],
         "async_path_launches": async_launches[k],
         "cli_path_launches": cli_launches[k],
         "mesh_path_launches": mesh_launches[k],
         "example_path_launches": example_launches[k],
         "capacity_path_launches": capacity_launches[k],
         **({"chain_floor_ms": k2_floor_ms} if k == "K2" else {})}
        for k, (name, source, replaces) in meta.items()]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
