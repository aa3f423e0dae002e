"""The port alone closes a drifted loop on oracle features, and its ring
scene is the JAX package's.

The loop: tests/test_loop_reloc_e2e.py:118-151's scenario through the
port's SLAMSystem (loop closing on, relocalisation off, the shipped
vocabulary): a full turn inside a ring world after a translational
lead-in, features from the JAX package's SyntheticScene(ring=True).observe,
and at frame 60 the recent half of the map remapped through the Sim3
s = 1.15, t = (0.4, 0, 0.2) (profile_paths.inject_drift). The revisit is
recognised by appearance but displaced in geometry: the port must close
at least one loop, track at least 60% of the frames, and lower the
keyframe ATE after a Sim3 alignment across the correction.

The ring: the port's SyntheticScene(ring=True) points, oracle features
and rendered frame and ring_trajectory poses bit-equal to JAX's, at the
full-width ring's settings and at another.

Run as a module, it runs one package on the CPU over the loop path of
profile_paths.py on a scene seed (the JAX package's run on seed 0 is the
reference chip_smoke.py's phase 14 holds the port to), or over the
full-width ring without drift, and prints one JSON line:

    python -m tests.test_torch_loop_e2e jax|port SCENE_SEED|ring

With `keep-up N [DEVICE [PERIOD ...]]` it runs the loop path's first N frames
(scene seed 0) through the port's sequential SLAMSystem with a mapper
latency (`SlamConfig.mapper_latency_frames`) of 2 and of 4 frames, one
frame per call with and without the tracker adopting the BA-refined
keyframe pose, and through the port's AsyncSLAMSystem drained after every
frame and paced at one frame every PERIOD seconds (and, on the CPU, the
JAX package's AsyncSLAMSystem), and prints one JSON line for each: what
the threads change on these frames (ROADMAP C17).
"""

import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu.io.synthetic import ring_trajectory as jax_ring_trajectory
from orb_slam_tpu_torch import profile_paths as pp
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, ring_trajectory
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
import tests.test_loop_reloc_e2e as jax_e2e
from tests.test_torch_system_map import _two_threads  # noqa: F401


# the full-width ring: SyntheticScene(ring=True) at 640x480 with the field
# of view of scripts/bench_full_pipeline.py:47-53, frames rendered with
# patch 6 along ring_trajectory(RING_FRAMES, 4.0, RING_ANGLE), 360 degrees
# at frame 240
RING_SCENE = dict(n_points=1200, seed=5, width=640, height=480, fx=400.0, fy=400.0,
                  cx=320.0, cy=240.0, depth_range=(10.0, 13.0), extent=(0, 3.0, 0))
RING_FRAMES = 260
RING_ANGLE = 2.0 * np.pi * RING_FRAMES / 240.0


@pytest.mark.parametrize("kw", [
    RING_SCENE,
    dict(n_points=1500, seed=5, extent=(0, 4.0, 0), depth_range=(7.0, 13.0))])
def test_ring_scene_and_trajectory_bit_equal_to_jax(kw):
    a, b = JaxScene(ring=True, **kw), SyntheticScene(ring=True, **kw)
    np.testing.assert_array_equal(b.points, a.points)
    np.testing.assert_array_equal(b.descriptors, a.descriptors)
    for n, r, ang in ((RING_FRAMES, 4.0, RING_ANGLE), (37, 2.0, 2.0 * np.pi)):
        np.testing.assert_array_equal(ring_trajectory(n, orbit_radius=r, total_angle=ang),
                                      jax_ring_trajectory(n, orbit_radius=r, total_angle=ang))
    T = jax_ring_trajectory(8, 4.0)[3]
    assert np.array_equal(b.render_image(T, patch=6), a.render_image(T, patch=6))
    for _ in range(2):
        fa, fb = a.observe(T, n_slots=250, pix_noise=0.4), b.observe(T, n_slots=250, pix_noise=0.4)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], k)


def oracle_loop_run(make_system=tsys.SLAMSystem):
    """(the port's system, frames tracked, frames, the keyframe ATE just
    before each correction and just after it) on the oracle ring, through
    `make_system(cfg, device="cpu")`. A system with threads (an
    AsyncSLAMSystem) is drained after every frame, its drift injected in
    a request_stop / release window, and closed at the end."""
    scene = JaxScene(n_points=1500, seed=5, extent=(0, 4.0, 0),
                     depth_range=(7.0, 13.0), ring=True)
    n_slots = 250
    cfg = tsys.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        map=MapConfig(max_keyframes=32, max_points=2048, n_features=n_slots),
        p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
        local_ba_window=6, orb=None, enable_relocalisation=False,
        max_frames_between_kf=6, min_frames_between_kf=4, kf_tracked_ratio=1.5,
        track_radius=25.0)
    s = make_system(cfg, device="cpu")
    threads = hasattr(s, "finish")
    poses = [jax_e2e.yaw_pose(0.0, [-0.5 + 0.0625 * i, 0.0, 0.0]) for i in range(8)]
    for i in range(116):
        yaw = 2 * np.pi * i / 96
        poses.append(jax_e2e.yaw_pose(yaw, [3.0 * np.sin(yaw), 0.0, 3.0 * (np.cos(yaw) - 1.0)]))
    poses = np.stack(poses).astype(np.float32)
    ates = []
    tracked = 0
    wrapped = None
    try:
        for fi, T in enumerate(poses):
            if s.loop_closer is not None and s.loop_closer is not wrapped:
                wrapped = s.loop_closer
                correct = s.loop_closer.correct

                def watched(system, new_kf, cand, S12, correct=correct):
                    before = pp.keyframe_ate(system, poses)[0]
                    ok = correct(system, new_kf, cand, S12)
                    ates.append((before, pp.keyframe_ate(system, poses)[0]))
                    return ok

                s.loop_closer.correct = watched
            out = s.process(features=scene.observe(T, n_slots=n_slots, pix_noise=0.4))
            if threads:
                s.finish()
            tracked += out is not None
            if fi == 60:
                assert s.state == tsys.WORKING
                if threads:
                    s.request_stop()
                try:
                    pp.inject_drift(s, 1.15, [0.4, 0.0, 0.2])
                finally:
                    if threads:
                        s.release()
    finally:
        if threads:
            s.close()
    return s, tracked, len(poses), ates


def test_port_closes_the_drifted_oracle_loop():
    s, tracked, n, ates = oracle_loop_run()
    assert tracked > 0.6 * n, (tracked, n)
    assert s.n_loops_closed >= 1 and ates, "no loop closure"
    before, after = ates[0]
    assert after < before, (before, after)
    m = s.map
    assert torch.isfinite(m.kf_pose[m.kf_valid]).all()
    assert torch.isfinite(m.pt_pos[m.pt_valid]).all()
    assert (m.loop_edges >= 0).any()


def jax_system(scene):
    """A JAX SLAMSystem at the SlamConfig defaults for the scene's camera,
    on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam_tpu.geometry import CameraModel as JaxCamera
    from orb_slam_tpu.pipeline.system import SLAMSystem, SlamConfig

    return SLAMSystem(SlamConfig(camera=JaxCamera.create(
        scene.fx, scene.fy, scene.cx, scene.cy, width=scene.width,
        height=scene.height)))


def jax_loop_reference(seed: int = 0):
    """The JAX package on the CPU over the loop path of profile_paths.py
    on scene seed `seed` (its frames, rendered by the port's bit-equal
    renderer, and its drift, injected as profile_paths.drive_loop_frames
    places it) at the SlamConfig defaults: prints one JSON line with the
    first frame tracked, the frames tracked after it, the closures (frame,
    keyframes' frames, the keyframe ATE after a Sim3 alignment just before
    and after each correction) and the keyframe ATE at the end, the
    readings chip_smoke.py's phase 14 holds the port to (seed 0)."""
    import json
    import time

    import orb_slam_tpu.pipeline.loop_closing as jlc

    scene = pp.loop_scene(seed)
    poses, frames = pp.loop_frames(scene, "cpu")
    s = jax_system(scene)
    from orb_slam_tpu.pipeline.system import WORKING

    closures = []
    correct = jlc.LoopCloser.correct

    def watched(self, system, new_kf, cand, S12):
        before = pp.keyframe_ate(system, poses)[0]
        ok = correct(self, system, new_kf, cand, S12)
        fid = np.asarray(system.map.kf_frame_id)
        closures.append(dict(frame=system.frame_id - 1, kf_frame=int(fid[new_kf]),
                             cand_frame=int(fid[cand]), s=float(S12[0]),
                             ate_before=before,
                             ate_after=pp.keyframe_ate(system, poses)[0]))
        return ok

    jlc.LoopCloser.correct = watched
    t = time.perf_counter()
    out, drift_after, _ = pp.drive_loop_frames(
        s, frames.numpy(), lambda system: jax_e2e.TestLoopClosing._inject_drift(
            None, system, pp.LOOP_DRIFT[0], list(pp.LOOP_DRIFT[1])), working=WORKING)
    first = next((k for k, p in enumerate(out) if p is not None), len(out))
    ate, scale, length, _ = pp.keyframe_ate(s, poses)
    print(json.dumps(dict(
        seed=seed, frames=len(out), first=first,
        tracked=sum(p is not None for p in out[first:]),
        lost_frames=[k for k in range(first, len(out)) if out[k] is None],
        lost_count=s.lost_count, n_relocs=s.n_relocs, n_loops_closed=s.n_loops_closed,
        drift_after=drift_after, closures=closures, ate_end=ate,
        scale=scale, length=length, keyframes=s.kf_counter, live=s.n_keyframes,
        seconds=time.perf_counter() - t)))


def port_loop_run(seed: int):
    """The port on the CPU over the loop path of profile_paths.py on scene
    seed `seed`, as chip_smoke.py's phase 14 runs it on the card: prints
    one JSON line with the frames lost, the closures and loop_summary."""
    import json

    r = pp.loop_path(pp.loop_scene(seed), "cpu")
    out, fid = r["out"], r["system"].map.kf_frame_id.numpy()
    first = next((k for k, p in enumerate(out) if p is not None), len(out))
    print(json.dumps(dict(
        seed=seed, lost_frames=[k for k in range(first, len(out)) if out[k] is None],
        closures=[dict(frame=c["frame_id"], kf_frame=int(fid[c["new_kf"]]),
                       cand_frame=int(fid[c["cand"]]), ate_before=c["ate_before"],
                       ate_after=c["ate_after"]) for c in r["closures"]],
        summary=pp.loop_summary(r))))


def ring_reference(package: str):
    """One package ("jax" or "port") on the CPU over the full-width ring
    (RING_SCENE, no drift) at the SlamConfig defaults with the shipped
    vocabulary: prints one JSON line with the first frame tracked, the
    frames tracked after it, the frames lost, keyframes and loops."""
    import json
    import time

    scene = SyntheticScene(ring=True, **RING_SCENE)
    poses = ring_trajectory(RING_FRAMES, orbit_radius=4.0, total_angle=RING_ANGLE)
    frames = np.stack([scene.render_image(p, patch=6) for p in poses])
    if package == "jax":
        s = jax_system(scene)
    else:
        s = pp.loop_system(scene, "cpu")
        frames = torch.from_numpy(frames)
    t = time.perf_counter()
    out = s.process_batch(frames)
    first = next((k for k, p in enumerate(out) if p is not None), len(out))
    print(json.dumps(dict(
        package=package, frames=len(out), first=first,
        tracked=sum(p is not None for p in out[first:]),
        lost_frames=[k for k in range(first, len(out)) if out[k] is None],
        lost_count=s.lost_count, n_relocs=s.n_relocs, n_loops_closed=s.n_loops_closed,
        keyframes=s.kf_counter, live=s.n_keyframes, seconds=time.perf_counter() - t)))


def keep_up(n: int, device: str = "cpu", periods=(0.3,)):
    """The loop path's first `n` frames (seed 0) at the SlamConfig
    defaults with the shipped vocabulary on `device`: through the port's
    sequential SLAMSystem with a mapper latency
    (`SlamConfig.mapper_latency_frames`) of 2 and of 4 frames; one frame
    per call with the tracker adopting the BA-refined keyframe pose
    (`_publish_mapped_pose`) and keeping its own; the AsyncSLAMSystem
    drained after every frame; the AsyncSLAMSystem fed by
    `profile_paths.PacedFeed` at one frame every `period` seconds, for
    each of `periods`; and, on the CPU, the JAX package's
    AsyncSLAMSystem. One JSON line each with the frames lost, keyframes,
    resets, per frame the inliers at the keyframe decision, whether the
    mapper was accepting and whether a keyframe was made, and per
    integration the keyframe's frame, the tracker's frame at its start
    and end and its host-clock ms."""
    import dataclasses
    import json
    import time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = pp.loop_scene(0)
    _, frames = pp.loop_frames(scene, device)
    frames = frames[:n]

    def traced(s):
        log, integrations = [], []
        need, integrate = s._need_new_keyframe, s._integrate_keyframe

        def recorded(frame_id, n_inliers):
            accepting = s._mapper_accepting()
            made = need(frame_id, n_inliers)
            log.append((frame_id, int(n_inliers), bool(accepting), bool(made)))
            return made

        def timed(frame, *args, **kw):
            start, t = s.frame_id, time.perf_counter()
            try:
                return integrate(frame, *args, **kw)
            finally:
                integrations.append((frame.frame_id, start, s.frame_id,
                                     round((time.perf_counter() - t) * 1e3, 1)))

        s._need_new_keyframe, s._integrate_keyframe = recorded, timed
        resets = [0]
        reset = s.reset

        def counted():
            resets[0] += 1
            reset()

        s.reset = counted
        return log, resets, integrations

    def emit(name, s, out, log, resets, integrations):
        print(json.dumps(dict(
            run=name, frames=len(out),
            lost_frames=[k for k, p in enumerate(out) if p is None],
            keyframes=s.kf_counter, state=s.state, lost_count=s.lost_count,
            resets=resets[0], decisions=log, integrations=integrations)), flush=True)

    if device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from orb_slam_tpu.geometry import CameraModel as JaxCamera
        from orb_slam_tpu.pipeline.async_system import AsyncSLAMSystem as JaxAsync
        from orb_slam_tpu.pipeline.system import SlamConfig

        js = JaxAsync(SlamConfig(camera=JaxCamera.create(
            scene.fx, scene.fy, scene.cx, scene.cy, width=scene.width,
            height=scene.height)))
        try:
            out = js.process_batch(list(frames.numpy()))
            js.finish()
        finally:
            js.close()
        emit("jax AsyncSLAMSystem", js, out, [], [0], [])
    for latency in (2, 4):
        s = pp.loop_system(scene, device)
        s.cfg = dataclasses.replace(s.cfg, mapper_latency_frames=latency)
        rec = traced(s)
        emit(f"port SLAMSystem, mapper latency {latency}", s, s.process_batch(frames),
             *rec)
    for publish in (True, False):
        s = pp.loop_system(scene, device)
        if not publish:
            s._publish_mapped_pose = lambda new_kf: None
        rec = traced(s)
        emit(f"port SLAMSystem, one frame per call, the tracker "
             f"{'adopting the keyframe pose' if publish else 'keeping its own pose'}",
             s, s.process_batch(frames, chunk_size=1), *rec)
    for period in (None,) + tuple(periods):
        paced = period is not None
        s = pp.async_system(scene, device)
        rec = traced(s)
        try:
            if paced:
                out = pp.PacedFeed(period, s.cfg.track_chunk_size)(s, frames, 0)
            else:
                out = []
                for k in range(len(frames)):
                    out += s.process_batch(frames[k:k + 1])
                    s.finish()
            s.finish()
        finally:
            s.close()
        emit(f"port AsyncSLAMSystem, "
             f"{f'one frame every {period} s' if paced else 'drained after every frame'}",
             s, out, *rec)


if __name__ == "__main__":
    import sys

    package, scenario = sys.argv[1:3]
    if package == "keep-up":
        keep_up(int(scenario), *sys.argv[3:4], *([tuple(map(float, sys.argv[4:]))]
                                                 if sys.argv[4:] else []))
    elif scenario == "ring":
        ring_reference(package)
    elif package == "jax":
        jax_loop_reference(int(scenario))
    else:
        port_loop_run(int(scenario))
