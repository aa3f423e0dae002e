"""The multi-device mode against the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices tests/conftest.py gives it
(`make_mesh(8)`: data 4 x model 2); the port on a mesh of eight `cpu`
entries of the same shape, which runs the same sharded code as distinct
cards (parallel/mesh.py). The problems are JAX's own:
tests/test_parallel.py's two BA steps, the live map of
tests/test_torch_local_ba.py, and the state of tests/test_system_vo.py
after 12 oracle-feature frames that tests/test_torch_system_map.py
integrates frame 12 into.

Tolerances and why: the mesh and the meshes' shapes, matching and RANSAC
are integer work or picks among given floats: exact, ties included (the
lowest global column, the first hypothesis). One BA step and a whole BA
sum their normal equations in f32 over the shards in another order than
JAX's psum (the port adds the shards in their order) and factor them
through LAPACK instead of XLA: poses within 5e-5, points within 5e-4, the
outlier mask and the observation table equal, the bounds
tests/test_parallel.py:141-166 holds JAX's mesh against its single device.
In the points problem one point is seen four times from one camera: its
3x3 block has rank 2 plus the damping, and LAPACK's and XLA's inverses of
it differ (1.4e-2 on one device as on the mesh, ROADMAP C7), so it is held
to the port's single device alone.
One whole `_integrate_keyframe` in mesh mode, against the port's single
device and JAX's mesh: test_parallel.py:199-222's bounds (poses 1e-4,
points 1e-3, at most 2 validity flips, under 0.5% of kf_obs differing),
with tests/test_torch_system_map.py's rule for the points seen by one or
two keyframes, which a reordered sum moves along their rays (1.5e-2,
ROADMAP C7). That integration runs with `max_ba_points` 256, so the
compact point space spreads the live points over all four shards (with
the default 2048 they would all fall in the first shard's block). The
port's mesh repeats bit for bit: its sums run in a fixed order.
"""

import copy
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.io.synthetic import SyntheticScene as JaxScene
from orb_slam_tpu.io.synthetic import lateral_trajectory as jax_trajectory
from orb_slam_tpu.parallel import sharding as jsh
from orb_slam_tpu.pipeline.track_kernels import track_frame
from orb_slam_tpu.slam_map.observations import observation_table
from orb_slam_tpu.solvers import local_ba as jba
from orb_slam_tpu_torch.parallel import mesh as tmesh
from orb_slam_tpu_torch.parallel import sharding as tsh
from orb_slam_tpu_torch.pipeline import system as tsys
from orb_slam_tpu_torch.slam_map.observations import (
    observation_table as port_observation_table,
)
from orb_slam_tpu_torch.solvers import local_ba as tba
from tests.test_system_vo import run_sequence
from tests.test_torch_local_ba import KM, build_problem
from tests.test_torch_system_map import port_system


@pytest.fixture(scope="module")
def meshes():
    """(JAX's mesh over the 8 virtual devices, the port's over 8 `cpu`)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jsh.make_mesh(8), tsh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch, as tests/test_torch_system_map.py runs
    the system: the float sums' order then does not follow the host's
    core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,model_axis", [(1, None), (2, None), (3, None), (4, None),
                                          (6, None), (8, None), (8, 1), (8, 4)])
def test_make_mesh_shape(n, model_axis):
    want = jsh.make_mesh(n, model_axis)
    got = tsh.make_mesh(n, model_axis, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_refuses():
    with pytest.raises(ValueError) as want:
        jsh.make_mesh(9)
    with pytest.raises(ValueError) as got:
        tsh.make_mesh(9, devices=["cpu"] * 8)
    head = lambda e: str(e.value).split(" on platform")[0]
    assert head(got) == head(want) == ("make_mesh: requested 9 devices but only 8 "
                                       "available")
    if torch.cuda.is_available():
        assert tsh.make_mesh().devices[0, 0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsh.make_mesh()


def test_collectives_in_shard_order():
    parts = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
             torch.tensor([-1e8])]
    assert float(tmesh.psum(parts)) == 0.0        # (1e8 + 1) - 1e8 in f32
    assert [float(p) for p in tmesh.all_gather(parts)] == [1e8, 1.0, -1e8]
    x = torch.arange(12.0).reshape(6, 2)
    blocks = tmesh.split_rows(x, [torch.device("cpu")] * 3)
    assert [b.shape[0] for b in blocks] == [2, 2, 2]
    assert torch.equal(torch.cat(blocks), x)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_sharded_hamming_argmin(meshes, case):
    jm, tm = meshes
    rng = np.random.default_rng(3)
    P, N = 64, 32
    if case == "random":
        da = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
        db = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    else:   # few distinct descriptors: most rows tie across columns and shards
        pool = rng.integers(0, 2**32, (3, 8), dtype=np.uint32)
        da, db = pool[rng.integers(0, 3, P)], pool[rng.integers(0, 3, N)]
    jb, jd = jsh.sharded_hamming_argmin(jm)(jnp.asarray(da), jnp.asarray(db))
    tb, td = tsh.sharded_hamming_argmin(tm)(torch.from_numpy(da.view(np.int32)),
                                            torch.from_numpy(db.view(np.int32)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.dtype == td.dtype == torch.int32
    D = np.unpackbits((da[:, None] ^ db[None]).view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(tb.numpy(), D.argmin(1))   # lowest column
    at_min = D == D.min(1, keepdims=True)
    crossed = at_min[:, :N // 2].any(1) & at_min[:, N // 2:].any(1)
    assert crossed.any()                 # a tie across the model axis


@pytest.mark.parametrize("case", ["random", "ties"])
def test_sharded_ransac_best(meshes, case):
    jm, tm = meshes
    rng = np.random.default_rng(4)
    if case == "random":
        scores = rng.uniform(0, 1, 32 * 4).astype(np.float32)
    else:   # inlier counts: the maximum repeats within and across shards
        scores = rng.integers(0, 6, 32 * 4).astype(np.float32)
        assert (scores == scores.max()).sum() > 4
    js, ji = jsh.sharded_ransac_best(jm)(jnp.asarray(scores))
    ts, ti = tsh.sharded_ransac_best(tm)(torch.from_numpy(scores))
    assert float(ts) == float(js) == scores.max()
    assert int(ti) == int(ji) == scores.argmax()


def ba_step_problem(rng, d_data, cameras):
    """tests/test_parallel.py's two BA problems: points perturbed with the
    cameras fixed, or camera 2 perturbed with the points fixed."""
    from scipy.spatial.transform import Rotation as SR
    Kk, O = 4, 4
    Pp = (32 if cameras else 16) * d_data
    pts = np.stack([rng.uniform(-2, 2, Pp), rng.uniform(-1.5, 1.5, Pp),
                    rng.uniform(5, 9, Pp)], 1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (Kk, 1, 1))
    for k in range(Kk):
        poses[k][:3, 3] = [-0.3 * k, 0, 0]
    edge_kf = rng.integers(0, Kk, (Pp, O)).astype(np.int32)
    uv = np.zeros((Pp, O, 2), np.float32)
    for p in range(Pp):
        for o in range(O):
            T = poses[edge_kf[p, o]]
            pc = T[:3, :3] @ pts[p] + T[:3, 3]
            uv[p, o] = [500 * pc[0] / pc[2] + 320, 500 * pc[1] / pc[2] + 240]
    cam_opt = np.zeros(Kk, bool)
    if cameras:
        dR = SR.from_rotvec([0.01, -0.02, 0.01]).as_matrix().astype(np.float32)
        poses[2][:3, :3] = dR @ poses[2][:3, :3]
        poses[2][:3, 3] += [0.03, -0.02, 0.01]
        cam_opt[2] = True
        pt_opt = np.zeros(Pp, bool)
    else:
        pts = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
        pt_opt = np.ones(Pp, bool)
    return (poses, pts, edge_kf, uv, np.ones((Pp, O), np.float32), cam_opt,
            pt_opt, KM)


@pytest.mark.parametrize("cameras", [False, True])
def test_sharded_ba_step(meshes, cameras):
    jm, tm = meshes
    args = ba_step_problem(np.random.default_rng(42), tm.shape["data"], cameras)
    jstep = jsh.sharded_ba_step(jm, 4)
    tstep = tsh.sharded_ba_step(tm, 4)
    kf_pose, pt_pos, edge_kf, uv, edge_w, cam_opt, pt_opt, K = args
    jpose, jpts = jnp.asarray(kf_pose), jnp.asarray(pt_pos)
    tpose, tpts = torch.from_numpy(kf_pose), torch.from_numpy(pt_pos)
    spose, spts = tpose, tpts
    t = lambda a: torch.from_numpy(a)
    for _ in range(4 if cameras else 1):
        jpose, jpts = jstep(jpose, jpts, *map(jnp.asarray, args[2:]))
        tpose, tpts = tstep(tpose, tpts, *map(t, args[2:]))
        spose, spts = tba._solve_iteration(spose, spts, t(edge_w), t(edge_kf), t(uv),
                                           t(K), t(cam_opt), t(pt_opt), 1e-3)
    # a point seen from one camera has a rank-2 block (ROADMAP C7): its
    # depth moves with LAPACK's and XLA's rounding of the inverse alike
    seen_twice = np.array([len(set(r)) >= 2 for r in edge_kf])
    for pose, pts, rows in ((jpose, jpts, seen_twice), (spose, spts, slice(None))):
        np.testing.assert_allclose(tpose.numpy(), np.asarray(pose), rtol=0, atol=5e-5)
        np.testing.assert_allclose(tpts.numpy()[rows], np.asarray(pts)[rows], rtol=0,
                                   atol=5e-4)
    fixed = ~cam_opt
    assert torch.equal(tpose[fixed], torch.from_numpy(kf_pose[fixed]))
    moved, start = (tpose, kf_pose) if cameras else (tpts, pt_pos)
    assert np.abs(moved.numpy() - start).max() > 1e-3     # a real step


@pytest.fixture(scope="module")
def problem():
    return build_problem()


@pytest.mark.parametrize("Kl,Pl", [(None, None), (32, 256)])
def test_bundle_adjust_mesh(meshes, problem, Kl, Pl):
    jm, tm = meshes
    m, t, cam_opt, _ = problem
    kw = dict(iters1=5, iters2=10, max_opt_cams=Kl, max_opt_pts=Pl)
    sj, oj, (kj, fj) = jba.bundle_adjust(m, jnp.asarray(KM), jnp.asarray(cam_opt),
                                         m.pt_valid, mesh=jm, **kw)
    K, co = torch.from_numpy(KM), torch.from_numpy(cam_opt)
    ss, os_, _ = tba.bundle_adjust(t, K, co, t.pt_valid, **kw)
    its = []
    st, ot, (kt, ft) = tba.bundle_adjust(t, K, co, t.pt_valid, mesh=tm,
                                         iterations=its, **kw)
    for pose, pts, outlier in ((sj.kf_pose, sj.pt_pos, oj),
                               (ss.kf_pose, ss.pt_pos, os_)):
        np.testing.assert_allclose(st.kf_pose.numpy(), np.asarray(pose), rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(st.pt_pos.numpy(), np.asarray(pts), rtol=0,
                                   atol=5e-4)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(outlier))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ot.sum() > 0 and len(its) == 1
    # the compact space spreads the live points over every shard
    assert Pl is None or int(t.pt_valid.sum()) > 3 * Pl // tm.shape["data"]


def test_bundle_adjust_mesh_repeats(meshes, problem):
    _, tm = meshes
    _, t, cam_opt, _ = problem
    runs = [tba.bundle_adjust(t, torch.from_numpy(KM), torch.from_numpy(cam_opt),
                              t.pt_valid, mesh=tm, max_opt_cams=32, max_opt_pts=256)
            for _ in range(2)]
    (a, oa, _), (b, ob, _) = runs
    assert torch.equal(a.kf_pose, b.kf_pose) and torch.equal(a.pt_pos, b.pt_pos)
    assert torch.equal(oa, ob)


def test_indivisible_point_space_raises_as_jax(problem):
    m, t, cam_opt, _ = problem
    with pytest.raises(ValueError) as want:
        jba.bundle_adjust(m, jnp.asarray(KM), jnp.asarray(cam_opt), m.pt_valid,
                          mesh=jsh.make_mesh(3))
    with pytest.raises(ValueError) as got:
        tba.bundle_adjust(t, torch.from_numpy(KM), torch.from_numpy(cam_opt),
                          t.pt_valid, mesh=tsh.make_mesh(devices=["cpu"] * 3))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def integrated(meshes):
    """(JAX's mesh integration, the port's single-device one, the port's
    mesh one), each one _integrate_keyframe of frame 12 from the JAX
    system's state after 12 frames, with max_ba_points 256."""
    jm, tm = meshes
    jsys, _, _ = run_sequence(n_frames=12)
    feats = JaxScene(n_points=500, seed=0).observe(jax_trajectory(14, step=0.08)[12],
                                                   n_slots=200)
    frame = jsys.make_frame(features=feats)
    res = track_frame(jsys.map, frame.xy, frame.desc, frame.octave, frame.valid,
                      jnp.asarray(jsys.last_pose), jsys.K_dev, p_local=jsys.cfg.p_local,
                      width=jsys.cfg.camera.width, height=jsys.cfg.camera.height)
    n_in = int(res.n_inliers)
    pose = np.asarray(res.pose)

    tframe = tsys.FrameData(*(torch.from_numpy(np.array(v)) for v in (
        frame.xy, np.asarray(frame.desc).view(np.int32), frame.octave, frame.angle,
        frame.valid)), frame.frame_id, frame.timestamp)
    ports = []
    for mesh in (None, tm):
        s = port_system(jsys)
        s.cfg = dc_replace(s.cfg, max_ba_points=256, mesh=mesh)
        ports.append(s)

    a = copy.copy(jsys)
    a.cfg = dc_replace(jsys.cfg, enable_loop_closing=False, max_ba_points=256, mesh=jm)
    a.free_kf, a.free_pt = list(jsys.free_kf), list(jsys.free_pt)
    a.kf_order = jsys.kf_order.copy()
    a.pt_forward = jsys.pt_forward.copy()
    a.trajectory = list(jsys.trajectory)
    a._integrate_keyframe(frame, res.obs, n_in, pose=pose)
    for s in ports:
        s._integrate_keyframe(tframe, torch.from_numpy(np.array(res.obs)), n_in,
                              pose=pose)
    out = [a] + ports
    return tuple(out)


def assert_integrations_agree(got, want_pose, want_pts, want_valid, want_obs, n_obs):
    np.testing.assert_allclose(got.map.kf_pose.numpy(), want_pose, atol=1e-4)
    d = np.abs(got.map.pt_pos.numpy() - want_pts).max(1)
    assert d[want_valid & (n_obs >= 3)].max() < 1e-3
    assert d[want_valid].max() < 1.5e-2
    assert (got.map.pt_valid.numpy() != want_valid).sum() <= 2
    assert (got.map.kf_obs.numpy() != want_obs).mean() < 0.005


def test_integrate_keyframe_mesh_vs_single(integrated):
    _, single, mesh = integrated
    assert mesh.kf_counter == single.kf_counter
    assert mesh.last_kf_slot == single.last_kf_slot
    n_obs = port_observation_table(single.map)[2].sum(1).numpy()
    assert_integrations_agree(mesh, single.map.kf_pose.numpy(),
                              single.map.pt_pos.numpy(), single.map.pt_valid.numpy(),
                              single.map.kf_obs.numpy(), n_obs)
    assert len(mesh.ba_iterations) == 2


def test_integrate_keyframe_mesh_vs_jax_mesh(integrated):
    a, _, mesh = integrated
    assert mesh.kf_counter == a.kf_counter and mesh.last_kf_slot == a.last_kf_slot
    n_obs = np.asarray(observation_table(a.map)[2]).sum(1)
    assert_integrations_agree(mesh, np.asarray(a.map.kf_pose), np.asarray(a.map.pt_pos),
                              np.asarray(a.map.pt_valid), np.asarray(a.map.kf_obs),
                              n_obs)
