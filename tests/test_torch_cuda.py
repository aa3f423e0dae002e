"""The CUDA kernels against their plain versions at more shapes than the
main path's, and the port's main path on the card against itself on the
CPU. Needs a CUDA device and nvcc; skipped without a card. On the GPU
machine: `python -m pytest tests/test_torch_cuda.py -q -m cuda`.

Tolerances: K1, K3 and K4 are bit-exact (min/max of exact differences,
exact top-K; the tests that compare bit patterns tell -0.0 from +0.0);
K2 holds the JAX kernel test's bounds (pose atol 1e-4, at
most max(2, 1%) inlier flips); the whole path on the card and on the CPU
sums in different orders, so poses agree to 1e-3 and at least 98% of
keypoints are equal; the Harris extractor likewise keeps 98% of its
keypoints (its shifted scores tie at f32 spacing, so a last-bit change of
the pyramid can swap two).
"""

import numpy as np
import pytest
import torch

from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory, seed_map
from orb_slam_tpu_torch.ops import fast_cell_topk as k4
from orb_slam_tpu_torch.ops import fast_score_nms as k1
from orb_slam_tpu_torch.ops import fast_score_rect as k3
from orb_slam_tpu_torch.ops.fast_stack import (
    DetectCellsFused, build_pyramid_stack, pyramid_matrices,
)
from orb_slam_tpu_torch.ops.image import pyramid_shapes
from orb_slam_tpu_torch.pipeline.chunk import extract_track_chunk
from orb_slam_tpu_torch.slam_map.map_state import MapConfig
from orb_slam_tpu_torch.solvers import pose_opt as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def canvas(h, w, levels, seed, quantize):
    scene = SyntheticScene(n_points=300, width=w, height=h, fx=w * 0.78,
                           fy=w * 0.78, cx=w / 2, cy=h / 2, seed=seed)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1],
                                              quantize=quantize))
    Rp, Cp = pyramid_matrices(h, w, levels, 1.2)
    stack = build_pyramid_stack(img, torch.from_numpy(Rp), torch.from_numpy(Cp))
    return stack, pyramid_shapes(h, w, levels, 1.2)


@pytest.mark.parametrize("h,w,levels,border,quantize", [
    (480, 640, 8, 16, True), (128, 256, 4, 16, False), (241, 319, 3, 16, False),
    (100, 90, 2, 3, True)])
def test_k1_equals_plain(dev, h, w, levels, border, quantize):
    stack, shapes = canvas(h, w, levels, 1, quantize)
    stack = stack.to(dev)
    before = k1.KERNEL.launches
    got = k1.fast_score_nms(stack, shapes, border=border)
    assert k1.KERNEL.launches == before + 1
    want = k1.fast_score_nms_plain(stack, shapes, border=border)
    for l, (lh, lw) in enumerate(shapes):
        assert torch.equal(got[l, :lh, :lw], want[l, :lh, :lw]), l


def test_k1_rejects_bad_input(dev):
    stack, shapes = canvas(128, 256, 4, 0, False)
    with pytest.raises(ValueError):
        k1.fast_score_nms(stack.to(dev).double(), shapes)
    with pytest.raises(ValueError):
        k1.fast_score_nms(stack.to(dev).transpose(1, 2), shapes)
    with pytest.raises(ValueError):
        k1.fast_score_nms(stack.to(dev), shapes[:-1])


@pytest.mark.parametrize("h,w,levels,quantize", [
    (480, 640, 8, True), (241, 319, 3, False)])
def test_k3_equals_plain(dev, h, w, levels, quantize):
    stack, _ = canvas(h, w, levels, 1, quantize)
    stack = stack.to(dev)
    before = k3.KERNEL.launches
    got = k3.fast_score_nms_rect(stack)
    assert k3.KERNEL.launches == before + 1
    want = k3.fast_score_nms_rect_plain(stack)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def k3_bit_equal(stack):
    before = k3.KERNEL.launches
    got = k3.fast_score_nms_rect(stack)
    assert k3.KERNEL.launches == before + 1
    want = k3.fast_score_nms_rect_plain(stack)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("value", [0.0, -0.0, 41.5, -3e38])
def test_k3_constant_canvas(dev, value):
    """Every tile takes the early-out."""
    k3_bit_equal(torch.full((3, 100, 136), value, device=dev))


# one tile's 40x40 window on a [2, 96, 160] canvas: the tile at (32, 64),
# window rows 28..67, columns 60..99
HALO_SPOTS = [(28, 60), (28, 99), (67, 60), (67, 99),        # corners
              (28, 80), (67, 80), (48, 60), (48, 99)]        # sides


@pytest.mark.parametrize("y,x", HALO_SPOTS)
def test_k3_single_pixel_in_a_tile_halo(dev, y, x):
    """A zero canvas but one pixel just inside the edge of a tile's window:
    that tile must not take the early-out."""
    stack = torch.zeros((2, 96, 160), device=dev)
    stack[1, y, x] = 57.0
    k3_bit_equal(stack)


def test_k3_signed_zeros(dev):
    """Level 0 all +0.0; level 1 all -0.0 but for isolated +0.0 pixels 7
    apart: tiles of +0.0 only, of -0.0 only, and of both. Bit patterns, not
    values, decide the early-out. Each pixel's 16 differences share one
    sign (+0.0 around a -0.0 centre, -0.0 around an isolated +0.0 one), so
    every arc minimum and maximum is that zero in any order, and the score
    is fmaxf(-0.0, +0.0) at the isolated pixels, fmaxf(+0.0, -0.0)
    elsewhere, in the kernel and in torch alike. (Where a stencil mixes
    signed zeros, the sign of a min or max depends on the operand order,
    which torch's reductions do not fix.)"""
    stack = np.zeros((2, 96, 128), dtype=np.float32)
    stack[1] = -0.0
    stack[1, 4:92:7, 4:64:7] = 0.0
    k3_bit_equal(torch.from_numpy(stack).to(dev))


def test_k3_unaligned_canvas(dev):
    """A canvas 4 bytes past a 16-byte boundary takes the scalar loads and
    stores."""
    stack, _ = canvas(128, 256, 4, 1, True)
    flat = torch.empty(stack.numel() + 1, device=dev)
    shifted = flat[1:].view(stack.shape)
    shifted.copy_(stack.to(dev))
    k3_bit_equal(shifted)


@pytest.mark.parametrize("h,w,levels,quantize", [
    (480, 640, 8, True), (241, 319, 3, False)])
def test_k4_equals_plain(dev, h, w, levels, quantize):
    stack, shapes = canvas(h, w, levels, 2, quantize)
    stack = stack.to(dev)
    before = k4.KERNEL.launches
    got = k4.fast_cell_topk(stack, shapes)
    assert k4.KERNEL.launches == before + 1
    want = k4.fast_cell_topk_plain(stack, shapes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def k1_bit_equal(stack, shapes, border=16):
    """K1 equals its plain version bit for bit inside every level (the
    kernel leaves the canvas outside the levels' tiles unwritten)."""
    before = k1.KERNEL.launches
    got = k1.fast_score_nms(stack, shapes, border=border)
    assert k1.KERNEL.launches == before + 1
    want = k1.fast_score_nms_plain(stack, shapes, border=border)
    for l, (lh, lw) in enumerate(shapes):
        assert torch.equal(bits(got[l, :lh, :lw].contiguous()),
                           bits(want[l, :lh, :lw].contiguous())), l


def k4_bit_equal(stack, shapes, **kw):
    before = k4.KERNEL.launches
    got = k4.fast_cell_topk(stack, shapes, **kw)
    assert k4.KERNEL.launches == before + 1
    want = k4.fast_cell_topk_plain(stack, shapes, **kw)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
    return got


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_k1_k4_unaligned_canvas(dev, kernel):
    """A canvas 4 bytes past a 16-byte boundary takes the scalar window
    loads (and K1 the scalar stores)."""
    stack, shapes = canvas(128, 256, 4, 1, True)
    flat = torch.empty(stack.numel() + 1, device=dev)
    shifted = flat[1:].view(stack.shape)
    shifted.copy_(stack.to(dev))
    {"k1": k1_bit_equal, "k4": k4_bit_equal}[kernel](shifted, shapes)


def test_k4_all_zero_canvas(dev):
    """No corner anywhere: every cell, skipped or scored, gives +0.0 and
    2^30 in every slot."""
    shapes = [(100, 136), (83, 113), (69, 94)]
    vals, pos = k4_bit_equal(torch.zeros((3, 100, 136), device=dev), shapes)
    assert not bits(vals).any() and bool((pos == k4.SENTINEL).all())


def constant_patches(seed, L, H, W):
    """Few distinct values (integer scores tie everywhere) and large
    constant patches."""
    rng = np.random.default_rng(seed)
    stack = (rng.integers(0, 4, (L, H, W)) * 20.0).astype(np.float32)
    for l in range(L):
        for _ in range(4):
            y, x = rng.integers(0, H - 24), rng.integers(0, W - 24)
            dy, dx = rng.integers(8, 48, 2)
            stack[l, y:y + dy, x:x + dx] = float(rng.integers(0, 4) * 20)
    return torch.from_numpy(stack)


def test_k4_constant_patches(dev):
    shapes = pyramid_shapes(200, 300, 3, 1.2)
    k4_bit_equal(constant_patches(6, 3, 200, 300).to(dev), shapes, K=8)


@pytest.mark.parametrize("BW", [32, 128, 256])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_k4_strip_widths_and_rounds(dev, BW, K):
    stack, shapes = canvas(241, 319, 3, 4, True)
    vals, _ = k4_bit_equal(stack.to(dev), shapes, K=K, BW=BW)
    assert vals.shape[1:] == (BW // 32, K)


@pytest.mark.parametrize("border", [3, 16])
def test_k1_levels_smaller_than_a_tile(dev, border):
    shapes = [(100, 90), (20, 25), (8, 8)]
    stack = constant_patches(7, 3, 100, 90)
    stack[1:] = torch.from_numpy(
        np.random.default_rng(8).integers(0, 5, (2, 100, 90)).astype(np.float32) * 9)
    k1_bit_equal(stack.to(dev), shapes, border=border)


@pytest.mark.parametrize("wrapper", ["k3", "k4"])
def test_k3_k4_reject_bad_input(dev, wrapper):
    stack, shapes = canvas(128, 256, 4, 0, False)
    stack = stack.to(dev)
    call = {"k3": lambda s, sh: k3.fast_score_nms_rect(s),
            "k4": lambda s, sh: k4.fast_cell_topk(s, sh)}[wrapper]
    with pytest.raises(ValueError):
        call(stack.double(), shapes)
    with pytest.raises(ValueError):
        call(stack.transpose(1, 2), shapes)
    deep = stack[:1].expand(33, -1, -1).contiguous()
    with pytest.raises(ValueError):
        call(deep, shapes[:1] * 33)


def test_detect_cells_fused_on_card_matches_cpu(dev):
    stack, shapes = canvas(480, 640, 8, 3, True)
    quotas = ORBConfig().level_quotas()
    got = DetectCellsFused(shapes, quotas, device=dev)(stack.to(dev))
    want = DetectCellsFused(shapes, quotas, device="cpu")(stack)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_harris_extractor_on_card_matches_cpu(dev):
    W, H = 320, 240
    scene = SyntheticScene(n_points=400, width=W, height=H, fx=250.0, fy=250.0,
                           cx=160.0, cy=120.0)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1]))
    cfg = ORBConfig(n_features=300, n_levels=4, score_harris=True)
    fc = ORBExtractor(cfg, H, W, device="cpu")(img)
    before = (k1.KERNEL.launches, k3.KERNEL.launches)
    fg = ORBExtractor(cfg, H, W, device=dev)(img.to(dev))
    assert (k1.KERNEL.launches, k3.KERNEL.launches) == (before[0], before[1] + 1)
    same = (fg.xy.cpu() == fc.xy).all(-1).float().mean()
    assert same >= 0.98, same


def gn_fixture(N, seed, dev):
    """The outlier fixture of tests/test_solvers.py:220-234, started 2 cm
    off the true pose (as a motion-model prediction would be)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                    rng.uniform(4, 10, N)], 1).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    pc = pts + np.float32([0.1, -0.05, 0.02])
    uv = (pc[:, :2] / pc[:, 2:3]) * 500.0 + [320, 240]
    uv = (uv + rng.normal(0, 1.0, (N, 2))).astype(np.float32)
    uv[::7] += rng.normal(0, 40, uv[::7].shape).astype(np.float32)
    valid = rng.random(N) > 0.1
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 8, N))).astype(np.float32)
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.08, -0.04, 0.015])
    return [t.to(dev) for t in (T0, torch.from_numpy(pts),
                                torch.from_numpy(uv), torch.from_numpy(inv_s2),
                                torch.from_numpy(valid), torch.from_numpy(K))]


@pytest.mark.parametrize("N", [32, 37, 300, 1000, 1024, 4096, 5000])
@pytest.mark.parametrize("iters", [(4, 3, 2, 2), (10, 10, 7, 5), (0, 2, 0, 1)])
def test_k2_equals_plain(dev, N, iters):
    args = gn_fixture(N, N, dev)
    before = k2.KERNEL.launches
    T, inl, n = k2.pose_optimize(*args, iters=iters)
    assert k2.KERNEL.launches == before + 1
    Tp, inlp = k2.pose_gn_plain(*args, iters=iters)
    torch.testing.assert_close(T, Tp, atol=1e-4, rtol=0)
    assert int((inl != inlp).sum()) <= max(2, N // 100)
    assert int(n) == int(inl.sum())


@pytest.mark.parametrize("iters", [(4, 3, 2, 2), (10, 10, 7, 5), (0, 2, 0, 1)])
def test_k2_single_row(dev, iters):
    """One row: its normal equations have rank 2, so four directions of each
    step are set by the 1e-3 damping alone and carry each implementation's
    rounding divided by it; two implementations that round differently
    differ there by ~1e-2, and the pose is not compared. What one row does
    determine is compared: its inlier flag and count, a rigid pose, and the
    row's reprojection residual, which both drive to the same fit."""
    args = gn_fixture(1, 1, dev)
    before = k2.KERNEL.launches
    T, inl, n = k2.pose_optimize(*args, iters=iters)
    assert k2.KERNEL.launches == before + 1
    Tp, inlp = k2.pose_gn_plain(*args, iters=iters)
    assert torch.equal(inl, inlp) and int(n) == int(inl.sum())
    R = T[:3, :3]
    torch.testing.assert_close(R @ R.T, torch.eye(3, device=dev), atol=1e-5, rtol=0)
    assert torch.equal(T[3], torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev))
    res = [float(k2._residuals_jac(t, args[1], args[2], args[5])[0].norm())
           for t in (T, Tp)]
    assert res[0] <= res[1] + 1e-3, res


def test_k2_rejects_bad_input(dev):
    args = gn_fixture(64, 0, dev)
    bad = list(args)
    bad[2] = args[2].double()
    with pytest.raises(ValueError):
        k2.pose_optimize(*bad)
    bad = list(args)
    bad[1] = args[1][:32]
    with pytest.raises(ValueError):
        k2.pose_optimize(*bad)


def test_main_path_on_card_matches_cpu(dev):
    W, H = 320, 240
    scene = SyntheticScene(n_points=400, width=W, height=H, fx=250.0, fy=250.0,
                           cx=160.0, cy=120.0)
    poses = lateral_trajectory(4, step=0.01)
    imgs = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
    cam = CameraModel(250.0, 250.0, 160.0, 120.0, width=W, height=H)
    outs = {}
    for d in ("cpu", dev):
        ex = ORBExtractor(ORBConfig(n_features=300, n_levels=4), H, W, device=d)
        f0 = ex(imgs[0].to(d))
        state = seed_map(scene, poses[0], f0.xy, f0.desc_i32, f0.octave, f0.valid,
                         MapConfig(max_keyframes=8, max_points=1024, n_features=300,
                                   n_levels=4), device=d, n_extra=500)
        outs[str(d)] = extract_track_chunk(
            imgs[1:].to(d), ex, cam, state, torch.from_numpy(poses[0]).to(d),
            torch.eye(4, device=d), torch.from_numpy(scene.K).to(d), p_local=1024)
    (fc, _, cc), (fg, _, cg) = outs["cpu"], outs[str(dev)]
    same = (fg.xy.cpu() == fc.xy).all(-1).float().mean()
    assert same >= 0.98, same
    torch.testing.assert_close(cg.pose.cpu(), cc.pose, atol=1e-3, rtol=0)
    assert (cg.n_inliers.cpu() - cc.n_inliers).abs().max() <= 6


# --- the mapping modules: each on the card against its CPU run ---------------
# The map is the port's own after a short mapping run on the CPU (320x240,
# 300 features, 4 levels, 12 frames). Integers must be equal; floats within
# the CPU parity tests' tolerances (normals 1e-5, distance bands 1e-5
# relative, triangulated points 1e-4 of their norm, BA poses 5e-5 and points
# within bounds set from readings, see BA_REL_SEEN3).


@pytest.fixture(scope="module")
def mapped():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return mapped_system()


def mapped_system():
    """(the port's SLAMSystem after a 12-frame mapping run on the CPU, K)."""
    from orb_slam_tpu_torch.pipeline import system as slam
    from orb_slam_tpu_torch.profile_paths import start_working

    W, H, f = 320, 240, 250.0
    scene = SyntheticScene(n_points=800, width=W, height=H, fx=f, fy=f, cx=W / 2,
                           cy=H / 2)
    poses = lateral_trajectory(12, step=0.04)
    frames = torch.from_numpy(np.stack([scene.render_image(p) for p in poses]))
    cfg = slam.SlamConfig(camera=CameraModel(f, f, W / 2, H / 2, width=W, height=H),
                          orb=ORBConfig(n_features=300, n_levels=4),
                          map=MapConfig(max_keyframes=16, max_points=2048,
                                        n_features=300, n_levels=4))
    s = slam.SLAMSystem(cfg, device="cpu")
    start_working(s, scene, poses, frames)
    s.process_batch(frames[2:])
    return s, torch.from_numpy(scene.K)


def on(dev, state):
    import dataclasses
    return state.replace(**{f.name: getattr(state, f.name).to(dev)
                            for f in dataclasses.fields(state)})


def assert_states_equal(a, b):
    import dataclasses
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu()), f.name


def test_covisibility_and_observations_on_card(dev, mapped):
    from orb_slam_tpu_torch.slam_map import covisibility as cv
    from orb_slam_tpu_torch.slam_map import observations as ob

    s, _ = mapped
    c, g = s.map, on(dev, s.map)
    for fn in (cv.incidence_matrix, cv.covisibility_weights, cv.observation_counts):
        assert torch.equal(fn(g).cpu(), fn(c)), fn.__name__
    assert torch.equal(cv.local_point_mask(g, s.last_kf_slot).cpu(),
                       cv.local_point_mask(c, s.last_kf_slot))
    for a, b in zip(ob.observation_table(g), ob.observation_table(c)):
        assert torch.equal(a.cpu(), b)
    rg, rc = ob.refresh_point_stats(g), ob.refresh_point_stats(c)
    assert torch.equal(rg.pt_desc.cpu(), rc.pt_desc)
    assert torch.equal(rg.pt_ref_kf.cpu(), rc.pt_ref_kf)
    torch.testing.assert_close(rg.pt_normal.cpu(), rc.pt_normal, atol=1e-5, rtol=0)
    for name in ("pt_min_dist", "pt_max_dist"):
        torch.testing.assert_close(getattr(rg, name).cpu(), getattr(rc, name),
                                   rtol=1e-5, atol=0)


def test_mapping_kernels_on_card(dev, mapped):
    from orb_slam_tpu_torch.pipeline import mapping_kernels as mk

    s, K = mapped
    c, g = s.map, on(dev, s.map)
    live = torch.nonzero(c.kf_valid)[:, 0].tolist()
    a, b = live[-1], live[-2]
    tc = mk.triangulate_new_points(c, a, b, K)
    tg = mk.triangulate_new_points(g, a, b, K.to(dev))
    assert torch.equal(tg.valid.cpu(), tc.valid) and torch.equal(tg.feat_b.cpu(), tc.feat_b)
    v = tc.valid
    rel = (tg.pos.cpu()[v] - tc.pos[v]).norm(dim=-1) / tc.pos[v].norm(dim=-1)
    assert rel.numel() == 0 or float(rel.max()) < 1e-4
    free = torch.nonzero(~c.pt_valid)[:64, 0].to(torch.int32)
    mc, nc = mk.insert_new_points(c, a, b, tc, free)
    mg, ng = mk.insert_new_points(g, a, b, tc._replace(
        **{k: getattr(tc, k).to(dev) for k in tc._fields}), free.to(dev))
    assert int(ng) == int(nc)
    assert_states_equal(mg, mc)
    for src, dst in ((a, b), (b, a)):
        oc = mk.fuse_into_keyframe(c, src, dst, K, width=320, height=240, n_levels=4)
        og = mk.fuse_into_keyframe(g, src, dst, K.to(dev), width=320, height=240,
                                   n_levels=4)
        assert_states_equal(og[0], oc[0])
        assert [int(x) for x in og[1:3]] == [int(x) for x in oc[1:3]]
        assert torch.equal(og[3].cpu(), oc[3])
    for x, y in zip(mk.point_cull_stats(g, 9), mk.point_cull_stats(c, 9)):
        assert torch.equal(x.cpu(), y)
    for kf in live:
        assert [float(x) for x in mk.keyframe_redundancy(g, kf)] == [
            float(x) for x in mk.keyframe_redundancy(c, kf)]


def ba_card_vs_cpu(dev, s, K, pt_opt):
    """One bundle_adjust of the mapped map (max_opt_cams 16, max_opt_pts
    1024) on the CPU and on the card with the points pt_opt: ({device:
    (state, outlier, table, iterations)}, readings), the readings the
    largest pose difference and, over the points, the largest difference
    over the point's distance (at least 1)."""
    from orb_slam_tpu_torch.solvers import local_ba as ba

    c = s.map
    cam_opt = c.kf_valid.clone()
    order = np.where(s.kf_order >= 0, s.kf_order, 10**9)
    cam_opt[torch.from_numpy(np.argsort(order)[:2].copy())] = False
    out = {}
    for d in ("cpu", str(dev)):
        its = []
        out[d] = ba.bundle_adjust(on(d, c), K.to(d), cam_opt.to(d), pt_opt.to(d),
                                  max_opt_cams=16, max_opt_pts=1024,
                                  iterations=its) + (its,)
    sc, sg = out["cpu"][0], out[str(dev)][0]
    d = (sg.pt_pos.cpu() - sc.pt_pos)[pt_opt].abs().amax(1)
    return out, dict(
        pose=float((sg.kf_pose.cpu() - sc.kf_pose).abs().max()),
        rel=float((d / sc.pt_pos[pt_opt].norm(dim=1).clamp(min=1.0)).max()))


# The map is metric, its points 2 to 146 m out, where the CPU tests' maps
# have unit scale, so a point's difference is taken over its distance (the
# absolute 5e-4 of the CPU tests failed at 5.32e-4 on a point 17 m out).
# Readings on an NVIDIA H100 80GB HBM3 (the __main__ block below, under this
# directory's SLAM_OBS_CAP=16): with the points seen by 3+ keyframes, poses
# 2.39e-7 and points 2.81e-5 of their distance; with every live point, as
# the mapping path optimizes them, poses 8.87e-5 and points 2.17e-4, after
# the same LM iterations on both devices: the steps pass through the
# ill-conditioned 3x3 blocks of the points seen once, whose rounding also
# separates one JAX and one port step on the CPU by 3.0e-4
# (tests/test_torch_local_ba.py). Each bound sits just above its reading;
# the every-point case's pose bound is looser than the CPU tests' 5e-5.
BA_REL_SEEN3 = 3.5e-5
BA_POSE_ALL, BA_REL_ALL = 1e-4, 2.5e-4


def test_bundle_adjust_on_card(dev, mapped):
    from orb_slam_tpu_torch.slam_map.map_state import remove_keyframe, remove_points
    from orb_slam_tpu_torch.slam_map.observations import observation_table
    from orb_slam_tpu_torch.solvers import local_ba as ba

    s, K = mapped
    c = s.map
    pt_opt = c.pt_valid & (observation_table(c)[2].sum(1) >= 3)
    out, r = ba_card_vs_cpu(dev, s, K, pt_opt)
    (sc, oc, tc, ic), (sg, og, tg, ig) = out["cpu"], out[str(dev)]
    assert r["pose"] <= 5e-5 and r["rel"] <= BA_REL_SEEN3, r
    assert torch.equal(og.cpu(), oc) and ig == ic
    assert all(torch.equal(x.cpu(), y) for x, y in zip(tg, tc))
    for kill in (True, False):
        a = ba.apply_edge_outliers(on(dev, c), og, *tg, kill_starved=kill)
        b = ba.apply_edge_outliers(c, oc, *tc, kill_starved=kill)
        assert torch.equal(a.kf_obs.cpu(), b.kf_obs)
        assert torch.equal(a.pt_valid.cpu(), b.pt_valid)
    mask = torch.from_numpy(np.random.default_rng(0).random(c.pt_valid.shape[0]) < 0.2)
    assert_states_equal(remove_keyframe(remove_points(on(dev, c), mask.to(dev)), 1),
                        remove_keyframe(remove_points(c, mask), 1))


def test_bundle_adjust_every_point_on_card(dev, mapped):
    s, K = mapped
    out, r = ba_card_vs_cpu(dev, s, K, s.map.pt_valid)
    assert r["pose"] <= BA_POSE_ALL and r["rel"] <= BA_REL_ALL, r
    assert torch.equal(out[str(dev)][1].cpu(), out["cpu"][1])


if __name__ == "__main__":
    # The readings the BA bounds above rest on, under the observation cap
    # tests/conftest.py sets:
    #   SLAM_OBS_CAP=16 PYTHONPATH=. python3 tests/test_torch_cuda.py
    from orb_slam_tpu_torch.slam_map.observations import OBS_CAP, observation_table

    assert OBS_CAP == 16, "run with SLAM_OBS_CAP=16, as the tests run"
    s, K = mapped_system()
    c = s.map
    n_obs = observation_table(c)[2].sum(1)
    for name, pts in (("seen by 3+ keyframes", c.pt_valid & (n_obs >= 3)),
                      ("every live point", c.pt_valid)):
        out, r = ba_card_vs_cpu(torch.device("cuda", 0), s, K, pts)
        print(f"bundle_adjust card vs CPU, {int(pts.sum())} points {name}: "
              f"poses {r['pose']:.3g}, points {r['rel']:.3g} of their distance; "
              f"outliers equal {torch.equal(out['cuda:0'][1].cpu(), out['cpu'][1])}; "
              f"LM iterations CPU {out['cpu'][3]}, card {out['cuda:0'][3]}")
