"""The CUDA kernels against their plain versions at more shapes than the
main path's, and the port's main path on the card against itself on the
CPU. Needs a CUDA device and nvcc; skipped without a card. On the GPU
machine: `python -m pytest tests/test_torch_cuda.py -q -m cuda`.

Tolerances: K1, K3, K4 and K5 are bit-exact (min/max of exact
differences, exact top-K, compares only; the tests that compare bit
patterns tell -0.0 from +0.0);
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

import chip_smoke

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


@pytest.mark.parametrize("table", chip_smoke.K5_TABLES, ids=lambda t: t[0])
def test_k5_equals_plain(dev, table):
    """chip_smoke.check_k5's comparisons at one table: K5 bit-equal to the
    plain selector (xy, score, valid) on the main path's canvas after K1,
    the Harris path's at 640x480 and the adversarial canvases, one launch
    per selection."""
    cases = chip_smoke.k5_cases(dev, tables=[table])
    assert len(cases) >= 5
    for name, sel, canvas in cases:
        bad, launches = chip_smoke.k5_compare(sel, canvas)
        assert not bad and launches == 1, (name, bad, launches)


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


# --- initialisation and the tracking ladder: the card against the CPU ------
# initialize_two_view from the same matches and minimal sets: cuSOLVER and
# LAPACK round differently, so R within 1e-3, the unit t within 1e-2 and
# is_triangulated agreeing on >= 99% of rows (chip_smoke.py's bounds; on the
# CPU the port and JAX read R 3.2e-6 and t 1.2e-5 on the translation scene).
# track_prev_frame: matching is exact, K2 against the plain GN holds its
# pose to 1e-4, so the pose within 1e-4 and counts within max(2, 1%).

TWO_VIEW_K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def two_view_scene(kind, seed=42):
    """(x1, x2, valid) of tests/test_solvers.py's translation and planar
    scenes, in numpy."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n = 300
    z = np.full(n, 6.0) if kind == "planar" else rng.uniform(4.0, 10.0, n)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), z], 1)
    rv, t = (([0.0, -0.04, 0.0], [-0.6, 0.0, 0.1]) if kind == "planar"
             else ([0.02, -0.05, 0.01], [-0.8, 0.1, 0.05]))
    R = Rotation.from_rotvec(rv).as_matrix()

    def project(P):
        uv = P[:, :2] / P[:, 2:3] * 500.0 + [320, 240]
        return (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)

    return project(pts), project(pts @ R.T + t), np.ones(n, bool)


def two_view_both(dev, x1, x2, valid, seed=0):
    from orb_slam_tpu_torch.solvers import two_view as tv

    cpu = [torch.from_numpy(a) for a in (x1, x2, valid, TWO_VIEW_K)]
    idx = tv.sample_minimal_sets(cpu[2], 200, 8,
                                 generator=torch.Generator().manual_seed(seed))
    c = tv.initialize_two_view(*cpu, idx=idx)
    g = tv.initialize_two_view(*(a.to(dev) for a in cpu), idx=idx.to(dev))
    return c, g


@pytest.mark.parametrize("kind", ["translation", "planar"])
def test_initialize_two_view_on_card_matches_cpu(dev, kind):
    c, g = two_view_both(dev, *two_view_scene(kind))
    assert bool(c.success) and bool(g.success)
    assert bool(g.used_homography) == bool(c.used_homography) == (kind == "planar")
    assert float((g.R21.cpu() - c.R21).abs().max()) < 1e-3
    assert float((g.t21.cpu() - c.t21).abs().max()) < 1e-2
    assert (g.is_triangulated.cpu() == c.is_triangulated).float().mean() >= 0.99


@pytest.mark.parametrize("case", ["too_few", "all_invalid", "identical"])
def test_two_view_degenerate_inputs_on_card(dev, case):
    from orb_slam_tpu_torch.solvers import two_view as tv

    rng = np.random.default_rng(42)
    x1 = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    valid = np.zeros(64, bool)
    if case == "too_few":
        valid[:5] = True
    elif case == "identical":           # no parallax, every H is the identity
        x2, valid = x1.copy(), np.ones(64, bool)
    c, g = two_view_both(dev, x1, x2, valid)
    torch.cuda.synchronize()
    assert not bool(g.success) and not bool(c.success)
    assert torch.isfinite(g.R21).all()
    H = torch.zeros((2, 3, 3), device=dev)
    H[1] = torch.eye(3, device=dev)
    s, inl = tv._score_h(H, torch.from_numpy(x1).to(dev), torch.from_numpy(x1).to(dev),
                         torch.ones(64, dtype=torch.bool, device=dev))
    assert float(s[0]) == 0.0 and not bool(inl[0].any()) and float(s[1]) > 0


def test_track_prev_frame_on_card_matches_cpu(dev, mapped):
    from orb_slam_tpu_torch.pipeline.track_kernels import track_prev_frame

    s, K = mapped
    W, H, f = 320, 240, 250.0
    scene = SyntheticScene(n_points=800, width=W, height=H, fx=f, fy=f, cx=W / 2,
                           cy=H / 2)
    cur = s.extractor(torch.from_numpy(scene.render_image(
        lateral_trajectory(13, step=0.04)[12])))
    pf, pobs = s._prev_frame
    args = [pf.xy, pf.desc, pf.octave, pf.angle, pobs, cur.xy, cur.desc_i32,
            cur.octave, cur.angle, cur.valid, torch.from_numpy(s.last_pose), K]
    kw = dict(width=W, height=H, scale_factor=1.2, n_levels=4)
    for coarse in (0, 2):
        Tc, nc, mc = track_prev_frame(s.map, *args, coarse, **kw)
        k2.KERNEL.launches = 0
        Tg, ng, mg = track_prev_frame(on(dev, s.map), *(a.to(dev) for a in args),
                                      coarse, **kw)
        assert k2.KERNEL.launches == 2
        assert float((Tg.cpu() - Tc).abs().max()) < 1e-4
        assert abs(int(ng) - int(nc)) <= max(2, int(nc) // 100)
        assert abs(int(mg) - int(mc)) <= max(2, int(mc) // 100) and int(mc) > 30


def test_init_to_working_on_card(dev):
    from orb_slam_tpu_torch.pipeline import system as slam

    W, H = 320, 240
    scene = SyntheticScene(n_points=220, seed=23, width=W, height=H, fx=260.0,
                           fy=260.0, cx=160.0, cy=120.0, extent=(7.0, 5.0, 3.0),
                           depth_range=(5.5, 8.5))
    poses = lateral_trajectory(6, step=0.12)
    frames = torch.from_numpy(np.stack([scene.render_image(p, patch=5)
                                        for p in poses])).to(dev)
    cfg = slam.SlamConfig(
        camera=CameraModel(260.0, 260.0, 160.0, 120.0, width=W, height=H),
        orb=ORBConfig(n_features=400, n_levels=4),
        map=MapConfig(max_keyframes=16, max_points=1024, n_features=400, n_levels=4),
        p_local=512, n_triangulation_neighbors=2, n_fuse_neighbors=2,
        local_ba_window=4, enable_loop_closing=False, enable_relocalisation=False,
        min_init_matches=60, min_init_keypoints=60)
    s = slam.SLAMSystem(cfg, device=dev)
    k1.KERNEL.launches = k2.KERNEL.launches = 0
    out = s.process_batch(frames)
    torch.cuda.synchronize()
    assert s.state == slam.WORKING and out[0] is None
    tracked = [p for p in out if p is not None]
    assert len(tracked) >= 4 and all(np.isfinite(p).all() for p in tracked)
    assert s.n_points > 50 and s.map.pt_pos.is_cuda
    assert k1.KERNEL.launches >= len(frames) and k2.KERNEL.launches >= len(tracked) - 1


@pytest.fixture(scope="module")
def shipped_vocabulary():
    from orb_slam_tpu_torch.place.pretrained import load_pretrained

    return load_pretrained()


def _descs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    valid = rng.random(n) > 0.1
    return torch.from_numpy(d), torch.from_numpy(valid)


@pytest.mark.parametrize("n", [1, 1000, 4000])
def test_transform_and_bow_on_card_match_cpu(dev, shipped_vocabulary, n):
    """Words, node ids and BoW ids equal; BoW weights within 1e-6."""
    from orb_slam_tpu_torch.place.vocabulary import bow_vector, transform

    voc = shipped_vocabulary
    d, v = _descs(n, n)
    out = {}
    for device in (dev, torch.device("cpu")):
        words, nodes = transform(voc, d.to(device), v.to(device))
        ids, w = bow_vector(words, voc.device_arrays(device)[3], n_slots=1000)
        out[device.type] = [t.cpu() for t in (words, nodes, ids, w)]
    g, c = out["cuda"], out["cpu"]
    for a, b in zip(g[:3], c[:3]):
        assert torch.equal(a, b)
    assert float((g[3] - c[3]).abs().max()) <= 1e-6


def test_database_scores_on_card_match_cpu(dev, shipped_vocabulary):
    """A 64-row database filled on the card and on the CPU: scores within
    1e-6, shared words and both candidate lists equal."""
    from orb_slam_tpu_torch.place import KeyFrameDatabase

    rng = np.random.default_rng(3)
    dbs = {d.type: KeyFrameDatabase(shipped_vocabulary, 64, 500, device=d)
           for d in (dev, torch.device("cpu"))}
    base = [_descs(500, s) for s in range(20)]
    for row in range(40):
        d, v = base[row % 20]
        if row >= 20:                              # re-observations
            d = d ^ torch.from_numpy(rng.integers(0, 2, d.shape).astype(np.int32) << 3)
        for db in dbs.values():
            db.add(row, *db.compute_bow(d.to(db.device), v.to(db.device))[:2])
    for db in dbs.values():
        db.erase(7)
    covis = rng.integers(0, 40, (64, 64)) * (rng.random((64, 64)) < 0.2)
    covis = (np.triu(covis, 1) + np.triu(covis, 1).T).astype(np.int32)
    q, qv = base[4]
    got = {}
    for k, db in dbs.items():
        ids, w, _ = db.compute_bow(q.to(db.device), qv.to(db.device))
        got[k] = (db.scores_against_all(ids, w), db.shared_words_against_all(ids),
                  db.detect_relocalisation_candidates(ids, w, covis),
                  db.detect_loop_candidates(ids, w, 4, [24], 0.01, covis))
    g, c = got["cuda"], got["cpu"]
    assert np.abs(g[0] - c[0]).max() <= 1e-6
    np.testing.assert_array_equal(g[1], c[1])
    assert g[2] == c[2] and len(g[2]) > 0 and g[3] == c[3]


def test_epnp_ransac_on_card(dev):
    """1000 rows, 128 four- and six-point sets drawn once: the card and the
    CPU find inlier counts within 1%, flags equal on >= 99% of rows, and
    poses refined by pose_optimize on the inliers within 1e-3 (the winner
    among equally good hypotheses is decided by each device's eigensolver:
    the control points' PCA signs, and a four-point set's null-space
    basis; see solvers/epnp.py). Nothing raises on a set of equal
    points."""
    from orb_slam_tpu_torch.solvers import epnp
    from orb_slam_tpu_torch.solvers.pose_opt import pose_optimize
    from orb_slam_tpu_torch.solvers.two_view import sample_minimal_sets

    rng = np.random.default_rng(1000)
    n = 1000
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 10, n)], 1).astype(np.float32)
    t = np.array([0.5, -0.3, 1.0], np.float32)
    uv = (pw[:, :2] + t[:2]) / (pw[:, 2:3] + t[2]) * 500.0 + [320, 240]
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:300] += rng.uniform(30, 100, (300, 2)).astype(np.float32)
    valid = torch.from_numpy(rng.random(n) > 0.05)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    args = [torch.from_numpy(pw), torch.from_numpy(uv), valid, torch.ones(n), K]
    for min_set in (4, 6):
        idx = sample_minimal_sets(valid, 128, min_set,
                                  generator=torch.Generator().manual_seed(min_set))
        res = {}
        for d in (dev, torch.device("cpu")):
            a = [x.to(d) for x in args]
            R, t_, inl, n_in = epnp.epnp_ransac(*a, idx=idx.to(d), min_set=min_set)
            T0 = torch.eye(4, device=d)
            T0[:3, :3], T0[:3, 3] = R, t_
            T_ref = pose_optimize(T0, a[0], a[1], a[3], inl, a[4])[0]
            res[d.type] = [o.cpu() for o in (inl, n_in, T_ref)]
        g, c = res["cuda"], res["cpu"]
        assert abs(int(g[1]) - int(c[1])) <= 0.01 * int(c[1]) and int(c[1]) > 600
        assert float((g[0] == c[0]).float().mean()) >= 0.99
        assert float((g[2] - c[2]).abs().max()) <= 1e-3
    same = [a.to(dev) for a in args]
    same[0] = torch.zeros_like(same[0])
    out = epnp.epnp_ransac(*same, idx=idx.to(dev))
    torch.cuda.synchronize()
    assert int(out[3]) >= 0


# -- loop closing: the Sim3 solvers, the essential graph, the loop fuse and
# one whole LoopCloser.process, card against CPU

def sim3_rows(n=1000, seed=7, s_true=1.3):
    """Matched camera-frame points of two keyframes related by a Sim3,
    a fifth of the rows outliers, and their level variances."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 8, n)], 1).astype(np.float32)
    R = Rotation.from_rotvec([0.05, 0.3, -0.1]).as_matrix().astype(np.float32)
    t = np.array([0.4, -0.2, 0.5], np.float32)
    p2 = ((p1 - t) / s_true) @ R
    proj = lambda p: (p[:, :2] / p[:, 2:3]) * 500.0 + [320, 240]
    uv1 = (proj(p1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (proj(p2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    p2[: n // 5] += rng.uniform(1, 3, (n // 5, 3))
    s2 = (1.2 ** (2 * rng.integers(0, 4, (2, n)))).astype(np.float32)
    T = torch.from_numpy
    return [T(p1), T(p2.astype(np.float32)), T(uv1), T(uv2),
            T(rng.random(n) > 0.05), T(s2[0]), T(s2[1])]


K500 = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


def test_sim3_ransac_and_optimize_on_card_match_cpu(dev):
    """sim3_ransac on the same 300 sets: s, R, t within 1e-4 and the
    inlier flags equal on >= 99.5% of rows (Horn's eigh and the f32
    reprojection gates round differently); optimize_sim3 from the CPU's
    estimate, with and without fix_scale: within 1e-4, inliers within
    0.5%."""
    from orb_slam_tpu_torch.solvers import sim3
    from orb_slam_tpu_torch.solvers.two_view import sample_minimal_sets

    rows = sim3_rows()
    idx = sample_minimal_sets(rows[4], 300, 3, generator=torch.Generator().manual_seed(3))
    c = sim3.sim3_ransac(*rows, K500, idx=idx)
    g = sim3.sim3_ransac(*(x.to(dev) for x in rows), K500.to(dev), idx=idx.to(dev))
    for a, b in zip(g[:3], c[:3]):
        assert float((a.cpu() - b).abs().max()) <= 1e-4
    assert float((g[3].cpu() == c[3]).float().mean()) >= 0.995 and int(c[4]) > 600
    for fix in (False, True):
        inv = [1.0 / rows[5], 1.0 / rows[6]]
        args = list(c[:3]) + rows[:5] + inv + [K500]
        oc = sim3.optimize_sim3(*args, fix_scale=fix)
        og = sim3.optimize_sim3(*(x.to(dev) for x in args), fix_scale=fix)
        for a, b in zip(og[:3], oc[:3]):
            assert float((a.cpu() - b).abs().max()) <= 1e-4
        assert abs(int(og[4]) - int(oc[4])) <= 0.005 * int(oc[4])


@pytest.mark.parametrize("K,solver", [(256, "dense"), (1024, "cg")])
def test_essential_graph_on_card_matches_cpu_and_repeats(dev, K, solver):
    """Dense at 256 keyframe slots and PCG at 1024: s, R, t within 1e-4
    plus 1e-4 of their size of the CPU's (100 f32 CG steps over 7168
    unknowns summed in another order: t, of size ~4, moved by 1.39e-4 on
    an H100), and two card runs bit-equal (the sorted scatter-adds)."""
    from orb_slam_tpu_torch.profile_paths import chain_pose_graph
    from orb_slam_tpu_torch.solvers.essential_graph import optimize_essential_graph

    args = chain_pose_graph(K)
    c = optimize_essential_graph(*args, iters=15, solver=solver)
    on_dev = [x.to(dev) for x in args]
    g1 = optimize_essential_graph(*on_dev, iters=15, solver=solver)
    g2 = optimize_essential_graph(*on_dev, iters=15, solver=solver)
    for a, b, d in zip(g1, c, g2):
        assert torch.equal(a, d)
        assert float(((a.cpu() - b).abs() - 1e-4 * b.abs()).max()) <= 1e-4


def test_fuse_points_into_keyframes_on_card(dev, mapped):
    """Every live point into every live keyframe: kf_obs, validity, the
    counters and the remap equal on the card and the CPU."""
    from orb_slam_tpu_torch.pipeline import mapping_kernels as mk

    s, K = mapped
    c, g = s.map, on(dev, s.map)
    live = torch.nonzero(c.kf_valid)[:, 0].tolist()
    kw = dict(width=320, height=240, n_levels=4)
    mc, rc = mk.fuse_points_into_keyframes(c, c.pt_valid, live + [-1], K, **kw)
    mg, rg = mk.fuse_points_into_keyframes(g, g.pt_valid, live + [-1], K.to(dev), **kw)
    assert_states_equal(mg, mc)
    assert torch.equal(rg.cpu(), rc)


def yaw_pose(yaw, C):
    """tests/test_loop_reloc_e2e.py::yaw_pose in numpy."""
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.asarray(C, np.float32)
    return T


@pytest.fixture(scope="module")
def loop_state():
    """The port on the CPU over the oracle ring of
    tests/test_loop_reloc_e2e.py:118-151 (the drift injected at frame 60),
    saved just before its first accepted loop-closing pass, with that
    pass's minimal sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from orb_slam_tpu_torch import profile_paths as pp
    from orb_slam_tpu_torch.pipeline import system as slam

    scene = SyntheticScene(n_points=1500, seed=5, extent=(0, 4.0, 0),
                           depth_range=(7.0, 13.0), ring=True)
    cfg = slam.SlamConfig(
        camera=CameraModel(scene.fx, scene.fy, scene.cx, scene.cy,
                           width=scene.width, height=scene.height),
        map=MapConfig(max_keyframes=32, max_points=2048, n_features=250),
        p_local=512, n_triangulation_neighbors=3, n_fuse_neighbors=2,
        local_ba_window=6, orb=None, enable_relocalisation=False,
        max_frames_between_kf=6, min_frames_between_kf=4, kf_tracked_ratio=1.5,
        track_radius=25.0)
    s = slam.SLAMSystem(cfg, device="cpu")
    saved = {}
    run = s._run_loop_closing

    def watched(slot):
        snap = pp.loop_snapshot(s)
        sets, draw = [], s.loop_closer._sim3_sets

        def recorded(valid):
            sets.append(draw(valid))
            return sets[-1]

        s.loop_closer._sim3_sets = recorded
        n = s.n_loops_closed
        run(slot)
        s.loop_closer._sim3_sets = draw
        if s.n_loops_closed > n and not saved:
            saved.update(snap=snap, sets=sets, slot=slot)

    s._run_loop_closing = watched
    poses = [yaw_pose(0.0, [-0.5 + 0.0625 * i, 0, 0]) for i in range(8)]
    poses += [yaw_pose(2 * np.pi * i / 96, [3 * np.sin(2 * np.pi * i / 96), 0,
                                            3 * (np.cos(2 * np.pi * i / 96) - 1)])
              for i in range(116)]
    for fi, T in enumerate(poses):
        s.process(features=scene.observe(T, n_slots=250, pix_noise=0.4))
        if fi == 60:
            pp.inject_drift(s, 1.15, [0.4, 0.0, 0.2])
        if saved:
            break
    assert saved, "no loop closed on the CPU"
    return saved


def test_loop_closer_process_on_card_matches_cpu(dev, loop_state):
    """One LoopCloser pass from the saved state on the card and the CPU
    with the same sets: the same decision and candidate, S12 within 1e-4,
    the corrected keyframe poses within 1e-3, loop_edges equal."""
    from orb_slam_tpu_torch import profile_paths as pp

    res = {}
    for d in (dev, torch.device("cpu")):
        s, hit, _ = pp.loop_replay(loop_state, d)
        res[d.type] = (s.n_loops_closed, hit, s.map.kf_pose.cpu(),
                       s.map.loop_edges.cpu(), s.map.kf_valid.cpu())
    g, c = res["cuda"], res["cpu"]
    assert g[0] == c[0] and g[1]["cand"] == c[1]["cand"]
    for a, b in zip(g[1]["S12"], c[1]["S12"]):
        assert float((a - b).abs().max()) <= 1e-4
    live = c[4]
    assert float((g[2][live] - c[2][live]).abs().max()) <= 1e-3
    assert torch.equal(g[3], c[3])
