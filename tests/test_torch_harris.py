"""The Harris-scored (nScoreType=0) extraction against the JAX package:
kernel K3's module, the Harris response, the XLA-route detector, the
stacked extractor with `score_harris=True` and the Harris chunk.

Tolerances and why:
- `fast_score_map`, `nms3x3`, `harris_score_map` and K3's plain version
  are exact: min/max of exactly rounded differences, and the Harris sums
  run in the XLA order (Sobel six-term sums, the 7x7 window summed
  row-major from 0), which matches reduce_window on the CPU bit for bit;
- `detect_keypoints_stack` on the same canvas: exact (xy, score, valid)
  for FAST and for Harris;
- the extractor with Harris ranking: level 0 is exact (the canvas is the
  image and every step after it is exact); on levels >= 1 the pyramid's
  f32 sums run in another order (tests/test_torch_fast.py::
  test_pyramid_stack) and the shifted Harris scores sit near 21, where f32
  spacing is ~2e-6, so many are ties broken by index. At least 98% of
  those keypoints must be identical and their responses agree to 1e-5
  (measured: 100% at 320x240);
- the Harris chunk holds test_torch_slice.py's bounds for the FAST one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.frontend.orb_extractor import ORBConfig as JaxConfig
from orb_slam_tpu.frontend.orb_extractor import ORBExtractor as JaxExtractor
from orb_slam_tpu.frontend.orb_extractor import _extract_stacked
from orb_slam_tpu.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu.ops import fast as jfast
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu.ops.pallas_fast import fast_score_nms_pallas
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.ops import fast as tfast
from orb_slam_tpu_torch.ops import fast_stack as tfs
from orb_slam_tpu_torch.ops.fast_score_rect import (
    fast_score_nms_rect, fast_score_nms_rect_plain,
)

W, H, NF, L = 320, 240, 300, 4


def textured(rng, h=128, w=256):
    img = rng.uniform(30, 70, (h, w)).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(8, h - 8), rng.integers(8, w - 8)
        s = int(rng.integers(2, 6))
        img[y - s:y + s, x - s:x + s] = float(rng.uniform(100, 255))
    return img


def rendered(quantize, seed=0, step=0.05):
    scene = SyntheticScene(n_points=400, width=W, height=H, fx=250.0, fy=250.0,
                           cx=160.0, cy=120.0, seed=seed)
    return scene.render_image(lateral_trajectory(3, step=step)[2],
                              quantize=quantize)


def jax_stack(img, levels=L):
    stack, shapes = jfs.build_pyramid_stack(jnp.asarray(img), levels, 1.2)
    return np.array(stack), tuple(tuple(s) for s in shapes)


IMAGES = {
    "textured": lambda: textured(np.random.default_rng(0)),
    "rendered": lambda: rendered(False),
    "quantized": lambda: rendered(True),
}


@pytest.mark.parametrize("kind", list(IMAGES))
def test_harris_score_map_matches_jax(kind):
    img = IMAGES[kind]()
    want = np.asarray(jfast.harris_score_map(jnp.asarray(img)))
    got = tfast.harris_score_map(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_harris_batched_matches_vmap():
    stack, _ = jax_stack(rendered(False))
    want = np.asarray(jax.vmap(jfast.harris_score_map)(jnp.asarray(stack)))
    got = tfast.harris_score_map(torch.from_numpy(stack)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(IMAGES))
def test_fast_score_map_and_nms_match_jax(kind):
    img = IMAGES[kind]()
    score = tfast.fast_score_map(torch.from_numpy(img))
    want = jfast.fast_score_map(jnp.asarray(img))
    np.testing.assert_array_equal(score.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfast.nms3x3(score).numpy(),
                                  np.asarray(jfast.nms3x3(want)))


@pytest.mark.parametrize("kind", list(IMAGES))
def test_plain_k3_matches_pallas_interpret(kind):
    """The whole canvas, padding and canvas edge included."""
    stack, _ = jax_stack(IMAGES[kind]())
    want_s, want_k = fast_score_nms_pallas(jnp.asarray(stack), interpret=True)
    got_s, got_k = fast_score_nms_rect_plain(torch.from_numpy(stack))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


def test_k3_wrapper_runs_plain_on_cpu():
    stack, _ = jax_stack(textured(np.random.default_rng(3)), 3)
    t = torch.from_numpy(stack)
    for a, b in zip(fast_score_nms_rect(t), fast_score_nms_rect_plain(t)):
        assert torch.equal(a, b)


def detect_both(stack, shapes, quotas, use_harris):
    sel = tfs.KeypointSelector(shapes, quotas, device="cpu")
    got = tfs.detect_keypoints_stack(torch.from_numpy(stack), sel,
                                     use_harris=use_harris)
    want = jfs.detect_keypoints_stack(jnp.asarray(stack), shapes, quotas,
                                      use_harris=use_harris)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("use_harris", [False, True])
@pytest.mark.parametrize("kind", list(IMAGES))
def test_detect_keypoints_stack_matches_jax(kind, use_harris):
    stack, shapes = jax_stack(IMAGES[kind]())
    (gxy, gs, gv), (wxy, ws, wv) = detect_both(stack, shapes, (120, 80, 60, 40),
                                               use_harris)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gxy, wxy)
    np.testing.assert_array_equal(gs, ws)


def test_packed_and_stack_detectors_agree():
    """K1's route and K3's route select the same keypoints for FAST."""
    stack, shapes = jax_stack(rendered(True))
    sel = tfs.KeypointSelector(shapes, (120, 80, 60, 40), device="cpu")
    a = tfs.detect_keypoints_packed(torch.from_numpy(stack), sel)
    b = tfs.detect_keypoints_stack(torch.from_numpy(stack), sel)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def extract_both(img):
    jc = JaxConfig(n_features=NF, n_levels=L, score_harris=True)
    consts = JaxExtractor(jc, use_pallas=False).pyramid_consts((H, W))
    fj = jax.jit(lambda im, c: _extract_stacked(im, c, config=jc,
                                                use_pallas=False))(
        jnp.asarray(img), consts)
    ex = ORBExtractor(ORBConfig(n_features=NF, n_levels=L, score_harris=True),
                      H, W, device="cpu")
    return fj, ex(torch.from_numpy(img))


@pytest.mark.parametrize("kind", ["rendered", "quantized"])
def test_harris_extractor_matches_jax(kind):
    img = rendered(kind == "quantized")
    fj, ft = extract_both(img)
    octave = np.asarray(fj.octave)
    np.testing.assert_array_equal(ft.octave.numpy(), octave)
    xy_j, xy_t = np.asarray(fj.xy), ft.xy.numpy()
    desc_j = np.asarray(fj.desc_u32).view(np.int32)
    l0 = octave == 0
    np.testing.assert_array_equal(xy_t[l0], xy_j[l0])
    np.testing.assert_array_equal(ft.response.numpy()[l0], np.asarray(fj.response)[l0])
    np.testing.assert_array_equal(ft.desc_i32.numpy()[l0], desc_j[l0])
    up = ~l0
    same = np.all(xy_t[up] == xy_j[up], 1) & (ft.valid.numpy()[up]
                                              == np.asarray(fj.valid)[up])
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(ft.response.numpy()[up][same],
                               np.asarray(fj.response)[up][same], rtol=1e-5)
    assert int(ft.valid.sum()) > 0.8 * NF


def test_harris_ranking_differs_from_fast():
    """The Harris route really ranks by Harris: its responses sit above
    th_ini + 1 and its selection is not the FAST one."""
    img = rendered(False)
    _, fh = extract_both(img)
    ff = ORBExtractor(ORBConfig(n_features=NF, n_levels=L), H, W,
                      device="cpu")(torch.from_numpy(img))
    assert float(fh.response[fh.valid].min()) > 21.0
    assert not torch.equal(fh.xy, ff.xy)


def test_harris_chunk_matches_jax():
    """The Harris path through the chunk: test_torch_slice's FAST check,
    with the extractor built from nScoreType=0."""
    import test_torch_slice as ts

    jscene, tscene = ts.scenes(ts.DIST["pinhole"])
    poses = ts.tsyn.lateral_trajectory(ts.B + 1, step=0.01)
    jcam, cam = jscene.camera_model(), tscene.camera_model()
    cfg = ORBConfig(n_features=NF, n_levels=L, score_harris=True)
    extractor = ORBExtractor(cfg, H, W, device="cpu")
    m, state = ts.build_maps(tscene, poses[0], extractor)
    imgs = np.stack([tscene.render_image(p) for p in poses[1:]])
    fj, xyj, (pj, obsj, nij, nmj, visj) = ts.jax_chunk(
        imgs, m, jcam, jnp.asarray(jscene.K), poses[0], score_harris=True)
    ft, xyt, ct = ts.extract_track_chunk(
        torch.from_numpy(imgs), extractor, cam, state,
        torch.from_numpy(poses[0]), torch.eye(4), torch.from_numpy(tscene.K),
        p_local=ts.P, radius=15.0, min_inliers=30, use_motion_model=True,
        max_dist=100)
    ts.check_chunk(fj, xyj, pj, nij, nmj, visj, ft, xyt, ct, poses)
