"""Kernel K5's module (ops/keypoint_select.py) on the CPU.

- K5's launch table, built in Python, agrees with KeypointSelector's
  grids, k_tots and quotas at the three frame sizes of chip_smoke.py's
  K5_TABLES, and its shared memory fits.
- The wrapper raises before any launch (nothing built, no launch counted)
  on a table whose shared memory does not fit and on what the kernel does
  not take; a CPU canvas runs the plain selector and launches nothing.
- The plain selector equals the JAX package's `_select_from_masked` on
  chip_smoke.k5_adversarial's canvases (all zero, ties everywhere, the
  th_min fallback, texture-skewed cells) and on a canvas with one level
  all zero.
- A numpy mirror of K5's two launches (per-cell sorted lists cut by a
  radix select of 8 bits a pass, the redistribution run to its fixed
  point, retainBest by (score, pool position), then the pool's zeros in
  pool order) equals the plain selector bit for bit on the main path's
  canvas and on the adversarial ones at every table; the card holds the
  kernel itself to the plain selector (tests/test_torch_cuda.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam_tpu.ops import fast_stack as jfs
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig, ORBExtractor
from orb_slam_tpu_torch.io.synthetic import SyntheticScene, lateral_trajectory
from orb_slam_tpu_torch.ops import keypoint_select as k5
from orb_slam_tpu_torch.ops.fast_score_nms import fast_score_nms_plain
from orb_slam_tpu_torch.ops.fast_stack import KeypointSelector, build_pyramid_stack

TABLES = [t[1:] for t in chip_smoke.K5_TABLES]
KINDS = ["all zero", "ties", "th_min fallback", "texture-skewed"]


def extractor(h, w, n):
    return ORBExtractor(ORBConfig(n_features=n), h, w, device="cpu")


def main_canvas(ex):
    """The main path's canvas: the plain K1 on a rendered, noisy frame."""
    h, w = ex.height, ex.width
    scene = SyntheticScene(n_points=800, width=w, height=h, cx=w / 2, cy=h / 2)
    img = torch.from_numpy(scene.render_image(lateral_trajectory(2)[1], noise=2.0))
    stack = build_pyramid_stack(img, ex.Rp, ex.Cp)
    return fast_score_nms_plain(stack, ex.shapes, border=ex.selector.border)


@pytest.mark.parametrize("h,w,n", TABLES)
def test_launch_table_matches_selector(h, w, n):
    sel = extractor(h, w, n).selector
    plan = sel.launch_plan()
    rows = np.asarray(list(plan.table)).reshape(len(sel.shapes), 10)
    np.testing.assert_array_equal(rows[:, 0:2], sel.shapes)
    np.testing.assert_array_equal(rows[:, 2:6], sel.grids)
    np.testing.assert_array_equal(rows[:, 6], sel.k_tots)
    np.testing.assert_array_equal(rows[:, 7], sel.quotas)
    cells = [r * c for r, c, _, _ in sel.grids]
    np.testing.assert_array_equal(rows[:, 8], np.cumsum([0] + cells)[:-1])
    np.testing.assert_array_equal(
        rows[:, 9], np.cumsum([0] + [c * k for c, k in zip(cells, sel.k_tots)])[:-1])
    assert plan.n_cells == sum(cells)
    assert plan.n_slots == sum(c * k for c, k in zip(cells, sel.k_tots))
    assert plan.Q == max(sel.quotas) <= max(sel.k_tots)
    assert plan.cell_smem == 8 * max(sel.k_tots)
    assert plan.level_smem == max(12 * k + 36 * c for c, k in zip(cells, sel.k_tots))
    assert max(plan.cell_smem, plan.level_smem) <= k5.MAX_DYNAMIC_SMEM
    assert sel.launch_plan() is plan


def card_canvas():
    """A stand-in for a CUDA canvas: the wrapper must refuse the selector
    before it reads anything else of it."""
    return types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("shapes,quotas,th", [
    ([(480, 640)], [60000], (20.0, 7.0)),                 # k_tot 120000
    ([(480, 640), (400, 533)], [217, 181], (20.0, -1.0)),  # negative th_min
    ([(40, 40)], [400], (20.0, 7.0)),                     # Qmax > k_tot 64
])
def test_wrapper_raises_before_any_launch(shapes, quotas, th):
    sel = KeypointSelector(shapes, quotas, th_ini=th[0], th_min=th[1],
                           device="cpu")
    before = k5.KERNEL.launches
    with pytest.raises(ValueError):
        k5.keypoint_select(card_canvas(), sel)
    assert k5.KERNEL.launches == before and k5.KERNEL._fn is None


def test_cpu_canvas_runs_plain():
    ex = extractor(240, 320, 300)
    canvas = main_canvas(ex)
    before = k5.KERNEL.launches
    got = ex.selector(canvas)
    want = ex.selector.plain(canvas)
    assert k5.KERNEL.launches == before == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def jax_select(canvas, sel):
    out = jfs._select_from_masked(jnp.asarray(canvas), tuple(sel.shapes),
                                  tuple(sel.quotas), th_ini=sel.th_ini,
                                  th_min=sel.th_min, border=sel.border)
    return [np.asarray(o) for o in out]


def small_canvases():
    """k5_adversarial's canvases at 240x320 / 4 levels / 300 features, and
    the rendered canvas with level 1 all zero."""
    ex = ORBExtractor(ORBConfig(n_features=300, n_levels=4), 240, 320,
                      device="cpu")
    out = chip_smoke.k5_adversarial(ex.selector, 240, 320, seed=1)
    zero_level = main_canvas(ex).numpy().copy()
    zero_level[1] = 0.0
    out["a level all zero"] = zero_level
    return ex.selector, out


@pytest.mark.parametrize("kind", KINDS + ["a level all zero"])
def test_plain_equals_jax(kind):
    sel, canvases = small_canvases()
    canvas = canvases[kind]
    got = [t.numpy() for t in sel(torch.from_numpy(canvas))]
    for a, b in zip(got, jax_select(canvas, sel)):
        np.testing.assert_array_equal(a, b)


# ---- a numpy mirror of K5's two launches


def keys_of(v, flat):
    """K5's 64-bit keys: the score's bits over the inverted flat index."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - flat.astype(np.uint64))


def radix_threshold(keys, k):
    """pick_digit's select: 8 bits a pass from the top, done once the
    digit's bin is taken whole; keys >= the result are exactly the k
    largest."""
    prefix, k_rem = np.uint64(0), k
    for shift in range(56, -1, -8):
        high = np.uint64(0) if shift == 56 else ~np.uint64(0) << np.uint64(shift + 8)
        sub = keys[(keys & high) == prefix]
        hist = np.bincount(((sub >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= k_rem:
                break
            above += hist[d]
        prefix |= np.uint64(d) << np.uint64(shift)
        k_rem -= above
        if hist[d] == k_rem:
            break
    assert int((keys >= prefix).sum()) == k
    return prefix


def fixed_point_retain(avail, quota):
    """reference_quota's redistribution, stopped at its first pass that
    adds no cell; also returns the passes it ran."""
    n = len(avail)
    fair = -(-quota // n)
    nm = avail <= fair
    d, q, passes = int((fair - avail)[nm].sum()), fair, 0
    while True:
        passes += 1
        u = max(n - int(nm.sum()), 1)
        if d > 0:
            q = fair + -(-d // u)
        newly = ~nm & (avail <= q)
        d = int((q - avail)[newly].sum())
        nm |= newly
        if not newly.any():
            return np.where(nm, avail, q), passes


def k5_mirror(canvas, sel):
    canvas = np.asarray(canvas, np.float32)
    L = len(sel.shapes)
    Q, b = max(sel.quotas), sel.border
    xy = np.zeros((L, Q, 2), np.int32)
    score = np.zeros((L, Q), np.float32)
    valid = np.zeros((L, Q), bool)
    passes = []
    for l, ((h, w), (rows, cols, ch, cw), k_tot, quota) in enumerate(
            zip(sel.shapes, sel.grids, sel.k_tots, sel.quotas)):
        RW = cols * cw
        region = np.zeros((rows * ch, RW), np.float32)
        yl, xl = max(0, min(rows * ch, h - b)), max(0, min(RW, w - b))
        region[:yl, :xl] = canvas[l, b:b + yl, b:b + xl]
        # launch 1: each cell's min(avail, k_tot) largest keys, descending
        lists, avail, low = [], [], []
        for c in range(rows * cols):
            r, k = divmod(c, cols)
            v = region[r * ch:(r + 1) * ch, k * cw:(k + 1) * cw]
            ys, xs = np.mgrid[r * ch:(r + 1) * ch, k * cw:(k + 1) * cw]
            is_low = int((v > sel.th_ini).sum()) <= 3
            th = np.float32(sel.th_min if is_low else sel.th_ini)
            keys = keys_of(v[v > th], (ys * RW + xs)[v > th])
            if len(keys) > k_tot and k_tot:
                keys = keys[keys >= radix_threshold(keys, k_tot)]
            lists.append(np.sort(keys if k_tot else keys[:0])[::-1])
            avail.append(int((v > th).sum()))
            low.append(is_low)
        avail = np.asarray(avail)
        # launch 2: the pool, the redistribution, retainBest, the zeros
        if avail.sum() > k_tot and k_tot:
            T = radix_threshold(np.concatenate(lists), k_tot)
            p = np.asarray([int((lst >= T).sum()) for lst in lists])
        else:
            p = np.asarray([len(lst) for lst in lists])
        retain, n_passes = fixed_point_retain(avail, quota)
        passes.append(n_passes)
        r = np.minimum(p, retain)
        poff = np.cumsum(p) - p
        fkeys, flats = [], []
        for c, lst in enumerate(lists):
            kept = lst[:r[c]]
            pos = (poff[c] + np.arange(r[c])).astype(np.uint64)
            fkeys.append((kept & np.uint64(0xFFFFFFFF00000000))
                         | (np.uint64(0xFFFFFFFF) - pos))
            flats.append(np.uint64(0xFFFFFFFF) - (kept & np.uint64(0xFFFFFFFF)))
        order = np.argsort(np.concatenate(fkeys))[::-1]
        fkey, flat = np.concatenate(fkeys)[order], np.concatenate(flats)[order]
        value = (fkey >> np.uint64(32)).astype(np.uint32).view(np.float32)
        entries = list(zip(flat.astype(np.int64).tolist(), value.tolist()))
        for c, lst in enumerate(lists):
            entries += [(int(np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF))),
                         np.float32(0.0)) for key in lst[r[c]:p[c]]]
        fy, fx = np.divmod(np.arange(k_tot), RW)
        th_f = np.where(np.asarray(low)[(fy // ch) * cols + fx // cw],
                        np.float32(sel.th_min), np.float32(sel.th_ini))
        zeros = np.flatnonzero(~(region[fy, fx] > th_f))[:k_tot - int(p.sum())]
        entries += [(int(f), np.float32(0.0)) for f in zeros]
        entries += [(-1, np.float32(0.0))] * max(0, Q - len(entries))
        for slot, (f, s) in enumerate(entries[:Q]):
            if f >= 0:
                xy[l, slot] = (f % RW + b, f // RW + b)
            score[l, slot] = s
            valid[l, slot] = s > 0 and slot < quota
    return (torch.from_numpy(xy), torch.from_numpy(score),
            torch.from_numpy(valid)), passes


@pytest.mark.parametrize("h,w,n", TABLES)
@pytest.mark.parametrize("kind", ["main path"] + KINDS)
def test_k5_mirror_equals_plain(h, w, n, kind):
    ex = extractor(h, w, n)
    sel = ex.selector
    if kind == "main path":
        canvas = main_canvas(ex)
    else:
        canvas = torch.from_numpy(chip_smoke.k5_adversarial(sel, h, w)[kind])
    got, passes = k5_mirror(canvas.numpy(), sel)
    want = sel.plain(canvas)
    for name, a, b in zip(("xy", "score", "valid"), got, want):
        assert chip_smoke.bits_equal(a, b), name
    if kind == "texture-skewed":
        # two passes that each add cells, then the fixed point
        assert passes[0] >= 3, passes
