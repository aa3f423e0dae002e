"""How `correct` is decided: what the window's episodes produced, against
the plain references of slam_bench/reference/.

The harness records, in the first episode of the window, what the timed
path itself produced (`Capture`): every frame's ORB features as the
program's extractor returned them, every tracked frame's pose with its
inlier bindings and the map points it tracked against, and the map after
every keyframe integration. Once the window has closed and the program's
state is freed, `numbers` compares them:

- `features_differ`: the share of feature slots (valid flag, level-0
  pixel, level, angle, descriptor) where the program's extraction and the
  reference extractor's differ, over every frame of the episode;
- `track_pose_gap_px_p90`: the 90th percentile (nearest rank), over the
  tracked frames, of the RMS shift of a frame's inlier projections
  between its pose and the pose refitted from those inliers, so that a
  fault on one frame in eight moves it (the largest is kept beside it,
  uncompared: the program optimises each pose over the inliers of its last
  round but one and reports those of its last gate, so a few frames sit
  up to ~0.5 px off, on the CPU's plain path as on the card);
- `kf_pose_gap_px_p90`: the same percentile over each new keyframe after
  local mapping, refitted against the map's points;
- `point_gap_px`: over the points each new keyframe observes, the median
  RMS shift of their projections into the keyframes that observe them
  between the program's positions and those refitted from all their live
  observations, in level-0 pixels;
- `wrong_point_share`: against the scene's ground truth, the share of
  the tracked frames' inlier bindings whose map point is not the scene
  point the feature shows. A feature shows the square the renderer
  painted under its pixel (`scene.billboard_index`); a map point is the
  scene point most of its keyframe observations show. Bindings where
  either side shows no square are left out;
- `frames_unanswered`: frames of the window given no pose, and frames of
  the episode whose extraction or tracked pose was never produced.

With `control=True` the reference takes the program's place computed one
precision lower (bfloat16), and the float32/float64 reference judges it;
`wrong_point_share` judges the program's bindings either way.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import stats
from slam_bench.reference import refit
from slam_bench.reference.orb import Extractor

FEATURE_FIELDS = ("xy", "angle", "octave", "desc")


class Capture:
    """What the first episode of the window produced, by episode frame
    index (the system's frame id less `base`): `features[i]` (xy, angle,
    octave, desc, valid), `tracked[i]` (pose, inlier bindings of its
    features, the map it tracked against, the inlier count where the
    chunk gave one) and `integrations` (the new keyframe's slot and the
    map fields after its integration)."""

    def __init__(self, base: int = 2):
        self.base = base
        self.features, self.tracked, self.integrations = {}, {}, []


def _host(x, dtype=None):
    t = torch.as_tensor(x).detach().cpu()
    return t if dtype is None else t.to(dtype)


def features_differ(program: dict, reference: dict) -> float:
    """Share of slots where valid flags differ, or a valid feature's
    pixel, level, angle or descriptor does."""
    v_p, v_r = _host(program["valid"]), _host(reference["valid"])
    bad = v_p != v_r
    both = v_p & v_r
    for k in FEATURE_FIELDS:
        a, b = _host(program[k]), _host(reference[k])
        if a.dtype.is_floating_point:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        diff = (a != b).reshape(len(a), -1).any(1)
        bad |= both & diff
    return float(bad.float().mean())


def _inv_s2(octave, scale_factor):
    return 1.0 / scale_factor ** (2.0 * _host(octave, torch.float64))


def pose_gaps(pose, pts, uv, w, K, rnd=None):
    """(camera-centre distance in m, RMS shift of the observations'
    projections in px) between `pose` and the pose refitted from the
    observations; with `rnd` the refit in that precision stands in for
    `pose`."""
    ref = refit.pose_refit(pose, pts, uv, w, K)
    got = pose if rnd is None else refit.pose_refit(pose, pts, uv, w, K, rnd=rnd)
    shift = refit.project(got, pts, K) - refit.project(ref, pts, K)
    return (float(torch.linalg.norm(refit.center(got) - refit.center(ref))),
            float(torch.sqrt((shift ** 2).sum(-1).mean())))


def track_gaps(rec, feats, cfg, K, rnd=None):
    """pose_gaps of one tracked frame against its inlier matches: the
    frame's extracted pixels (undistorted here) bound by the program to
    the map points it tracked against."""
    obs = _host(rec["obs"], torch.int64)
    sel = obs >= 0
    uv = undistort(_host(feats["xy"], torch.float64), cfg)
    return pose_gaps(_host(rec["pose"], torch.float64),
                     _host(rec["map"].pt_pos, torch.float64)[obs[sel]], uv[sel],
                     _inv_s2(feats["octave"], cfg["scale_factor"])[sel], K, rnd)


def undistort(uv, cfg, iters=8):
    """cv::undistortPoints' fixed-point iteration back through K; the
    pixels themselves where the camera has no distortion."""
    k1, k2, p1, p2 = cfg["dist"]
    if not any((k1, k2, p1, p2)):
        return uv
    (fx, _, cx), (_, fy, cy), _ = cfg["K"]
    xd = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    x = xd
    for _ in range(iters):
        r2 = (x ** 2).sum(-1)
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x[:, 0] * x[:, 1] + p2 * (r2 + 2.0 * x[:, 0] ** 2)
        dy = p1 * (r2 + 2.0 * x[:, 1] ** 2) + 2.0 * p2 * x[:, 0] * x[:, 1]
        x = torch.stack([(xd[:, 0] - dx) / radial, (xd[:, 1] - dy) / radial], -1)
    return torch.stack([fx * x[:, 0] + cx, fy * x[:, 1] + cy], -1)


def distort(uv, cfg):
    """Undistorted pixels [n, 2] to the camera's own (the forward model
    the renderer paints with); the pixels themselves without distortion."""
    k1, k2, p1, p2 = cfg["dist"]
    if not any((k1, k2, p1, p2)):
        return uv
    (fx, _, cx), (_, fy, cy), _ = cfg["K"]
    x, y = (uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


class SceneIds:
    """Which scene point a pixel of a frame of the sequence shows: the
    renderer's square index (-1 on background), the frames' index maps
    made once each."""

    def __init__(self, truth: dict):
        self.scene, self.poses, self.maps = truth["scene"], truth["poses"], {}

    def __call__(self, frame: int, xy):
        if frame not in self.maps:
            self.maps[frame] = torch.from_numpy(
                self.scene.billboard_index(self.poses[frame]))
        ids = self.maps[frame]
        px = torch.round(xy).long()
        H, W = ids.shape
        inside = ((px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0)
                  & (px[:, 1] < H))
        out = torch.full((len(px),), -1, dtype=torch.int64)
        out[inside] = ids[px[inside, 1], px[inside, 0]].long()
        return out


def point_scene_ids(m, ids: SceneIds, cfg) -> torch.Tensor:
    """[P] the scene point most of each map point's live keyframe
    observations show (-1 where none shows one)."""
    kf_valid = _host(m.kf_valid)
    kf_obs = _host(m.kf_obs, torch.int64)
    k_idx, f_idx = torch.nonzero(kf_valid[:, None] & (kf_obs >= 0), as_tuple=True)
    pid = kf_obs[k_idx, f_idx]
    frame = _host(m.kf_frame_id, torch.int64)[k_idx]
    raw = distort(_host(m.kf_xy, torch.float64)[k_idx, f_idx], cfg)
    sid = torch.full_like(pid, -1)
    for fr in torch.unique(frame).tolist():
        sel = frame == fr
        sid[sel] = ids(int(fr), raw[sel])
    keep = sid >= 0
    n_s = len(ids.scene.points)
    key, count = torch.unique(pid[keep] * n_s + sid[keep], return_counts=True)
    p_u, s_u = key // n_s, key % n_s
    # per point, the scene id with the most observations (ties: lowest id)
    order = torch.argsort(p_u * (count.max() + 1) - count, stable=True)
    p_u, s_u = p_u[order], s_u[order]
    first = torch.ones(len(p_u), dtype=torch.bool)
    first[1:] = p_u[1:] != p_u[:-1]
    out = torch.full((len(_host(m.pt_valid)),), -1, dtype=torch.int64)
    out[p_u[first]] = s_u[first]
    return out


def wrong_bindings(rec, feats, frame: int, ids: SceneIds, cfg, cache: dict):
    """(bindings judged, bindings whose point is not the scene point the
    feature shows) of one tracked frame; `cache` keeps each map's point
    ids (the frames of a chunk share one map)."""
    obs = _host(rec["obs"], torch.int64)
    sel = obs >= 0
    feat_sid = ids(frame, _host(feats["xy"], torch.float64)[sel])
    key = id(rec["map"])
    if key not in cache:
        cache[key] = point_scene_ids(rec["map"], ids, cfg)
    pt_sid = cache[key][obs[sel]]
    judged = (feat_sid >= 0) & (pt_sid >= 0)
    return int(judged.sum()), int((judged & (feat_sid != pt_sid)).sum())


def integration_gaps(rec, K, scale_factor, rnd=None):
    """(pose_gaps of the new keyframe, [gap of each point it observes] in
    px) of one integration, or None where local mapping culled the new keyframe."""
    slot = rec["slot"]
    kf_valid = _host(rec["kf_valid"])
    if not bool(kf_valid[slot]):
        return None
    kf_obs = _host(rec["kf_obs"], torch.int64)
    kf_xy = _host(rec["kf_xy"], torch.float64)
    kf_pose = _host(rec["kf_pose"], torch.float64)
    inv_s2 = _inv_s2(rec["kf_octave"], scale_factor)
    pt_pos = _host(rec["pt_pos"], torch.float64)
    pt_valid = _host(rec["pt_valid"])
    obs = kf_obs[slot]
    sel = (obs >= 0) & pt_valid[obs.clamp(min=0)]
    pids = obs[sel]
    kf_gap = pose_gaps(kf_pose[slot], pt_pos[pids], kf_xy[slot][sel],
                       inv_s2[slot][sel], K, rnd)

    # every live observation of those points, in every live keyframe
    # (one per keyframe where a keyframe binds a point twice)
    live = kf_valid[:, None] & (kf_obs >= 0)
    k_idx, f_idx = torch.nonzero(live, as_tuple=True)
    p_of = kf_obs[k_idx, f_idx]
    key = p_of * len(kf_valid) + k_idx
    order = torch.argsort(key, stable=True)
    k_idx, f_idx, p_of, key = k_idx[order], f_idx[order], p_of[order], key[order]
    first = torch.ones(len(key), dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    k_idx, f_idx, p_of = k_idx[first], f_idx[first], p_of[first]
    counts = torch.bincount(p_of, minlength=len(pt_pos))
    pids = pids[counts[pids] >= 2]
    if not len(pids):
        return kf_gap, []
    O = int(counts[pids].max())
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(O)
    rows = starts[pids][:, None] + j[None, :]
    mask = j[None, :] < counts[pids][:, None]
    rows = torch.where(mask, rows, 0)
    kk, ff = k_idx[rows], f_idx[rows]
    args = (kf_pose[kk], kf_xy[kk, ff], inv_s2[kk, ff], mask, K)
    X = pt_pos[pids]
    ref_X, ok = refit.points_refit(X, *args)
    got_X = X if rnd is None else refit.points_refit(X, *args, rnd=rnd)[0]
    # a point's depth is weakly held by short baselines, so its gap is
    # read where it is observed: the RMS shift of its projections
    proj = lambda P: refit.project(kf_pose[kk], P[:, None, :], K)
    shift = ((proj(got_X) - proj(ref_X)) ** 2).sum(-1)
    rms = torch.sqrt((shift * mask).sum(1) / mask.sum(1))
    return kf_gap, rms[ok].tolist()


def numbers(capture: Capture, frames, frames_without_pose: int, cfg: dict,
            device, truth: dict, control: bool = False) -> dict:
    """{number: value} of the window's episode against the references.
    `frames` [n, H, W] are the episode's frames; cfg holds the numbers
    the reference is built from (see harness.reference_numbers); `truth`
    the scene and the poses the frames were rendered from."""
    K = torch.tensor(cfg["K"], dtype=torch.float64)
    sf = cfg["scale_factor"]
    build = lambda ctl: Extractor(cfg["n_features"], cfg["n_levels"], sf,
                                  cfg["fast_th"], cfg["score_harris"],
                                  cfg["height"], cfg["width"], device,
                                  control=ctl)
    truth_ex = build(False)
    stand_in = build(True) if control else None
    rnd = refit.bf16 if control else None
    differ = []
    for i, feats in sorted(capture.features.items()):
        ref = truth_ex(frames[i])
        got = stand_in(frames[i]) if control else feats
        differ.append(features_differ(got, ref))
    min_inliers = cfg["min_inliers"]
    tracked = {i: r for i, r in capture.tracked.items()
               if r["n_in"] is None or int(r["n_in"]) >= min_inliers}
    # every frame of the episode has its extraction and its pose recorded
    missing = sum(i not in capture.features or i not in tracked
                  for i in range(len(frames)))
    track = [track_gaps(tracked[i], capture.features[i], cfg, K, rnd)
             for i in sorted(tracked) if i in capture.features]
    ids, cache = SceneIds(truth), {}
    judged = wrong = 0
    for i in sorted(tracked):
        if i in capture.features:
            n, w = wrong_bindings(tracked[i], capture.features[i],
                                  capture.base + i, ids, cfg, cache)
            judged, wrong = judged + n, wrong + w
    kf_gaps, point_gaps = [], []
    for rec in capture.integrations:
        g = integration_gaps(rec, K, sf, rnd)
        if g is not None:
            kf_gaps.append(g[0])
            point_gaps.extend(g[1])
    if not (differ and track):
        raise RuntimeError("the window's first episode recorded no frame")
    px = [p for _, p in track]
    out = dict(features_differ=float(np.mean(differ)),
               track_pose_gap_px_p90=stats.percentile(px, 90),
               track_pose_gap_px_max=max(px),
               wrong_point_share=wrong / judged if judged else 1.0,
               frames_unanswered=float(frames_without_pose + missing))
    if kf_gaps:
        kpx = [p for _, p in kf_gaps]
        out["kf_pose_gap_px_p90"] = stats.percentile(kpx, 90)
        out["kf_pose_gap_px_max"] = max(kpx)
    if point_gaps:
        out["point_gap_px"] = float(np.median(point_gaps))
    return out


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): correct when every number the
    limits name was read and is at or under its limit."""
    rows = [(k, values.get(k), lim) for k, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
