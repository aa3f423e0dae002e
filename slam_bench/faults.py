"""Faults planted in the program's timed path, for the check's tests and
for the upper readings of its limits (`control.py --fault`): each breaks
one thing where it is produced, and `correct` has to come out false.

- `unchanged`: a tracking step that returns its state unchanged (the
  predicted pose, every match an inlier);
- `half`: the chunk's second half left out, its frames given the first
  half's last result;
- `moved`: a pose altered where it is produced, 1 cm along x;
- `descriptor`: a feature altered where it is produced, one descriptor
  bit flipped;
- `rebind`: every fifth inlier binding of a tracked frame moved to
  another inlier's map point, where tracking produces it.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "moved", "descriptor", "rebind")


def _unchanged_pose(T0, points, uv, inv_sigma2, valid, K, iters=None, damping=1e-3):
    return T0.clone(), valid.clone(), valid.sum(dtype=torch.int32)


def _half_the_chunk(extract):
    def f(imgs, *a, **kw):
        h = max(1, len(imgs) // 2)
        feats, xy, res = extract(imgs[:h], *a, **kw)
        pad = lambda t: torch.cat([t, t[-1:].expand(len(imgs) - h, *t.shape[1:])])
        return (type(feats)(*(pad(getattr(feats, k)) for k in feats.__dataclass_fields__)),
                pad(xy), type(res)(*(pad(v) for v in res)))
    return f


def _moved_pose(optimize):
    def f(*a, **kw):
        T, inl, n = optimize(*a, **kw)
        T = T.clone()
        T[0, 3] += 0.01
        return T, inl, n
    return f


def _flipped_descriptors(forward):
    def f(self, img):
        out = forward(self, img)
        out.desc_i32 = out.desc_i32 ^ 1
        return out
    return f


def rebind(obs: torch.Tensor) -> torch.Tensor:
    """obs [..., N] with every fifth binding (>= 0) of each row moved to
    the point of the row's next such binding."""
    out = obs.clone()
    for row in out.reshape(-1, out.shape[-1]):
        idx = torch.nonzero(row >= 0).flatten()[::5]
        if len(idx) > 1:
            row[idx] = row[idx.roll(-1)]
    return out


def _rebound_chunk(extract):
    def f(*a, **kw):
        feats, xy, res = extract(*a, **kw)
        return feats, xy, res._replace(obs=rebind(res.obs))
    return f


def _rebound_track(track):
    def f(*a, **kw):
        res = track(*a, **kw)
        return res._replace(obs=rebind(res.obs))
    return f


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted for the block."""
    from orb_slam_tpu_torch.frontend import orb_extractor
    from orb_slam_tpu_torch.pipeline import system, track_kernels

    targets = {
        "unchanged": [(track_kernels, "pose_optimize", lambda f: _unchanged_pose)],
        "half": [(system, "extract_track_chunk", _half_the_chunk)],
        "moved": [(track_kernels, "pose_optimize", _moved_pose)],
        "descriptor": [(orb_extractor.ORBExtractor, "forward", _flipped_descriptors)],
        "rebind": [(system, "extract_track_chunk", _rebound_chunk),
                   (system, "track_frame", _rebound_track)],
    }[name]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    try:
        for obj, attr, make in targets:
            setattr(obj, attr, make(getattr(obj, attr)))
        yield
    finally:
        for obj, attr, prev in saved:
            setattr(obj, attr, prev)
