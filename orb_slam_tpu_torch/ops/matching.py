"""Dense masked Hamming matching.

Port of orb_slam_tpu/ops/matching.py: `hamming_matrix` (:28-36, with the
+-1 matmul form of :38-55), `rotation_consistency_mask` (:58-77),
`resolve_duplicates` (:79-94), `match` (:101-161) and `window_gate`
(:163-181). Thresholds: TH_HIGH = 100, TH_LOW = 50, HISTO_LENGTH = 30
(src/ORBmatcher.cc:40-42).

Descriptors are [n, 8] int32 words (bit patterns of the JAX uint32). The
distance is computed as a float32 matmul of +-1 bit vectors,
ham = (256 - <a, b>) / 2, which is exact: every partial sum is an integer
of magnitude <= 256.
"""

from __future__ import annotations

import math

import torch

from orb_slam_tpu_torch.ops.sort import top_k

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INVALID_DIST = 512  # > any Hamming distance (256)


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[n, 8] int32 words -> [n, 256] f32 in {-1, +1}, bit b of word w at
    column 32 w + b."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return 2.0 * bits.reshape(desc.shape[0], 256).to(torch.float32) - 1.0


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 words -> [N, M] int32 Hamming distances."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def rotation_consistency_mask(angle_a, angle_b_matched, valid):
    """`valid` restricted to the matches whose angle difference falls in
    the 3 fullest of 30 rotation bins, the second and third only if they
    hold more than 0.1 of the first (ComputeThreeMaxima and its filter,
    src/ORBmatcher.cc:1748-1789). The bins are ranked by ops/sort.top_k,
    ties to the lower bin as `lax.top_k`."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b_matched, two_pi)
    bins = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).to(
        torch.int64), 0, HISTO_LENGTH) % HISTO_LENGTH
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device)
    hist = hist.scatter_add(0, bins, valid.to(torch.int32))
    vals, idx = top_k(hist.to(torch.float32), 3)
    keep = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=bins.device)
    keep = keep.index_put((idx,), torch.stack([
        torch.ones((), dtype=torch.bool, device=bins.device),
        vals[1] > 0.1 * vals[0], vals[2] > 0.1 * vals[0]]))
    return valid & keep[bins]


def resolve_duplicates(best_idx, best_dist, valid, m_size: int):
    """One-to-one: where several rows matched one column, the row with the
    smallest distance wins, ties to the lowest row."""
    n = best_idx.shape[0]
    dist_eff = torch.where(valid, best_dist, INVALID_DIST)
    col_best = torch.full((m_size,), INVALID_DIST, dtype=torch.int32,
                          device=best_idx.device)
    col_best = col_best.scatter_reduce(0, best_idx, dist_eff, reduce="amin")
    wins = dist_eff == col_best[best_idx]
    rows = torch.arange(n, dtype=torch.int32, device=best_idx.device)
    col_row = torch.full((m_size,), n, dtype=torch.int32, device=best_idx.device)
    col_row = col_row.scatter_reduce(0, best_idx,
                                     torch.where(wins & valid, rows, n),
                                     reduce="amin")
    return valid & wins & (col_row[best_idx] == rows)


def match(desc_a, desc_b, allowed=None, valid_a=None, valid_b=None,
          angle_a=None, angle_b=None, max_dist: int = TH_LOW,
          nn_ratio: float = 1.0, mutual: bool = False,
          check_rotation: bool = False, unique: bool = True):
    """desc_a [N, 8], desc_b [M, 8] int32 words; allowed [N, M] bool gate.
    Returns (best_idx [N] int64, best_dist [N] int32, matched [N] bool):
    the nearest allowed column of each row, kept if within max_dist, under
    the ratio test when nn_ratio < 1, only where the row is also its
    column's nearest when mutual (SearchForInitialization,
    src/ORBmatcher.cc:598-713), in the rotation histogram's top bins of
    angle_a - angle_b when check_rotation, and one-to-one when unique."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    dist = hamming_matrix(desc_a, desc_b)
    gate = torch.ones((N, M), dtype=torch.bool, device=dist.device)
    if allowed is not None:
        gate = gate & allowed
    if valid_a is not None:
        gate = gate & valid_a[:, None]
    if valid_b is not None:
        gate = gate & valid_b[None, :]
    dist = torch.where(gate, dist, INVALID_DIST)

    best_idx = torch.argmin(dist, 1)                  # first minimum, as JAX
    best_dist = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    second = dist.scatter(1, best_idx[:, None], INVALID_DIST).amin(1)
    matched = best_dist <= max_dist
    if nn_ratio < 1.0:
        matched = matched & (best_dist.to(torch.float32)
                             < nn_ratio * second.to(torch.float32))
    if mutual:
        col_best = torch.argmin(dist, 0)              # first minimum, as JAX
        matched = matched & (col_best[best_idx] == torch.arange(
            N, device=dist.device))
    if check_rotation:
        matched = rotation_consistency_mask(angle_a, angle_b[best_idx],
                                            matched)
    if unique:
        matched = resolve_duplicates(best_idx, best_dist, matched, M)
    return best_idx, best_dist, matched


def window_gate(xy_a, xy_b, radius, octave_b=None, min_level=None,
                max_level=None, per_row_radius: bool = False):
    """[N, M] gate: b within `radius` of a (one radius per row of a when
    per_row_radius; a tensor radius stays on the device) and the octave of
    b inside [min_level, max_level], each a scalar or one per row
    (WindowSearch, SearchForInitialization and the previous-frame search,
    src/ORBmatcher.cc:409-713)."""
    d = xy_a[:, None, :] - xy_b[None, :, :]
    r = radius[:, None] if per_row_radius else radius
    gate = (d * d).sum(-1) <= r * r

    def per_row(v):
        v = torch.as_tensor(v, device=xy_a.device)
        return v[:, None] if v.ndim == 1 else v

    if octave_b is not None and min_level is not None:
        gate = gate & (octave_b[None, :] >= per_row(min_level))
    if octave_b is not None and max_level is not None:
        gate = gate & (octave_b[None, :] <= per_row(max_level))
    return gate
