"""Dense masked Hamming matching.

Port of orb_slam_tpu/ops/matching.py: `hamming_matrix` (:28-36, with the
+-1 matmul form of :38-55), `resolve_duplicates` (:79-94) and `match`
(:101-160) without `mutual` and `check_rotation`, which tracking does not
use. Thresholds: TH_HIGH = 100, TH_LOW = 50 (src/ORBmatcher.cc:40-42).

Descriptors are [n, 8] int32 words (bit patterns of the JAX uint32). The
distance is computed as a float32 matmul of +-1 bit vectors,
ham = (256 - <a, b>) / 2, which is exact: every partial sum is an integer
of magnitude <= 256.
"""

from __future__ import annotations

import torch

TH_HIGH = 100
TH_LOW = 50
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
          max_dist: int = TH_LOW, nn_ratio: float = 1.0, unique: bool = True):
    """desc_a [N, 8], desc_b [M, 8] int32 words; allowed [N, M] bool gate.
    Returns (best_idx [N] int64, best_dist [N] int32, matched [N] bool):
    the nearest allowed column of each row, kept if within max_dist, under
    the ratio test when nn_ratio < 1, and one-to-one when unique."""
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
    if unique:
        matched = resolve_duplicates(best_idx, best_dist, matched, M)
    return best_idx, best_dist, matched
