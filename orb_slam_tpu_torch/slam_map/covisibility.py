"""The covisibility graph as dense tensor ops.

Port of orb_slam_tpu/slam_map/covisibility.py:22-114: `incidence_matrix`,
`covisibility_weights`, `observation_counts`, `local_point_mask`,
`best_covisible` and `essential_edges`. The incidence matrix A[k, p] (KF k
observes point p) is written by one scatter of True values, and the whole
weight matrix is one float matmul W = A A^T, exact while the counts stay
under 2^24 (KeyFrame::UpdateConnections, KeyFrame.cc:332-421).
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.ops.sort import top_k
from orb_slam_tpu_torch.slam_map.map_state import MapState

COVIS_THRESHOLD = 15  # reference: KeyFrame.cc:372
ESSENTIAL_THRESHOLD = 100  # reference: Optimizer.cc:701, MapPublisher.cc:240


def incidence_matrix(state: MapState) -> torch.Tensor:
    """[K, P] bool: KF k observes point p. Unbound entries are written to a
    dump column, so every real entry is written True or not at all."""
    K, N = state.kf_obs.shape
    P = state.pt_valid.shape[0]
    pid = state.kf_obs.long()
    bound = (pid >= 0) & state.kf_valid[:, None]
    A = torch.zeros((K, P + 1), dtype=torch.bool, device=pid.device)
    A.scatter_(1, torch.where(bound, pid, P), True)
    return A[:, :P] & state.pt_valid[None, :]


def covisibility_weights(state: MapState, A=None) -> torch.Tensor:
    """[K, K] int32 shared-observation counts, diagonal and invalid
    keyframes zeroed."""
    if A is None:
        A = incidence_matrix(state)
    Af = A.to(torch.float32)
    W = (Af @ Af.T).to(torch.int32)
    K = W.shape[0]
    W = W * (1 - torch.eye(K, dtype=torch.int32, device=W.device))
    valid2 = state.kf_valid[:, None] & state.kf_valid[None, :]
    return torch.where(valid2, W, 0)


def observation_counts(state: MapState, A=None) -> torch.Tensor:
    """[P] int32 observing keyframes per point (MapPoint::nObs)."""
    if A is None:
        A = incidence_matrix(state)
    return A.sum(0).to(torch.int32)


def local_point_mask(state: MapState, ref_kf) -> torch.Tensor:
    """[P] bool: the local map's points seen from keyframe `ref_kf`
    (UpdateReferenceKeyFrames/Points, src/Tracking.cc:728-839): K1 = the
    keyframes covisible with the reference and itself, K2 = K1's covisible
    neighbours; the points observed by K1 u K2. `W @ k1` is an integer
    product in JAX, done here in f32, which is exact at these counts."""
    W = covisibility_weights(state)
    K = W.shape[0]
    dev = W.device
    k1 = ((W[ref_kf] > 0) & state.kf_valid) | (
        torch.arange(K, device=dev) == ref_kf)
    k2 = ((W.to(torch.float32) @ k1.to(torch.float32)) > 0) & state.kf_valid
    kf_mask = k1 | k2
    obs = state.kf_obs.long()
    P = state.pt_valid.shape[0]
    ids = torch.where(kf_mask[:, None] & (obs >= 0), obs, P)
    mask = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    mask[ids.reshape(-1)] = True
    return mask[:P] & state.pt_valid


def best_covisible(W: torch.Tensor, slot, k: int):
    """Top-k covisible KF slots of `slot` by weight, ties to the lower slot
    as `lax.top_k` orders them (GetBestCovisibilityKeyFrames,
    KeyFrame.cc:177-190). Returns (slots [k], weights [k] int32)."""
    weights, slots = top_k(W[slot].to(torch.float32), k)
    return slots, weights.to(torch.int32)


def essential_edges(W, spanning_parent, loop_edges,
                    threshold: int = ESSENTIAL_THRESHOLD) -> torch.Tensor:
    """[K, K] bool symmetric adjacency of the essential graph: spanning
    tree + covisibility edges of weight >= threshold + loop edges
    (Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:566-737)."""
    K = W.shape[0]
    dev = W.device
    adj = torch.zeros((K + 1, K + 1), dtype=torch.bool, device=dev)
    adj[:K, :K] = W >= threshold
    rows = torch.arange(K, device=dev)
    for a, b in ((rows, spanning_parent.long()),
                 (rows[:, None].expand(loop_edges.shape), loop_edges.long())):
        ok = b >= 0
        a, b = torch.where(ok, a, K), torch.where(ok, b, K)
        adj[a, b] = True
        adj[b, a] = True
    return adj[:K, :K] & ~torch.eye(K, dtype=torch.bool, device=dev)
