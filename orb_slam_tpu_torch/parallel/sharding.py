"""Sharded solvers over a `Mesh`: one bundle-adjustment step, dense
Hamming matching and the RANSAC best-hypothesis pick.

Port of orb_slam_tpu/parallel/sharding.py:51-136: `sharded_ba_step`
(:51-81), `sharded_hamming_argmin` (:84-110) and `sharded_ransac_best`
(:113-136), with `make_mesh` (:30-48) from parallel/mesh.py. Each holds
JAX's per-shard arrays in JAX's layout: what a PartitionSpec('data') or
('model') splits is split along axis 0 in contiguous blocks, and what
JAX replicates is copied to each shard. One process drives every shard
in turn and meets them in one explicit collective (parallel/mesh.py), so
each function returns its result on the mesh's first device, or, for the
BA step, on the device of its inputs. A block split over `data` alone
runs on the first device of its `data` row: JAX's replicas of it along
`model` compute the same values.
"""

from __future__ import annotations

import torch

from orb_slam_tpu_torch.ops.matching import hamming_matrix
from orb_slam_tpu_torch.parallel.mesh import (
    Mesh, all_gather, make_mesh, split_rows,
)
from orb_slam_tpu_torch.solvers import local_ba

__all__ = ["Mesh", "make_mesh", "sharded_ba_step", "sharded_hamming_argmin",
           "sharded_ransac_best"]


def _check_divides(what: str, n: int, axis: str, size: int):
    if n % size:
        raise ValueError(f"{what}: {n} rows must divide the mesh {axis!r} "
                         f"axis ({size})")


def sharded_ba_step(mesh: Mesh, n_cams: int, damping: float = 1e-3):
    """One Gauss-Newton step of BA over raw edge arrays, the points and
    edges sharded over `data` (local_ba._solve_step: one `psum` reduces
    the camera system; the whole adaptive LM is
    bundle_adjust(mesh=...)). Layout: kf_pose [K, 4, 4], cam_opt [K] and
    K_mat replicated; pt_pos [P, 3], edge_kf [P, O], edge_uv [P, O, 2],
    edge_w [P, O] and pt_opt [P] split over `data`. n_cams is K, as in
    JAX. Returns step(kf_pose, pt_pos, edge_kf, edge_uv, edge_w, cam_opt,
    pt_opt, K_mat) -> (new kf_pose, new pt_pos), on pt_pos's device."""
    devices = mesh.data_devices
    root = devices[0]

    def step(kf_pose, pt_pos, edge_kf, edge_uv, edge_w, cam_opt, pt_opt, K_mat):
        _check_divides("sharded_ba_step", pt_pos.shape[0], "data", len(devices))
        split = lambda x: split_rows(x, devices)
        edges = [local_ba._Edges(k, uv, None, o) for k, uv, o in
                 zip(split(edge_kf), split(edge_uv), split(pt_opt))]
        lam = torch.tensor(damping, dtype=torch.float32, device=root)
        new_pose, pts = local_ba._solve_step(
            kf_pose.to(root), K_mat.to(root), cam_opt.to(root), lam,
            split(pt_pos), edges, split(edge_w))
        dev = pt_pos.device
        return new_pose.to(dev), torch.cat([p.to(dev) for p in pts])

    return step


def sharded_hamming_argmin(mesh: Mesh):
    """Dense Hamming matching with the [P, N] distance matrix sharded over
    both axes: rows over `data`, columns over `model`. Each shard takes
    its row-wise argmin; the shards' minima are gathered and merged, the
    lowest global column winning a tie, as in JAX. Returns fn(desc_p
    [P, 8], desc_f [N, 8] int32 words) -> (best_idx [P] int32, best_dist
    [P] int32) on the mesh's first device."""
    n_data, n_model = mesh.devices.shape

    def fn(desc_p, desc_f):
        _check_divides("sharded_hamming_argmin", desc_p.shape[0], "data", n_data)
        _check_divides("sharded_hamming_argmin", desc_f.shape[0], "model",
                       n_model)
        rows = desc_p.split(desc_p.shape[0] // n_data)
        n_local = desc_f.shape[0] // n_model
        cols = desc_f.split(n_local)
        dist, idx = [], []
        for i in range(n_data):
            for j in range(n_model):
                dev = mesh.devices[i, j]
                d = hamming_matrix(rows[i].to(dev, non_blocking=True),
                                   cols[j].to(dev, non_blocking=True))
                best = d.argmin(1)
                dist.append(d.gather(1, best[:, None])[:, 0])
                idx.append(best.to(torch.int32) + j * n_local)
        shape = (n_data, n_model, -1)
        all_dist = torch.stack(all_gather(dist)).reshape(shape)
        all_idx = torch.stack(all_gather(idx)).reshape(shape)
        which = all_dist.argmin(1, keepdim=True)            # [data, 1, P/data]
        best = all_idx.gather(1, which).reshape(-1)
        return best, all_dist.gather(1, which).reshape(-1)

    return fn


def sharded_ransac_best(mesh: Mesh):
    """The best of H hypothesis scores, the scores sharded over `data`:
    each shard takes its argmax, then the global argmax of the gathered
    maxima; on a tie the first wins. Returns fn(scores [H]) ->
    (best_score, best_idx) on the mesh's first device."""
    devices = mesh.data_devices

    def fn(scores):
        _check_divides("sharded_ransac_best", scores.shape[0], "data",
                       len(devices))
        h_local = scores.shape[0] // len(devices)
        best_s, best_i = [], []
        for i, part in enumerate(split_rows(scores, devices)):
            b = part.argmax()
            best_s.append(part[b])
            best_i.append(b + i * h_local)
        all_s = torch.stack(all_gather(best_s))
        all_i = torch.stack(all_gather(best_i))
        w = all_s.argmax()
        return all_s[w], all_i[w]

    return fn
