"""`x.at[idx].set(v)` with duplicate indices, as XLA applies it on the CPU.

XLA's CPU scatter applies the updates in order, so where several rows
write one target the last row wins. The mapping code relies on that in
three places (orb_slam_tpu/slam_map/observations.py:74-80,
pipeline/mapping_kernels.py:193-197 and :287-288). `index_put_` with
duplicate indices leaves the winner undefined on CUDA, so here the winner
is found first: for every target the highest source row that writes it,
by an integer `scatter_reduce("amax")`, which is deterministic on the card.
"""

from __future__ import annotations

import torch


def last_writer(n_targets: int, index: torch.Tensor) -> torch.Tensor:
    """[n_targets] int64: the highest i with index[i] == t, or -1."""
    index = index.reshape(-1).long()
    rows = torch.arange(index.numel(), device=index.device)
    out = torch.full((n_targets,), -1, dtype=torch.int64, device=index.device)
    return out.scatter_reduce(0, index, rows, reduce="amax")


def set_last(base: torch.Tensor, index: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """A copy of `base` (1-D) with base[index[i]] = values[i] applied for
    i = 0, 1, ... in order: the last write to a target wins."""
    w = last_writer(base.shape[0], index)
    got = values.reshape(-1)[w.clamp(min=0)]
    return torch.where(w >= 0, got, base)
