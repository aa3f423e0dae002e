"""`top_k` with the tie order of `jax.lax.top_k`: on equal values the lower
index comes first.

`torch.topk` does not promise any tie order, and the main path depends on
it in three places: the pool and retainBest picks of the FAST selection
(orb_slam_tpu/ops/fast_stack.py:362, :399) and the candidate and row
compaction picks of tracking (orb_slam_tpu/pipeline/track_kernels.py:135,
:173). Here each float is mapped to an int32 key that orders like the
float (IEEE total order), the index is folded into the low 32 bits of an
int64 key, and `torch.topk` runs on keys that are all distinct.
"""

from __future__ import annotations

import torch


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 key in the same (total) order as the floats."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis of a
    float32 tensor, values descending, ties in ascending index order."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    key = (_ordered_bits(x.to(torch.float32)) << 32) | (n - 1 - idx)
    _, sel = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, sel), sel


def first_k_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of `lax.top_k(mask.astype(f32), k)`: the True entries in
    ascending order, then the False ones in ascending order."""
    return top_k(mask.to(torch.float32), k)[1]
