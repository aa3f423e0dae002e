"""A mesh of devices and the collectives over it.

Port of orb_slam_tpu/parallel/sharding.py:30-48 (`make_mesh`) and of the
`psum` / `all_gather` that JAX's shard_map bodies call. JAX runs one
program per device and its collectives meet in the middle; the port has
one process drive every device, as JAX's single controller does, so a
sharded function is a loop over the shards around one explicit
reduction:

  * `psum(parts)` copies each shard's partial to the first part's device
    (the mesh's first device) and adds them in shard order. The order is
    fixed, so a run repeats bit for bit. On distinct cards the copies are
    peer copies over NVLink;
  * `all_gather(parts)` is the same copy, without the add;
  * `replicate(x, devices)` sends a replicated value back to each shard.

Every copy is `.to(device, non_blocking=True)`. Between two cards PyTorch
orders such a copy after the work queued on both devices' current streams
and before the work queued after it, so a shard's tensor stays alive
until its copy has run and no event or `record_stream` is needed. On one
device the copy is the tensor itself, so one shard on one device is the
single-device path, with the same operations and the same bits.

The three run the same code on every mesh: one card, a device repeated,
the CPU or distinct cards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D array of `torch.device`s, [data, model], with JAX's axis
    names; `shape` maps each name to its size, as `jax.sharding.Mesh`
    does."""

    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list:
        """The first device of each `data` row: where a shard over `data`
        alone runs. Its replicas along `model` would compute the same
        values, so the port runs each block once."""
        return list(self.devices[:, 0])


def make_mesh(n_devices: int | None = None, model_axis: int | None = None,
              devices=None) -> Mesh:
    """A ('data', 'model') mesh over the first `n_devices` devices (all of
    them by default): the CUDA cards, or the list `devices` names.
    `model_axis` is 2 for an even n of at least 4, else 1; `data` takes
    the rest. A device may repeat in `devices`: four entries of `cuda:0`
    on a one-card machine, or eight of `cpu` in the tests, stand in for
    the virtual devices that tests/conftest.py gives JAX. That is a way to
    test the sharded code on fewer devices, not a mode of its own.
    Raises without a CUDA card unless `devices` is given, and with fewer
    devices than asked."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; name the devices "
                "(devices=[...]) to build a mesh on another platform")
        devs = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("make_mesh: `devices` names no device")
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {len(devs)} "
            f"available on platform {devs[0].type!r}; name more devices "
            f"(devices=[...]; a device may repeat)")
    devs = devs[:n]
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    data_axis = n // model_axis
    arr = np.empty(data_axis * model_axis, dtype=object)
    arr[:] = devs[:data_axis * model_axis]
    return Mesh(arr.reshape(data_axis, model_axis))


def all_gather(parts: list) -> list:
    """Each shard's tensor on the first part's device, in shard order."""
    root = parts[0].device
    return [p.to(root, non_blocking=True) for p in parts]


def psum(parts: list) -> torch.Tensor:
    """The sum of the shards' partials on the first part's device, added
    in shard order."""
    total, *rest = all_gather(parts)
    for p in rest:
        total = total + p
    return total


def replicate(x: torch.Tensor, devices: list) -> list:
    """x on each device of `devices`."""
    return [x.to(d, non_blocking=True) for d in devices]


def split_rows(x: torch.Tensor, devices: list) -> list:
    """x split along axis 0 in len(devices) contiguous blocks, block i on
    devices[i] (PartitionSpec('data')). The caller checks that the rows
    divide."""
    return [b.to(d, non_blocking=True)
            for b, d in zip(x.split(x.shape[0] // len(devices)), devices)]
