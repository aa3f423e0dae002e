"""Carry state from the JAX package into the port, through numpy.

The functions take the JAX package's objects as numpy arrays (for example
`{k: np.asarray(v) for k, v in jax_map._asdict().items()}`), so this
package still imports no JAX. Descriptors, uint32 words in JAX, become
int32 tensors holding the same bits (`.view(np.int32)`); every other
field keeps its dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.slam_map.map_state import MapState

_DESC_FIELDS = ("kf_desc", "pt_desc")


def map_state_from_numpy(arrays: dict, device="cuda") -> MapState:
    """Every MapState field from a dict of numpy arrays, on `device` (the
    card unless the caller names another)."""
    device = require_device(device)
    fields = {}
    for f in dataclasses.fields(MapState):
        a = np.array(arrays[f.name])        # a writable copy
        if f.name in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        fields[f.name] = torch.from_numpy(a).to(device)
    return MapState(**fields)


def camera_from_numpy(fields: dict) -> CameraModel:
    """CameraModel from the JAX CameraModel's fields (`cam._asdict()`,
    values as numpy scalars or Python numbers)."""
    return CameraModel(**{
        f.name: (int(fields[f.name]) if type(f.default) is int
                 else float(np.asarray(fields[f.name], np.float32)))
        for f in dataclasses.fields(CameraModel)})


def orb_config_from_dict(values: dict) -> ORBConfig:
    """ORBConfig from the JAX ORBConfig's fields (`dataclasses.asdict`)."""
    names = {f.name for f in dataclasses.fields(ORBConfig)}
    return ORBConfig(**{k: v for k, v in values.items() if k in names})
