"""Carry state from the JAX package into the port, through numpy.

The functions take the JAX package's objects as numpy arrays (for example
`{k: np.asarray(v) for k, v in jax_map._asdict().items()}`), so this
package still imports no JAX. Descriptors, uint32 words in JAX, become
int32 tensors holding the same bits (`.view(np.int32)`); every other
field keeps its dtype. The same holds for a vocabulary's node descriptors
(`vocabulary_from_numpy`) and a keyframe database's BoW rows
(`database_from_numpy`), so a test can carry a JAX system's vocabulary,
database and map into the port; `loop_closer_from_state` carries its loop
closer's consistent groups and counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.frontend.orb_extractor import ORBConfig
from orb_slam_tpu_torch.geometry.camera import CameraModel
from orb_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam_tpu_torch.place.database import KeyFrameDatabase
from orb_slam_tpu_torch.place.vocabulary import Vocabulary
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


def vocabulary_from_numpy(fields: dict) -> Vocabulary:
    """Vocabulary from the JAX Vocabulary's fields (`vars(voc)`, arrays
    as numpy): node descriptors as int32 words of the same bits."""
    v = {f.name: fields[f.name] for f in dataclasses.fields(Vocabulary)
         if f.init}
    v["node_desc"] = np.array(v["node_desc"]).astype(np.uint32).view(np.int32)
    v["k"], v["L"] = int(v["k"]), int(v["L"])
    return Vocabulary(**v)


def database_from_numpy(voc: Vocabulary, arrays: dict,
                        device="cuda") -> KeyFrameDatabase:
    """KeyFrameDatabase on `device` holding the JAX database's rows:
    `arrays` has bow_ids [K, W], bow_w [K, W] and active [K] as numpy."""
    ids = np.array(arrays["bow_ids"], np.int32)
    K, W = ids.shape
    db = KeyFrameDatabase(voc, K, W, device=device)
    db.bow_ids = torch.from_numpy(ids).to(db.device)
    db.bow_w = torch.from_numpy(np.array(arrays["bow_w"], np.float32)).to(db.device)
    db.active = np.array(arrays["active"], bool)
    return db


def loop_closer_from_state(db: KeyFrameDatabase, cfg, consistent_groups,
                           last_loop_kf_counter: int) -> LoopCloser:
    """A LoopCloser over `db` holding the JAX loop closer's state: its
    consistent groups (a list of (set of keyframe slots, count)) and the
    keyframe counter of its last closure."""
    lc = LoopCloser(db, cfg)
    lc.consistent_groups = [(set(int(k) for k in g), int(c))
                            for g, c in consistent_groups]
    lc.last_loop_kf_counter = int(last_loop_kf_counter)
    return lc
