"""Map checkpoint and resume, in the JAX package's file format.

Port of orb_slam_tpu/slam_map/serialization.py:20-144: `save_map`,
`load_map`, `save_session` and `load_session`. The reference has no map
persistence (SURVEY.md §5); here the whole map is one npz, and the host
bookkeeping (free lists from validity, counters, the trajectory), the
vocabulary, the keyframe database and the loop closer's state ride along.

The file is the JAX package's, so that a session written by either
package loads in the other: every MapState field under its own name and
JAX dtype, the descriptors (`kf_desc`, `pt_desc`, the vocabulary's
`__voc_desc__`) as uint32 words (the port holds the same bits as int32,
convert.py), the vocabulary and database arrays and the `__meta__` JSON
under JAX's keys. The random state differs: JAX's `rng_key` is a
`jax.random` key the port cannot use (ROADMAP C9). The port writes its
own generators' states (`SLAMSystem._gen`, `LoopCloser._gen`, by
`get_state()`) as the arrays `__torch_gen__` and `__torch_loop_gen__`
with the device type they came from in `torch_gen_device`, and restores
them into generators of the same device type. A JAX session, or one
written on another device type, leaves the generators as the system's
`reset` seeded them from `cfg.seed`. JAX ignores the port's extra keys.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from orb_slam_tpu_torch.convert import map_state_from_numpy
from orb_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam_tpu_torch.place.database import KeyFrameDatabase
from orb_slam_tpu_torch.place.vocabulary import Vocabulary
from orb_slam_tpu_torch.slam_map.map_state import MapState

_DESC_FIELDS = ("kf_desc", "pt_desc")


def _map_arrays(state: MapState) -> dict:
    """Every MapState field as numpy, descriptors as uint32 words."""
    out = {}
    for f in dataclasses.fields(MapState):
        a = getattr(state, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    return out


def _meta(extra: dict):
    return np.frombuffer(json.dumps(extra).encode(), np.uint8)


def _read_meta(data) -> dict:
    return json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}


def save_map(path: str, state: MapState, extra: dict | None = None):
    """Write the MapState (and optional JSON-serializable extras)."""
    np.savez_compressed(path, __meta__=_meta(extra or {}), **_map_arrays(state))


def load_map(path: str, device="cuda"):
    """(MapState on `device`, the extras dict)."""
    data = np.load(path)
    return (map_state_from_numpy({f.name: data[f.name] for f in dataclasses.fields(MapState)},
                                 device=device),
            _read_meta(data))


def save_session(path: str, system):
    """Checkpoint a running SLAMSystem: the map, the host bookkeeping, the
    vocabulary arrays, the keyframe BoW database, the loop closer's state
    and the generators' states."""
    extra = {
        "kf_order": [int(x) for x in system.kf_order],
        "kf_counter": int(system.kf_counter),
        "frame_id": int(system.frame_id),
        "last_pose": np.asarray(system.last_pose).tolist(),
        "velocity": np.asarray(system.velocity).tolist(),
        "state": int(system.state),
        "last_kf_slot": int(system.last_kf_slot),
        "last_kf_frame": int(system.last_kf_frame),
        "ref_kf_tracked": int(system.ref_kf_tracked),
        "trajectory": [
            [int(fid), float(ts), np.asarray(T).tolist()]
            for fid, ts, T in system.trajectory
        ],
        "n_loops_closed": int(getattr(system, "n_loops_closed", 0)),
        "torch_gen_device": system.device.type,
    }
    arrays = _map_arrays(system.map)
    arrays["__torch_gen__"] = system._gen.get_state().numpy()
    lc = getattr(system, "loop_closer", None)
    if lc is not None:
        extra["loop_state"] = {
            "last_loop_kf_counter": int(lc.last_loop_kf_counter),
            "consistent_groups": [
                [sorted(int(k) for k in group), int(count)]
                for group, count in lc.consistent_groups
            ],
        }
        arrays["__torch_loop_gen__"] = lc._gen.get_state().numpy()
    if system.vocab is not None:
        v = system.vocab
        arrays.update({
            "__voc_children__": v.children,
            "__voc_desc__": np.ascontiguousarray(v.node_desc).view(np.uint32),
            "__voc_leaf__": v.is_leaf.astype(np.uint8),
            "__voc_weight__": v.word_weight,
            "__voc_level__": v.level_of_node,
        })
        extra["voc_kL"] = [int(v.k), int(v.L)]
    if system.db is not None:
        arrays["__db_ids__"] = system.db.bow_ids.cpu().numpy()
        arrays["__db_w__"] = system.db.bow_w.cpu().numpy()
        arrays["__db_active__"] = system.db.active.astype(np.uint8)
    np.savez_compressed(path, __meta__=_meta(extra), **arrays)


def _restore_gen(gen: torch.Generator, data, key: str, extra: dict):
    """A saved generator state into `gen` when both come from one device
    type; else `gen` keeps its seeding from cfg.seed."""
    if key in data and extra.get("torch_gen_device") == gen.device.type:
        gen.set_state(torch.from_numpy(np.array(data[key], np.uint8)))


def load_session(path: str, system):
    """Restore a checkpoint (the port's or the JAX package's) into a
    configured SLAMSystem, on the system's device."""
    data = np.load(path)
    extra = _read_meta(data)
    dev = system.device
    state = map_state_from_numpy(
        {f.name: data[f.name] for f in dataclasses.fields(MapState)}, device=dev)
    system.map = state
    if "__voc_children__" in data:
        children = data["__voc_children__"]
        is_leaf = data["__voc_leaf__"].astype(bool)
        word_of_node = np.full(len(children), -1, np.int32)
        leaves = np.where(is_leaf)[0]
        word_of_node[leaves] = np.arange(len(leaves))
        k, L = extra["voc_kL"]
        system.vocab = Vocabulary(
            children=children,
            node_desc=data["__voc_desc__"].astype(np.uint32).view(np.int32),
            is_leaf=is_leaf, word_of_node=word_of_node,
            node_of_word=leaves.astype(np.int32),
            word_weight=data["__voc_weight__"],
            level_of_node=data["__voc_level__"], k=k, L=L)
        if "__db_ids__" in data:
            ids = data["__db_ids__"]
            db = KeyFrameDatabase(system.vocab, ids.shape[0], ids.shape[1],
                                  device=dev)
            db.bow_ids = torch.from_numpy(np.array(ids, np.int32)).to(dev)
            db.bow_w = torch.from_numpy(np.array(data["__db_w__"], np.float32)).to(dev)
            db.active = data["__db_active__"].astype(bool)
            system.db = db
            if system.cfg.enable_loop_closing:
                system.loop_closer = LoopCloser(db, system.cfg)
    system.n_loops_closed = extra.get("n_loops_closed", 0)
    _restore_gen(system._gen, data, "__torch_gen__", extra)
    lc = getattr(system, "loop_closer", None)
    if lc is not None:
        _restore_gen(lc._gen, data, "__torch_loop_gen__", extra)
        if extra.get("loop_state"):
            ls = extra["loop_state"]
            lc.last_loop_kf_counter = ls["last_loop_kf_counter"]
            lc.consistent_groups = [
                (set(group), count) for group, count in ls["consistent_groups"]
            ]
    system.kf_order = np.asarray(extra["kf_order"], np.int64)
    system.kf_counter = extra["kf_counter"]
    system.frame_id = extra["frame_id"]
    system.last_pose = np.asarray(extra["last_pose"], np.float32)
    system.velocity = np.asarray(extra["velocity"], np.float32)
    system.state = extra["state"]
    system.last_kf_slot = extra["last_kf_slot"]
    system.last_kf_frame = extra["last_kf_frame"]
    system.ref_kf_tracked = extra["ref_kf_tracked"]
    system.trajectory = [
        (fid, ts, np.asarray(T, np.float32)) for fid, ts, T in extra["trajectory"]
    ]
    system.free_pt = [int(i) for i in np.where(~state.pt_valid.cpu().numpy())[0]]
    system.free_kf = [int(i) for i in np.where(~state.kf_valid.cpu().numpy())[0]]
    return system
