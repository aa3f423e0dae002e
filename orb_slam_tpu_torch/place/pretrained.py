"""The shipped vocabulary artifact, read by path.

Port of orb_slam_tpu/place/pretrained.py:17-43 (`load_pretrained`). The
reference loads its ~1M-word ORBvoc.txt at startup (main.cc:94-108); the
JAX package ships a ~1e5-word k=10 L=5 tree (`vocab_k10L5.npz`, 106,145
nodes, 95,118 words) and a compact k=10 L=4 one. The port reads those
files where the JAX package keeps them, orb_slam_tpu/data/, read-only and
without importing that package; it copies nothing. Cached per process;
None if neither artifact is there.
"""

from __future__ import annotations

import os

from orb_slam_tpu_torch.place.vocabulary import load_npz

_CACHE = {}

DATA_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "orb_slam_tpu",
    "data"))


def load_pretrained(name: str = None):
    """The named artifact of DATA_DIR, by default the largest shipped
    (vocab_k10L5.npz, falling back to vocab_k10L4.npz)."""
    if name is None:
        for cand in ("vocab_k10L5.npz", "vocab_k10L4.npz"):
            if os.path.exists(os.path.join(DATA_DIR, cand)):
                name = cand
                break
        else:
            return None
    if name in _CACHE:
        return _CACHE[name]
    path = os.path.join(DATA_DIR, name)
    voc = load_npz(path) if os.path.exists(path) else None
    _CACHE[name] = voc
    return voc
