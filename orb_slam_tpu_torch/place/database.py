"""KeyFrameDatabase: BoW store and loop / relocalisation candidate retrieval.

Port of orb_slam_tpu/place/database.py:29-196 (`KeyFrameDatabase`), which
replaces the reference's inverted file (src/KeyFrameDatabase.cc): every
keyframe's sparse BoW vector is a row of `bow_ids [K, W]` and `bow_w [K,
W]` on the device, and a query is scored against all K rows at once, one
batched `torch.searchsorted` (the JAX package vmaps `l1_score`).

The candidate logic is host numpy, copied verbatim, dict insertion order
included:
  * DetectLoopCandidates (KeyFrameDatabase.cc:75-196): exclude covisible
    KFs, >= 0.8 * max-common-words gate, min-score gate, covisibility-group
    score accumulation, 0.75 * best-accumulated-score cut;
  * DetectRelocalisationCandidates (198-308): the same without the
    covisible exclusion and the min score.
The scores are f32 sums whose order of addition differs from XLA's and
between the CPU and the card: a candidate at the 0.75 cut could change
sides by rounding.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from orb_slam_tpu_torch.device import require_device
from orb_slam_tpu_torch.place.vocabulary import (
    BIG, Vocabulary, bow_vector, l1_score, transform,
)


def _locked(fn):
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self.lock:
            return fn(self, *a, **k)
    return wrapper


class KeyFrameDatabase:
    """BoW store on `device` (the card unless the caller names another).
    Mutators and queries take `lock` (an RLock), as the reference guards
    its inverted file (KeyFrameDatabase::mMutex, KeyFrameDatabase.cc:41)."""

    def __init__(self, voc: Vocabulary, max_keyframes: int, n_slots: int,
                 device="cuda"):
        self.lock = threading.RLock()
        self.voc = voc
        self.K = max_keyframes
        self.W = n_slots
        self.device = require_device(device)
        self.bow_ids = torch.full((max_keyframes, n_slots), BIG,
                                  dtype=torch.int32, device=self.device)
        self.bow_w = torch.zeros((max_keyframes, n_slots), dtype=torch.float32,
                                 device=self.device)
        self.active = np.zeros(max_keyframes, bool)

    def __getstate__(self):
        """Copies and pickles carry the rows, not the lock."""
        state = self.__dict__.copy()
        del state["lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lock = threading.RLock()

    @_locked
    def add(self, slot: int, ids, w):
        """Register a keyframe's BoW vector (KeyFrameDatabase::add)."""
        self.bow_ids[slot] = ids
        self.bow_w[slot] = w
        self.active[slot] = True

    @_locked
    def erase(self, slot: int):
        self.bow_ids[slot] = BIG
        self.bow_w[slot] = 0.0
        self.active[slot] = False

    def compute_bow(self, desc, valid):
        """descriptors [N, 8] int32 -> (ids [W], w [W], node_ids [N]) on
        the descriptors' device."""
        words, nodes = transform(self.voc, desc, valid)
        weights = self.voc.device_arrays(desc.device)[3]
        ids, w = bow_vector(words, weights, n_slots=self.W)
        return ids, w, nodes

    def _scores(self, ids, w):
        """[K] L1 scores of the query against every row, as numpy."""
        return l1_score(ids, w, self.bow_ids, self.bow_w).cpu().numpy()

    @_locked
    def min_covisible_score(self, ids, w, covisible_slots, default=1.0):
        """Min L1 score of the query vs its active covisible keyframes, the
        loop-detection score floor (LoopClosing::DetectLoop,
        LoopClosing.cc:114-131). With no active covisible the reference's
        minScore keeps its initial 1.0 (LoopClosing.cc:114), which admits
        no candidate."""
        act = [c for c in covisible_slots if self.active[c]]
        if not act:
            return default
        scores = self._scores(ids, w)
        return float(scores[act].min())

    @_locked
    def scores_against_all(self, ids, w):
        """[K] L1 scores of query BoW vs every stored keyframe."""
        s = self._scores(ids, w)
        s[~self.active] = 0.0
        return s

    @_locked
    def shared_words_against_all(self, ids):
        """[K] count of common words (the maxCommonWords gate,
        KeyFrameDatabase.cc:92-121)."""
        q = ids.expand(self.bow_ids.shape).contiguous()
        pos = torch.searchsorted(self.bow_ids, q).clamp(0, self.W - 1)
        common = (self.bow_ids.gather(1, pos) == q) & (q < BIG)
        counts = common.sum(1).cpu().numpy()
        counts[~self.active] = 0
        return counts

    # ---------------------------------------------------------------- queries

    @_locked
    def detect_loop_candidates(self, ids, w, query_slot, covisible_slots,
                               min_score, covis_weights):
        """Loop candidates for the keyframe in `query_slot`.
        covisible_slots: slots connected to the query in the covisibility
        graph (excluded from candidacy but used for group scoring).
        covis_weights: [K, K] numpy covisibility weights for grouping.
        Returns list of candidate slots."""
        shared = self.shared_words_against_all(ids)
        exclude = np.zeros(self.K, bool)
        exclude[query_slot] = True
        for s in covisible_slots:
            exclude[s] = True
        shared_m = np.where(exclude, 0, shared)
        if shared_m.max() == 0:
            return []
        min_common = int(0.8 * shared_m.max())
        cand = np.where((shared_m > min_common) & (shared_m > 0))[0]
        if len(cand) == 0:
            return []
        scores = self.scores_against_all(ids, w)
        cand = [c for c in cand if scores[c] >= min_score]
        if not cand:
            return []
        # covisibility-group score accumulation (KeyFrameDatabase.cc:138-167):
        # group = candidate's 10 strongest covisibles; a member contributes
        # when its shared-word count beats minCommonWords, with no min-score
        # gate inside the accumulation (KeyFrameDatabase.cc:158)
        acc_scores = {}
        for c in cand:
            group = np.where(covis_weights[c] > 0)[0]
            order = np.argsort(-covis_weights[c][group])
            group = group[order][:10]
            acc = scores[c]
            best_in_group = c
            best_sc = scores[c]
            for g in group:
                if shared_m[g] > min_common:
                    acc += scores[g]
                    if scores[g] > best_sc:
                        best_sc = scores[g]
                        best_in_group = g
            acc_scores[best_in_group] = max(
                acc_scores.get(best_in_group, 0.0), acc
            )
        if not acc_scores:
            return []
        # bestAccScore seeded with minScore (KeyFrameDatabase.cc:144)
        best_acc = max(max(acc_scores.values()), min_score)
        return [c for c, a in acc_scores.items() if a > 0.75 * best_acc]

    @_locked
    def detect_relocalisation_candidates(self, ids, w, covis_weights):
        """Relocalisation candidates for a lost frame
        (KeyFrameDatabase.cc:198-308)."""
        return self.relocalisation_scores(ids, w, covis_weights)[0]

    @_locked
    def relocalisation_scores(self, ids, w, covis_weights):
        """(the candidates of `detect_relocalisation_candidates`, their
        accumulated scores by group best {slot: score}, the cut 0.75 * the
        best of them): the cut and the scores show how near a candidate
        came to the other side."""
        shared = self.shared_words_against_all(ids)
        if shared.max() == 0:
            return [], {}, None
        min_common = int(0.8 * shared.max())
        cand = np.where(shared > max(min_common, 0))[0]
        if len(cand) == 0:
            return [], {}, None
        scores = self.scores_against_all(ids, w)
        # group member gate: any top-10 covisible sharing >= 1 word with
        # the query (the mnRelocQuery check only, KeyFrameDatabase.cc:272-275),
        # always with the current query's score
        acc_scores = {}
        for c in cand:
            group = np.where(covis_weights[c] > 0)[0]
            order = np.argsort(-covis_weights[c][group])
            group = group[order][:10]
            acc = scores[c]
            best_in_group, best_sc = c, scores[c]
            for g in group:
                if shared[g] > 0:
                    acc += scores[g]
                    if scores[g] > best_sc:
                        best_sc, best_in_group = scores[g], g
            acc_scores[best_in_group] = max(acc_scores.get(best_in_group, 0.0), acc)
        best_acc = max(acc_scores.values())
        cut = 0.75 * best_acc
        return [c for c, a in acc_scores.items() if a > cut], acc_scores, cut
