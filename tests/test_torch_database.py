"""The port's KeyFrameDatabase (orb_slam_tpu_torch/place/database.py)
against the JAX package's, on the CPU, on the same BoW vectors and
covisibility weights.

Both databases share one vocabulary (trained by the JAX package, carried
over by convert.py) and get the same keyframes: random descriptor sets
and re-observations of them with a few bits flipped. Tolerances and why:
the stored ids, the active flags and the shared-word counts are integers:
equal; the stored weights and the L1 scores are f32 sums in another order
than XLA's: within 1e-6. The candidate lists are host numpy over those
scores, copied verbatim, and must come out equal and in equal order; the
test also checks that no accumulated score lies within 1e-5 of the 0.75
cut, where that order of addition could decide membership. The two cases
of tests/test_perceptual_aliasing.py run on the port as they run on JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.place import KeyFrameDatabase as JaxDatabase
from orb_slam_tpu.place import train_vocabulary as jax_train
from orb_slam_tpu_torch.convert import vocabulary_from_numpy
from orb_slam_tpu_torch.place import KeyFrameDatabase, train_vocabulary
from tests.test_perceptual_aliasing import SelfSimilarWorld

K, W = 16, 160


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def perturb(rng, descs, bits):
    d = descs.copy()
    n = len(d)
    for _ in range(bits):
        w = rng.integers(0, 8, n)
        b = rng.integers(0, 32, n).astype(np.uint32)
        d[np.arange(n), w] ^= np.uint32(1) << b
    return d


class Both:
    """A JAX and a port database fed the same keyframes."""

    def __init__(self, jvoc, max_keyframes=K, n_slots=W, drop=True):
        self.drop = drop    # every 11th feature invalid
        self.j = JaxDatabase(jvoc, max_keyframes, n_slots)
        self.t = KeyFrameDatabase(vocabulary_from_numpy(vars(jvoc)), max_keyframes,
                                  n_slots, device="cpu")

    def bow(self, desc):
        valid = np.ones(len(desc), bool)
        valid[::11] = not self.drop
        ij, wj, _ = self.j.compute_bow(jnp.asarray(desc), jnp.asarray(valid))
        it, wt, _ = self.t.compute_bow(i32(desc), torch.from_numpy(valid))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
        return (ij, wj), (it, wt)

    def add(self, slot, desc):
        (ij, wj), (it, wt) = self.bow(desc)
        self.j.add(slot, ij, wj)
        self.t.add(slot, it, wt)

    def erase(self, slot):
        self.j.erase(slot)
        self.t.erase(slot)

    def assert_rows_equal(self):
        np.testing.assert_array_equal(self.t.active, self.j.active)
        np.testing.assert_array_equal(self.t.bow_ids.numpy(), np.asarray(self.j.bow_ids))
        np.testing.assert_allclose(self.t.bow_w.numpy(), np.asarray(self.j.bow_w),
                                   atol=1e-6)


@pytest.fixture(scope="module")
def world():
    """(the JAX vocabulary, 10 keyframe descriptor sets); a k=6, L=3 tree
    trained on a corpus with shared texture families, so that keyframes
    share words."""
    rng = np.random.default_rng(7)
    fam = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    corpus = perturb(rng, fam[rng.integers(0, 40, 1200)], 20)
    jvoc = jax_train(corpus, k=6, L=3, seed=1)
    kfs = [perturb(rng, fam[rng.integers(0, 40, 120)], 20) for _ in range(10)]
    return jvoc, kfs


def test_trained_vocabulary_matches(world):
    jvoc, _ = world
    rng = np.random.default_rng(7)
    fam = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    corpus = perturb(rng, fam[rng.integers(0, 40, 1200)], 20)
    t = train_vocabulary(corpus.view(np.int32), k=6, L=3, seed=1)
    np.testing.assert_array_equal(t.node_desc, jvoc.node_desc.view(np.int32))
    np.testing.assert_array_equal(t.word_weight, jvoc.word_weight)


def test_add_erase_and_scores(world):
    """Rows after adds and erases, the L1 scores against all keyframes, the
    shared-word counts and the covisible score floor."""
    jvoc, kfs = world
    rng = np.random.default_rng(1)
    b = Both(jvoc)
    for k, d in enumerate(kfs):
        b.add(k, d)
    b.erase(3)
    b.erase(7)
    b.add(7, kfs[2])
    b.assert_rows_equal()
    for src in (2, 5, 9):
        (ij, wj), (it, wt) = b.bow(perturb(rng, kfs[src], 6))
        st, sj = b.t.scores_against_all(it, wt), b.j.scores_against_all(ij, wj)
        np.testing.assert_allclose(st, sj, atol=1e-6)
        assert st[3] == 0.0 and st[src] == st.max()
        np.testing.assert_array_equal(b.t.shared_words_against_all(it),
                                      b.j.shared_words_against_all(ij))
        for covis in ([], [3], [1, 4, 8], [0, 2, 7]):
            mt = b.t.min_covisible_score(it, wt, covis)
            mj = b.j.min_covisible_score(ij, wj, covis)
            assert abs(mt - mj) <= 1e-6, (covis, mt, mj)


def _covis(rng, density):
    w = rng.integers(0, 60, (K, K)) * (rng.random((K, K)) < density)
    w = np.triu(w, 1)
    return (w + w.T).astype(np.int32)


@pytest.mark.parametrize("density", [0.0, 0.3, 0.8])
def test_candidate_queries_equal_in_order(world, density):
    """Both candidate queries return equal lists in equal order, for
    queries re-observing several keyframes, under covisibility graphs from
    empty to dense."""
    jvoc, kfs = world
    rng = np.random.default_rng(int(density * 10) + 3)
    b = Both(jvoc)
    for k, d in enumerate(kfs):
        b.add(k, d)
    b.erase(4)
    covis = _covis(rng, density)
    for src in range(0, 10, 2):
        q = perturb(rng, kfs[src], 8)
        (ij, wj), (it, wt) = b.bow(q)
        ct = b.t.detect_relocalisation_candidates(it, wt, covis)
        cj = b.j.detect_relocalisation_candidates(ij, wj, covis)
        assert ct == cj and len(ct) > 0, (ct, cj)
        _, acc, cut = b.t.relocalisation_scores(it, wt, covis)
        assert min(abs(a - cut) for a in acc.values()) > 1e-5
        covisible = [int(c) for c in np.where(covis[src] > 0)[0]]
        for min_score in (0.0, 0.02, b.j.min_covisible_score(ij, wj, covisible)):
            lt = b.t.detect_loop_candidates(it, wt, src, covisible, min_score, covis)
            lj = b.j.detect_loop_candidates(ij, wj, src, covisible, min_score, covis)
            assert lt == lj, (src, min_score, lt, lj)


def _aliased(rng):
    """tests/test_perceptual_aliasing.py's _setup, on both packages."""
    world = SelfSimilarWorld(rng)
    corpus = np.concatenate([world.image() for _ in range(12)])
    b = Both(jax_train(corpus, k=6, L=3, seed=1), max_keyframes=16, n_slots=160,
             drop=False)
    return world, b


def test_no_covisible_floor_admits_nothing(rng):
    world, b = _aliased(rng)
    for k in range(6):
        b.add(k, world.image())
    (ij, wj), (it, wt) = b.bow(world.image())
    scores = b.t.scores_against_all(it, wt)
    assert scores.max() > 0.05
    assert b.t.min_covisible_score(it, wt, covisible_slots=[]) == 1.0
    covis = np.zeros((16, 16), np.int32)
    assert b.t.detect_loop_candidates(it, wt, 7, [], 1.0, covis) == []
    floor_t = b.t.detect_loop_candidates(it, wt, 7, [], 0.05, covis)
    assert len(floor_t) > 0
    assert floor_t == b.j.detect_loop_candidates(ij, wj, 7, [], 0.05, covis)


def test_covisible_min_score_rejects_aliased_place(rng):
    world, b = _aliased(rng)
    cur = world.image()
    for k in range(3):
        b.add(k, world.reobserve(cur))
    alias_slots = list(range(3, 8))
    for k in alias_slots:
        b.add(k, world.image())
    (ij, wj), (it, wt) = b.bow(world.reobserve(cur))
    scores = b.t.scores_against_all(it, wt)
    min_score = b.t.min_covisible_score(it, wt, [0, 1, 2])
    assert scores[alias_slots].max() > 0.05
    assert min_score > scores[alias_slots].max()
    covis = np.zeros((16, 16), np.int32)
    for a in (0, 1, 2):
        covis[8, a] = covis[a, 8] = 40
    assert b.t.detect_loop_candidates(it, wt, 8, [0, 1, 2], min_score, covis) == []
    floor_t = b.t.detect_loop_candidates(it, wt, 8, [0, 1, 2], 0.05, covis)
    assert len(floor_t) > 0
    assert floor_t == b.j.detect_loop_candidates(ij, wj, 8, [0, 1, 2], 0.05, covis)
