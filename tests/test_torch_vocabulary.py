"""The port's vocabulary (orb_slam_tpu_torch/place/vocabulary.py and the
native parser) against the JAX package's, on the CPU, from the same numpy
inputs.

Tolerances and why: `transform` (words and the node ids `levels_up`
above the leaves), `bow_vector`'s ids, the trained trees and the parsed
text files are integer or copied host computations: equal. The BoW
weights and L1 scores are f32 sums whose order of addition differs
between XLA and torch: within 1e-6 (they are at most 1). The copied
parser source is byte-equal to the JAX package's.
"""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.place import vocabulary as jv
from orb_slam_tpu.place.pretrained import load_pretrained as jax_pretrained
from orb_slam_tpu_torch import native
from orb_slam_tpu_torch.convert import vocabulary_from_numpy
from orb_slam_tpu_torch.place import vocabulary as tv
from orb_slam_tpu_torch.place.pretrained import load_pretrained

REPO = Path(__file__).resolve().parents[1]


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def random_descs(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def assert_same_vocabulary(t, j):
    """Every field of the port's Vocabulary equal to the JAX one's."""
    assert (t.k, t.L) == (j.k, j.L)
    np.testing.assert_array_equal(t.node_desc, np.asarray(j.node_desc).view(np.int32))
    for f in ("children", "is_leaf", "word_of_node", "node_of_word", "word_weight",
              "level_of_node"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


@pytest.fixture(scope="module")
def shipped():
    return load_pretrained(), jax_pretrained()


def test_parser_source_is_a_byte_equal_copy():
    assert filecmp.cmp(REPO / "orb_slam_tpu" / "native" / "vocab_parser.cpp",
                       native.SOURCE, shallow=False)


def test_shipped_vocabulary_read_by_path(shipped):
    t, j = shipped
    assert len(t.node_desc) == 106_145 and t.n_words == 95_118
    assert_same_vocabulary(t, j)
    assert load_pretrained() is t                     # cached per process


def _tie_at_root(voc, rng):
    """A descriptor whose Hamming distances to two root children are equal
    and the least of all root children."""
    ch = voc.children[0][voc.children[0] >= 0]
    d = voc.node_desc.view(np.uint32)
    for a in range(len(ch)):
        for b in range(a + 1, len(ch)):
            ca, cb = d[ch[a]], d[ch[b]]
            diff = np.unpackbits((ca ^ cb).view(np.uint8))
            idx = np.where(diff)[0]
            bits = np.unpackbits(ca.view(np.uint8))
            take = rng.permutation(idx)[: len(idx) // 2]
            bits[take] = np.unpackbits(cb.view(np.uint8))[take]
            q = np.packbits(bits).view(np.uint32)
            ham = [int(np.unpackbits((q ^ d[c]).view(np.uint8)).sum()) for c in ch]
            if ham[a] == ham[b] == min(ham):
                return q, ch[ham.index(min(ham))]
    raise AssertionError("no root tie found")


@pytest.mark.parametrize("levels_up", [1, 4, 5, 7])
def test_transform_shipped_tree(shipped, rng, levels_up):
    """Words and node ids exactly equal on 500 random descriptors, 84
    descriptors at the shallow (level-4) leaves, and one tied at the root
    (the first child wins, as jnp.argmin); some rows invalid."""
    t, j = shipped
    shallow = np.where(t.is_leaf & (t.level_of_node < t.L))[0]
    q_tie, first = _tie_at_root(t, rng)
    q = np.concatenate([random_descs(rng, 500), t.node_desc[shallow].view(np.uint32),
                        q_tie[None]])
    valid = rng.random(len(q)) > 0.1
    valid[-1] = True
    wt, nt = tv.transform(t, i32(q), torch.from_numpy(valid), levels_up=levels_up)
    wj, nj = jv.transform(j, jnp.asarray(q), jnp.asarray(valid), levels_up=levels_up)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    words = wt.numpy()
    assert np.isin(t.node_of_word[words[words >= 0]], shallow).any()
    w_tie = words[-1]
    node = t.node_of_word[w_tie]
    while t.level_of_node[node] > 1:              # climb to the root child
        node = np.where((t.children == node).any(1))[0][0]
    assert node == first


def test_bow_vector_and_l1_score(shipped, rng):
    """ids exact, weights within 1e-6, at the default slots and in JAX's
    overflow case (tests/test_place.py:179): more unique words than slots,
    the extra ones dropped and the norm over the kept ones."""
    t, j = shipped
    q = random_descs(rng, 400)
    words = tv.transform(t, i32(q))[0]
    ww_t = torch.from_numpy(t.word_weight)
    ww_j = jnp.asarray(j.word_weight)
    n_unique = len(np.unique(words.numpy()[words.numpy() >= 0]))
    bows = {}
    for W in (400, max(n_unique // 2, 4)):
        it, wt_ = tv.bow_vector(words, ww_t, n_slots=W)
        ij, wj_ = jv.bow_vector(jnp.asarray(words.numpy()), ww_j, n_slots=W)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt_.numpy(), np.asarray(wj_), atol=1e-6)
        bows[W] = (it, wt_, ij, wj_)
    it, wt_, ij, wj_ = bows[400]
    q2 = q.copy()
    q2[::3, 0] ^= np.uint32(1 << 7)
    w2 = tv.transform(t, i32(q2))[0]
    it2, wt2 = tv.bow_vector(w2, ww_t, n_slots=400)
    ij2, wj2 = jv.bow_vector(jnp.asarray(w2.numpy()), ww_j, n_slots=400)
    for a, b in (((it, wt_, it2, wt2), (ij, wj_, ij2, wj2)),
                 ((it, wt_, it, wt_), (ij, wj_, ij, wj_))):
        st, sj = float(tv.l1_score(*a)), float(jv.l1_score(*b))
        assert abs(st - sj) <= 1e-6, (st, sj)
    # the batched form: one score per row
    rows_i = torch.stack([it2, it, torch.full((400,), 2 ** 30, dtype=torch.int32)])
    rows_w = torch.stack([wt2, wt_, torch.zeros(400)])
    s = tv.l1_score(it, wt_, rows_i, rows_w).numpy()
    np.testing.assert_allclose(s, [float(jv.l1_score(ij, wj_, ij2, wj2)), 1.0, 0.0],
                               atol=1e-6)


@pytest.mark.parametrize("with_documents", [False, True])
def test_train_vocabulary_bit_equal(rng, with_documents):
    """The same seed builds the same tree and idf weights, bit for bit."""
    train = random_descs(rng, 600)
    docs = [train[i:i + 100] for i in range(0, 600, 100)] if with_documents else None
    t = tv.train_vocabulary(train.view(np.int32), k=5, L=3, seed=3, documents=docs)
    j = jv.train_vocabulary(train, k=5, L=3, seed=3, documents=docs)
    assert_same_vocabulary(t, j)


def test_npz_and_text_round_trips(rng, tmp_path):
    """npz both ways between the packages; save_text writes JAX's bytes; the
    port reads its own text file back into the same tree."""
    j = jv.train_vocabulary(random_descs(rng, 300), k=4, L=3, seed=1)
    t = vocabulary_from_numpy(vars(j))
    assert_same_vocabulary(t, j)
    tv.save_npz(t, tmp_path / "t.npz")
    jv.save_npz(j, tmp_path / "j.npz")
    assert_same_vocabulary(tv.load_npz(tmp_path / "j.npz"), j)
    assert_same_vocabulary(tv.load_npz(tmp_path / "t.npz"), jv.load_npz(tmp_path / "t.npz"))
    tv.save_text(t, tmp_path / "t.txt")
    jv.save_text(j, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    back = tv.load_text(str(tmp_path / "t.txt"))
    np.testing.assert_array_equal(back.node_desc, t.node_desc)
    np.testing.assert_array_equal(back.children, t.children)
    np.testing.assert_allclose(back.word_weight, t.word_weight, atol=1e-6)


def test_native_load_text_on_an_11k_node_tree(rng, tmp_path):
    """A full k=10, L=4 tree in DBoW2 text (tests/test_place.py:131): the
    native parser, the plain parser and JAX's load_text give equal trees,
    and transform equal words on them."""
    k, L = 10, 4
    rows, level_nodes, next_id = [], [[0]], 1
    for lvl in range(L):
        cur = []
        for p in level_nodes[-1]:
            for _ in range(k):
                is_leaf = 1 if lvl == L - 1 else 0
                d = rng.integers(0, 256, 32)
                w = rng.uniform(0.1, 1.0) if is_leaf else 0.0
                rows.append(f"{p} {is_leaf} {' '.join(map(str, d))} {w:.6f}")
                cur.append(next_id)
                next_id += 1
        level_nodes.append(cur)
    path = str(tmp_path / "voc.txt")
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n" + "\n".join(rows) + "\n")
    t = tv.load_text(path)
    assert t.n_words == k ** L
    j = jv.load_text(path)
    assert_same_vocabulary(t, j)
    assert_same_vocabulary(tv.load_text_plain(path), j)
    q = random_descs(rng, 200)
    np.testing.assert_array_equal(tv.transform(t, i32(q))[0].numpy(),
                                  np.asarray(jv.transform(j, jnp.asarray(q))[0]))


def test_native_parser_rejects_a_bad_file(tmp_path):
    """No silent fallback: a file the parser cannot read raises."""
    with pytest.raises(ValueError):
        tv.load_text(str(tmp_path / "missing.txt"))
