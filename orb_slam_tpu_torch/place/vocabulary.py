"""Vocabulary tree: training, transform (descriptor -> word), BoW scoring.

Port of orb_slam_tpu/place/vocabulary.py: `Vocabulary` (:22-58),
`_pack_bits`/`_unpack_bits`/`_kmajority` (:65-112), `train_vocabulary`
(:115-191), `save_npz`/`load_npz` (:196-220), `transform`
(`_transform_device` and its wrapper, :223-265), `bow_vector` (:268-305),
`l1_score` (:308-322) and `save_text`/`load_text` (:327-408); the
reference's DBoW2::TemplatedVocabulary (Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h) as flat arrays, descended for all descriptors at
once.

Descriptors and `node_desc` are [n, 8] int32 words holding the bits of
the JAX package's uint32 words (the port's convention, ops/matching.py).
`Vocabulary` keeps numpy fields; `device_arrays(device)` puts them on an
explicit device and keeps them there (36 MB of node descriptors at the
1,111,111-node shape of ORBvoc.txt), so fields are replaced, never edited
in place. The per-level Hamming distance is a byte popcount table over
the XOR viewed as uint8 (torch has no popcount); ties among the k children
go to the first, as `jnp.argmin` does, by ranking distance * k + child
slot. Training is host numpy, copied verbatim: with the same seed it
builds the same tree bit for bit. `load_text` parses with the native
parser of `orb_slam_tpu_torch.native`; `load_text_plain` is the
pure-Python parser it is held against. No function here is a kernel of
ours: the JAX versions are XLA ops, not Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

BIG = 2 ** 30    # the padding id of a BoW vector
_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(1).astype(np.uint16)
_LUT = {}


@dataclass
class Vocabulary:
    """Flat-array k-ary vocabulary tree.

    children: [n_nodes, k] i32 child node ids (-1 = none)
    node_desc: [n_nodes, 8] i32 packed mean descriptors
    is_leaf: [n_nodes] bool
    word_of_node: [n_nodes] i32 word index for leaves (-1 otherwise)
    node_of_word: [n_words] i32 reverse map
    word_weight: [n_words] f32 idf weights
    level_of_node: [n_nodes] i32 depth (root = 0)
    k, L: branching factor / depth
    """

    children: np.ndarray
    node_desc: np.ndarray
    is_leaf: np.ndarray
    word_of_node: np.ndarray
    node_of_word: np.ndarray
    word_weight: np.ndarray
    level_of_node: np.ndarray
    k: int
    L: int
    _on_device: dict = field(default_factory=dict, init=False, repr=False,
                             compare=False)

    @property
    def n_words(self):
        return len(self.node_of_word)

    def device_arrays(self, device):
        """(children, node_desc, word_of_node, word_weight, level_of_node)
        as tensors on `device`, copied once per device and again only if a
        field was replaced."""
        device = torch.device(device)
        host = (self.children, self.node_desc, self.word_of_node,
                self.word_weight, self.level_of_node)
        hit = self._on_device.get(device)
        if hit is None or any(a is not b for a, b in zip(hit[0], host)):
            tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            for a in host)
            self._on_device[device] = hit = (host, tensors)
        return hit[1]


def _as_u32(descs):
    """[M, 8] words (uint32, or int32 holding the same bits) as uint32."""
    d = np.ascontiguousarray(descs)
    return d.view(np.uint32) if d.dtype == np.int32 else d.astype(np.uint32)


def _pack_bits(bits):
    """[M, 256] uint8/bool -> [M, 8] u32."""
    b = np.asarray(bits, np.uint32).reshape(-1, 8, 32)
    return (b << np.arange(32, dtype=np.uint32)[None, None, :]).sum(-1).astype(np.uint32)


def _unpack_bits(packed):
    """[M, 8] u32 -> [M, 256] uint8."""
    p = np.asarray(packed)[:, :, None]
    return ((p >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1).reshape(
        -1, 256
    ).astype(np.uint8)


def _kmajority(descs, k, rng, iters=8):
    """Binary k-means with majority-vote means (FORB::meanValue,
    Thirdparty/DBoW2/DBoW2/FORB.cpp:28-77). descs: [M, 8] u32 numpy.
    Returns (centers [k', 8] u32, assignment [M])."""
    M = len(descs)
    k = min(k, M)
    if k == 0:
        return np.zeros((0, 8), np.uint32), np.zeros(0, np.int64)
    centers = descs[rng.choice(M, k, replace=False)]
    bits = _unpack_bits(descs)  # [M, 256]
    assign = np.zeros(M, np.int64)
    for _ in range(iters):
        x = descs[:, None, :] ^ centers[None, :, :]
        d = _POPCOUNT8[x.view(np.uint8)].sum(-1, dtype=np.uint32)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            assign = new_assign
            break
        assign = new_assign
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) == 0:
                centers[c] = descs[rng.integers(0, M)]
            else:
                maj = (sel.mean(0) >= 0.5).astype(np.uint8)
                centers[c] = _pack_bits(maj[None])[0]
    return centers, assign


def _words_on_host(voc, descs_u32):
    """transform's word ids of a uint32 numpy descriptor set, on the CPU."""
    d = torch.from_numpy(np.ascontiguousarray(descs_u32).view(np.int32))
    return transform(voc, d)[0].numpy()


def train_vocabulary(descriptors, k=10, L=3, seed=0, weighting="tfidf",
                     documents=None):
    """Hierarchical k-majority clustering (DBoW2 create equivalent).
    descriptors: [M, 8] words (uint32, or int32 of the same bits), the
    training set. Returns Vocabulary.

    documents: optional list of per-image descriptor arrays; when given,
    idf weights use document frequency (the DBoW2 TF_IDF weighting,
    TemplatedVocabulary.h setNodeWeights) instead of treating each
    descriptor as its own document."""
    rng = np.random.default_rng(seed)
    descriptors = _as_u32(descriptors)

    children_list = [[]]  # node 0 = root
    desc_list = [np.zeros(8, np.uint32)]
    level_list = [0]
    parent_of = [-1]

    def build(node_id, node_descs, level):
        if level == L or len(node_descs) < 2:
            return
        centers, assign = _kmajority(node_descs, k, rng)
        for c in range(len(centers)):
            cid = len(desc_list)
            desc_list.append(centers[c])
            level_list.append(level + 1)
            parent_of.append(node_id)
            children_list.append([])
            children_list[node_id].append(cid)
            sub = node_descs[assign == c]
            build(cid, sub, level + 1)

    build(0, descriptors, 0)

    n_nodes = len(desc_list)
    children = np.full((n_nodes, k), -1, np.int32)
    for nid, ch in enumerate(children_list):
        children[nid, : len(ch)] = ch
    is_leaf = (children[:, 0] == -1)
    is_leaf[0] = False if n_nodes > 1 else True
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaves = np.where(is_leaf)[0]
    word_of_node[leaves] = np.arange(len(leaves))
    node_of_word = leaves.astype(np.int32)

    voc = Vocabulary(
        children=children,
        node_desc=np.stack(desc_list).astype(np.uint32).view(np.int32),
        is_leaf=is_leaf,
        word_of_node=word_of_node,
        node_of_word=node_of_word,
        word_weight=np.ones(len(leaves), np.float32),
        level_of_node=np.asarray(level_list, np.int32),
        k=k,
        L=L,
    )
    if weighting == "tfidf" and len(descriptors):
        if documents is not None:
            # document-frequency idf (TemplatedVocabulary.h setNodeWeights)
            df = np.zeros(len(leaves), np.int64)
            for doc in documents:
                doc = _as_u32(doc)
                if not len(doc):
                    continue
                w = _words_on_host(voc, doc)
                df[np.unique(w[w >= 0])] += 1
            n_docs = max(len(documents), 1)
            idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
            idf[df == 0] = 0.0
            voc.word_weight = np.maximum(idf, 1e-3)
        else:
            # fallback: one document per descriptor
            words = _words_on_host(voc, descriptors)
            counts = np.bincount(words[words >= 0], minlength=len(leaves))
            n_docs = max(len(descriptors), 1)
            idf = np.log(n_docs / np.maximum(counts, 1)).astype(np.float32)
            idf[counts == 0] = 0.0
            voc.word_weight = np.maximum(idf, 1e-3)
    return voc


# ----------------------------------------------------------------- npz format

def save_npz(voc: Vocabulary, path: str):
    """The JAX package's npz artifact (node descriptors stored as uint32,
    so either package reads it)."""
    np.savez_compressed(
        path, children=voc.children, node_desc=_as_u32(voc.node_desc),
        is_leaf=voc.is_leaf, word_weight=voc.word_weight,
        level_of_node=voc.level_of_node, kL=np.asarray([voc.k, voc.L]))


def load_npz(path: str) -> Vocabulary:
    d = np.load(path)
    is_leaf = d["is_leaf"].astype(bool)
    n_nodes = len(is_leaf)
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaves = np.where(is_leaf)[0]
    word_of_node[leaves] = np.arange(len(leaves))
    k, L = (int(x) for x in d["kL"])
    return Vocabulary(
        children=d["children"], node_desc=_as_u32(d["node_desc"]).view(np.int32),
        is_leaf=is_leaf, word_of_node=word_of_node,
        node_of_word=leaves.astype(np.int32), word_weight=d["word_weight"],
        level_of_node=d["level_of_node"], k=k, L=L)


# ------------------------------------------------------------------ transform

def _popcount_lut(device):
    lut = _LUT.get(device)
    if lut is None:
        lut = _LUT[device] = torch.from_numpy(_POPCOUNT8.astype(np.int32)).to(device)
    return lut


def transform(voc: Vocabulary, descs, valid=None, levels_up: int = 4):
    """descs [N, 8] int32 words on any device -> (word ids [N] i32, -1
    where not valid; node ids [N] i32 at `levels_up` above the leaves, the
    FeatureVector grouping level the reference uses for matching,
    Frame.cc:285), on descs' device. A descriptor stays at a node without
    children (a shallow leaf)."""
    dev = descs.device
    N = descs.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=dev)
    children, node_desc, word_of_node, _, _ = voc.device_arrays(dev)
    n_nodes, k = children.shape
    lut = _popcount_lut(dev)
    slot = torch.arange(k, device=dev)
    q = descs.contiguous()[:, None, :]
    cur = torch.zeros(N, dtype=torch.int64, device=dev)       # the root
    node_at_lu = torch.zeros(N, dtype=torch.int32, device=dev)
    target_level = max(voc.L - levels_up, 0)
    for lvl in range(voc.L):
        ch = children[cur]                                    # [N, k]
        has = ch >= 0
        cdesc = node_desc[ch.clamp(0, n_nodes - 1).long()]    # [N, k, 8]
        x = (cdesc ^ q).view(torch.uint8)                     # [N, k, 32]
        d = lut[x.long()].sum(-1)
        d = torch.where(has, d, 10 ** 9)
        best = (d * k + slot).argmin(-1)    # the first minimum, as jnp.argmin
        nxt = ch.gather(1, best[:, None])[:, 0]
        cur = torch.where(nxt >= 0, nxt.long(), cur)
        if lvl + 1 == target_level:
            node_at_lu = cur.to(torch.int32)
    words = torch.where(valid, word_of_node[cur], -1)
    return words, node_at_lu


def bow_vector(words, weights_of_word, n_slots=None):
    """Aggregate per-feature word ids into a sorted sparse BoW vector.

    words: [N] i32 (-1 invalid). weights_of_word: [n_words] f32 tensor.
    Returns (ids [W] i32, w [W] f32) with W = n_slots or N: unique sorted
    word ids (padded with BIG = 2^30) and L1-normalised tf-idf weights
    (BowVector::normalize, DBoW2/BowVector.cpp:63-84). Unique words past
    W are dropped into a dump slot, and the norm is over the kept ones."""
    dev = words.device
    N = words.shape[0]
    W = n_slots or N
    w_sorted = torch.sort(torch.where(words >= 0, words, BIG)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       w_sorted[1:] != w_sorted[:-1]]) & (w_sorted < BIG)
    uniq_rank = torch.cumsum(first, 0) - 1
    in_range = (w_sorted < BIG) & (uniq_rank < W)
    slot = torch.where(in_range, uniq_rank, W)
    tf = torch.zeros(W + 1, dtype=torch.float32, device=dev).index_add(
        0, slot, in_range.to(torch.float32))[:W]
    keep = first & in_range
    ids = torch.full((W + 1,), BIG, dtype=torch.int32, device=dev).scatter(
        0, torch.where(keep, uniq_rank, W),
        torch.where(keep, w_sorted, BIG).to(torch.int32))[:W]
    n_words = weights_of_word.shape[0]
    wt = tf * torch.where(ids < BIG,
                          weights_of_word[ids.clamp(0, n_words - 1).long()], 0.0)
    norm = torch.clamp(wt.abs().sum(), min=1e-12)
    return ids, wt / norm


def l1_score(ids1, w1, ids2, w2):
    """DBoW2 L1 score between sorted sparse BoW vectors:
    s = 0.5 * sum_common(|v| + |w| - |v - w|), in [0, 1]
    (ScoringObject.cpp:23-67), a merge by searchsorted. ids2 and w2 may
    carry leading batch dimensions: one score of the query (ids1 [W], w1
    [W]) against each row, in one batched searchsorted."""
    q = ids1.expand(ids2.shape[:-1] + ids1.shape[-1:]).contiguous()
    pos = torch.searchsorted(ids2.contiguous(), q)
    pos = pos.clamp(0, ids2.shape[-1] - 1)
    match_ = ids2.gather(-1, pos) == q
    v = w1
    w = torch.where(match_, w2.gather(-1, pos), 0.0)
    common = torch.where(match_, v.abs() + w.abs() - (v - w).abs(), 0.0)
    return 0.5 * common.sum(-1)


# ---------------------------------------------------------------- text format

def save_text(voc: Vocabulary, path: str):
    """DBoW2-compatible text format: first line `k L scoring weighting`,
    then per non-root node: `parent_id is_leaf d0..d31 weight`
    (TemplatedVocabulary.h saveToTextFile)."""
    parent = np.full(len(voc.node_desc), -1, np.int64)
    for nid in range(len(voc.children)):
        for c in voc.children[nid]:
            if c >= 0:
                parent[c] = nid
    bytes_ = np.ascontiguousarray(voc.node_desc).view(np.uint8).reshape(-1, 32)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L} 0 0\n")
        for nid in range(1, len(voc.node_desc)):
            w = (
                voc.word_weight[voc.word_of_node[nid]]
                if voc.is_leaf[nid]
                else 0.0
            )
            d = " ".join(str(int(b)) for b in bytes_[nid])
            f.write(f"{parent[nid]} {1 if voc.is_leaf[nid] else 0} {d} {w:.6f}\n")


def load_text(path: str) -> Vocabulary:
    """Parse the DBoW2 text vocabulary format (ORBvoc.txt compatible, the
    reference loads it at startup, src/main.cc:94-108) with the native
    mmap parser. Raises if the parser cannot be built or rejects the
    file."""
    from orb_slam_tpu_torch.native import parse_vocab_text

    k, L, parent1, leaf1, node_desc, w1 = parse_vocab_text(path)
    n_nodes = len(parent1) + 1
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[1:] = leaf1.astype(bool)
    weights = np.zeros(n_nodes, np.float32)
    weights[1:] = w1
    # children table: stable order preserves the file's child order
    nids = np.arange(1, n_nodes)
    order = np.argsort(parent1, kind="stable")
    sorted_pid = parent1[order]
    first = np.concatenate([[True], sorted_pid[1:] != sorted_pid[:-1]])
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(order)), 0))
    slot = np.arange(len(order)) - group_start
    children = np.full((n_nodes, k), -1, np.int32)
    children[sorted_pid, np.minimum(slot, k - 1)] = nids[order]
    # levels: parents precede children in the file; L passes converge
    level = np.zeros(n_nodes, np.int32)
    for _ in range(L + 1):
        level[1:] = level[parent1] + 1
    return _from_text_arrays(k, L, children, node_desc, is_leaf, weights, level)


def load_text_plain(path: str) -> Vocabulary:
    """The pure-Python parser of the same format, the plain version of
    `load_text`."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = [line.split() for line in f if line.strip()]
    n_nodes = len(rows) + 1
    children = np.full((n_nodes, k), -1, np.int32)
    node_desc = np.zeros((n_nodes, 32), np.uint8)
    is_leaf = np.zeros(n_nodes, bool)
    weights = np.zeros(n_nodes, np.float32)
    child_count = np.zeros(n_nodes, np.int32)
    level = np.zeros(n_nodes, np.int32)
    for i, r in enumerate(rows):
        nid = i + 1
        pid = int(r[0])
        is_leaf[nid] = bool(int(r[1]))
        node_desc[nid] = [int(x) for x in r[2:34]]
        weights[nid] = float(r[34])
        children[pid, child_count[pid]] = nid
        child_count[pid] += 1
        level[nid] = level[pid] + 1
    return _from_text_arrays(k, L, children, node_desc, is_leaf, weights, level)


def _from_text_arrays(k, L, children, node_desc, is_leaf, weights, level):
    """The Vocabulary of a parsed text file: node descriptors [n, 32]
    bytes packed little-endian into int32 words."""
    n_nodes = len(is_leaf)
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaves = np.where(is_leaf)[0]
    word_of_node[leaves] = np.arange(len(leaves))
    packed = node_desc.reshape(-1, 8, 4).astype(np.uint32)
    packed = (
        packed[..., 0]
        | (packed[..., 1] << 8)
        | (packed[..., 2] << 16)
        | (packed[..., 3] << 24)
    )
    return Vocabulary(
        children=children,
        node_desc=packed.astype(np.uint32).view(np.int32),
        is_leaf=is_leaf,
        word_of_node=word_of_node,
        node_of_word=leaves.astype(np.int32),
        word_weight=weights[leaves],
        level_of_node=level,
        k=k,
        L=L,
    )
