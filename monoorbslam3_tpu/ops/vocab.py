"""Bag-of-binary-words vocabulary: dense batched tree descent.

Analog of the vendored DBoW2 (thirdParty/DBoW2/
TemplatedVocabulary.h): a hierarchical k-means tree over 256-bit ORB
descriptors. The reference walks a pointer tree per descriptor
(TemplatedVocabulary.h:1066-1117); here the tree is flattened into dense
child tables and the descent is a fixed-depth sequence of batched masked
Hamming argmins — every descriptor descends in lockstep, one fused kernel.

Covers the reference's uses:
- `transform` -> word ids + mid-level node ids (the FeatureVector grouping
  that drives SearchByBow, ORBMatcher.cpp:131-185) + tf-idf BowVector;
- `score` (L1, BowVector similarity) for API parity (unused by the
  reference runtime — no loop closing — but part of the surface);
- `train` builds a vocabulary from sample descriptors with binary k-means
  (majority-bit medoids), replacing the 145 MB ORBvoc.txt load
  (ORBVocabulary.cpp:13) with a train-on-first-run flow. A text loader for
  DBoW2-format vocabularies is provided for compatibility.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_to_centers(descs: np.ndarray, centers: np.ndarray,
                        chunk: int = 16384) -> np.ndarray:
    """[n, 8]x[k, 8] uint32 -> [n, k] int32 Hamming, chunked byte-LUT
    popcount: the unpackbits form materializes n*k*256 bytes at once
    (0.5 GB at corpus scale), this stays at chunk*k*32."""
    n, k = len(descs), len(centers)
    out = np.empty((n, k), np.int32)
    cb = centers.view(np.uint8).reshape(1, k, 32)
    for s in range(0, n, chunk):
        db = descs[s:s + chunk].view(np.uint8).reshape(-1, 1, 32)
        out[s:s + chunk] = _POPCNT8[db ^ cb].sum(-1, dtype=np.int32)
    return out


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Binary centroid: per-bit majority vote over [n, 8] uint32 rows."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [n, 256]
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _binary_kmeans(descs: np.ndarray, k: int, rng, iters: int = 8):
    """k-means over binary descriptors with Hamming distance."""
    n = len(descs)
    if n <= k:
        return descs.copy(), np.arange(n) % max(len(descs), 1)
    centers = descs[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_to_centers(descs, centers)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _majority_centroid(sel)
            else:
                centers[c] = descs[rng.integers(0, n)]
    return centers, assign


class Vocabulary(NamedTuple):
    """Flattened vocabulary tree.

    Nodes are stored level-major; level l has k^l nodes (complete tree,
    padded with duplicated parents where training data ran out). The word
    layer is the last level.
    """

    k: int  # branching factor
    levels: int  # tree depth (word level = levels)
    node_desc: jnp.ndarray  # [n_nodes, 8] uint32 (all levels, level-major)
    level_offset: tuple  # static python tuple: start index of each level
    word_idf: jnp.ndarray  # [k**levels] idf weight per word
    group_level: int  # node level used for match bucketing (BoW groups)

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    # ------------------------------------------------------------------

    @staticmethod
    def train(descs: np.ndarray, k: int = 8, levels: int = 3,
              group_level: int = 1, seed: int = 0) -> "Vocabulary":
        """Hierarchical binary k-means (the DBoW2 build, done in-process)."""
        rng = np.random.default_rng(seed)
        descs = np.asarray(descs, np.uint32).reshape(-1, 8)
        n_nodes = sum(k**l for l in range(1, levels + 1))
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        level_offset = []
        off = 0
        # recursively split; store per-level
        groups = {0: descs}  # parent slot -> member descriptors
        for l in range(1, levels + 1):
            level_offset.append(off)
            next_groups = {}
            n_level = k**l
            for parent, members in groups.items():
                if len(members) == 0:
                    # starved branch: pad every child with the parent's
                    # descriptor (the loader does the same for missing
                    # branches) so the complete-tree descent stays sound
                    pdesc = (node_desc[level_offset[l - 2] + parent]
                             if l >= 2 else np.zeros(8, np.uint32))
                    for c in range(k):
                        node_desc[off + parent * k + c] = pdesc
                        next_groups[parent * k + c] = members
                    continue
                centers, assign = _binary_kmeans(members, k, rng)
                for c in range(k):
                    slot = parent * k + c
                    if c < len(centers):
                        node_desc[off + slot] = centers[c]
                        next_groups[slot] = members[assign == c] if len(members) > k else members[:0]
                    else:
                        node_desc[off + slot] = centers[c % max(len(centers), 1)]
                        next_groups[slot] = members[:0]
            groups = next_groups
            off += n_level
        # idf: uniform until corpus statistics exist (reference computes tf-idf
        # from the training corpus; uniform weights preserve ranking behavior)
        idf = np.ones(k**levels, np.float32)
        return Vocabulary(
            k=k, levels=levels,
            node_desc=jnp.asarray(node_desc),
            level_offset=tuple(level_offset),
            word_idf=jnp.asarray(idf),
            group_level=group_level,
        )

    # ------------------------------------------------------------------

    def transform(self, desc: jnp.ndarray, valid: jnp.ndarray):
        """[N, 8] uint32 -> (word_id [N], group_id [N], bow [n_words]).

        word_id: leaf index; group_id: the ancestor node id at
        `group_level` (the FeatureVector node used to gate SearchByBow);
        bow: tf-idf-weighted normalized word histogram (BowVector).
        """
        return _transform_impl(self.node_desc, self.word_idf, desc, valid,
                               self.k, self.levels, self.level_offset,
                               self.group_level)

    def score(self, bow_a: jnp.ndarray, bow_b: jnp.ndarray) -> jnp.ndarray:
        """L1 BowVector similarity in [0, 1] (DBoW2 L1Scoring)."""
        return 1.0 - 0.5 * jnp.sum(jnp.abs(bow_a - bow_b))


@partial(jax.jit, static_argnames=("k", "levels", "level_offset", "group_level"))
def _transform_impl(node_desc, word_idf, desc, valid,
                    k: int, levels: int, level_offset: tuple, group_level: int):
    from .matching import _unpack_pm1

    N = desc.shape[0]
    A = _unpack_pm1(desc)  # [N, 256] +-1, unpacked once for all levels
    node = jnp.zeros(N, jnp.int32)  # slot within current level's parent order
    group = jnp.zeros(N, jnp.int32)
    for l in range(1, levels + 1):
        off = level_offset[l - 1]
        # children of `node` at this level occupy slots node*k .. node*k+k-1
        child_slots = node[:, None] * k + jnp.arange(k)[None, :]  # [N, k]
        child_desc = node_desc[off + child_slots]  # [N, k, 8]
        # +-1 contraction over the 256-lane minor dim instead of a
        # lane-starved [N, k, 8] XOR+popcount (hamming = (256 - A.C)/2;
        # argmin is unaffected by the affine map, so compare -A.C)
        C = _unpack_pm1(child_desc.reshape(-1, 8)).reshape(N, k, 256)
        d = -jnp.einsum("nc,nkc->nk", A, C, preferred_element_type=jnp.float32)
        best = jnp.argmin(d, axis=-1).astype(jnp.int32)
        node = node * k + best
        if l == group_level:
            group = node
    word = node
    word_m = jnp.where(valid, word, 0)
    hist = jnp.zeros(k**levels, jnp.float32).at[word_m].add(
        valid.astype(jnp.float32))
    bow = hist * word_idf
    norm = jnp.maximum(jnp.sum(bow), 1e-9)
    bow = bow / norm
    word = jnp.where(valid, word, -1)
    group = jnp.where(valid, group, -1)
    return word, group, bow


def _open_text(path: str, mode: str):
    """Text open with transparent gzip by extension: a reference-scale
    vocabulary (100k+ leaves, ~14 MB text) ships as a .gz repo artifact."""
    if str(path).endswith(".gz"):
        import gzip

        return gzip.open(path, mode + "t")
    return open(path, mode)


def save_dbow2_text(vocab: Vocabulary, path: str):
    """Write a vocabulary in the DBoW2 text format (the ORBvoc.txt layout
    load_dbow2_text parses): header `k L scoring weighting`, then one line
    per node `parent_id is_leaf b0..b31 weight`, level-major in slot order
    (children consecutive per parent, matching the loader's
    encounter-order slot assignment). Roundtrips exactly with the loader,
    and lets a trained-in-process vocabulary ship as a settings artifact
    the reference's own tooling could read."""
    k, L = vocab.k, vocab.levels
    node_desc = np.asarray(vocab.node_desc)
    idf = np.asarray(vocab.word_idf)

    def file_id(l: int, s: int) -> int:
        return sum(k**j for j in range(1, l)) + s + 1

    with _open_text(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for l in range(1, L + 1):
            off = vocab.level_offset[l - 1]
            for s in range(k**l):
                pid = 0 if l == 1 else file_id(l - 1, s // k)
                b = node_desc[off + s].view(np.uint8)
                w = float(idf[s]) if l == L else 0.0
                is_leaf = 1 if l == L else 0
                f.write(f"{pid} {is_leaf} "
                        + " ".join(str(int(x)) for x in b) + f" {w:.6f}\n")


def load_dbow2_text(path: str, group_level: int = 1) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the ORBvoc.txt format:
    header `k L scoring weighting`, then per node: parent is_leaf 32 bytes
    weight). Rebuilds the dense complete-tree layout; missing branches are
    padded with their parent's descriptor."""
    with _open_text(path, "r") as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        n_nodes = sum(k**l for l in range(1, levels + 1))
        node_desc = np.zeros((n_nodes, 8), np.uint32)
        level_offset = []
        off = 0
        for l in range(1, levels + 1):
            level_offset.append(off)
            off += k**l
        # DBoW2 text lists nodes in creation order with parent ids; rebuild
        parents = {0: (0, 0)}  # file node id -> (level, slot); root = level 0
        child_count = {0: 0}
        idf = np.ones(k**levels, np.float32)
        for file_id, line in enumerate(f, start=1):
            parts = line.split()
            if len(parts) < 35:
                continue
            pid = int(parts[0])
            bytes_ = np.array([int(x) for x in parts[2:34]], np.uint8)
            weight = float(parts[34])
            p_level, p_slot = parents[pid]
            c = child_count.get(pid, 0)
            child_count[pid] = c + 1
            level = p_level + 1
            slot = p_slot * k + c
            parents[file_id] = (level, slot)
            if 1 <= level <= levels:
                node_desc[level_offset[level - 1] + slot] = bytes_.view(np.uint32)
                if level == levels:
                    idf[slot] = weight
    return Vocabulary(
        k=k, levels=levels, node_desc=jnp.asarray(node_desc),
        level_offset=tuple(level_offset), word_idf=jnp.asarray(idf),
        group_level=group_level,
    )
