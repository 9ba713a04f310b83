"""Bag-of-words vocabulary, DBoW2-equivalent (reference Thirdparty/DBoW2).

Port of orb_slam_system_tpu/vocab/vocabulary.py. A k^L tree of binary
(256-bit) descriptor centroids with TF-IDF weights:
  * `load` reads the reference's ORBvoc.txt text format (per-line
    `parent is_leaf 32 descriptor bytes weight`, DBoW2
    TemplatedVocabulary.h:1342-1420) and caches a packed .npz binary.
  * `build` trains a vocabulary from descriptors (hierarchical k-medoids
    on Hamming distance) with DBoW2 TF-IDF leaf weights
    (TemplatedVocabulary::setNodeWeights semantics).
  * Two bit-identical descents of descriptors through the tree, by
    min-Hamming, level by level against each descriptor's children block:
      - `transform` (host numpy): `build`'s own training pass;
      - `transform_device` (torch, on the descriptors' device): frame and
        keyframe BoW in the tracker and the mapper. Per level it gathers
        the children [N,k] and their descriptors, takes
        ops.hamming.distance_pairwise, masks absent children, and takes the
        first minimum (numpy's argmin and torch's both do), leaves staying
        put. The node tables are cached per device.
    Output: (word ids, TF-IDF weights, direct-index node LEVELS_UP levels
    above the leaves, reference Frame::ComputeBoW src/Frame.cc:375-382,
    levelsup=4).
  * `score` = L1 scoring (DBoW2 ScoringObject.cpp L1Scoring).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.mapping.arena import hamming_np
from orb_slam_system_tpu_torch.ops.hamming import distance_pairwise

_ABSENT = 1 << 20   # distance of a missing child (any real one is <= 256)
LEVELS_UP = 4       # direct-index level above the leaves (Frame.cc:379)


def bow_dict(word_ids: np.ndarray, weights: np.ndarray) -> dict:
    """L1-normalized BowVector (word id -> weight) of one frame's words,
    summed in slot order (DBoW2 BowVector)."""
    bow: dict[int, float] = {}
    for w, wt in zip(word_ids, weights):
        if w >= 0 and wt > 0:
            bow[int(w)] = bow.get(int(w), 0.0) + float(wt)
    norm = sum(abs(v) for v in bow.values())
    return {k: v / norm for k, v in bow.items()} if norm > 0 else {}


class Vocabulary:
    def __init__(self, k: int, L: int, node_desc: np.ndarray,
                 node_parent: np.ndarray, node_children: np.ndarray,
                 node_is_leaf: np.ndarray, node_weight: np.ndarray,
                 word_of_node: np.ndarray):
        self.k = k
        self.L = L
        self.node_desc = node_desc          # u32[n_nodes, 8]
        self.node_parent = node_parent      # i32[n_nodes]
        self.node_children = node_children  # i32[n_nodes, k] (-1 padded)
        self.node_is_leaf = node_is_leaf    # bool[n_nodes]
        self.node_weight = node_weight      # f32[n_nodes]
        self.word_of_node = word_of_node    # i32[n_nodes] (-1 if not a word)
        self.n_words = int((word_of_node >= 0).sum())
        self._tables: dict = {}             # device -> node tables

    # ------------------------------------------------------------------

    @classmethod
    def build(cls, descriptors: np.ndarray, k: int = 10, L: int = 3,
              seed: int = 0,
              doc_ids: Optional[np.ndarray] = None) -> "Vocabulary":
        """Hierarchical k-medoids on packed descriptors u32[N,8].

        Leaf weights follow DBoW2's TF_IDF training semantics
        (TemplatedVocabulary::setNodeWeights): weight_i = log(N_docs / Ni)
        with Ni = number of training documents containing word i.
        `doc_ids` i32[N] groups descriptors into documents (images /
        keyframes); when omitted, each descriptor counts as its own
        document, which reduces to a plain IDF over descriptor frequency —
        still discriminative (rare words weigh more), unlike the uniform
        weights used before."""
        rng = np.random.default_rng(seed)
        nodes_desc = [np.zeros(8, np.uint32)]   # root (unused descriptor)
        parents = [-1]
        children: list[list[int]] = [[]]
        levels = [0]

        def cluster(idx: np.ndarray, parent: int, level: int):
            if level >= L or len(idx) <= k:
                return
            D = descriptors[idx]
            # k-medoids init: random distinct rows.
            sel = rng.choice(len(idx), size=min(k, len(idx)), replace=False)
            cents = D[sel]
            for _ in range(5):
                dist = hamming_np(D[:, None, :], cents[None, :, :])
                assign = np.argmin(dist, axis=1)
                new_cents = []
                for c in range(len(cents)):
                    members = D[assign == c]
                    if len(members) == 0:
                        new_cents.append(cents[c])
                        continue
                    # Bit-majority mean (FORB::meanValue semantics).
                    bits = np.unpackbits(
                        members.view(np.uint8), axis=1, bitorder="little")
                    mean_bits = (bits.mean(0) >= 0.5).astype(np.uint8)
                    new_cents.append(np.packbits(
                        mean_bits, bitorder="little").view(np.uint32))
                cents = np.stack([np.asarray(c).reshape(8) for c in new_cents])
            dist = hamming_np(D[:, None, :], cents[None, :, :])
            assign = np.argmin(dist, axis=1)
            for c in range(len(cents)):
                node_id = len(nodes_desc)
                nodes_desc.append(cents[c].astype(np.uint32))
                parents.append(parent)
                children.append([])
                levels.append(level + 1)
                children[parent].append(node_id)
                members = idx[assign == c]
                if level + 1 < L and len(members) > k:
                    cluster(members, node_id, level + 1)

        cluster(np.arange(len(descriptors)), 0, 0)
        n = len(nodes_desc)
        node_desc = np.stack(nodes_desc)
        node_parent = np.asarray(parents, np.int32)
        node_children = np.full((n, k), -1, np.int32)
        for i, ch in enumerate(children):
            node_children[i, :len(ch)] = ch
        node_is_leaf = np.asarray([len(ch) == 0 and i > 0
                                   for i, ch in enumerate(children)])
        word_of_node = np.full(n, -1, np.int32)
        w = 0
        for i in range(n):
            if node_is_leaf[i]:
                word_of_node[i] = w
                w += 1
        node_weight = np.where(node_is_leaf, 1.0, 0.0).astype(np.float32)
        voc = cls(k, L, node_desc, node_parent, node_children,
                  node_is_leaf, node_weight, word_of_node)
        # TF-IDF weights from the training data (DBoW2 setNodeWeights):
        # assign every training descriptor to its word, count document
        # frequency, weight = log(N_docs / Ni). Words unseen in training
        # keep weight 0 (DBoW2 leaves them at 0 too).
        if doc_ids is None:
            docs = np.arange(len(descriptors), dtype=np.int64)
        else:
            docs = np.asarray(doc_ids, np.int64)
        word_ids, _, _ = voc.transform(descriptors)
        seen = word_ids >= 0
        n_docs = max(len(np.unique(docs)), 1)
        pairs = np.unique(np.stack([word_ids[seen], docs[seen]]), axis=1)
        ni = np.bincount(pairs[0], minlength=voc.n_words)
        idf = np.zeros(voc.n_words, np.float32)
        nz = ni > 0
        idf[nz] = np.log(n_docs / ni[nz].astype(np.float64))
        # log(N/N) == 0 would null words present in EVERY document; DBoW2
        # keeps them scoreable — floor strictly positive counts at a tiny
        # weight.
        idf[nz] = np.maximum(idf[nz], 1e-3)
        w_nodes = np.zeros_like(voc.node_weight)
        leaf_rows = np.nonzero(voc.node_is_leaf)[0]
        w_nodes[leaf_rows] = idf[voc.word_of_node[leaf_rows]]
        voc.node_weight = w_nodes
        return voc

    # ------------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        """Load ORBvoc.txt (reference text format) with .npz caching."""
        cache = path + ".npz"
        # Cache is valid only for the text file it was built from: a
        # replaced/updated ORBvoc.txt at the same path must not silently
        # serve the stale tree (mtime stored at build, compared on load).
        if os.path.exists(cache):
            z = np.load(cache)
            src_mtime = float(z["src_mtime"]) if "src_mtime" in z else None
            if (src_mtime is not None and os.path.exists(path)
                    and abs(os.path.getmtime(path) - src_mtime) < 1.0):
                return cls(int(z["k"]), int(z["L"]), z["node_desc"],
                           z["node_parent"], z["node_children"],
                           z["node_is_leaf"], z["node_weight"],
                           z["word_of_node"])
        # Vectorized parse: the real ORBvoc.txt is ~1.08M lines / 140 MB —
        # a per-line Python loop takes minutes; one token split + one
        # ndarray conversion takes seconds. Every node line has exactly 35
        # tokens (`parent is_leaf 32-bytes weight`, TemplatedVocabulary::
        # saveToTextFile); fall back to row-wise parsing if not.
        with open(path, "r") as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            body = f.read()
        toks = body.split()
        if len(toks) % 35 == 0:
            arr = np.asarray(toks, dtype=np.float64).reshape(-1, 35)
        else:
            rows = []
            for line in body.splitlines():
                parts = line.split()
                if len(parts) >= 35:
                    rows.append([float(x) for x in parts[:35]])
            arr = np.asarray(rows, dtype=np.float64)
        n = arr.shape[0] + 1
        node_parent = np.full(n, -1, np.int32)
        node_parent[1:] = arr[:, 0].astype(np.int32)
        node_is_leaf = np.zeros(n, bool)
        node_is_leaf[1:] = arr[:, 1] != 0
        node_desc = np.zeros((n, 8), np.uint32)
        node_desc[1:] = np.ascontiguousarray(
            arr[:, 2:34].astype(np.uint8)).view(np.uint32)
        node_weight = np.zeros(n, np.float32)
        node_weight[1:] = arr[:, 34].astype(np.float32)
        # Children table: stable-sort node ids by parent, then place each
        # id at its within-parent slot (file order preserved — DBoW2
        # children are contiguous in save order).
        ids = np.arange(1, n, dtype=np.int32)
        par = node_parent[1:]
        order = np.argsort(par, kind="stable")
        sorted_par = par[order]
        # Within-group rank: index minus the first index of the group.
        grp_start = np.zeros(len(order), np.int64)
        new_grp = np.empty(len(order), bool)
        if len(order):
            new_grp[0] = True
            new_grp[1:] = sorted_par[1:] != sorted_par[:-1]
            grp_start = np.maximum.accumulate(
                np.where(new_grp, np.arange(len(order)), 0))
        rank = np.arange(len(order)) - grp_start
        node_children = np.full((n, k), -1, np.int32)
        keep = rank < k
        node_children[sorted_par[keep], rank[keep]] = ids[order][keep]
        word_of_node = np.full(n, -1, np.int32)
        word_of_node[node_is_leaf] = np.arange(
            int(node_is_leaf.sum()), dtype=np.int32)
        voc = cls(k, L, node_desc, node_parent, node_children,
                  node_is_leaf, node_weight, word_of_node)
        np.savez_compressed(
            cache, k=k, L=L, node_desc=node_desc, node_parent=node_parent,
            node_children=node_children, node_is_leaf=node_is_leaf,
            node_weight=node_weight, word_of_node=word_of_node,
            src_mtime=np.float64(os.path.getmtime(path)))
        return voc

    # ------------------------------------------------------------------

    def transform(self, desc: np.ndarray, valid: Optional[np.ndarray] = None,
                  levels_up: int = 4):
        """Descend descriptors u32[N,8] through the tree.

        Returns (word_ids i32[N], word_weights f32[N], node_ids i32[N])
        where node_ids is the direct-index node at depth L-levels_up
        (reference transform(..., levelsup=4)). Invalid slots get -1.
        """
        N = desc.shape[0]
        if valid is None:
            valid = np.ones(N, bool)
        current = np.zeros(N, np.int32)           # start at root
        node_at_level = np.zeros(N, np.int32)     # root if target level is 0
        # Direct-index depth: L-levels_up, but at least level min(2, L-1) so
        # shallow (self-trained) vocabularies still discriminate (DBoW2's
        # levelsup=4 default assumes the L=6 ORBvoc).
        target_level = max(self.L - levels_up, min(2, self.L - 1))
        for level in range(self.L):
            ch = self.node_children[current]      # [N,k]
            has_child = ch >= 0
            # Hamming distance to each candidate child.
            cd = self.node_desc[np.maximum(ch, 0)]        # [N,k,8]
            dist = hamming_np(desc[:, None, :], cd)       # [N,k]
            dist = np.where(has_child, dist, 1 << 20)
            best = np.argmin(dist, axis=1)
            nxt = ch[np.arange(N), best]
            # Stop at leaves (keep current when no children).
            done = ~has_child.any(axis=1)
            current = np.where(done, current, nxt).astype(np.int32)
            if level + 1 == target_level:
                node_at_level = current.copy()
        word_ids = self.word_of_node[current]
        word_ids = np.where(valid, word_ids, -1).astype(np.int32)
        weights = np.where(word_ids >= 0, self.node_weight[current], 0.0)
        node_ids = np.where(valid, node_at_level, -1).astype(np.int32)
        return word_ids, weights.astype(np.float32), node_ids

    # ------------------------------------------------------------------
    # Torch descent: bit-identical to the numpy transform.
    # ------------------------------------------------------------------

    def _device_tables(self, device: torch.device):
        """(node_desc i32[n,8] bits, node_children i64[n,k], node_weight
        f32[n], word_of_node i64[n]) on `device`, uploaded once per device."""
        key = str(torch.device(device))
        tables = self._tables.get(key)
        if tables is None:
            tables = (
                torch.from_numpy(np.ascontiguousarray(self.node_desc)
                                 .view(np.int32)).to(device),
                torch.from_numpy(self.node_children.astype(np.int64)).to(device),
                torch.from_numpy(self.node_weight.astype(np.float32)).to(device),
                torch.from_numpy(self.word_of_node.astype(np.int64)).to(device))
            self._tables[key] = tables
        return tables

    def transform_device(self, desc: torch.Tensor,
                         valid: Optional[torch.Tensor] = None):
        """`transform` in torch ops on desc's device: desc int32[N,8]
        (descriptor words as int32 bits), valid bool[N]. Returns tensors
        there (word_ids i32[N], weights f32[N], node_ids i32[N]), bit-equal
        to `transform` on the same descriptors."""
        dev = desc.device
        N = desc.shape[0]
        node_desc, node_children, node_weight, word_of_node = \
            self._device_tables(dev)
        if valid is None:
            valid = torch.ones(N, dtype=torch.bool, device=dev)
        target_level = max(self.L - LEVELS_UP, min(2, self.L - 1))
        cur = torch.zeros(N, dtype=torch.int64, device=dev)
        node_at = cur
        for level in range(self.L):
            ch = node_children[cur]                              # [N,k]
            has = ch >= 0
            dist = distance_pairwise(desc[:, None, :],
                                     node_desc[ch.clamp_min(0)])  # [N,k]
            dist = torch.where(has, dist, _ABSENT)
            nxt = ch.gather(1, dist.argmin(dim=1, keepdim=True))[:, 0]
            cur = torch.where(has.any(dim=1), nxt, cur)          # leaf: stay
            if level + 1 == target_level:
                node_at = cur
        word_ids = torch.where(valid, word_of_node[cur], -1)
        weights = torch.where(word_ids >= 0, node_weight[cur], 0.0)
        node_ids = torch.where(valid, node_at, -1)
        return (word_ids.to(torch.int32), weights,
                node_ids.to(torch.int32))

    def bow_vector(self, desc: np.ndarray, valid: Optional[np.ndarray] = None):
        """Normalized sparse BowVector dict word_id -> weight (DBoW2
        BowVector with L1 normalization)."""
        word_ids, weights, _ = self.transform(desc, valid)
        return bow_dict(word_ids, weights)

    @staticmethod
    def score(bow1: dict, bow2: dict) -> float:
        """DBoW2 L1 scoring: 1 - 0.5 * |v1/|v1| - v2/|v2||_1, computed over
        the shared words (ScoringObject.cpp L1Scoring)."""
        s = 0.0
        for w, v1 in bow1.items():
            v2 = bow2.get(w)
            if v2 is not None:
                s += abs(v1) + abs(v2) - abs(v1 - v2)
        return 0.5 * s


def generate_orbvoc(path: str, k: int = 10, L: int = 6, seed: int = 0):
    """Write a full k-ary depth-L vocabulary with random centroids and
    IDF-like leaf weights, made from `seed`, in the ORBvoc.txt text format
    (a copy of the JAX package's tools/make_full_vocab.py generate): a
    stand-in of the real file's shape where the file is not at hand. Nodes
    are written level by level, so each parent's children are contiguous,
    the order `load` relies on."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        # Header: k L scoring_type weighting_type (L1_NORM=0, TF_IDF=0).
        f.write(f"{k} {L} 0 0\n")
        first_id = 1
        parent_first = 0
        n_parents = 1
        for lvl in range(1, L + 1):
            n_nodes = n_parents * k
            parents = np.repeat(
                np.arange(parent_first, parent_first + n_parents,
                          dtype=np.int64), k)
            is_leaf = int(lvl == L)
            descs = rng.integers(0, 256, size=(n_nodes, 32), dtype=np.uint8)
            if is_leaf:
                # Most words rare (high weight), some common: an
                # exponential spread like the real file's.
                w = rng.exponential(scale=1.0, size=n_nodes).astype(
                    np.float32) * 1e-4
            else:
                w = np.zeros(n_nodes, np.float32)
            arr = np.empty((n_nodes, 35), np.float64)
            arr[:, 0] = parents
            arr[:, 1] = is_leaf
            arr[:, 2:34] = descs
            arr[:, 34] = w
            np.savetxt(f, arr, fmt="%d %d" + " %d" * 32 + " %.8g")
            parent_first = first_id
            first_id += n_nodes
            n_parents = n_nodes
