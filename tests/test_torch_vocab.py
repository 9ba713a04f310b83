"""The port's vocabulary, keyframe database and node-constrained matching
against the JAX package on the CPU.

- Vocabulary.build gives JAX's tree (every table equal) on the same
  descriptors and documents.
- The torch descent (Vocabulary.transform_device) is bit-equal to the
  numpy transform in word ids, weights and node ids: on a self-trained
  k=10, L=3 tree and on an L=6, k=4 tree written in the reference's ORBvoc
  text format and read back with Vocabulary.load (which reads the same
  tables as JAX's load), at N = 1000, N = 0 and with every slot invalid.
- KeyFrameDatabase.detect_reloc_candidates (and detect_loop_candidates)
  return JAX's lists on the same BoWs and covisibility.
- search_by_node_id over a leading candidate axis (ratio 0.75, as
  relocalization calls it) returns JAX's search_by_node_id_batch
  indices for every candidate.
All exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_system_tpu.mapping.keyframe_db import (
    KeyFrameDatabase as JKeyFrameDatabase)
from orb_slam_system_tpu.ops import matching as jmatching
from orb_slam_system_tpu.vocab.vocabulary import Vocabulary as JVocabulary
from orb_slam_system_tpu_torch.mapping.keyframe_db import KeyFrameDatabase
from orb_slam_system_tpu_torch.ops import matching
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TABLES = ("node_desc", "node_parent", "node_children", "node_is_leaf",
          "node_weight", "word_of_node")


def write_orbvoc(voc, path):
    """Write a Vocabulary in the reference's ORBvoc text format (DBoW2
    saveToTextFile): header `k L scoring weighting`, then one line per node
    after the root, `parent is_leaf 32 bytes weight`, in node-id order."""
    byts = np.ascontiguousarray(voc.node_desc).view(np.uint8)
    lines = [f"{voc.k} {voc.L} 0 0"]
    for i in range(1, len(voc.node_parent)):
        lines.append(f"{voc.node_parent[i]} {int(voc.node_is_leaf[i])} "
                     + " ".join(str(b) for b in byts[i])
                     + f" {float(voc.node_weight[i])!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def clustered_descriptors(rng, n, n_centres=60, flips=20):
    """u32[n,8] descriptors scattered around random centres, with docs."""
    centres = rng.integers(0, 2 ** 32, size=(n_centres, 8), dtype=np.uint32)
    pick = rng.integers(0, n_centres, n)
    bits = np.unpackbits(centres[pick].view(np.uint8), axis=1)
    for i in range(n):
        bits[i, rng.choice(256, flips, replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32), pick % 7


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(0)
    D, docs = clustered_descriptors(rng, 2500)
    self_trained = Vocabulary.build(D, k=10, L=3, seed=0, doc_ids=docs)
    deep = Vocabulary.build(D, k=4, L=6, seed=1, doc_ids=docs)
    path = str(tmp_path_factory.mktemp("voc") / "voc_k4_L6.txt")
    write_orbvoc(deep, path)
    loaded = Vocabulary.load(path)
    jloaded = JVocabulary.load(path)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(loaded, name),
                                      getattr(deep, name))
        np.testing.assert_array_equal(getattr(jloaded, name),
                                      getattr(deep, name))
    return {"self_trained": self_trained, "orbvoc_k4_L6": loaded}


def test_build_matches_jax():
    rng = np.random.default_rng(1)
    D, docs = clustered_descriptors(rng, 1500)
    got = Vocabulary.build(D, k=10, L=3, seed=0, doc_ids=docs)
    want = JVocabulary.build(D, k=10, L=3, seed=0, doc_ids=docs)
    assert (got.k, got.L, got.n_words) == (want.k, want.L, want.n_words)
    assert got.n_words > 100
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("n", ["1000", "0", "all_invalid"])
@pytest.mark.parametrize("tree", ["self_trained", "orbvoc_k4_L6"])
def test_descent_bit_equal(trees, tree, n):
    voc = trees[tree]
    rng = np.random.default_rng(2)
    N = 0 if n == "0" else 1000
    D, _ = clustered_descriptors(rng, N)
    valid = rng.uniform(size=N) < 0.9
    if n == "all_invalid":
        valid[:] = False
    w_np, wt_np, nd_np = voc.transform(D, valid)
    jw, jwt, jnd = JVocabulary.transform(voc, D, valid)
    w, wt, nd = voc.transform_device(torch.from_numpy(D.view(np.int32)),
                                     torch.from_numpy(valid))
    assert w.dtype == torch.int32 and nd.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), w_np)
    np.testing.assert_array_equal(wt.numpy().view(np.int32),
                                  wt_np.view(np.int32))
    np.testing.assert_array_equal(nd.numpy(), nd_np)
    np.testing.assert_array_equal(w_np, jw)
    np.testing.assert_array_equal(wt_np, jwt)
    np.testing.assert_array_equal(nd_np, jnd)
    if n == "1000":
        assert len(np.unique(w_np[valid])) > 20 and (nd_np[valid] > 0).all()
    else:
        assert (w_np == -1).all() and (nd_np == -1).all()


class _Arena:
    """The two members the keyframe database reads."""

    def __init__(self, covis):
        self.kfs = {k: _KF(k, c) for k, c in covis.items()}

    def covisible_ordered(self, kf, n):
        return kf.order[:n]


class _KF:
    def __init__(self, kf_id, order):
        self.id = kf_id
        self.order = order
        self.covis = {c: 20 for c in order}


def test_keyframe_database_matches_jax(trees):
    """Twelve keyframes whose descriptors overlap their neighbours' in a
    ring; a query near keyframe 5; candidates equal JAX's, in order."""
    voc = trees["self_trained"]
    rng = np.random.default_rng(3)
    pool, _ = clustered_descriptors(rng, 3000)
    kf_ids = list(range(100, 112))
    covis = {k: [kf_ids[(i + d) % 12] for d in (1, -1, 2, -2)]
             for i, k in enumerate(kf_ids)}
    arena = _Arena(covis)
    db, jdb = KeyFrameDatabase(voc), JKeyFrameDatabase(voc)
    for i, k in enumerate(kf_ids):
        sel = pool[(i * 250 + np.arange(500)) % 3000]
        bow = voc.bow_vector(sel)
        db.add(k, bow)
        jdb.add(k, bow)
    db.erase(111)
    jdb.erase(111)
    for centre in (5 * 250 + 100, 40):
        query = voc.bow_vector(pool[(centre + np.arange(400)) % 3000])
        got = db.detect_reloc_candidates(query, arena)
        assert got and got == jdb.detect_reloc_candidates(query, arena)
        assert 111 not in got
        got = db.detect_loop_candidates(105, query, 0.01, arena)
        assert got == jdb.detect_loop_candidates(105, query, 0.01, arena)


def test_search_by_node_id_batch_matches_jax(trees):
    """Three candidate keyframes (one near the frame, one shifted, one
    unrelated) against one frame, with real vocabulary nodes."""
    voc = trees["self_trained"]
    rng = np.random.default_rng(4)
    pool, _ = clustered_descriptors(rng, 2000)
    frame = pool[:400]
    cands = [pool[0:300], pool[200:500], pool[1500:1800]]
    n1 = 320
    desc1 = np.zeros((3, n1, 8), np.uint32)
    valid1 = np.zeros((3, n1), bool)
    node1 = np.full((3, n1), -1, np.int32)
    for c, d in enumerate(cands):
        desc1[c, :len(d)] = d
        valid1[c, :len(d)] = rng.uniform(size=len(d)) < 0.9
        node1[c] = np.where(valid1[c], voc.transform(desc1[c])[2], -1)
    ang1 = rng.uniform(0, 2 * np.pi, (3, n1)).astype(np.float32)
    valid2 = np.ones(len(frame), bool)
    node2 = voc.transform(frame)[2]
    ang2 = np.concatenate([ang1[0, :300], rng.uniform(0, 2 * np.pi, 100)]
                          ).astype(np.float32)
    args = (desc1, valid1, ang1, node1, frame, valid2, ang2, node2)
    want = np.asarray(jmatching.search_by_node_id_batch(
        *map(jnp.asarray, args), nn_ratio=0.75))
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a.astype(np.int64)
                                   if a.dtype == np.int32 else a)
    got = matching.search_by_node_id(*map(t, args), nn_ratio=0.75).idx2
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] >= 0).sum() > 100 and (want[2] >= 0).sum() < 20
