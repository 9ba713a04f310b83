"""The port's vocabulary at ORBvoc's branching (the counterpart of
tests/test_vocab_scale.py's k=10, L=4 cases), on the CPU: a full 10-ary
tree of depth 4 (11,111 nodes) in the reference's ORBvoc.txt text format,
written from a seed by that test's own writer.

* The text load: the tree's shapes, every internal node with 10 children.
* The descent: numpy `transform` and the torch `transform_device` equal to
  a brute-force greedy descent, to each other and to the JAX package's
  `transform` (words, weights, direct-index nodes).
* The .npz cache: a second load reads it and descends the same.
* BoW scoring: a lightly perturbed copy scores above unrelated noise, as in
  the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam_system_tpu.vocab.vocabulary import Vocabulary as JVocabulary
from orb_slam_system_tpu_torch.mapping.arena import hamming_np
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
from test_vocab_scale import K, L, write_synthetic_orbvoc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big_vocab(tmp_path_factory):
    rng = np.random.default_rng(5)
    p = tmp_path_factory.mktemp("voc") / "synthvoc.txt"
    write_synthetic_orbvoc(p, rng)
    return Vocabulary.load(str(p)), p


def test_scale_load_shapes(big_vocab):
    voc, _ = big_vocab
    n_nodes = sum(K ** lv for lv in range(1, L + 1)) + 1
    assert voc.k == K and voc.L == L
    assert voc.node_desc.shape == (n_nodes, 8)
    assert voc.node_children.shape == (n_nodes, K)
    assert voc.n_words == K ** L
    internal = ~voc.node_is_leaf
    assert ((voc.node_children[internal] >= 0).sum(axis=1) == K).all()


def test_scale_descent_matches_bruteforce_and_jax(big_vocab):
    voc, p = big_vocab
    rng = np.random.default_rng(9)
    q = rng.integers(0, 2 ** 32, size=(512, 8), dtype=np.uint32)
    valid = np.ones(512, bool)
    valid[::17] = False
    word_ids, weights, node_ids = voc.transform(q, valid)
    assert (word_ids[valid] >= 0).all() and (word_ids[valid] < voc.n_words).all()
    assert (word_ids[~valid] == -1).all()
    for i in range(0, 512, 37):
        if not valid[i]:
            continue
        cur = 0
        for _ in range(L):
            ch = voc.node_children[cur]
            ch = ch[ch >= 0]
            if len(ch) == 0:
                break
            d = hamming_np(q[i][None, :], voc.node_desc[ch])
            cur = int(ch[int(np.argmin(d))])
        assert voc.word_of_node[cur] == word_ids[i]
    dw, dwt, dn = voc.transform_device(
        torch.from_numpy(q.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(dw.numpy(), word_ids)
    np.testing.assert_array_equal(dwt.numpy(), weights)
    np.testing.assert_array_equal(dn.numpy(), node_ids)
    jw, jwt, jn = JVocabulary.load(str(p)).transform(q, valid)
    np.testing.assert_array_equal(word_ids, jw)
    np.testing.assert_array_equal(weights, jwt)
    np.testing.assert_array_equal(node_ids, jn)


def test_scale_npz_cache_roundtrip(big_vocab):
    voc, p = big_vocab
    assert os.path.exists(str(p) + ".npz")
    voc2 = Vocabulary.load(str(p))           # from the cache
    np.testing.assert_array_equal(voc.node_desc, voc2.node_desc)
    np.testing.assert_array_equal(voc.word_of_node, voc2.word_of_node)
    np.testing.assert_array_equal(voc.node_weight, voc2.node_weight)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 2 ** 32, size=(64, 8), dtype=np.uint32)
    w1, _, n1 = voc.transform(q)
    w2, _, n2 = voc2.transform(q)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(n1, n2)


def test_scale_bow_scoring_discriminates(big_vocab):
    voc, p = big_vocab
    rng = np.random.default_rng(11)
    base = rng.integers(0, 2 ** 32, size=(200, 8), dtype=np.uint32)
    flips = np.uint32(1) << rng.integers(0, 32, size=(200, 8)).astype(np.uint32)
    mask = rng.uniform(size=(200, 8)) < 0.25
    near = np.where(mask, base ^ flips, base)
    far = rng.integers(0, 2 ** 32, size=(200, 8), dtype=np.uint32)
    b0 = voc.bow_vector(base)
    s_near = Vocabulary.score(b0, voc.bow_vector(near))
    s_far = Vocabulary.score(b0, voc.bow_vector(far))
    assert s_near > s_far
    jvoc = JVocabulary.load(str(p))
    jb0 = jvoc.bow_vector(base)
    assert s_near == pytest.approx(
        JVocabulary.score(jb0, jvoc.bow_vector(near)), abs=1e-6)
    assert s_far == pytest.approx(
        JVocabulary.score(jb0, jvoc.bow_vector(far)), abs=1e-6)
