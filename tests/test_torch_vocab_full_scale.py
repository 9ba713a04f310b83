"""The port's vocabulary at the real ORBvoc.txt's size (the counterpart of
tests/test_vocab_full_scale.py), on the card. Env-gated:

    ORB_SLAM_RUN_VOCAB_FULL=1 python -m pytest \\
        tests/test_torch_vocab_full_scale.py -q -s -m cuda --noconftest

A k=10, L=6 file (1,111,111 nodes, ~140 MB) written from a seed by
vocab.vocabulary.generate_orbvoc (ORB_SLAM_VOCAB_FULL_PATH reuses one),
loaded through the text parser and again through its .npz cache; 1000
random descriptors descend on the host (numpy) and on the card
(transform_device), which must agree bit for bit; a BoW vector scores 1
against itself. Prints the load and descent times: host ms, the card's
call ms (CUDA events) and device ms (torch.profiler, every kernel of one
descent), each over 5 calls after a warm-up.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from orb_slam_system_tpu_torch.vocab.vocabulary import (Vocabulary,
                                                        generate_orbvoc)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(os.environ.get("ORB_SLAM_RUN_VOCAB_FULL") != "1",
                       reason="~140 MB generate and a full-size load (set "
                              "ORB_SLAM_RUN_VOCAB_FULL=1)")]


def _descent_device_ms(voc, desc, valid, reps=5):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            voc.transform_device(desc, valid)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    return (sum(e.self_device_time_total for e in evs) / 1e3 / reps,
            sum(e.count for e in evs) // reps)


def test_full_scale_vocab(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path = os.environ.get("ORB_SLAM_VOCAB_FULL_PATH",
                          str(tmp_path / "orbvoc_full.txt"))
    if not os.path.exists(path):
        generate_orbvoc(path, k=10, L=6)
    out = {"file_mb": round(os.path.getsize(path) / 1e6, 1)}
    if os.path.exists(path + ".npz"):
        os.unlink(path + ".npz")
    t0 = time.perf_counter()
    voc = Vocabulary.load(path)
    out["load_text_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc2 = Vocabulary.load(path)
    out["load_cache_s"] = time.perf_counter() - t0
    out["n_nodes"] = int(voc.node_desc.shape[0])
    out["n_words"] = int(voc.n_words)
    assert voc2.n_words == voc.n_words
    rng = np.random.default_rng(1)
    q = rng.integers(0, 2 ** 32, size=(1000, 8), dtype=np.uint32)
    valid = np.ones(1000, bool)
    wid, ww, nid = voc.transform(q, valid)
    t0 = time.perf_counter()
    for _ in range(5):
        voc.transform(q, valid)
    out["transform_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    desc = torch.from_numpy(q.view(np.int32)).cuda()
    dvalid = torch.from_numpy(valid).cuda()
    dw, dwt, dn = voc.transform_device(desc, dvalid)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        voc.transform_device(desc, dvalid)
    end.record()
    torch.cuda.synchronize()
    out["transform_device_call_ms"] = start.elapsed_time(end) / 5
    out["transform_device_ms"], out["transform_device_kernels"] = \
        _descent_device_ms(voc, desc, dvalid)
    out["device_bit_equal"] = bool(
        np.array_equal(dw.cpu().numpy(), wid)
        and np.array_equal(dn.cpu().numpy(), nid)
        and np.array_equal(dwt.cpu().numpy(), ww))
    b = voc.bow_vector(rng.integers(0, 2 ** 32, size=(500, 8),
                                    dtype=np.uint32))
    out["score_self"] = Vocabulary.score(b, b)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    assert out["n_nodes"] == sum(10 ** i for i in range(0, 7))
    assert out["n_words"] == 10 ** 6
    assert out["file_mb"] > 100
    assert out["device_bit_equal"]
    assert out["transform_host_ms"] < 2000
    assert abs(out["score_self"] - 1.0) < 1e-3
    assert out["load_cache_s"] < out["load_text_s"]
