"""The port's System with a vocabulary loaded from a file, against the JAX
System loading the same file (the reference's ORBvoc text format).

A k=8, L=4 vocabulary is trained with Vocabulary.build on the descriptors
of five frames of the test orbit (320x240, 400 features; one document per
frame), written in the ORBvoc text format, and loaded by
System(..., vocabulary_path=...) and by the JAX System(path, ...). Both
track the first 15 frames: the same tracking state on every frame, and
the same keyframe BoWs and nodes. Then, forced on the next frame,
track_reference_keyframe matches >= 15 features through real vocabulary
nodes on both sides (the frame's nodes are not all 0), with the same
matches in both packages. A run with a loaded vocabulary is the one in
which the JAX package's round-5 zero-node-id fault showed.
"""

import numpy as np
import pytest
import torch

from orb_slam_system_tpu.config import (CameraConfig as JCameraConfig,
                                        ORBConfig as JORBConfig,
                                        SlamConfig as JSlamConfig)
from orb_slam_system_tpu.models import tracking as jtracking
from orb_slam_system_tpu.models.system import System as JSystem
from orb_slam_system_tpu_torch.config import TrackingState
from orb_slam_system_tpu_torch.drivers.mono_synthetic import (make_config,
                                                              render_sequence)
from orb_slam_system_tpu_torch.models import tracking
from orb_slam_system_tpu_torch.models.frame import FrameBuilder
from orb_slam_system_tpu_torch.models.system import System
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary
from test_torch_vocab import write_orbvoc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (as tests/test_torch_realtime.py):
    the suite runs several workers on a shared machine, where a thread per
    core in every worker spins against the others. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_FRAMES, N_FEATURES = 15, 400


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    cfg = make_config(320, 240, N_FEATURES)
    frames, _ = render_sequence(cfg, N_FRAMES + 1)
    fb = FrameBuilder(cfg, "cpu")
    descs, docs = [], []
    for d, i in enumerate(range(0, N_FRAMES + 1, 3)):
        f = fb.build(frames[i], 0.0).feats
        descs.append(f.desc[f.valid])
        docs.append(np.full(int(f.valid.sum()), d))
    voc = Vocabulary.build(np.concatenate(descs), k=8, L=4, seed=0,
                           doc_ids=np.concatenate(docs))
    path = str(tmp_path_factory.mktemp("voc") / "ORBvoc_test.txt")
    write_orbvoc(voc, path)
    c = cfg.camera
    jcfg = JSlamConfig(camera=JCameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, fps=30.0, width=c.width,
        height=c.height), orb=JORBConfig(n_features=N_FEATURES))
    port = System(cfg, device="cpu", vocabulary_path=path)
    jslam = JSystem(path, jcfg)
    jslam.local_mapper.loop_closer = None
    states = ([], [])
    for i in range(N_FRAMES):
        port.track_monocular(frames[i], i / 30.0)
        jslam.track_monocular(frames[i], i / 30.0)
        states[0].append(int(port.get_tracking_state()))
        states[1].append(int(jslam.get_tracking_state()))
    return port, jslam, voc, states, frames[N_FRAMES]


def test_loaded_vocabulary_tracks_as_jax(systems):
    port, jslam, voc, states, _ = systems
    assert port.place_rec.ready and port.place_rec.vocab.n_words == voc.n_words
    np.testing.assert_array_equal(port.place_rec.vocab.node_desc, voc.node_desc)
    assert states[0] == states[1]
    ok = int(TrackingState.OK)
    assert states[0][-1] == ok and states[0].count(ok) >= N_FRAMES - 2
    assert sorted(port.arena.kfs) == sorted(jslam.arena.kfs)
    for kf_id, kf in port.arena.kfs.items():
        assert kf.bow == jslam.arena.kfs[kf_id].bow
        np.testing.assert_array_equal(kf.node_ids, jslam.arena.kfs[kf_id].node_ids)


def test_reference_keyframe_search_uses_real_nodes(systems, monkeypatch):
    port, jslam, _, _, img = systems
    seen = {}

    def spy(mod, key):
        orig = mod.matching.search_by_node_id

        def wrapped(*args, **kw):
            res = orig(*args, **kw)
            seen[key] = (np.asarray(args[3]), np.asarray(args[7]),
                         np.asarray(res.idx2))
            return res
        monkeypatch.setattr(mod.matching, "search_by_node_id", wrapped)

    spy(tracking, "port")
    spy(jtracking, "jax")
    for s in (port, jslam):
        tr = s.tracker
        tr.current = tr.build_frame(img, N_FRAMES / 30.0)
        assert tr.track_reference_keyframe()
    node_kf, node_cur, idx2 = seen["port"]
    jnode_kf, jnode_cur, jidx2 = seen["jax"]
    np.testing.assert_array_equal(node_kf, jnode_kf)
    np.testing.assert_array_equal(node_cur, jnode_cur)
    assert len(np.unique(node_cur)) > 10 and (node_kf > 0).any()
    assert (idx2 >= 0).sum() >= 15
    np.testing.assert_array_equal(idx2, jidx2)
