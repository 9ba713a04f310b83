"""Place-recognition service: vocabulary + keyframe database lifecycle.

Port of orb_slam_system_tpu/models/place_recognition.py. The reference
requires the pre-trained 140MB ORBvoc.txt asset (not shipped). Both ways
work here:
  * an externally loaded vocabulary (reference text format,
    Vocabulary.load);
  * a lazily self-trained vocabulary: once the map has enough keyframes,
    train a k=10 tree from the map's own descriptors and backfill BoW for
    the existing keyframes. A self-trained vocabulary is weaker than the
    offline-trained one, but relocalization works with no external asset.

Frame and keyframe BoW descend the tree with Vocabulary.transform_device on
the service's device (the tracker's); the BoW dict is summed on the host in
slot order, as the JAX package does, so both give identical dicts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.mapping.arena import KeyFrameRec, MapArena
from orb_slam_system_tpu_torch.mapping.keyframe_db import KeyFrameDatabase
from orb_slam_system_tpu_torch.utils.interop import to_device
from orb_slam_system_tpu_torch.utils.metrics import fetch
from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary, bow_dict

MIN_KFS_FOR_SELF_TRAIN = 5
SELF_TRAIN_K = 10
SELF_TRAIN_L = 3


class PlaceRecognition:
    def __init__(self, vocab: Optional[Vocabulary] = None, device="cuda"):
        self.vocab = vocab
        self.db = KeyFrameDatabase(vocab) if vocab is not None else None
        self.device = torch.device(device)

    @property
    def ready(self) -> bool:
        return self.db is not None

    def maybe_self_train(self, arena: MapArena):
        if self.ready:
            return
        if arena.n_keyframes() < MIN_KFS_FOR_SELF_TRAIN:
            return
        descs = []
        docs = []
        for d, kf in enumerate(arena.kfs.values()):
            sel = kf.feats.desc[kf.feats.valid]
            descs.append(sel)
            docs.append(np.full(len(sel), d, np.int64))
        D = np.concatenate(descs, axis=0)
        if len(D) < 500:
            return
        # Each keyframe is one training document, giving DBoW2-style TF-IDF
        # weights (rare words discriminate; plane-texture words common to
        # every view score low).
        self.vocab = Vocabulary.build(D, k=SELF_TRAIN_K, L=SELF_TRAIN_L,
                                      seed=0, doc_ids=np.concatenate(docs))
        self.db = KeyFrameDatabase(self.vocab)
        # Backfill existing keyframes.
        for kf in arena.kfs.values():
            self._compute_bow(kf)
            self.db.add(kf.id, kf.bow)

    def _descend(self, desc: torch.Tensor, valid: torch.Tensor,
                 layer: str = "mapping"):
        """(BoW dict, node ids i32[N] on the device, the same on the host)
        with one fetch, counted in `layer` (a keyframe's in mapping, a
        frame's in tracking)."""
        word_ids, weights, node_ids = self.vocab.transform_device(desc, valid)
        host = fetch(torch.stack([word_ids, weights.view(torch.int32),
                                  node_ids]), layer)
        return (bow_dict(host[0], host[1].view(np.float32)), node_ids,
                host[2].copy())

    def _compute_bow(self, kf: KeyFrameRec):
        kf.bow, _, kf.node_ids = self._descend(
            to_device(kf.feats.desc, self.device),
            to_device(kf.feats.valid, self.device))

    def on_new_keyframe(self, kf: KeyFrameRec, arena: MapArena):
        """Compute BoW (reference KeyFrame::ComputeBoW src/KeyFrame.cc:39-48)
        and index it (KeyFrameDatabase::add)."""
        self.maybe_self_train(arena)
        if not self.ready:
            return
        if kf.bow is None:
            self._compute_bow(kf)
            self.db.add(kf.id, kf.bow)

    def on_erase_keyframe(self, kf_id: int):
        if self.ready:
            self.db.erase(kf_id)

    def frame_bow(self, desc: torch.Tensor, valid: torch.Tensor):
        """BoW + direct-index nodes of a (non-keyframe) frame (reference
        Frame::ComputeBoW src/Frame.cc:375-382): desc int32[N,8] and valid
        bool[N] on the device -> (BoW dict, node ids i32[N] there), or
        (None, None) before the vocabulary exists."""
        if not self.ready:
            return None, None
        return self._descend(desc, valid, "track")[:2]

    def reset(self):
        if self.db is not None:
            self.db.clear()

    def rebuild(self, arena: MapArena, vocab: Optional[Vocabulary]):
        """Index a map that replaced the old one (System.load_map). With
        `vocab`, a loaded vocabulary, every keyframe's BoW and nodes are
        computed against it; without one the vocabulary is self-trained
        anew from the map's keyframes, as a fresh System's would be."""
        self.vocab = vocab
        self.db = KeyFrameDatabase(vocab) if vocab is not None else None
        if vocab is None:
            self.maybe_self_train(arena)
            return
        for kf in arena.kfs.values():
            self._compute_bow(kf)
            self.db.add(kf.id, kf.bow)
