"""Keyframe database: inverted word index for place recognition.

Copy of orb_slam_system_tpu/mapping/keyframe_db.py (host-only).

Replaces reference KeyFrameDatabase (src/KeyFrameDatabase.cc): word ->
keyframe inverted file (add :20-26), loop-candidate detection with
min-score + common-word (0.8x max) + covisibility-accumulated score (0.75x
best) filters (DetectLoopCandidates :56-177) and the analogous
relocalization candidate search (DetectRelocalizationCandidates :179-289).

The index and scoring are tiny host-side work (SURVEY.md §2.2: "inverted
index stays host-side"); the heavy part — descriptor-to-word assignment —
runs as the batched vocabulary descent.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

from orb_slam_system_tpu_torch.vocab.vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.inverted: Dict[int, Set[int]] = defaultdict(set)
        self.bows: Dict[int, dict] = {}

    def add(self, kf_id: int, bow: dict):
        self.bows[kf_id] = bow
        for w in bow:
            self.inverted[w].add(kf_id)

    def erase(self, kf_id: int):
        bow = self.bows.pop(kf_id, None)
        if bow:
            for w in bow:
                self.inverted[w].discard(kf_id)

    def clear(self):
        self.inverted.clear()
        self.bows.clear()

    # ------------------------------------------------------------------

    def _common_word_counts(self, bow: dict, exclude: Set[int]) -> Dict[int, int]:
        counts: Dict[int, int] = defaultdict(int)
        for w in bow:
            for kf_id in self.inverted.get(w, ()):
                if kf_id not in exclude:
                    counts[kf_id] += 1
        return counts

    def detect_loop_candidates(self, kf_id: int, bow: dict, min_score: float,
                               arena) -> List[int]:
        """Reference DetectLoopCandidates (:56-177)."""
        kf = arena.kfs.get(kf_id)
        connected = set(kf.covis) | {kf_id} if kf is not None else {kf_id}
        counts = self._common_word_counts(bow, connected)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = []
        for cand, n in counts.items():
            if n > min_common and cand in self.bows:
                s = Vocabulary.score(bow, self.bows[cand])
                if s >= min_score:
                    scored.append((s, cand))
        if not scored:
            return []
        # Covisibility-accumulated scores (:118-160).
        acc = []
        best_acc = min_score
        for s, cand in scored:
            ckf = arena.kfs.get(cand)
            group = [cand] + (arena.covisible_ordered(ckf, 10) if ckf else [])
            acc_score = 0.0
            best_kf = cand
            best_s = s
            direct = dict((c, sc) for sc, c in scored)
            for g in group:
                sg = direct.get(g)
                if sg is not None:
                    acc_score += sg
                    if sg > best_s:
                        best_s = sg
                        best_kf = g
            acc.append((acc_score, best_kf))
            best_acc = max(best_acc, acc_score)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc_score, best_kf in acc:
            if acc_score > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out

    def detect_reloc_candidates(self, bow: dict, arena) -> List[int]:
        """Reference DetectRelocalizationCandidates (:179-289)."""
        counts = self._common_word_counts(bow, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = [(Vocabulary.score(bow, self.bows[c]), c)
                  for c, n in counts.items() if n > min_common and c in self.bows]
        if not scored:
            return []
        acc = []
        best_acc = 0.0
        direct = dict((c, s) for s, c in scored)
        for s, cand in scored:
            ckf = arena.kfs.get(cand)
            group = [cand] + (arena.covisible_ordered(ckf, 10) if ckf else [])
            acc_score = 0.0
            best_kf = cand
            best_s = s
            for g in group:
                sg = direct.get(g)
                if sg is not None:
                    acc_score += sg
                    if sg > best_s:
                        best_s = sg
                        best_kf = g
            acc.append((acc_score, best_kf))
            best_acc = max(best_acc, acc_score)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc_score, best_kf in acc:
            if acc_score > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out
