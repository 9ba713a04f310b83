"""S full SLAM Systems sharing one batched extraction (BASELINE.json
config 5, "batched multi-sequence EuRoC MH01-05 mapping on one chip").

Port of orb_slam_system_tpu/parallel/multi_system.py. Each sequence keeps
a complete System of its own (tracking, local mapping, loop closing,
relocalization, trajectory export; separate arenas, mappers, loop closers
and device caches), so its results are those of a System run alone. What
is shared is the steady-state frame build: one FrameBuilder extracts every
steady sequence's image in one call at batch S (kernel A and kernel B's
describe mode launch once for all of them), and each System tracks its
row of the packed result as a prebuilt frame. A sequence still
initializing runs its own track_monocular, since monocular initialization
extracts with the 2x-features builder.

Two parts of the JAX class are not carried over:
  * it extracts the full [S, H, W] batch even when only some sequences are
    steady, so that XLA does not compile a program per steady count; here
    only the steady rows are extracted;
  * it tracks the steady sequences on a thread pool to overlap the round
    trips of a remote TPU; here they are tracked in order on the caller's
    thread and the current stream, as one card and one interpreter lock
    would serialize them anyway.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from orb_slam_system_tpu_torch.config import Sensor, SlamConfig, TrackingState
from orb_slam_system_tpu_torch.models.frame import Frame, FrameBuilder
from orb_slam_system_tpu_torch.models.system import System


class MultiSystem:
    """S independent full SLAM Systems with a shared batched front end."""

    def __init__(self, cfg: SlamConfig, n_sequences: int,
                 async_mapping: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.systems: List[System] = [
            System(cfg, Sensor.MONOCULAR, device=device,
                   async_mapping=async_mapping)
            for _ in range(n_sequences)]
        # ONE steady-state builder for the batched extraction; each System's
        # own builders keep their frame-id counters (the keyframe rule counts
        # frames by id) and the initialization's 2x-features extractor.
        self.shared_builder = FrameBuilder(cfg, device)
        self.frame_ms: list[float] = []

    @property
    def n_sequences(self) -> int:
        return len(self.systems)

    def track_batch(self, imgs, timestamp: float) -> list:
        """imgs u8/f32 [S, H, W] grayscale (numpy or tensor), row s for
        sequence s -> list of Tcw (4x4) or None."""
        t0 = time.perf_counter()
        S = self.n_sequences
        if imgs.shape[0] != S:
            raise ValueError(f"track_batch: {imgs.shape[0]} images for {S} "
                             f"sequences")
        steady = [s for s, sy in enumerate(self.systems)
                  if sy.tracker.state not in (TrackingState.NO_IMAGES_YET,
                                              TrackingState.NOT_INITIALIZED)]
        poses: list[Optional[np.ndarray]] = [None] * S
        if steady:
            packed = self.shared_builder.extract_packed_batch(
                imgs if len(steady) == S else imgs[steady])
            for row, s in enumerate(steady):
                builder = self.systems[s].tracker.builder
                frame = Frame(id=builder._next_id, timestamp=timestamp,
                              packed=packed[row])
                builder._next_id += 1
                poses[s] = self.systems[s].track_monocular_prebuilt(frame)
        for s in range(S):
            if s not in steady:
                poses[s] = self.systems[s].track_monocular(imgs[s], timestamp)
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        return poses

    def shutdown(self):
        for sy in self.systems:
            sy.shutdown()

    def aggregate_fps(self, skip: int = 5) -> float:
        """Frames per second over all sequences, from the rounds after the
        first `skip` (host clock)."""
        ms = self.frame_ms[skip:]
        if not ms:
            return 0.0
        return len(ms) * self.n_sequences / (sum(ms) / 1e3)
