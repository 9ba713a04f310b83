"""Faults planted in the program underneath the harness, by name: the CPU
tests drive a whole run with each and see `correct` come out false, and
calibrate.py reads each at a cell's own size on the card, where it gives a
number's upper reading. The benchmark's own runs plant none.

  pose_unchanged       tracking's step returns its state unchanged: once
                       the System is warm, every frame gets the last pose
                       it returned (`cameras`: only the Systems of these
                       indices, in the order they first track; one of two
                       is half of the batch left out);
  pose_dropped         an answer altered where it is produced: once the
                       System is warm, every second frame's pose is
                       returned as None (LOST), the System's own state
                       untouched;
  local_ba_skipped     mapping's step returns its state unchanged: local
                       bundle adjustment neither moves a keyframe or a
                       point nor drops an outlier observation;
  descriptor_altered   an answer altered where it is produced: every
                       descriptor's words XORed with one mask, which leaves
                       Hamming distances, and so tracking, unchanged.
"""

from __future__ import annotations


def _pose_unchanged(set_attr, cameras=None):
    from orb_slam_system_tpu_torch.models.system import System
    orig = System._track
    order = []

    def track(self, grab, timestamp, *args, view=None):
        if self not in order:
            order.append(self)
        frozen = getattr(self, "_fault_frozen", None)
        if frozen is not None and (cameras is None or order.index(self) in cameras):
            return frozen.copy()
        T = orig(self, grab, timestamp, *args, view=view)
        if T is not None and self.place_rec.ready:
            self._fault_frozen = T
        return T

    set_attr(System, "_track", track)


def _pose_dropped(set_attr):
    from orb_slam_system_tpu_torch.models.system import System
    orig = System._track

    def track(self, grab, timestamp, *args, view=None):
        T = orig(self, grab, timestamp, *args, view=view)
        if self.place_rec.ready:
            self._fault_calls = getattr(self, "_fault_calls", 0) + 1
            if self._fault_calls % 2 == 0:
                return None
        return T

    set_attr(System, "_track", track)


def _local_ba_skipped(set_attr):
    from orb_slam_system_tpu_torch.models.local_mapping import LocalMapper

    def local_ba(self, kf):
        return None

    set_attr(LocalMapper, "local_ba", local_ba)


def _descriptor_altered(set_attr):
    import torch
    from orb_slam_system_tpu_torch.models.frame import FrameBuilder
    orig = FrameBuilder._pack

    def pack(self, *a, **kw):
        p = orig(self, *a, **kw)
        d = p[..., 8:16].contiguous().view(torch.int32) ^ 0x00010001
        return torch.cat([p[..., :8], d.view(torch.float32), p[..., 16:]], dim=-1)

    set_attr(FrameBuilder, "_pack", pack)


FAULTS = {"pose_unchanged": _pose_unchanged,
          "pose_dropped": _pose_dropped,
          "local_ba_skipped": _local_ba_skipped,
          "descriptor_altered": _descriptor_altered}


def plant(name: str, set_attr=setattr, **kw) -> None:
    """Plants fault `name` (set_attr: setattr, or a test's
    monkeypatch.setattr so that the test undoes it)."""
    FAULTS[name](set_attr, **kw)
