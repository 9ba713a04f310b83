"""Arithmetic of the end-to-end and device metrics."""

from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by nearest rank: the smallest value with
    at least a share q of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]


def beyond(n: int, q: float) -> int:
    """How many of n samples lie beyond the nearest-rank q-quantile."""
    return n - max(math.ceil(q * n), 1)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
