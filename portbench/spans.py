"""What the per-layer metrics of source `program_span` share: the program's
own spans (cocodr_tpu_torch/utils/logging.py::span) in a traced window,
clipped to it, and their overlap with the device's idle gaps.

The spans are read from the program's in-memory log after the window has
closed, on the trace's clock (ns since the epoch). A program that records
no spans (one older than the recorder) gives none, and every reading here
is then None, as it is where the window holds no span of the name.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[int, int]


def spans(run, name: str) -> List[Interval]:
    """(start, end) ns of the spans named `name` that overlap the window,
    clipped to it, in the order they ended."""
    try:
        from cocodr_tpu_torch.utils.logging import recorded_spans
    except ImportError:
        return []
    lo, hi = run.window_ns
    return [(max(s.start_ns, lo), min(s.end_ns, hi))
            for s in recorded_spans(lo, hi) if s.name == name]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def subtract(a: Iterable[Interval], b: Iterable[Interval]) -> List[Interval]:
    """The parts of union(a) outside union(b)."""
    cut, out = union(b), []
    for s, e in union(a):
        for bs, be in cut:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
        if e > s:
            out.append((s, e))
    return out


def seconds(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals) / 1e9


def mean_ms(run, name: str) -> Optional[float]:
    """The mean time of a span of `name` in the window, ms."""
    found = spans(run, name)
    if not found:
        return None
    return 1e3 * seconds(found) / len(found)


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The time two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, name: str, minus: Optional[str] = None
               ) -> Optional[float]:
    """Share of the window in which the device idles while a span of
    `name` runs, outside the spans of `minus`, %; None without a device
    trace or where the window holds no span of `name`."""
    found = spans(run, name)
    if not found or not run.device_ops:
        return None
    inside = subtract(found, spans(run, minus) if minus else [])
    idle = overlap_ns(inside, run.idle_gaps())
    return 100.0 * idle / (run.window_ns[1] - run.window_ns[0])
