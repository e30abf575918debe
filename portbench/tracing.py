"""The traced window: ``torch.profiler`` over the window, reduced to host
span times, device time by operation and by card, each card's busy time
(the union of its operations' intervals), and the idle gaps of the first
card named by the host span that was open at their middle.

The busy and idle reading is the method of ``chip_smoke.py``'s
``profile_stage`` (device time over the traced wall), taken per card and
from intervals, so overlapping operations on one card count once.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

TOP = 10


def _device_op(e, span_names) -> bool:
    """Whether an event on the card's timeline is work on the card (a
    kernel, a copy or a fill) and not a host span's mirror there."""
    return not e.is_user_annotation() and e.name() not in span_names


@contextmanager
def traced(enabled: bool, on_card: bool):
    """Profile the body when ``enabled``; yields a dict that holds, after
    the body, "events" (the raw profiler events) and "window_s"."""
    out = {"events": None, "window_s": None}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        out["window_s"] = time.perf_counter() - t0
    out["events"] = prof.profiler.kineto_results.events()


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, window_s: float) -> dict:
    """{"spans_s": {host span: s}, "ops_s": {device op: s}, "busy_s":
    {card: s}, "idle_gaps": [[host span, s], ...], "window_s"}."""
    spans, ops, per_card, host_spans = {}, {}, {}, []
    t_lo, t_hi = None, None
    on_card = []
    for e in events:
        dev = str(e.device_type())
        s, d = e.start_ns(), e.duration_ns()
        if dev.endswith("CPU"):
            if e.is_user_annotation():
                name = e.name()
                spans[name] = spans.get(name, 0.0) + d / 1e9
                host_spans.append((s, s + d, name))
            t_lo = s if t_lo is None else min(t_lo, s)
            t_hi = s + d if t_hi is None else max(t_hi, s + d)
        elif dev.endswith("CUDA"):
            on_card.append((e, s, d))
    for e, s, d in on_card:
        if _device_op(e, spans):
            name = e.name()
            ops[name] = ops.get(name, 0.0) + d / 1e9
            per_card.setdefault(int(e.device_index()), []).append((s, s + d))
    busy = {c: sum(e - s for s, e in _union(iv)) / 1e9
            for c, iv in per_card.items()}
    gaps = {}
    if per_card and t_lo is not None:
        first = min(per_card)
        merged = _union(per_card[first])
        host_spans.sort()
        starts = [h[0] for h in host_spans]
        edges = [t_lo] + [x for iv in merged for x in iv] + [t_hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "no span"
            # the innermost span open at mid: the latest of the spans
            # started before it that is still open (spans nest shallowly)
            j = bisect.bisect_right(starts, mid)
            for hs, he, hn in reversed(host_spans[max(0, j - 16):j]):
                if he >= mid:
                    name = hn
                    break
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    return {"spans_s": spans, "ops_s": ops, "busy_s": busy,
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:TOP],
            "window_s": window_s}


def breakdown(summary: dict) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the first card's idle time by what the host was doing."""
    ops = sorted(summary["ops_s"].items(), key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": summary["idle_gaps"]}
