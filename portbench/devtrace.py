"""The traced window: ``torch.profiler`` over CPU and CUDA on every thread,
its Chrome trace read back into device intervals and the harness's spans.

* busy: the union of the intervals in which a kernel, a copy or a set ran on
  the card, clipped to the window (the ``portbench.window`` span).
* device time by name: the summed durations of the device events whose
  names match a pattern.
* idle gaps by what the host was doing: each stretch of the window with
  nothing on the card, given to the innermost ``portbench.*`` span open on
  the window's thread at that time (``outside_spans`` where none is).
"""

from __future__ import annotations

import bisect
import json
import os
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def profiler(cuda: bool = True):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))


class Trace:
    def __init__(self, events: List[dict]):
        windows = [e for e in events if e.get("name") == WINDOW
                   and e.get("ph") == "X"]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} windows")
        w = windows[0]
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.end - self.start) / 1e6
        self.device: List[Tuple[str, float, float]] = [
            (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X" and "dur" in e]
        self.spans: List[Tuple[str, float, float]] = sorted(
            (e["name"][len("portbench."):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid")
            and str(e.get("name", "")).startswith("portbench.")
            and e["name"] != WINDOW)
        self._busy = self._union()
        self.busy_s = sum(b - a for a, b in self._busy) / 1e6

    def _union(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.device, key=lambda d: d[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def device_seconds(self, patterns) -> Optional[float]:
        """Summed seconds of the device events whose names match one of the
        regular expressions; None when none matches."""
        rx = [re.compile(p) for p in patterns]
        hits = [b - a for name, a, b in self.device
                if any(r.search(name) for r in rx)]
        return sum(hits) / 1e6 if hits else None

    def idle_by_span(self) -> Dict[str, float]:
        """Seconds of the window with nothing on the card, by span."""
        cuts = sorted({self.start, self.end}
                      | {t for _, a, b in self.spans for t in (a, b)
                         if self.start < t < self.end})
        starts = [a for a, _ in self._busy]
        cum = [0.0]
        for a, b in self._busy:
            cum.append(cum[-1] + b - a)

        def busy_before(t: float) -> float:
            i = bisect.bisect_right(starts, t) - 1
            if i < 0:
                return 0.0
            a, b = self._busy[i]
            return cum[i] + min(t, b) - a

        out: Dict[str, float] = {}
        open_spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            mid = (lo + hi) / 2
            label = "outside_spans"
            best = None
            for name, a, b in open_spans:
                if a > mid:
                    break
                if b > mid and (best is None or a >= best):
                    best, label = a, name
            idle = (hi - lo) - (busy_before(hi) - busy_before(lo))
            out[label] = out.get(label, 0.0) + idle / 1e6
        return out

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for name, a, b in self.device:
            key = name[:64]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.idle_by_span().items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [list(x) for x in ops],
                "idle_gaps": [list(x) for x in gaps]}


def read(prof, path: str) -> Trace:
    """Export the profiler's Chrome trace to ``path``, read it, delete it."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
