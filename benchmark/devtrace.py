"""Reading torch.profiler's Chrome trace of a stretch of calls.

The device operations are the events of categories kernel, gpu_memcpy and
gpu_memset (chip_smoke.py's `trace_device_us` and `trace_busy_span_us`,
copied); busy time is their intervals merged, the span runs from the first
one's start to the last one's end, so the host's gaps between calls count
as idle.  The host's activity in a gap is the shortest host event of the
harness's or torch's own that covers the gap's middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_CATS = ("gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
KERNEL = "fused_admm_kernel"


@dataclasses.dataclass
class Trace:
    device: List[dict]          # device operations, sorted by start
    host: List[dict]            # host events

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        return cls.from_events(events)

    @classmethod
    def from_events(cls, events: List[dict]) -> "Trace":
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "ts" in e),
                     key=lambda e: float(e["ts"]))
        host = [e for e in events if e.get("cat") in HOST_CATS and "ts" in e and "dur" in e]
        return cls(dev, host)

    def launches(self) -> int:
        return sum(1 for e in self.device if e["cat"] == "kernel" and KERNEL in e.get("name", ""))

    def split_us(self) -> Dict[str, float]:
        """Device time, us, of the fused loop's launches, of the other
        kernels, and of copies and sets."""
        out = dict(kernel=0.0, small_ops=0.0, copy=0.0)
        for e in self.device:
            dur = float(e.get("dur", 0))
            if e["cat"] in COPY_CATS:
                out["copy"] += dur
            elif KERNEL in e.get("name", ""):
                out["kernel"] += dur
            else:
                out["small_ops"] += dur
        return out

    def intervals(self) -> List[Tuple[float, float]]:
        """The device operations' intervals, merged, us."""
        merged: List[Tuple[float, float]] = []
        for e in self.device:
            a = float(e["ts"])
            b = a + float(e.get("dur", 0))
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def busy_span_us(self) -> Tuple[float, float]:
        iv = self.intervals()
        if not iv:
            return 0.0, 0.0
        return sum(b - a for a, b in iv), iv[-1][1] - iv[0][0]

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, by name, seconds."""
        tot: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            tot[e.get("name", "?")] += float(e.get("dur", 0)) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time between device operations, by what the host was
        doing in the middle of each gap, the largest first, seconds."""
        iv = self.intervals()
        host = sorted(self.host, key=lambda e: float(e["ts"]))
        tot: Dict[str, float] = collections.defaultdict(float)
        active: List[dict] = []
        j = 0
        for (_, a), (b, _) in zip(iv, iv[1:]):
            mid = 0.5 * (a + b)
            while j < len(host) and float(host[j]["ts"]) <= mid:
                active.append(host[j])
                j += 1
            # the gaps come in time order: an event over before this one is over for good
            active = [e for e in active if float(e["ts"]) + float(e["dur"]) >= mid]
            best = min(active, key=lambda e: float(e["dur"]), default=None)
            what = best.get("name", "?") if best is not None else "no host event"
            tot[what] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
