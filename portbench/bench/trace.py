"""The traced window: torch.profiler over the card's activity, read from
its raw kineto events (the union of kernel and copy intervals is the busy
time; chip_smoke.device_busy's method), with the host's phases laid over
the device timeline by a marker kernel, so each idle gap is named by
what the host was doing."""

from __future__ import annotations

import bisect
import time


class Traced:
    """Context manager; ``enabled=False`` traces nothing."""

    def __init__(self, torch, enabled: bool, card: bool = True):
        self.torch, self.enabled, self.card = torch, enabled and card, card
        self.prof = None
        self.t0 = self.t1 = None
        self.spans, self.kernels, self.offset = [], {}, None

    def _marker(self):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.torch.cuda._sleep(2000)
        self.torch.cuda.synchronize()
        return t

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.m0 = self._marker()
        if self.card:
            self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.card:
            self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.enabled:
            self.prof.__exit__(*exc)
            self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType

        spans, marks = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            lo = e.start_ns() / 1e9
            hi = lo + e.duration_ns() / 1e9
            if "spin_kernel" in e.name():
                marks.append(lo)
                continue
            spans.append((lo, hi, e.name()))
        spans.sort()
        self.spans = spans
        if marks:
            self.offset = min(marks) - self.m0  # device clock minus host clock
        for lo, hi, name in spans:
            n, tot = self.kernels.get(name, (0, 0.0))
            self.kernels[name] = (n + 1, tot + hi - lo)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        busy, reach = 0.0, float("-inf")
        for lo, hi, _ in self.spans:
            busy += max(0.0, hi - max(lo, reach))
            reach = max(reach, hi)
        return busy

    def idle_gaps(self, phases, top: int = 10):
        """[[host phase, idle seconds]] over the window, the phases given as
        (label, t0, t1) on the host clock; longest total first."""
        if self.offset is None or not self.spans:
            return []
        lo_w, hi_w = self.t0 + self.offset, self.t1 + self.offset
        gaps, reach = [], lo_w
        for lo, hi, _ in self.spans:
            if lo > reach:
                gaps.append((reach, min(lo, hi_w)))
            reach = max(reach, hi)
        if reach < hi_w:
            gaps.append((reach, hi_w))
        phases = sorted(phases, key=lambda p: p[1])
        starts = [p[1] for p in phases]
        total = {}
        for a, b in gaps:
            if b <= a:
                continue
            mid = 0.5 * (a + b) - self.offset
            i = bisect.bisect_right(starts, mid) - 1
            label = phases[i][0] if i >= 0 and phases[i][2] >= mid else "between jobs"
            total[label] = total.get(label, 0.0) + (b - a)
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10):
        """[[kernel or copy, seconds]], most time first."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return [[name[:120], tot] for name, (_, tot) in ops]
