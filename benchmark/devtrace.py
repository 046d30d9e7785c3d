"""What a torch.profiler window over one render says: device busy time, device
time and launches by kernel name, and the longest gaps in the device's work.

Events are read from the profiler's raw kineto results: its own tables take
minutes over the hundreds of thousands of kernels that a render replays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TOP = 10


@dataclasses.dataclass
class Profile:
    window_s: float                  # host wall of the profiled render
    busy_s: float                    # union of the device's activity intervals
    seconds_by_name: dict            # device seconds by kernel (or copy) name
    count_by_name: dict              # device activities by name
    gaps: list                       # [(what the host was doing, seconds)], longest first

    def seconds_matching(self, *parts) -> float:
        return sum(s for n, s in self.seconds_by_name.items() if any(p in n for p in parts))

    def count_matching(self, *parts) -> int:
        return sum(c for n, c in self.count_by_name.items() if any(p in n for p in parts))

    @property
    def device_s(self) -> float:
        return sum(self.seconds_by_name.values())

    def top_ops(self):
        ops = sorted(self.seconds_by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in ops]


def _union(starts, ends):
    """(merged starts, merged ends) of the intervals, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    ends_m = np.append(run_end[idx[1:] - 1], run_end[-1])
    return s[idx], ends_m


def summarize(prof, window_s: float) -> Profile:
    from torch.autograd import DeviceType

    names, dev_start, dev_end = [], [], []
    cpu = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            names.append(e.name())
            dev_start.append(e.start_ns())
            dev_end.append(e.start_ns() + e.duration_ns())
        elif e.duration_ns() > 0:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    seconds, counts = {}, {}
    for n, a, b in zip(names, dev_start, dev_end):
        seconds[n] = seconds.get(n, 0.0) + (b - a) * 1e-9
        counts[n] = counts.get(n, 0) + 1
    if not names:
        return Profile(window_s, 0.0, seconds, counts, [])
    s, e = _union(np.asarray(dev_start, np.int64), np.asarray(dev_end, np.int64))
    busy = float((e - s).sum()) * 1e-9
    gap_len = s[1:] - e[:-1]
    gaps = []
    if len(gap_len):
        cpu_s = np.asarray([c[0] for c in cpu], np.int64)
        cpu_e = np.asarray([c[1] for c in cpu], np.int64)
        for i in np.argsort(-gap_len)[:TOP]:
            mid = (e[i] + s[i + 1]) // 2
            inside = np.flatnonzero((cpu_s <= mid) & (cpu_e >= mid)) if len(cpu) else []
            if len(inside):
                j = inside[np.argmin(cpu_e[inside] - cpu_s[inside])]
                what = cpu[j][2][:160]
            else:
                what = "host, no profiled op"
            gaps.append([what, float(gap_len[i]) * 1e-9])
    return Profile(window_s, busy, seconds, counts, gaps)
