"""The device's idle share of a train step: 1 - (the device's busy time in a
profiled step, the union of its activity intervals) / (the span of that
step's device activities, the first one's start to the last one's end), so
the sum of the gaps in the device's work, all read from the one profile
(the profiler slows the kernels, so its busy time is not set against an
unprofiled wall). It shows the host's share inside a step: the intersect
closure, the replays' launches, the gradients' assembly. None for a profile
without the span (no device activity, or a step profiled without it)."""
UNIT = "%"
LAYER = "device"
MOVES = "samples_per_s"


def read(run):
    p = run.profile
    span = getattr(p, "device_span_s", None)
    if p is None or not span or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / span)
