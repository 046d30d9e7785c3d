"""The device's idle share of an image: 1 - (the device's busy time in a
profiled render, the union of its activity intervals) / (the mean wall of
the window's unprofiled images). The profiler's own cost lengthens the
profiled render's wall, not the device's work, so its wall is not used. It
shows the host waits of the graphed loops (one host sync a step) and the
host-side passes (the photon grid build)."""
UNIT = "%"
LAYER = "device"
MOVES = "samples_per_s"


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0 or not run.images:
        return None
    wall = sum(im["wall"] for im in run.images) / len(run.images)
    return 100.0 * max(0.0, 1.0 - p.busy_s / wall)
