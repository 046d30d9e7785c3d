"""The three exact k-NN kernels' share of their roofline over a profiled
render: the least time a call's work needs (benchmark/roofline.py, counted
on calls kept from that render and scaled by the calls the profile counts,
one knn_ring1 launch each) over the three kernels' device time there."""
UNIT = "%"
LAYER = "k-NN kernels"
MOVES = "samples_per_s"

KERNELS = ("knn_ring1", "knn_rings", "knn_scan")


def read(run):
    p, w = run.profile, run.work.get("knn")
    if p is None or w is None or w[0] == 0:
        return None
    seconds, calls = p.seconds_matching(*KERNELS), p.count_matching("knn_ring1")
    if seconds <= 0 or calls == 0 or w[1] <= 0:
        return None
    return 100.0 * calls * (w[1] / w[0]) / seconds
