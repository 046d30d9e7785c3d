"""The share of a profiled render's device time spent outside the traversal
and k-NN kernels: the bounce's plain PyTorch (and copies) inside the graphs."""
UNIT = "%"
LAYER = "bounce PyTorch"
MOVES = "samples_per_s"

KERNELS = ("traverse_kernel", "knn_ring1", "knn_rings", "knn_scan")


def read(run):
    p = run.profile
    if p is None or p.device_s <= 0:
        return None
    return 100.0 * (p.device_s - p.seconds_matching(*KERNELS)) / p.device_s
