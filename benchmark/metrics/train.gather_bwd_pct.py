"""The share of a profiled train step's device time spent in the material
gather's backward: the float64 index_put_(accumulate=True) of
materials/bsdf._GatherRows, whose kernels' names hold one of KERNELS
(indexing's sort-based backward, `indexing_backward_kernel*`). It matches
kernel names: a change that replaces that kernel leaves this reader to be
pointed at its successor, and until then it reads nothing."""
UNIT = "%"
LAYER = "bounce PyTorch"
MOVES = "samples_per_s"

KERNELS = ("indexing_backward",)


def read(run):
    p = run.profile
    if p is None or p.device_s <= 0:
        return None
    seconds = p.seconds_matching(*KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * seconds / p.device_s
