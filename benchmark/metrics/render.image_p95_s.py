"""The 95th percentile of the window's image walls (the benchmark's span
around each render() call): the tail beside the rate."""
import numpy as np

UNIT = "s"
LAYER = "render entry points"
MOVES = "samples_per_s"


def read(run):
    if not run.images:
        return None
    return float(np.percentile([im["wall"] for im in run.images], 95))
