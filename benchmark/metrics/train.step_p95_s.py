"""The 95th percentile of the window's train-step walls (the benchmark's span
around each train_step call, its loss read and the update, to the
synchronisation that ends the step): the tail beside the rate."""
import numpy as np

UNIT = "s"
LAYER = "render entry points"
MOVES = "samples_per_s"


def read(run):
    if not run.images:
        return None
    return float(np.percentile([im["wall"] for im in run.images], 95))
