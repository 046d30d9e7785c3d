"""Process start to the first timed image: imports, the scene, the BVH, the
kernels' build or load, the warm-up render and its graph captures."""
UNIT = "s"
LAYER = None
MOVES = None


def read(run):
    return run.setup_s
