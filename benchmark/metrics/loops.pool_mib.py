"""The memory that an image's CUDA graph captures reserve for their private
pools, in MiB (the port's counter graph_pool_bytes, summed when each pool is
reserved, 0 in an image that captured nothing), the mean over the window's
images. None from a program that records no spans."""
UNIT = "MiB"
LAYER = "graphed loops"
MOVES = "peak_mem_gib"


def read(run):
    stats = [im["stats"] for im in run.images]
    if not stats or any("spans" not in s for s in stats):
        return None
    return sum(s.get("graph_pool_bytes", 0) for s in stats) / len(stats) / float(1 << 20)
