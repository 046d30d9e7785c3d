"""torch.cuda.max_memory_allocated() over set-up and window, after the
peak was reset at the start of the run: graph pools included."""
UNIT = "GiB"
LAYER = None
MOVES = None


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / float(1 << 30)
