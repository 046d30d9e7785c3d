"""Camera samples (pixels x samples a pixel) of the images finished in the
window, over the window: all the work over all the time, stalls included."""
UNIT = "samples/s"
LAYER = None
MOVES = None


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    return len(run.images) * run.samples_per_image / run.window_s
