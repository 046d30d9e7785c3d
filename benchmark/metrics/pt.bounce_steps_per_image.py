"""Bounce steps a path-tracer image runs (render()'s stats["bounce_steps"],
one host sync and, on the card, one graph replay each), over the window's
images."""
UNIT = "steps"
LAYER = "graphed loops"
MOVES = "samples_per_s"


def read(run):
    steps = [im["stats"].get("bounce_steps") for im in run.images]
    if not steps or any(s is None for s in steps):
        return None
    return sum(steps) / len(steps)
