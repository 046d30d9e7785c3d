"""The share of the window's image walls that the graphed loops spend on
their eager first steps and their CUDA graph captures (the port's spans
loop.warm and loop.capture in each image's stats): render() closes its
graphs, so every image pays them again."""
UNIT = "%"
LAYER = "graphed loops"
MOVES = "samples_per_s"

SPANS = ("loop.warm", "loop.capture")


def read(run):
    spans = [im["stats"].get("spans") for im in run.images]
    walls = sum(im["wall"] for im in run.images)
    if not spans or any(s is None for s in spans) or walls <= 0:
        return None
    return 100.0 * sum(s[n][1] for s in spans for n in SPANS if n in s) / walls
