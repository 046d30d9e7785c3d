"""The share of the window's image walls that render() spends on the scene's
device tables and its BVH and intersect (the port's spans render.tables and
render.bvh in each image's stats): set-up that every image pays again."""
UNIT = "%"
LAYER = "render entry points"
MOVES = "samples_per_s"

SPANS = ("render.tables", "render.bvh")


def read(run):
    spans = [im["stats"].get("spans") for im in run.images]
    walls = sum(im["wall"] for im in run.images)
    if not spans or any(s is None for s in spans) or walls <= 0:
        return None
    return 100.0 * sum(s[n][1] for s in spans for n in SPANS if n in s) / walls
