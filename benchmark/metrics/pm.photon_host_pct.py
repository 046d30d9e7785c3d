"""The share of the window's image walls that the photon pass spends on the
host: each emission chunk's copy of its stores to the host and the two
grids' host sort and upload (the port's spans pm.emit.copy and pm.grid in
each image's stats). None where no image ran a photon pass."""
UNIT = "%"
LAYER = "photon mapper passes"
MOVES = "samples_per_s"

SPANS = ("pm.emit.copy", "pm.grid")


def read(run):
    spans = [im["stats"].get("spans") for im in run.images]
    walls = sum(im["wall"] for im in run.images)
    if not spans or any(s is None or "pm.photon_pass" not in s for s in spans) or walls <= 0:
        return None
    return 100.0 * sum(s[n][1] for s in spans for n in SPANS if n in s) / walls
