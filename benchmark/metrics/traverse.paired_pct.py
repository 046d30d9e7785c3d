"""The share of the traversal kernel's launches that ran as two-CTA clusters,
in %: 100 x the port's counter traverse_paired_launches over traverse_launches,
each summed over the window's images. None from a program that counts
neither, and where no launch ran."""
UNIT = "%"
LAYER = "traversal kernel"
MOVES = "samples_per_s"


def read(run):
    stats = [im["stats"] for im in run.images]
    if not stats or any("traverse_launches" not in s for s in stats):
        return None
    launches = sum(s["traverse_launches"] for s in stats)
    if launches <= 0:
        return None
    return 100.0 * sum(s.get("traverse_paired_launches", 0) for s in stats) / launches
