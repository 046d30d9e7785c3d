"""The traversal kernel's share of its roofline over a profiled train step:
the least time its work needs (benchmark/roofline.py, counted on the
launches of every EVERY-th replay of the trips' graphs, entries/train_steps.
TripSamples, and scaled by the launches the profile counts) over its device
time there. The card's power limit is printed beside it."""
UNIT = "%"
LAYER = "traversal kernel"
MOVES = "samples_per_s"


def read(run):
    p, w = run.profile, run.work.get("traverse")
    if p is None or w is None or w[0] == 0:
        return None
    seconds, launches = p.seconds_matching("traverse_kernel"), p.count_matching("traverse_kernel")
    if seconds <= 0 or launches == 0 or w[1] <= 0:
        return None
    return 100.0 * launches * (w[1] / w[0]) / seconds
