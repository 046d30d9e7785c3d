"""The share of the window's train-step walls spent in the step's backward
pass: the port's span train.backward (torch.autograd.grad over the trips'
recompute and backward replays, and the gradients' assembly) in each
step's stats, over the step walls."""
UNIT = "%"
LAYER = "render entry points"
MOVES = "samples_per_s"

SPAN = "train.backward"


def read(run):
    spans = [im["stats"].get("spans") for im in run.images]
    walls = sum(im["wall"] for im in run.images)
    if not spans or any(s is None or SPAN not in s for s in spans) or walls <= 0:
        return None
    return 100.0 * sum(s[SPAN][1] for s in spans) / walls
